// NB2-log GLM log-likelihood on the hoisted math, with analytic gradients,
// batched over B parameter vectors, for NVIDIA Hopper (sm_90a). One source,
// two kernels, chosen by the compile-time switch DELTA:
//
//   DELTA = true  (K1) replaces the Pallas TPU kernel
//                 ppcseq_tpu/ops/nb_kernel.py:_fastk_delta (+ _fast_common);
//                 plain version ppcseq_tpu_torch/ops/nb_fast.py:glm_delta.
//   DELTA = false (K2) replaces ppcseq_tpu/ops/nb_kernel.py:_fastk_plain;
//                 plain version ppcseq_tpu_torch/ops/nb_fast.py:glm_plain.
//
// The branch structure, thresholds and polynomials follow the plain
// versions line for line.
//
//   value[b]          = sum_{s,g} mask[s,g] * lpmf(y[s,g] | d[b,s,g], phi[b,g])
//   dalpha[b,c,g]     = sum_s X[s,c] * mask[s,g] * deta[b,s,g]
//   dlog_phi[b,g]     = sum_s mask[s,g] * dlogphi[b,s,g]
//   K1: d = d0 + X (alpha[b] - alpha0) - (min(log_phi[b], 80) + sigma_raw0)
//   K2: d = exposure + X alpha[b] - min(log_phi[b], 80)   (C multiply-adds)
//
// Layout. One thread owns one (b, g) and loops over the S samples, so
// neighbouring threads read neighbouring genes of each [S, G] row
// (coalesced) and the per-gene tables (~12 transcendentals) are computed
// once in registers. The gradients accumulate in registers and are stored
// once: no atomics. The value is summed over S per thread into
// partial[b, g]; a second kernel reduces partial over G in a fixed order,
// so the value is bitwise reproducible from run to run.
//
// Bound. Per point ~3 exp + 1 log (more on the rarer far/fallback
// branches) and 8-12 bytes of [S, G] input (counts, mask, and d0 for K1),
// re-read for each b from L2. At large S*G*B the special-function units
// bound it; at the pipeline's shapes (S=21, G~500, B=1..128) launch latency
// does. The value-only instantiation (GRADS=false) skips the digamma terms
// and the gradient math.
//
// Build without --use_fast_math: the float32 smoothness of the delta form
// rests on accurate expf/logf and on the branch thresholds.

#include "nb_common.cuh"

namespace {

using namespace nbk;

template <int C, bool GRADS, bool DELTA>
__global__ void __launch_bounds__(THREADS)
nb_glm_fast_kernel(const float* __restrict__ X, const float* __restrict__ exposure,
                   const int32_t* __restrict__ counts, const float* __restrict__ mask,
                   const float* __restrict__ d0, const float* __restrict__ alpha,
                   const float* __restrict__ alpha0, const float* __restrict__ log_phi,
                   const float* __restrict__ sigma_raw0, int S, int G,
                   float* __restrict__ partial, float* __restrict__ dalpha,
                   float* __restrict__ dlog_phi) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (g >= G) return;

  // ---- per-gene tables (nb_fast._gene_tables) ----------------------------
  const float lp_raw = log_phi[(size_t)b * G + g];
  const float lpc = fminf(lp_raw, LOG_PHI_CAP);
  const float phi = expf(lpc);
  float cum_log[7], cum_frac[7];
  {
    float acc_l = logf(phi), acc_f = 1.0f;
    cum_log[0] = acc_l;
    cum_frac[0] = acc_f;
#pragma unroll
    for (int k = 1; k < 7; ++k) {
      acc_l = acc_l + logf(phi + (float)k);
      acc_f = acc_f + phi / (phi + (float)k);
      cum_log[k] = acc_l;
      cum_frac[k] = acc_f;
    }
  }
  const float xs = fminf(phi, 8.0f) + 8.0f;
  const float inv = 1.0f / xs;
  const float inv2 = inv * inv;
  const float log_xs = logf(xs);
  const float stirl = (xs - 0.5f) * log_xs - xs + HALF_LOG_2PI +
                      inv * (1.0f / 12.0f + inv2 * (-1.0f / 360.0f + inv2 * (1.0f / 1260.0f)));
  const float lgam_small = stirl - (cum_log[6] + logf(phi + 7.0f));
  const float psi8 =
      log_xs - 0.5f * inv - inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
  const float shift_c = cum_frac[6] + phi / (phi + 7.0f);
  const float log_phi_b = fmaxf(lpc, LOG8);
  const float phi_b = fmaxf(phi, 8.0f);
  const float inv_phi_b = 1.0f / phi_b;
  const float inv_phi_b3 = inv_phi_b * inv_phi_b * inv_phi_b;
  const float b_const = -0.5f * log_phi_b + 1.0f - HALF_LOG_2PI - (1.0f / 12.0f) * inv_phi_b +
                        (1.0f / 360.0f) * inv_phi_b3;
  const float d_b = phi - 1.0f;
  const float delta_log_phi = DELTA ? lpc + sigma_raw0[g] : 0.0f;  // log_phi - log_phi0
  const bool below_cap = lp_raw < LOG_PHI_CAP;

  float da[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    da[c] = DELTA ? alpha[((size_t)b * C + c) * G + g] - alpha0[(size_t)c * G + g]
                  : alpha[((size_t)b * C + c) * G + g];

  float acc_val = 0.0f, acc_dlp = 0.0f;
  float acc_da[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc_da[c] = 0.0f;

  for (int s = 0; s < S; ++s) {
    const size_t i = (size_t)s * G + g;
    const float m = mask[i];
    const float yf = (float)counts[i];

    // K1: delta_eta = X (alpha - alpha0); K2: eta = exposure + X alpha
    float eta = DELTA ? 0.0f : exposure[s];
#pragma unroll
    for (int c = 0; c < C; ++c) eta += __ldg(&X[s * C + c]) * da[c];
    const float d0v = DELTA ? d0[i] : 0.0f;
    const float dlo = eta - delta_log_phi;  // K1 only
    const float d = DELTA ? d0v + dlo : eta - lpc;

    // softplus pair sharing one exp (nb_fast._softplus_pair)
    const float em = expf(-fabsf(d));
    const float l1pem = log1p01(em);
    const float sp_d = fmaxf(d, 0.0f) + l1pem;
    const float sp_nd = fmaxf(-d, 0.0f) + l1pem;

    // part23 = -(phi_sp + y * y_sp), y_sp = softplus(-d)
    float phi_sp, y_sp;
    if (DELTA) {
      // baseline constants rebuilt from d0
      const float em0 = expf(-fabsf(d0v));
      const float sp_d0 = fmaxf(d0v, 0.0f) + log1p01(em0);
      const float sig_neg_d0 = d0v > 0.0f ? em0 / (1.0f + em0) : 1.0f / (1.0f + em0);
      const float spn0 = sp_d0 - d0v;  // softplus(-d0)

      // hybrid increments (nb_fast.delta_increment_terms)
      float inc_neg;
      if (dlo > -2.0f && dlo < 8.0f) {
        const float e1 =
            fabsf(dlo) < 0.35f
                ? dlo * (1.0f + dlo * (0.5f + dlo * (1.0f / 6.0f + dlo * (1.0f / 24.0f +
                  dlo * (1.0f / 120.0f + dlo * (1.0f / 720.0f + dlo / 5040.0f))))))
                : expf(dlo) - 1.0f;
        const float e1_neg = -e1 / (1.0f + e1);
        phi_sp = phi * (sp_d0 + log1p_wide((1.0f - sig_neg_d0) * e1));
        inc_neg = log1p_wide(sig_neg_d0 * e1_neg);
      } else {
        phi_sp = d < -25.0f ? expf(fminf(fmaxf(lpc + d, -60.0f), 60.0f)) : phi * sp_d;
        inc_neg = sp_nd - spn0;
      }
      y_sp = inc_neg + spn0;
    } else {
      phi_sp = phi * sp_d;
      y_sp = sp_nd;
    }

    // part1 and phi*(digamma(y+phi) - digamma(phi)) (nb_fast._part1_and_digamma)
    float part1, phi_d = 0.0f;
    if (yf <= 7.0f) {
      part1 = select_by_y(yf, cum_log) - lgamma_1p_small(yf);
      if (GRADS) phi_d = select_by_y(yf, cum_frac);
    } else {
      const float inv_y1 = 1.0f / (yf + 1.0f);
      const float l1p = log1p_wide(d_b * inv_y1);
      const float log_a1 = logf(yf + 1.0f) + l1p;  // log(y + phi)
      const float inv_a1 = 1.0f / (yf + phi);      // y >= 8 here: max(y, 8) = y
      const float inv_a1_2 = inv_a1 * inv_a1;
      const float corr = (1.0f / 12.0f) * (inv_a1 - inv_y1) -
                         (1.0f / 360.0f) * (inv_a1 * inv_a1_2 - inv_y1 * inv_y1 * inv_y1);
      const float pair = (yf + 0.5f) * l1p + corr;
      if (phi >= 8.0f) {
        const float ub = yf * inv_phi_b;
        const float l1p_b = ub < 0.5f ? log1p01(fminf(ub, 1.0f)) : log_a1 - log_phi_b;
        part1 = pair + (phi_b - 1.0f) * l1p_b + b_const;
        if (GRADS)
          phi_d = phi_b * l1p_b + 0.5f * yf * inv_a1 +
                  (1.0f / 12.0f) * (inv_phi_b - phi_b * inv_a1_2) -
                  (1.0f / 120.0f) * (inv_phi_b3 - phi_b * inv_a1_2 * inv_a1_2);
      } else {
        part1 = pair + d_b * log_a1 - d_b - lgam_small;
        if (GRADS) {
          const float psi_yphi =
              log_a1 - 0.5f * inv_a1 -
              inv_a1_2 * (1.0f / 12.0f - inv_a1_2 * (1.0f / 120.0f - inv_a1_2 / 252.0f));
          phi_d = fminf(phi, 8.0f) * (psi_yphi - psi8) + shift_c;
        }
      }
    }

    const float pts = part1 - phi_sp - yf * y_sp;
    acc_val += m * pts;

    if (GRADS) {
      // (deta, dlogphi) per point (nb_fast._grads_from_d)
      const float r = 1.0f / (1.0f + em);
      const float q = d > 0.0f ? em * r : r;  // sigmoid(-d)
      const float deta = yf * q - expf(lpc - sp_nd);
      float phi_a;
      if (d <= -1.386f) {
        const float series =
            0.5f - em * (2.0f / 3.0f - em * (0.75f - em * (0.8f - em * (5.0f / 6.0f -
            em * (6.0f / 7.0f - em * 0.875f)))));
        phi_a = expf(lpc + 2.0f * fminf(d, 0.0f)) * series;
      } else {
        phi_a = phi * (sp_d - (1.0f - q));
      }
      const float dlogphi = below_cap ? phi_d - phi_a - yf * q : 0.0f;
      const float mdeta = m * deta;
#pragma unroll
      for (int c = 0; c < C; ++c) acc_da[c] += __ldg(&X[s * C + c]) * mdeta;
      acc_dlp += m * dlogphi;
    }
  }

  partial[(size_t)b * G + g] = acc_val;
  if (GRADS) {
#pragma unroll
    for (int c = 0; c < C; ++c) dalpha[((size_t)b * C + c) * G + g] = acc_da[c];
    dlog_phi[(size_t)b * G + g] = acc_dlp;
  }
}


template <int C, bool DELTA>
void launch_c(dim3 grid, cudaStream_t st, bool grads, const float* X, const float* exposure,
              const int32_t* counts, const float* mask, const float* d0, const float* alpha,
              const float* alpha0, const float* log_phi, const float* sigma_raw0, int S, int G,
              float* partial, float* dalpha, float* dlog_phi) {
  if (grads)
    nb_glm_fast_kernel<C, true, DELTA><<<grid, THREADS, 0, st>>>(
        X, exposure, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, S, G, partial, dalpha,
        dlog_phi);
  else
    nb_glm_fast_kernel<C, false, DELTA><<<grid, THREADS, 0, st>>>(
        X, exposure, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, S, G, partial, dalpha,
        dlog_phi);
}

}  // namespace

extern "C" int nb_glm_fast_max_c() { return MAX_C; }

// Launches K1 (delta != 0: reads d0, alpha0, sigma_raw0; exposure ignored)
// or K2 (delta == 0: reads exposure; d0, alpha0, sigma_raw0 ignored), then
// the gene reduction, on `stream`. `partial` is [B, G] scratch;
// `dalpha`/`dlog_phi` are ignored unless want_grads. Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a C
// outside 1..MAX_C.
extern "C" int nb_glm_fast_launch(const void* X, const void* exposure, const void* counts,
                                  const void* mask, const void* d0, const void* alpha,
                                  const void* alpha0, const void* log_phi,
                                  const void* sigma_raw0, void* partial, void* value,
                                  void* dalpha, void* dlog_phi, int B, int S, int C, int G,
                                  int want_grads, int delta, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  dim3 grid((G + THREADS - 1) / THREADS, B);
  const bool grads = want_grads != 0;
  auto Xf = static_cast<const float*>(X);
  auto ex = static_cast<const float*>(exposure);
  auto cnt = static_cast<const int32_t*>(counts);
  auto mk = static_cast<const float*>(mask);
  auto d0f = static_cast<const float*>(d0);
  auto al = static_cast<const float*>(alpha);
  auto al0 = static_cast<const float*>(alpha0);
  auto lp = static_cast<const float*>(log_phi);
  auto sr0 = static_cast<const float*>(sigma_raw0);
  auto part = static_cast<float*>(partial);
  auto dal = static_cast<float*>(dalpha);
  auto dlp = static_cast<float*>(dlog_phi);
#define NB_CASE(n)                                                                           \
  if (delta)                                                                                 \
    launch_c<n, true>(grid, st, grads, Xf, ex, cnt, mk, d0f, al, al0, lp, sr0, S, G, part,   \
                      dal, dlp);                                                             \
  else                                                                                       \
    launch_c<n, false>(grid, st, grads, Xf, ex, cnt, mk, d0f, al, al0, lp, sr0, S, G, part,  \
                       dal, dlp);
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_over_genes_kernel<<<B, REDUCE_THREADS, 0, st>>>(part, G, static_cast<float*>(value));
  return (int)cudaGetLastError();
}
