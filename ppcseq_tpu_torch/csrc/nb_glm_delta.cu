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
// versions line for line; every point is computed by the same operations in
// the same order as before the tiled layout (a point's terms do not depend
// on where it runs).
//
//   value[b]          = sum_{s,g} mask[s,g] * lpmf(y[s,g] | d[b,s,g], phi[b,g])
//   dalpha[b,c,g]     = sum_s X[s,c] * mask[s,g] * deta[b,s,g]
//   dlog_phi[b,g]     = sum_s mask[s,g] * dlogphi[b,s,g]
//   K1: d = d0 + X (alpha[b] - alpha0) - (min(log_phi[b], 80) + sigma_raw0)
//   K2: d = exposure + X alpha[b] - min(log_phi[b], 80)   (C multiply-adds)
//
// What bounds it on the H100. Per point ~400 FP32 operations by
// ops/nb_kernel.py:work's count (3-4 expf, a logf on large counts, ~8 IEEE
// divides, short polynomials, no FMA contraction), ~900 instructions issued
// per warp and point once branch divergence is counted, against 12 bytes of
// [S, G] input: never the bytes. At the ADVI step (1, 21, ~515) and the 50k
// cohort's (1, 100, ~600) the call is one point's dependent chain (~1.3 us)
// plus the launch's fixed phases: too little work to fill the card, so the
// layout spreads it as wide as it goes. At (128, 21, 515) and (8, 100,
// 50000) the SMs' instruction issue bounds it.
//
// The two launch layouts, one launch per call, are csrc/nb_tile.cuh's
// (tiled, or one thread per (b, g)), chosen per shape by
// ops/nb_kernel.py:layout from an H100 sweep (bench_kernels.py --sweep); K1
// and K2 are its forms Fast<true> and Fast<false>. In the tiled layout the
// terms of a point that do not depend on b (lgamma(y+1) or log(y+1) and
// 1/(y+1); K1's softplus(d0) and sigmoid(-d0)) are computed once per staged
// point, not once per (b, point): ~13% fewer instructions at (8, 100,
// 50000); the per-(b, g) table (nb_fast._gene_tables) is built once per
// (b, g), its 8 logs and 7 ratios spread over the sample lanes. In the row
// layout (B >= 32 at S <= 32: the HMC leapfrog and the 100-sample ELBO) the
// tiled layout's per-block phases cost more than its hoisting saves.
// GRADS=false is the value-only instantiation (no_grad calls, the
// 100-sample ELBO).
//
// Build without --use_fast_math: the float32 smoothness of the delta form
// rests on accurate expf/logf and on the branch thresholds.

#include "nb_tile.cuh"

namespace {

using namespace nbk;

// The per-(b, g) constants of the hoisted math (nb_fast._gene_tables) and
// the gene's alpha step da (K1: alpha - alpha0; K2: alpha).
template <int C>
struct GeneRow {
  float lpc, phi, lgam_small, psi8, shift_c, log_phi_b, phi_b, inv_phi_b, inv_phi_b3, b_const,
      d_b, delta_log_phi;
  bool below_cap;
  float cum_log[7], cum_frac[7], da[C];
};

// Builds the row from lp_raw = log_phi[b, g]; log_k(k) = logf(phi + k) for
// k = 0..7 and frac_k(k) = phi / (phi + k) for k = 1..7, wherever the caller
// computed them; the running sums keep the plain version's order.
template <int C, bool GRADS, bool DELTA, class LogK, class FracK>
__device__ __forceinline__ void gene_row(GeneRow<C>& r, float lp_raw, float sr0, LogK log_k,
                                         FracK frac_k) {
  r.lpc = fminf(lp_raw, LOG_PHI_CAP);
  r.phi = expf(r.lpc);
  float acc_l = log_k(0), acc_f = 1.0f;
  r.cum_log[0] = acc_l;
  r.cum_frac[0] = acc_f;
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    acc_l = acc_l + log_k(k);
    if (GRADS) acc_f = acc_f + frac_k(k);
    r.cum_log[k] = acc_l;
    r.cum_frac[k] = acc_f;
  }
  const float xsm = fminf(r.phi, 8.0f) + 8.0f;
  const float inv = 1.0f / xsm;
  const float inv2 = inv * inv;
  const float log_xs = logf(xsm);
  const float stirl = (xsm - 0.5f) * log_xs - xsm + HALF_LOG_2PI +
                      inv * (1.0f / 12.0f + inv2 * (-1.0f / 360.0f + inv2 * (1.0f / 1260.0f)));
  r.lgam_small = stirl - (r.cum_log[6] + log_k(7));
  r.psi8 = log_xs - 0.5f * inv - inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
  r.shift_c = GRADS ? r.cum_frac[6] + frac_k(7) : 0.0f;
  r.log_phi_b = fmaxf(r.lpc, LOG8);
  r.phi_b = fmaxf(r.phi, 8.0f);
  r.inv_phi_b = 1.0f / r.phi_b;
  r.inv_phi_b3 = r.inv_phi_b * r.inv_phi_b * r.inv_phi_b;
  r.b_const = -0.5f * r.log_phi_b + 1.0f - HALF_LOG_2PI - (1.0f / 12.0f) * r.inv_phi_b +
              (1.0f / 360.0f) * r.inv_phi_b3;
  r.d_b = r.phi - 1.0f;
  r.delta_log_phi = DELTA ? r.lpc + sr0 : 0.0f;  // log_phi - log_phi0
  r.below_cap = lp_raw < LOG_PHI_CAP;
}

// One point's value and gradient terms, added to the accumulators: the
// plain version's operations in its order. `x` is the sample's design row,
// `ex` its exposure (K2), `d0v` its baseline (K1). With HOISTED, the
// b-independent terms come in from Fast::hoist (lgy: lgamma(y+1) for
// y <= 7, else log(y+1); inv_y1 = 1/(y+1); K1's softplus(d0) and
// sigmoid(-d0)); otherwise they are computed here, where the point needs
// them.
template <int C, bool GRADS, bool DELTA, bool HOISTED>
__device__ __forceinline__ void add_point(const GeneRow<C>& r, float m, float yf,
                                          const float* x, float ex, float d0v, float lgy,
                                          float inv_y1_h, float sp_d0_h, float sig_neg_d0_h,
                                          float& acc_val, float (&acc_da)[C], float& acc_dlp) {
  const float lpc = r.lpc, phi = r.phi;
  // K1: delta_eta = X (alpha - alpha0); K2: eta = exposure + X alpha
  float eta = DELTA ? 0.0f : ex;
#pragma unroll
  for (int c = 0; c < C; ++c) eta += x[c] * r.da[c];
  const float dlo = eta - r.delta_log_phi;  // K1 only
  const float d = DELTA ? d0v + dlo : eta - lpc;

  // softplus pair sharing one exp (nb_fast._softplus_pair)
  const float em = expf(-fabsf(d));
  const float l1pem = log1p01(em);
  const float sp_d = fmaxf(d, 0.0f) + l1pem;
  const float sp_nd = fmaxf(-d, 0.0f) + l1pem;

  // part23 = -(phi_sp + y * y_sp), y_sp = softplus(-d)
  float phi_sp, y_sp;
  if (DELTA) {
    float sp_d0 = sp_d0_h, sig_neg_d0 = sig_neg_d0_h;
    if (!HOISTED) {  // baseline constants rebuilt from d0
      const float em0 = expf(-fabsf(d0v));
      sp_d0 = fmaxf(d0v, 0.0f) + log1p01(em0);
      sig_neg_d0 = d0v > 0.0f ? em0 / (1.0f + em0) : 1.0f / (1.0f + em0);
    }
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
    part1 = select_by_y(yf, r.cum_log) - (HOISTED ? lgy : lgamma_1p_small(yf));
    if (GRADS) phi_d = select_by_y(yf, r.cum_frac);
  } else {
    const float inv_y1 = HOISTED ? inv_y1_h : 1.0f / (yf + 1.0f);
    const float l1p = log1p_wide(r.d_b * inv_y1);
    const float log_a1 = (HOISTED ? lgy : logf(yf + 1.0f)) + l1p;  // log(y + phi)
    const float inv_a1 = 1.0f / (yf + phi);  // y >= 8 here: max(y, 8) = y
    const float inv_a1_2 = inv_a1 * inv_a1;
    const float corr = (1.0f / 12.0f) * (inv_a1 - inv_y1) -
                       (1.0f / 360.0f) * (inv_a1 * inv_a1_2 - inv_y1 * inv_y1 * inv_y1);
    const float pair = (yf + 0.5f) * l1p + corr;
    if (phi >= 8.0f) {
      const float ub = yf * r.inv_phi_b;
      const float l1p_b = ub < 0.5f ? log1p01(fminf(ub, 1.0f)) : log_a1 - r.log_phi_b;
      part1 = pair + (r.phi_b - 1.0f) * l1p_b + r.b_const;
      if (GRADS)
        phi_d = r.phi_b * l1p_b + 0.5f * yf * inv_a1 +
                (1.0f / 12.0f) * (r.inv_phi_b - r.phi_b * inv_a1_2) -
                (1.0f / 120.0f) * (r.inv_phi_b3 - r.phi_b * inv_a1_2 * inv_a1_2);
    } else {
      part1 = pair + r.d_b * log_a1 - r.d_b - r.lgam_small;
      if (GRADS) {
        const float psi_yphi =
            log_a1 - 0.5f * inv_a1 -
            inv_a1_2 * (1.0f / 12.0f - inv_a1_2 * (1.0f / 120.0f - inv_a1_2 / 252.0f));
        phi_d = fminf(phi, 8.0f) * (psi_yphi - r.psi8) + r.shift_c;
      }
    }
  }

  const float pts = part1 - phi_sp - yf * y_sp;
  acc_val += m * pts;

  if (GRADS) {
    // (deta, dlogphi) per point (nb_fast._grads_from_d)
    const float rr = 1.0f / (1.0f + em);
    const float q = d > 0.0f ? em * rr : rr;  // sigmoid(-d)
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
    const float dlogphi = r.below_cap ? phi_d - phi_a - yf * q : 0.0f;
    const float mdeta = m * deta;
#pragma unroll
    for (int c = 0; c < C; ++c) acc_da[c] += x[c] * mdeta;
    acc_dlp += m * dlogphi;
  }
}

// K1 (DELTA) and K2 as forms of nb_tile.cuh
template <bool DELTA>
struct Fast {
  static constexpr bool BASE = DELTA;
  static constexpr int NH = DELTA ? 4 : 2;  // lgy, 1/(y+1); K1: softplus(d0), sigmoid(-d0)
  static constexpr int TAB = 16;            // logf(phi + k), phi / (phi + k)

  template <int C>
  using Row = GeneRow<C>;

  template <int C, bool GRADS, class LogK, class FracK>
  static __device__ __forceinline__ void build_row(Row<C>& r, float lp_raw, float sr0,
                                                   LogK log_k, FracK frac_k) {
    gene_row<C, GRADS, DELTA>(r, lp_raw, sr0, log_k, frac_k);
  }

  // The b-independent terms of a point, by the operations the point used
  static __device__ __forceinline__ void hoist(float yf, float d0v, float (&h)[NH]) {
    if (yf <= 7.0f) {
      h[0] = lgamma_1p_small(yf);
      h[1] = 0.0f;
    } else {
      h[1] = 1.0f / (yf + 1.0f);
      h[0] = logf(yf + 1.0f);
    }
    if (DELTA) {  // baseline constants rebuilt from d0
      const float em0 = expf(-fabsf(d0v));
      h[NH - 2] = fmaxf(d0v, 0.0f) + log1p01(em0);
      h[NH - 1] = d0v > 0.0f ? em0 / (1.0f + em0) : 1.0f / (1.0f + em0);
    }
  }

  template <int C, bool GRADS, bool HOISTED>
  static __device__ __forceinline__ void point(const Row<C>& r, float m, float yf,
                                               const float* x, float ex, float d0v,
                                               const float (&h)[NH], float& acc_val,
                                               float (&acc_da)[C], float& acc_dlp) {
    add_point<C, GRADS, DELTA, HOISTED>(r, m, yf, x, ex, d0v, h[0], h[1],
                                        DELTA ? h[NH - 2] : 0.0f, DELTA ? h[NH - 1] : 0.0f,
                                        acc_val, acc_da, acc_dlp);
  }
};

}  // namespace

extern "C" int nb_glm_fast_max_c() { return MAX_C; }

// Launches K1 (delta != 0: reads d0, alpha0, sigma_raw0; exposure ignored)
// or K2 (delta == 0: reads exposure; d0, alpha0, sigma_raw0 ignored) on
// `stream`, one kernel in all, with the layout of ops/nb_kernel.py:layout:
// SY = 0 is the row layout (T = 128 genes of one b per block, BY = 1, no
// shared memory); otherwise tiled blocks of T genes x BY parameter rows
// (b-lanes) x SY sample lanes, SC samples per staged chunk, `smem` bytes of
// dynamic shared memory. `partial` is [B, ceil(G / T)] double scratch;
// `ticket` is a zeroed unsigned that launches on this stream share (the
// kernel leaves it 0); `dalpha`/`dlog_phi` are ignored unless
// want_grads. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a C outside 1..MAX_C or a layout the kernel
// cannot run.
extern "C" int nb_glm_fast_launch(const void* X, const void* exposure, const void* counts,
                                  const void* mask, const void* d0, const void* alpha,
                                  const void* alpha0, const void* log_phi,
                                  const void* sigma_raw0, void* partial, void* value,
                                  void* dalpha, void* dlog_phi, void* ticket, int B, int S, int C,
                                  int G, int want_grads, int delta, int T, int BY, int SY, int SC,
                                  int smem, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  if (S <= 0 || T <= 0 || SY < 0) return (int)cudaErrorInvalidValue;
  const Inputs in{static_cast<const float*>(X),      static_cast<const float*>(exposure),
                  static_cast<const int32_t*>(counts), static_cast<const float*>(mask),
                  static_cast<const float*>(d0),     static_cast<const float*>(alpha),
                  static_cast<const float*>(alpha0), static_cast<const float*>(log_phi),
                  static_cast<const float*>(sigma_raw0)};
  const Outputs out{static_cast<double*>(partial), static_cast<float*>(value),
                    static_cast<float*>(dalpha), static_cast<float*>(dlog_phi),
                    static_cast<unsigned*>(ticket)};
#define NB_ONE(n, grads, dl) \
  return launch_layout<Fast<dl>, n, grads>(in, out, B, S, G, T, BY, SY, SC, smem, st);
#define NB_CASE(n)                   \
  if (want_grads) {                  \
    if (delta) NB_ONE(n, true, true) \
    NB_ONE(n, true, false)           \
  }                                  \
  if (delta) NB_ONE(n, false, true)  \
  NB_ONE(n, false, false)
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
#undef NB_ONE
  return (int)cudaErrorInvalidValue;  // not reached: every case returns
}
