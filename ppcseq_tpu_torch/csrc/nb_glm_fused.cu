// One-pass delta-form NB2-log GLM log-likelihood with analytic gradients on
// the unhoisted math (K3), batched over B parameter vectors, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ppcseq_tpu/ops/nb_kernel.py:_fused_dkernel.
// Plain version: ppcseq_tpu_torch/model/nb_model.py:delta_likelihood for the
// value and ppcseq_tpu_torch/ops/nb_grad.py:likelihood_grads for the
// gradients (the same functions; K3 evaluates the gradients at
// d = d0 + dlo, the plain version at d = eta - log_phi).
//
//   d = d0 + X (alpha[b] - alpha0) - (min(log_phi[b], 80) + sigma_raw0)
//   value[b]      = sum mask * [nb2_part1 - phi_sp - y inc_neg - y softplus(-d0)]
//   dalpha[b,c,g] = sum_s X[s,c] mask (y sigmoid(-d) - phi sigmoid(d))
//   dlog_phi[b,g] = sum_s mask [phi_digamma_diff - phi_softplus_minus_sigmoid
//                               - y sigmoid(-d)]   (0 for log_phi >= 80)
//
// phi_sp and inc_neg are the hybrid increments of the delta form (near the
// baseline for -2 < dlo < 8, direct stable forms outside, the Poisson limit
// below d = -25). Only counts, mask and d0 are read per point; softplus(d0),
// sigmoid(-d0) and softplus(-d0) are rebuilt from d0.
//
// Layout as in nb_glm_delta.cu: one thread per (b, g) looping over S, no
// atomics, fixed-order gene reduction for the value. GRADS=false is the
// value-only instantiation (no_grad calls).
//
// Bound. Per point ~8 exp/log (the unhoisted part1 adds up to 7 logs for
// small counts) plus the digamma-difference branch for the gradient:
// special-function units at large S*G*B, launch latency at the bundled
// shape. K1 computes the same density with ~3 exp + 1 log per point.

#include "nb_common.cuh"

namespace {

using namespace nbk;

// digamma(x) for x >= 8: asymptotic series (nb_grad._psi_asym)
__device__ __forceinline__ float psi_asym(float x) {
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  return logf(x) - 0.5f * inv - inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
}

// phi * (digamma(y + phi) - digamma(phi)), float32-moderate
// (nb_grad.phi_digamma_diff)
__device__ __forceinline__ float phi_digamma_diff(float yf, float phi) {
  if (yf <= 7.0f) {
    float part_a = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      if (yf > (float)k) part_a = part_a + phi / (phi + (float)k);
    return part_a;
  }
  if (phi >= 8.0f) {
    const float a = yf + phi;
    return phi * log1p_wide(yf / phi) + 0.5f * yf / a +
           (1.0f / 12.0f) * (1.0f / phi - phi / (a * a)) -
           (1.0f / 120.0f) * (1.0f / (phi * phi * phi) - phi / ((a * a) * (a * a)));
  }
  float shift = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) shift = shift + phi / (phi + (float)k);
  return phi * (psi_asym(yf + phi) - psi_asym(phi + 8.0f)) + shift;
}

// phi * (softplus(d) - sigmoid(d)) >= 0 (nb_grad.phi_softplus_minus_sigmoid)
__device__ __forceinline__ float phi_softplus_minus_sigmoid(float d, float log_phi) {
  if (d <= -1.386f) {
    const float dn = fminf(d, 0.0f);
    const float u = expf(dn);
    const float series =
        0.5f - u * (2.0f / 3.0f - u * (0.75f - u * (0.8f - u * (5.0f / 6.0f -
        u * (6.0f / 7.0f - u * 0.875f)))));
    return expf(log_phi + 2.0f * dn) * series;
  }
  const float em = expf(-fabsf(d));
  const float sig = d > 0.0f ? 1.0f / (1.0f + em) : em / (1.0f + em);
  return expf(log_phi) * (softplus(d) - sig);
}

template <int C, bool GRADS>
__global__ void __launch_bounds__(THREADS)
nb_glm_fused_kernel(const float* __restrict__ X, const int32_t* __restrict__ counts,
                    const float* __restrict__ mask, const float* __restrict__ d0,
                    const float* __restrict__ alpha, const float* __restrict__ alpha0,
                    const float* __restrict__ log_phi, const float* __restrict__ sigma_raw0,
                    int S, int G, float* __restrict__ partial, float* __restrict__ dalpha,
                    float* __restrict__ dlog_phi) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (g >= G) return;
  const float lp_raw = log_phi[(size_t)b * G + g];
  const float lpc = fminf(lp_raw, LOG_PHI_CAP);
  const float phi = expf(lpc);
  const float delta_log_phi = lpc + sigma_raw0[g];  // log_phi - log_phi0
  const bool below_cap = lp_raw < LOG_PHI_CAP;
  float da[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    da[c] = alpha[((size_t)b * C + c) * G + g] - alpha0[(size_t)c * G + g];

  float acc_val = 0.0f, acc_dlp = 0.0f;
  float acc_da[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc_da[c] = 0.0f;

  for (int s = 0; s < S; ++s) {
    const size_t i = (size_t)s * G + g;
    const float m = mask[i];
    const float yf = (float)counts[i];
    const float d0v = d0[i];

    float delta_eta = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) delta_eta += __ldg(&X[s * C + c]) * da[c];
    const float dlo = delta_eta - delta_log_phi;
    const float d = d0v + dlo;

    // baseline constants rebuilt from d0
    const float em0 = expf(-fabsf(d0v));
    const float sig_neg_d0 = d0v > 0.0f ? em0 / (1.0f + em0) : 1.0f / (1.0f + em0);
    const float sp_d0 = fmaxf(d0v, 0.0f) + log1p_wide(em0);
    const float spn0 = sp_d0 - d0v;  // softplus(-d0)

    // value: hybrid delta increments
    const float softplus_neg_d = softplus(-d);
    float phi_sp, inc_neg;
    if (dlo > -2.0f && dlo < 8.0f) {
      phi_sp = phi * (sp_d0 + log1p_wide((1.0f - sig_neg_d0) * expm1_precise(dlo)));
      inc_neg = log1p_wide(sig_neg_d0 * expm1_precise(-dlo));
    } else {
      phi_sp = d < -25.0f ? expf(fminf(fmaxf(lpc + d, -60.0f), 60.0f)) : phi * softplus(d);
      inc_neg = softplus_neg_d - spn0;
    }
    const float pts = nb2_part1(yf, phi) - phi_sp - yf * inc_neg - yf * spn0;
    acc_val += m * pts;

    if (GRADS) {
      const float em = expf(-fabsf(d));
      const float q = d > 0.0f ? em / (1.0f + em) : 1.0f / (1.0f + em);  // sigmoid(-d)
      const float phi_p = expf(lpc - softplus_neg_d);                  // phi * sigmoid(d)
      const float deta = m * (yf * q - phi_p);
      const float dlogphi =
          below_cap ? phi_digamma_diff(yf, phi) - phi_softplus_minus_sigmoid(d, lpc) - yf * q
                    : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc_da[c] += __ldg(&X[s * C + c]) * deta;
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

template <int C>
void launch_c(dim3 grid, cudaStream_t st, bool grads, const float* X, const int32_t* counts,
              const float* mask, const float* d0, const float* alpha, const float* alpha0,
              const float* log_phi, const float* sigma_raw0, int S, int G, float* partial,
              float* dalpha, float* dlog_phi) {
  if (grads)
    nb_glm_fused_kernel<C, true><<<grid, THREADS, 0, st>>>(
        X, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, S, G, partial, dalpha, dlog_phi);
  else
    nb_glm_fused_kernel<C, false><<<grid, THREADS, 0, st>>>(
        X, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, S, G, partial, dalpha, dlog_phi);
}

}  // namespace

extern "C" int nb_glm_fused_max_c() { return MAX_C; }

// Launches K3 and the gene reduction on `stream`. `partial` is [B, G]
// scratch; `dalpha`/`dlog_phi` are ignored unless want_grads. Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a C
// outside 1..MAX_C.
extern "C" int nb_glm_fused_launch(const void* X, const void* counts, const void* mask,
                                   const void* d0, const void* alpha, const void* alpha0,
                                   const void* log_phi, const void* sigma_raw0, void* partial,
                                   void* value, void* dalpha, void* dlog_phi, int B, int S,
                                   int C, int G, int want_grads, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  dim3 grid((G + THREADS - 1) / THREADS, B);
  const bool grads = want_grads != 0;
  auto part = static_cast<float*>(partial);
#define NB_CASE(n)                                                                             \
  launch_c<n>(grid, st, grads, static_cast<const float*>(X),                                  \
              static_cast<const int32_t*>(counts), static_cast<const float*>(mask),           \
              static_cast<const float*>(d0), static_cast<const float*>(alpha),                \
              static_cast<const float*>(alpha0), static_cast<const float*>(log_phi),          \
              static_cast<const float*>(sigma_raw0), S, G, part, static_cast<float*>(dalpha), \
              static_cast<float*>(dlog_phi));
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_over_genes_kernel<<<B, REDUCE_THREADS, 0, st>>>(part, G, static_cast<float*>(value));
  return (int)cudaGetLastError();
}
