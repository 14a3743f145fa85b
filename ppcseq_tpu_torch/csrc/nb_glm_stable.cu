// Stable-form NB2-log GLM log-likelihood (K4) and its analytic backward
// (K5), batched over B parameter vectors, for NVIDIA Hopper (sm_90a).
//
//   K4 replaces the Pallas TPU kernel ppcseq_tpu/ops/nb_kernel.py:_fwd_kernel;
//      plain version ppcseq_tpu_torch/model/nb_model.py:stable_likelihood
//      (nb2_log_lpmf_stable on eta = X alpha + exposure, masked sum).
//   K5 replaces ppcseq_tpu/ops/nb_kernel.py:_bwd_kernel (with _digamma_pos);
//      plain version ppcseq_tpu_torch/ops/nb_grad.py:likelihood_grads
//      (the same derivative, regrouped).
//
//   value[b]      = sum_{s,g} mask * lpmf(y | eta[b,s,g], phi[b,g] = e^min(log_phi, 80))
//   dalpha[b,c,g] = sum_s X[s,c] * mask * (y - (y + phi) p),       p = sigmoid(d)
//   dlog_phi[b,g] = sum_s mask * [phi (psi(y+phi) - psi(phi) + 1 - softplus(d)) - (y+phi) q]
//                   (0 for log_phi >= 80),     d = eta - log_phi,    q = sigmoid(-d)
//
// K5 keeps the TPU kernel's grouping of dlog_phi (a difference of O(phi)
// terms, so its float32 error grows with phi; the plain version regroups it
// into O(y) terms) and its digamma. The eta-derivative is evaluated as
// y q - phi p, the plain version's grouping: y - (y + phi) p cancels at
// large counts. A baseline attached to the data is ignored: these are the
// stable form's kernels.
//
// K4 is one kernel per call in nb_tile.cuh's layouts (chosen by
// ops/nb_kernel.py:layout; tiled at every shape). What bounds it on the H100
// is the FP32 instructions of each point (~160 by ops/nb_kernel.py:work's
// count at (8, 100, 50000), against 8 bytes of [S, G] input). nb2_part1's
// functions of phi alone (the 8 logs of log(phi + k), lgamma_pos_small(phi),
// 0.5 log(phi), 1/(12 phi), 1/(360 phi^3): nb_common.cuh Part1Row) are
// built once per (b, g); 1/(y+1) and 1/(y+1)^3 once per staged point; the
// softplus pair shares one exp(-|d|) and one log1p. Each is computed by the
// operations the point's own code would use, so every point's terms keep
// their bits.
//
// K5 keeps one thread per (b, g) looping over S (coalesced [S, G] reads,
// per-gene terms in registers, no atomics); per point 3 exp + 2 log + one
// digamma (1 log, and 6 reciprocals below x = 6): special-function units
// at large S*G*B, launch latency at the bundled shape.

#include "nb_tile.cuh"

namespace {

using namespace nbk;

// digamma for x > 0: asymptotic series for x >= 6, 6-term recurrence below
// (nb_kernel._digamma_pos of the JAX package)
__device__ __forceinline__ float digamma_pos(float x) {
  const bool small = x < 6.0f;
  const float xs = small ? x + 6.0f : x;
  const float inv = 1.0f / xs;
  const float inv2 = inv * inv;
  const float asym = logf(xs) - 0.5f * inv -
                     inv2 * (1.0f / 12.0f + inv2 * (-1.0f / 120.0f + inv2 * (1.0f / 252.0f)));
  if (!small) return asym;
  float shift = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) shift = shift + 1.0f / (x + (float)k);
  return asym - shift;
}

template <int C>
__device__ __forceinline__ float eta_at(const float* __restrict__ X,
                                        const float* __restrict__ exposure, const float (&a)[C],
                                        int s) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) acc += __ldg(&X[s * C + c]) * a[c];
  return acc + exposure[s];
}

// K4 as a form of nb_tile.cuh: value only (GRADS is always false)
struct StableFwd {
  static constexpr bool BASE = false;
  static constexpr int NH = 2;   // 1/(y+1), 1/(y+1)^3
  static constexpr int TAB = 8;  // logf(phi + k), k = 0..7

  template <int C>
  struct Row {
    float lpc;
    Part1Row p1;
    float da[C];  // alpha[b, :, g]
  };

  template <int C, bool GRADS, class LogK, class FracK>
  static __device__ __forceinline__ void build_row(Row<C>& r, float lp_raw, float, LogK log_k,
                                                   FracK) {
    r.lpc = fminf(lp_raw, LOG_PHI_CAP);
    build_part1(r.p1, expf(r.lpc), log_k);
  }

  static __device__ __forceinline__ void hoist(float yf, float, float (&h)[NH]) {
    hoist_y(yf, h[0], h[1]);
  }

  template <int C, bool GRADS, bool HOISTED>
  static __device__ __forceinline__ void point(const Row<C>& r, float m, float yf,
                                               const float* x, float ex, float,
                                               const float (&h)[NH], float& acc_val,
                                               float (&)[C], float&) {
    const float phi = r.p1.phi;
    float eta = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) eta += x[c] * r.da[c];
    const float d = (eta + ex) - r.lpc;
    // nb2_log_lpmf_stable: part1 + (-phi softplus(d) - y softplus(-d)), the
    // softplus pair sharing one exp and one log1p
    const float em = expf(-fabsf(d));
    const float l1pem = log1p_wide(em);
    const float part23 = -phi * (fmaxf(d, 0.0f) + l1pem) - yf * (fmaxf(-d, 0.0f) + l1pem);
    Part1Shared sh;
    const float pts = part1_point<HOISTED>(r.p1, yf, h[0], h[1], sh) + part23;
    acc_val += pts * m;
  }
};

template <int C>
__global__ void __launch_bounds__(THREADS)
nb_glm_stable_bwd_kernel(const float* __restrict__ X, const float* __restrict__ exposure,
                         const int32_t* __restrict__ counts, const float* __restrict__ mask,
                         const float* __restrict__ alpha, const float* __restrict__ log_phi,
                         int S, int G, float* __restrict__ dalpha, float* __restrict__ dlog_phi) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (g >= G) return;
  const float lp_raw = log_phi[(size_t)b * G + g];
  const float lpc = fminf(lp_raw, LOG_PHI_CAP);
  const float phi = expf(lpc);
  const bool below_cap = lp_raw < LOG_PHI_CAP;
  const float dg_phi = digamma_pos(phi);
  float a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = alpha[((size_t)b * C + c) * G + g];

  float acc_da[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc_da[c] = 0.0f;
  float acc_dlp = 0.0f;
  for (int s = 0; s < S; ++s) {
    const size_t i = (size_t)s * G + g;
    const float m = mask[i];
    const float yf = (float)counts[i];
    const float d = eta_at<C>(X, exposure, a, s) - lpc;
    const float em = expf(-fabsf(d));
    const float q = d > 0.0f ? em / (1.0f + em) : 1.0f / (1.0f + em);  // sigmoid(-d)
    const float softplus_d = fmaxf(d, 0.0f) + log1pf(em);
    // y - (y + phi) p, grouped as y q - phi p with phi p = exp(log_phi -
    // softplus(-d)) (nb_grad.nb2_grads): the TPU kernel's grouping cancels
    // two O(y) terms, ~0.03 (scaled) from float64 at counts ~1e5
    const float deta = m * (yf * q - expf(lpc - softplus(-d)));
    const float dlogphi =
        m * (below_cap
                 ? phi * (digamma_pos(yf + phi) - dg_phi + 1.0f - softplus_d) - (yf + phi) * q
                 : 0.0f);
#pragma unroll
    for (int c = 0; c < C; ++c) acc_da[c] += __ldg(&X[s * C + c]) * deta;
    acc_dlp += dlogphi;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dalpha[((size_t)b * C + c) * G + g] = acc_da[c];
  dlog_phi[(size_t)b * G + g] = acc_dlp;
}

}  // namespace

extern "C" int nb_glm_stable_max_c() { return MAX_C; }

// K4 on `stream`, one kernel in all, with the layout of
// ops/nb_kernel.py:layout("nb_glm_stable_fwd", ...): value[B] (partial and
// ticket as in nb_glm_fused_launch). Returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a C outside 1..MAX_C or a layout
// the kernel cannot run.
extern "C" int nb_glm_stable_fwd_launch(const void* X, const void* exposure, const void* counts,
                                        const void* mask, const void* alpha, const void* log_phi,
                                        void* partial, void* value, void* ticket, int B, int S,
                                        int C, int G, int T, int BY, int SY, int SC, int smem,
                                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  if (S <= 0 || T <= 0 || SY < 0) return (int)cudaErrorInvalidValue;
  const Inputs in{static_cast<const float*>(X),       static_cast<const float*>(exposure),
                  static_cast<const int32_t*>(counts), static_cast<const float*>(mask),
                  nullptr,                             static_cast<const float*>(alpha),
                  nullptr,                             static_cast<const float*>(log_phi),
                  nullptr};
  const Outputs out{static_cast<double*>(partial), static_cast<float*>(value), nullptr, nullptr,
                    static_cast<unsigned*>(ticket)};
#define NB_CASE(n) \
  return launch_layout<StableFwd, n, false>(in, out, B, S, G, T, BY, SY, SC, smem, st);
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
  return (int)cudaErrorInvalidValue;  // not reached: every case returns
}

// K5 on `stream`: dalpha[B, C, G] and dlog_phi[B, G] (not yet scaled by the
// cotangent). Returns as nb_glm_stable_fwd_launch.
extern "C" int nb_glm_stable_bwd_launch(const void* X, const void* exposure, const void* counts,
                                        const void* mask, const void* alpha, const void* log_phi,
                                        void* dalpha, void* dlog_phi, int B, int S, int C, int G,
                                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  dim3 grid((G + THREADS - 1) / THREADS, B);
#define NB_CASE(n)                                                                           \
  nb_glm_stable_bwd_kernel<n><<<grid, THREADS, 0, st>>>(                                    \
      static_cast<const float*>(X), static_cast<const float*>(exposure),                    \
      static_cast<const int32_t*>(counts), static_cast<const float*>(mask),                 \
      static_cast<const float*>(alpha), static_cast<const float*>(log_phi), S, G,           \
      static_cast<float*>(dalpha), static_cast<float*>(dlog_phi));
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
  return (int)cudaGetLastError();
}
