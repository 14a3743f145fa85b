// Stable-form NB2-log GLM log-likelihood (K4) and its value with analytic
// gradients in one pass (K5), batched over B parameter vectors, for NVIDIA
// Hopper (sm_90a).
//
//   K4 replaces the Pallas TPU kernel ppcseq_tpu/ops/nb_kernel.py:_fwd_kernel;
//      plain version ppcseq_tpu_torch/model/nb_model.py:stable_likelihood
//      (nb2_log_lpmf_stable on eta = X alpha + exposure, masked sum).
//   K5 replaces ppcseq_tpu/ops/nb_kernel.py:_bwd_kernel (with _digamma_pos);
//      plain version stable_likelihood for the value and
//      ppcseq_tpu_torch/ops/nb_grad.py:likelihood_grads for the gradients.
//
//   value[b]      = sum_{s,g} mask * lpmf(y | eta[b,s,g], phi[b,g] = e^min(log_phi, 80))
//   dalpha[b,c,g] = sum_s X[s,c] mask (y sigmoid(-d) - phi sigmoid(d)),   d = eta - log_phi
//   dlog_phi[b,g] = sum_s mask [phi_digamma_diff - phi_softplus_minus_sigmoid
//                               - y sigmoid(-d)]   (0 for log_phi >= 80)
//
// K5 takes the plain version's float32 grouping of dlog_phi (O(y) terms;
// the TPU kernel's phi (psi(y+phi) - psi(phi) + 1 - softplus(d)) - (y+phi) q
// is a difference of O(phi) terms, whose float32 error grows with phi) and
// computes it by K3's code (nb_common.cuh grad_point) at this form's d. A
// baseline attached to the data is ignored: this is the stable form.
//
// Both are one kernel per call in nb_tile.cuh's layouts (chosen by
// ops/nb_kernel.py:layout). What bounds them on the H100 is the FP32
// instructions of each point (by ops/nb_kernel.py:work's count at (8, 100,
// 50000), ~160 for K4 and ~240 for K5, against 8 bytes of [S, G] input).
// So the work that does not belong to a point is taken out of it: per (b,
// g), once, nb2_part1's functions of phi alone (the 8 logs of log(phi + k),
// lgamma_pos_small(phi), 0.5 log(phi), 1/(12 phi), 1/(360 phi^3):
// nb_common.cuh Part1Row, with digamma(phi + 8)) and, for K5, the digamma
// difference's 8 ratios phi / (phi + k), their sums, 1/phi and 1/phi^3
// (GradRow); 1/(y+1) and 1/(y+1)^3 once per staged point; per point one
// exp(-|d|) and one log1p, shared by the value's softplus pair and the
// gradient, and log(y + phi), 1/(y + phi), log1p(y / phi), shared by
// nb2_part1 and the digamma difference. Each is computed by the operations
// the point's own code would use, so every point's terms keep their bits.

#include "nb_tile.cuh"

namespace {

using namespace nbk;

// The stable form of nb_tile.cuh: K4 is Stable<false> (value only, GRADS is
// false), K5 Stable<true> (GRADS is true: its table holds the 8 ratios
// phi / (phi + k) beside the 8 logs)
template <bool K5>
struct Stable {
  static constexpr bool BASE = false;
  static constexpr int NH = 2;              // 1/(y+1), 1/(y+1)^3
  static constexpr int TAB = K5 ? 16 : 8;  // logf(phi + k) (, phi / (phi + k)), k = 0..7

  template <int C>
  struct Row {
    float lpc;
    Part1Row p1;
    GradRow gr;
    float da[C];  // alpha[b, :, g]
  };

  template <int C, bool GRADS, class LogK, class FracK>
  static __device__ __forceinline__ void build_row(Row<C>& r, float lp_raw, float, LogK log_k,
                                                   FracK frac_k) {
    r.lpc = fminf(lp_raw, LOG_PHI_CAP);
    const float phi = expf(r.lpc);
    build_part1(r.p1, phi, log_k);
    if (GRADS) build_grad_row(r.gr, lp_raw, phi, frac_k);
  }

  static __device__ __forceinline__ void hoist(float yf, float, float (&h)[NH]) {
    hoist_y(yf, h[0], h[1]);
  }

  template <int C, bool GRADS, bool HOISTED>
  static __device__ __forceinline__ void point(const Row<C>& r, float m, float yf,
                                               const float* x, float ex, float,
                                               const float (&h)[NH], float& acc_val,
                                               float (&acc_da)[C], float& acc_dlp) {
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
    if (GRADS) grad_point<C>(r.gr, r.p1, sh, r.lpc, m, yf, x, d, em, l1pem, acc_da, acc_dlp);
  }
};

}  // namespace

extern "C" int nb_glm_stable_max_c() { return MAX_C; }

// On `stream`, one kernel in all: with want_grads K5, value[B],
// dalpha[B, C, G] and dlog_phi[B, G] (not yet scaled by the cotangent), in
// the layout of ops/nb_kernel.py:layout("nb_glm_stable_bwd", ...); without,
// K4, value[B] only (dalpha/dlog_phi ignored), in that of
// layout("nb_glm_stable_fwd", ...). `partial` and `ticket` as in
// nb_glm_fused_launch. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a C outside 1..MAX_C or a layout the kernel
// cannot run.
extern "C" int nb_glm_stable_launch(const void* X, const void* exposure, const void* counts,
                                    const void* mask, const void* alpha, const void* log_phi,
                                    void* partial, void* value, void* dalpha, void* dlog_phi,
                                    void* ticket, int B, int S, int C, int G, int want_grads,
                                    int T, int BY, int SY, int SC, int smem, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  if (S <= 0 || T <= 0 || SY < 0) return (int)cudaErrorInvalidValue;
  const Inputs in{static_cast<const float*>(X),       static_cast<const float*>(exposure),
                  static_cast<const int32_t*>(counts), static_cast<const float*>(mask),
                  nullptr,                             static_cast<const float*>(alpha),
                  nullptr,                             static_cast<const float*>(log_phi),
                  nullptr};
  const Outputs out{static_cast<double*>(partial), static_cast<double*>(value),
                    static_cast<float*>(dalpha), static_cast<float*>(dlog_phi),
                    static_cast<unsigned*>(ticket)};
#define NB_CASE(n)                                                                            \
  if (want_grads)                                                                             \
    return launch_layout<Stable<true>, n, true>(in, out, B, S, G, T, BY, SY, SC, smem, st);   \
  return launch_layout<Stable<false>, n, false>(in, out, B, S, G, T, BY, SY, SC, smem, st);
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
  return (int)cudaErrorInvalidValue;  // not reached: every case returns
}
