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
// What bounds it on the H100: the FP32 instructions of each point (~340 by
// ops/nb_kernel.py:work's count at (8, 100, 50000), against 12 bytes of
// [S, G] input) and their divergent branches. So the work that does not
// belong to a point is taken out of it:
//  - per (b, g), once (Row): nb2_part1's phi terms (the 8 logs of
//    log(phi + k) and lgamma_pos_small(phi), nb_common.cuh Part1Row), and
//    the digamma difference's 8 ratios phi / (phi + k), their sums,
//    digamma(phi + 8), 1/phi and 1/phi^3;
//  - per (s, g), once per staged point in the tiled layout (hoist):
//    softplus(d0), sigmoid(-d0), 1/(y+1) and 1/(y+1)^3;
//  - per point, once: exp(-|d|) and log1p(exp(-|d|)), shared by
//    softplus(+-d), sigmoid(-d) and phi * (softplus(d) - sigmoid(d)); and
//    log(y + phi), 1/(y + phi), log1p(y / phi), shared by nb2_part1 and the
//    digamma difference.
// Each hoisted or shared value is computed by the operations the point's
// own code would use, so every point's terms have the bits of the plain
// per-point evaluation. The launch layouts (tiled or row, one kernel per
// call) are nb_tile.cuh's. GRADS=false is the value-only instantiation
// (no_grad calls).

#include "nb_tile.cuh"

namespace {

using namespace nbk;

struct Fused {
  static constexpr bool BASE = true;
  static constexpr int NH = 4;    // softplus(d0), sigmoid(-d0), 1/(y+1), 1/(y+1)^3
  static constexpr int TAB = 16;  // logf(phi + k), phi / (phi + k), k = 0..7

  template <int C>
  struct Row {
    float lpc, delta_log_phi, shift_f, inv_phi, inv_phi3;
    bool below_cap;
    Part1Row p1;
    float cum_f[7], da[C];
  };

  // log_k(k) = logf(phi + k), frac_k(k) = phi / (phi + k), k = 0..7
  template <int C, bool GRADS, class LogK, class FracK>
  static __device__ __forceinline__ void build_row(Row<C>& r, float lp_raw, float sr0,
                                                   LogK log_k, FracK frac_k) {
    r.lpc = fminf(lp_raw, LOG_PHI_CAP);
    const float phi = expf(r.lpc);
    r.delta_log_phi = r.lpc + sr0;  // log_phi - log_phi0
    r.below_cap = lp_raw < LOG_PHI_CAP;
    build_part1(r.p1, phi, log_k);
    if (GRADS) {  // phi * (digamma(y + phi) - digamma(phi))'s terms of phi
      float part_a = 0.0f;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        part_a = part_a + frac_k(k);
        r.cum_f[k] = part_a;
      }
      r.shift_f = part_a + frac_k(7);
      r.inv_phi = 1.0f / phi;
      r.inv_phi3 = 1.0f / (phi * phi * phi);
    }
  }

  // softplus(d0) and sigmoid(-d0): the baseline constants rebuilt from d0
  static __device__ __forceinline__ void hoist_d0(float d0v, float (&h)[NH]) {
    const float em0 = expf(-fabsf(d0v));
    h[0] = fmaxf(d0v, 0.0f) + log1p_wide(em0);
    h[1] = d0v > 0.0f ? em0 / (1.0f + em0) : 1.0f / (1.0f + em0);
  }
  // ... and hoist_y's 1/(y+1), 1/(y+1)^3
  static __device__ __forceinline__ void hoist(float yf, float d0v, float (&h)[NH]) {
    hoist_d0(d0v, h);
    hoist_y(yf, h[2], h[3]);
  }

  // One point; with HOISTED its per-(s, g) terms come in as h (hoist's),
  // otherwise they are computed here
  template <int C, bool GRADS, bool HOISTED>
  static __device__ __forceinline__ void point(const Row<C>& r, float m, float yf,
                                               const float* x, float, float d0v,
                                               const float (&h)[NH], float& acc_val,
                                               float (&acc_da)[C], float& acc_dlp) {
    const float lpc = r.lpc, phi = r.p1.phi;
    float hp[NH];
    if (HOISTED) {
#pragma unroll
      for (int k = 0; k < NH; ++k) hp[k] = h[k];
    } else {
      hoist_d0(d0v, hp);
    }
    const float sp_d0 = hp[0], sig_neg_d0 = hp[1];
    float delta_eta = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) delta_eta += x[c] * r.da[c];
    const float dlo = delta_eta - r.delta_log_phi;
    const float d = d0v + dlo;
    const float spn0 = sp_d0 - d0v;  // softplus(-d0)

    // the softplus pair's exp and log1p, once
    const float em = expf(-fabsf(d));
    const float l1pem = log1p_wide(em);
    const float softplus_neg_d = fmaxf(-d, 0.0f) + l1pem;
    const float softplus_d = fmaxf(d, 0.0f) + l1pem;

    // value: hybrid delta increments
    float phi_sp, inc_neg;
    if (dlo > -2.0f && dlo < 8.0f) {
      phi_sp = phi * (sp_d0 + log1p_wide((1.0f - sig_neg_d0) * expm1_precise(dlo)));
      inc_neg = log1p_wide(sig_neg_d0 * expm1_precise(-dlo));
    } else {
      phi_sp = d < -25.0f ? expf(fminf(fmaxf(lpc + d, -60.0f), 60.0f)) : phi * softplus_d;
      inc_neg = softplus_neg_d - spn0;
    }
    Part1Shared sh;
    const float part1 = part1_point<HOISTED>(r.p1, yf, hp[2], hp[3], sh);
    const float pts = part1 - phi_sp - yf * inc_neg - yf * spn0;
    acc_val += m * pts;

    if (GRADS) {
      const float q = d > 0.0f ? em / (1.0f + em) : 1.0f / (1.0f + em);  // sigmoid(-d)
      const float phi_p = expf(lpc - softplus_neg_d);                  // phi * sigmoid(d)
      const float deta = m * (yf * q - phi_p);
      // phi * (digamma(y + phi) - digamma(phi)), float32-moderate
      // (nb_grad.phi_digamma_diff)
      float phi_dd;
      if (yf <= 7.0f) {
        phi_dd = select_by_y(yf, r.cum_f);
      } else if (phi >= 8.0f) {
        const float a = yf + phi;
        phi_dd = phi * sh.l1p_yphi + 0.5f * yf / a +
                 (1.0f / 12.0f) * (r.inv_phi - phi / (a * a)) -
                 (1.0f / 120.0f) * (r.inv_phi3 - phi / ((a * a) * (a * a)));
      } else {  // digamma(y + phi) by the asymptotic series (nb_grad._psi_asym)
        const float inv2 = sh.inv_a1 * sh.inv_a1;
        const float psi_yphi = sh.log_a1 - 0.5f * sh.inv_a1 -
                               inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
        phi_dd = phi * (psi_yphi - r.p1.psi8) + r.shift_f;
      }
      // phi * (softplus(d) - sigmoid(d)) >= 0
      // (nb_grad.phi_softplus_minus_sigmoid); exp(min(d, 0)) = em there
      float phi_sms;
      if (d <= -1.386f) {
        const float dn = fminf(d, 0.0f);
        const float u = em;
        const float series =
            0.5f - u * (2.0f / 3.0f - u * (0.75f - u * (0.8f - u * (5.0f / 6.0f -
            u * (6.0f / 7.0f - u * 0.875f)))));
        phi_sms = expf(lpc + 2.0f * dn) * series;
      } else {
        const float sig = d > 0.0f ? 1.0f / (1.0f + em) : em / (1.0f + em);
        phi_sms = phi * (softplus_d - sig);
      }
      const float dlogphi = r.below_cap ? phi_dd - phi_sms - yf * q : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc_da[c] += x[c] * deta;
      acc_dlp += m * dlogphi;
    }
  }
};

}  // namespace

extern "C" int nb_glm_fused_max_c() { return MAX_C; }

// Launches K3 on `stream`, one kernel in all, with the layout of
// ops/nb_kernel.py:layout("nb_glm_fused", ...) (as nb_tile.cuh's
// launch_layout takes it). `partial` is [B, ceil(G / T)] double scratch;
// `ticket` a zeroed unsigned that launches on this stream share (left at
// 0); `dalpha`/`dlog_phi` are ignored unless want_grads. Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a C
// outside 1..MAX_C or a layout the kernel cannot run.
extern "C" int nb_glm_fused_launch(const void* X, const void* counts, const void* mask,
                                   const void* d0, const void* alpha, const void* alpha0,
                                   const void* log_phi, const void* sigma_raw0, void* partial,
                                   void* value, void* dalpha, void* dlog_phi, void* ticket, int B,
                                   int S, int C, int G, int want_grads, int T, int BY, int SY,
                                   int SC, int smem, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  if (S <= 0 || T <= 0 || SY < 0) return (int)cudaErrorInvalidValue;
  const Inputs in{static_cast<const float*>(X),      nullptr,
                  static_cast<const int32_t*>(counts), static_cast<const float*>(mask),
                  static_cast<const float*>(d0),     static_cast<const float*>(alpha),
                  static_cast<const float*>(alpha0), static_cast<const float*>(log_phi),
                  static_cast<const float*>(sigma_raw0)};
  const Outputs out{static_cast<double*>(partial), static_cast<float*>(value),
                    static_cast<float*>(dalpha), static_cast<float*>(dlog_phi),
                    static_cast<unsigned*>(ticket)};
#define NB_CASE(n)                                                                         \
  if (want_grads) return launch_layout<Fused, n, true>(in, out, B, S, G, T, BY, SY, SC,    \
                                                       smem, st);                          \
  return launch_layout<Fused, n, false>(in, out, B, S, G, T, BY, SY, SC, smem, st);
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
  return (int)cudaErrorInvalidValue;  // not reached: every case returns
}
