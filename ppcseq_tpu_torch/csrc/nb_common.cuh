// Shared pieces of the NB2-log GLM likelihood kernels (nb_glm_delta.cu,
// nb_glm_fused.cu, nb_glm_stable.cu): constants, float32-accurate log1p
// forms, the lgamma(y+phi) - lgamma(y+1) - lgamma(phi) term split into its
// per-(b, g) table and its per-point rest, K3's and K5's analytic gradient
// split the same way, the one-launch fixed-order gene reduction (the last
// block of the kernel's own launch) and cp.async copies.
//
// Every helper follows the torch function named beside it operation for
// operation, so that a kernel built with --fmad=false rounds as its plain
// version does; a value hoisted out of the point loop is computed by the
// operations the point used, so it has the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nbk {

constexpr float LOG_PHI_CAP = 80.0f;
constexpr float HALF_LOG_2PI = 0.9189385332046727f;
constexpr float LOG8 = 2.0794415416798357f;
constexpr int MAX_C = 8;
constexpr int MAX_THREADS = 256;  // tiled layouts: T genes x BY b-lanes x SY sample lanes
constexpr int ROW_THREADS = 128;  // row layouts: one thread per (b, g)

// Row stride of a staged [rows][T] plane in the tiled layouts. A warp is 4
// genes x 8 lanes; when the lanes are on 8 different samples, rows r..r+7 of
// the 4 genes then fall in 32 different banks.
__host__ __device__ constexpr int padded(int T) { return (T / 4) % 2 ? T : T + 4; }

// lgamma(y+1) for y = 0..7
__device__ __forceinline__ float lgamma_1p_small(float yf) {
  float v = 0.0f;
  v = yf >= 2.0f ? 0.6931471805599453f : v;
  v = yf >= 3.0f ? 1.791759469228055f : v;
  v = yf >= 4.0f ? 3.1780538303479458f : v;
  v = yf >= 5.0f ? 4.787491742782046f : v;
  v = yf >= 6.0f ? 6.579251212010101f : v;
  v = yf >= 7.0f ? 8.525161361065415f : v;
  return v;
}

// log(1+u), u in [0, 1]: odd atanh series through z^13 (nb_fast._log1p01)
__device__ __forceinline__ float log1p01(float u) {
  const float z = u / (2.0f + u);
  const float z2 = z * z;
  return 2.0f * z *
         (1.0f + z2 * (1.0f / 3.0f + z2 * (1.0f / 5.0f + z2 * (1.0f / 7.0f +
          z2 * (1.0f / 9.0f + z2 * (1.0f / 11.0f + z2 / 13.0f))))));
}

// log(1+u), u > -1: atanh series through z^9 on -1/3 < u < 1/2, else logf
// (nb.log1p_precise, nb_fast._log1p_wide)
__device__ __forceinline__ float log1p_wide(float u) {
  if (u > -1.0f / 3.0f && u < 0.5f) {
    const float z = u / (2.0f + u);
    const float z2 = z * z;
    return 2.0f * z *
           (1.0f + z2 * (1.0f / 3.0f + z2 * (1.0f / 5.0f + z2 * (1.0f / 7.0f + z2 / 9.0f))));
  }
  return logf(1.0f + u);
}

// exp(x)-1: Taylor polynomial for |x| < 0.35 (nb.expm1_precise)
__device__ __forceinline__ float expm1_precise(float x) {
  if (fabsf(x) < 0.35f)
    return x * (1.0f + x * (0.5f + x * (1.0f / 6.0f + x * (1.0f / 24.0f + x * (
        1.0f / 120.0f + x * (1.0f / 720.0f + x / 5040.0f))))));
  return expf(x) - 1.0f;
}

// sum_{k < y} table[k] for y in 0..7 (the largest applicable k wins)
__device__ __forceinline__ float select_by_y(float yf, const float (&t)[7]) {
  float out = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) out = yf > (float)k ? t[k] : out;
  return out;
}

// nb2_part1(y, phi) = lgamma(y+phi) - lgamma(y+1) - lgamma(phi), float32-
// moderate branches (nb.nb2_part1), split into what depends on (b, g) alone,
// built once per (b, g), and the rest, per point. Part1Row holds phi's
// terms: the y <= 7 prefix sums of log(phi + k) - log(k + 1),
// lgamma_pos_small(phi) (shift-by-8 Stirling, nb._lgamma_pos_small), the
// phi >= 8 branch's 0.5 log(phi), 1/(12 phi), 1/(360 phi^3), and (for the
// gradient, grad_point) digamma(phi + 8) by the asymptotic series
// (nb_grad._psi_asym).
struct Part1Row {
  float phi, d_b, lgam_small, half_log_phi, inv12, inv360, psi8;
  float cum_a[7];
};

// log_k(k) = logf(phi + k) for k = 0..7, wherever the caller computed it
template <class LogK>
__device__ __forceinline__ void build_part1(Part1Row& p, float phi, LogK log_k) {
  // log(k+1), k = 0..6
  const float log_kp1[7] = {0.0f, 0.6931471805599453f, 1.0986122886681098f,
                            1.3862943611198906f, 1.6094379124341003f,
                            1.791759469228055f, 1.9459101090932196f};
  p.phi = phi;
  p.d_b = phi - 1.0f;
  float part_a = 0.0f, shift = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const float l = log_k(k);
    part_a = part_a + (l - log_kp1[k]);
    p.cum_a[k] = part_a;
    shift = shift + l;
  }
  shift = shift + log_k(7);
  const float xs = phi + 8.0f;
  const float inv = 1.0f / xs;
  const float inv2 = inv * inv;
  const float log_xs = logf(xs);
  const float stirling = (xs - 0.5f) * log_xs - xs + HALF_LOG_2PI +
                         inv * (1.0f / 12.0f + inv2 * (-1.0f / 360.0f + inv2 * (1.0f / 1260.0f)));
  p.lgam_small = stirling - shift;
  p.psi8 = log_xs - 0.5f * inv - inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
  p.half_log_phi = 0.5f * logf(phi);
  p.inv12 = 1.0f / (12.0f * phi);
  p.inv360 = 1.0f / (360.0f * (phi * phi * phi));
}

// The terms of a point that depend on y alone, 1/(y+1) and 1/(y+1)^3, for
// y > 7 (0 for y <= 7, where they are not used)
__device__ __forceinline__ void hoist_y(float yf, float& inv_y1, float& inv_y1_3) {
  if (yf <= 7.0f) {
    inv_y1 = 0.0f;
    inv_y1_3 = 0.0f;
    return;
  }
  const float a2s = yf + 1.0f;
  inv_y1 = 1.0f / a2s;
  inv_y1_3 = 1.0f / (a2s * a2s * a2s);
}

// What part1_point computed that the gradient (grad_point) needs again at
// y > 7: log(y + phi) (phi < 8), 1/(y + phi), log1p(y / phi) (phi >= 8)
struct Part1Shared {
  float log_a1 = 0.0f, inv_a1 = 0.0f, l1p_yphi = 0.0f;
};

// nb2_part1 at one point from its row and, with HOISTED, its hoist_y terms
// (otherwise computed here, by the same operations)
template <bool HOISTED>
__device__ __forceinline__ float part1_point(const Part1Row& p, float yf, float inv_y1_h,
                                             float inv_y1_3_h, Part1Shared& sh) {
  if (yf <= 7.0f) return select_by_y(yf, p.cum_a);
  const float phi = p.phi, d = p.d_b;
  const float a1s = yf + phi;  // max(y, 8) = y here
  const float a2s = yf + 1.0f;
  const float inv_y1 = HOISTED ? inv_y1_h : 1.0f / a2s;
  const float inv_y1_3 = HOISTED ? inv_y1_3_h : 1.0f / (a2s * a2s * a2s);
  sh.inv_a1 = 1.0f / a1s;
  const float corr12 = (1.0f / 12.0f) * (sh.inv_a1 - inv_y1);
  const float corr360 = (-1.0f / 360.0f) * (1.0f / (a1s * a1s * a1s) - inv_y1_3);
  const float pair = (a2s - 0.5f) * log1p_wide(d / a2s) + corr12 + corr360;
  if (phi >= 8.0f) {
    sh.l1p_yphi = log1p_wide(yf / phi);
    return pair + (phi - 1.0f) * sh.l1p_yphi - p.half_log_phi + 1.0f - HALF_LOG_2PI - p.inv12 +
           p.inv360;
  }
  sh.log_a1 = logf(a1s);
  return pair + d * sh.log_a1 - d - p.lgam_small;
}

// The analytic gradient of the NB2-log lpmf (nb_grad.nb2_grads, its
// float32-moderate O(y) grouping), shared by K3 and K5. GradRow holds its
// terms of phi alone, built once per (b, g): the y <= 7 prefix sums of
// phi / (phi + k) and their total over k = 0..7, 1/phi, 1/phi^3, and
// whether log_phi is below the cap (dlog_phi is 0 at and above it).
struct GradRow {
  float shift_f, inv_phi, inv_phi3;
  bool below_cap;
  float cum_f[7];
};

// frac_k(k) = phi / (phi + k) for k = 0..7, wherever the caller computed it
template <class FracK>
__device__ __forceinline__ void build_grad_row(GradRow& r, float lp_raw, float phi,
                                               FracK frac_k) {
  r.below_cap = lp_raw < LOG_PHI_CAP;
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

// One point's gradient terms at d, from the point's em = exp(-|d|), its
// l1pem = log1p(em) and part1_point's shared values sh (lpc = min(log_phi,
// 80), phi = e^lpc = p.phi): adds x[c] * m * deta to acc_da[c] and
// m * dlogphi to acc_dlp, with
//   deta    = y sigmoid(-d) - phi sigmoid(d)
//   dlogphi = phi (digamma(y + phi) - digamma(phi))
//             - phi (softplus(d) - sigmoid(d)) - y sigmoid(-d)
template <int C>
__device__ __forceinline__ void grad_point(const GradRow& r, const Part1Row& p,
                                           const Part1Shared& sh, float lpc, float m, float yf,
                                           const float* x, float d, float em, float l1pem,
                                           float (&acc_da)[C], float& acc_dlp) {
  const float phi = p.phi;
  const float softplus_neg_d = fmaxf(-d, 0.0f) + l1pem;
  const float softplus_d = fmaxf(d, 0.0f) + l1pem;
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
    phi_dd = phi * sh.l1p_yphi + 0.5f * yf / a + (1.0f / 12.0f) * (r.inv_phi - phi / (a * a)) -
             (1.0f / 120.0f) * (r.inv_phi3 - phi / ((a * a) * (a * a)));
  } else {  // digamma(y + phi) by the asymptotic series (nb_grad._psi_asym)
    const float inv2 = sh.inv_a1 * sh.inv_a1;
    const float psi_yphi = sh.log_a1 - 0.5f * sh.inv_a1 -
                           inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
    phi_dd = phi * (psi_yphi - p.psi8) + r.shift_f;
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

// 4-byte global -> shared copy that does not wait (cp.async, sm_80+); the
// issuing thread waits with cp_async_wait_all (which commits its copies
// first), then a barrier publishes them.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The value of a one-launch kernel. Every block has written its double
// partial[b, blockIdx.x] for its rows b, each writer followed by a
// __threadfence(); the last block to finish (an atomicAdd ticket) sums
// partial[b, 0..n_tiles) into the double value[b] in a fixed order, so the
// value is bitwise reproducible: up to 64 tiles one thread per b sums them
// in index order (all b at once); beyond, one warp per b, lanes taking a
// fixed strided share and a fixed shuffle tree combining them. It then sets
// the ticket back to 0 for the next launch on the stream. Needs a block of
// whole warps.
__device__ __forceinline__ void last_block_sums_partials(const double* __restrict__ partial,
                                                         int n_tiles, int B,
                                                         double* __restrict__ value,
                                                         unsigned* __restrict__ ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (n_tiles <= 64) {  // few tiles: one thread per b, all b at once
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      double s = 0.0;
#pragma unroll 8
      for (int j = 0; j < n_tiles; ++j) s += __ldcg(&partial[(size_t)b * n_tiles + j]);
      value[b] = s;
    }
    if (threadIdx.x == 0) atomicExch(ticket, 0u);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int b = warp; b < B; b += n_warps) {
    double s = 0.0;
    for (int j = lane; j < n_tiles; j += 32) s += __ldcg(&partial[(size_t)b * n_tiles + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) value[b] = s;
  }
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

}  // namespace nbk

// switch (C) { case 1: F(1) ... case 8: F(8) default: return invalid }
#define NBK_DISPATCH_C(C, F)                                                \
  switch (C) {                                                              \
    case 1: F(1) break;                                                     \
    case 2: F(2) break;                                                     \
    case 3: F(3) break;                                                     \
    case 4: F(4) break;                                                     \
    case 5: F(5) break;                                                     \
    case 6: F(6) break;                                                     \
    case 7: F(7) break;                                                     \
    case 8: F(8) break;                                                     \
    default: return (int)cudaErrorInvalidValue;                             \
  }
