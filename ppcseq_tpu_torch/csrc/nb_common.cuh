// Shared pieces of the NB2-log GLM likelihood kernels (nb_glm_delta.cu,
// nb_glm_fused.cu, nb_glm_stable.cu): constants, float32-accurate log1p
// forms, the lgamma(y+phi) - lgamma(y+1) - lgamma(phi) term split into its
// per-(b, g) table and its per-point rest, the one-launch fixed-order gene
// reduction (the last block of the kernel's own launch) and cp.async copies.
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
constexpr int THREADS = 128;      // K5: one thread per (b, g)
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

// log(1 + exp(x)) (nb._softplus)
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1p_wide(expf(-fabsf(x)));
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
// phi >= 8 branch's 0.5 log(phi), 1/(12 phi), 1/(360 phi^3), and (for K3's
// gradient) digamma(phi + 8) by the asymptotic series (nb_grad._psi_asym).
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

// What part1_point computed that K3's gradient needs again at y > 7:
// log(y + phi) (phi < 8), 1/(y + phi), log1p(y / phi) (phi >= 8)
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
// partial[b, 0..n_tiles) into value[b] in double and a fixed order, so the
// value is bitwise reproducible: up to 64 tiles one thread per b sums them
// in index order (all b at once); beyond, one warp per b, lanes taking a
// fixed strided share and a fixed shuffle tree combining them. It then sets
// the ticket back to 0 for the next launch on the stream. Needs a block of
// whole warps.
__device__ __forceinline__ void last_block_sums_partials(const double* __restrict__ partial,
                                                         int n_tiles, int B,
                                                         float* __restrict__ value,
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
      value[b] = (float)s;
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
    if (lane == 0) value[b] = (float)s;
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
