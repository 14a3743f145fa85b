// Shared pieces of the NB2-log GLM likelihood kernels (nb_glm_delta.cu,
// nb_glm_fused.cu, nb_glm_stable.cu): constants, float32-accurate log1p
// forms, the lgamma/digamma series, the fixed-order gene reduction (a second
// launch, K3-K5; or the last block of the kernel's own launch, K1/K2) and
// cp.async copies.
//
// Every helper follows the torch function named beside it operation for
// operation, so that a kernel built with --fmad=false rounds as its plain
// version does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nbk {

constexpr float LOG_PHI_CAP = 80.0f;
constexpr float HALF_LOG_2PI = 0.9189385332046727f;
constexpr float LOG8 = 2.0794415416798357f;
constexpr int MAX_C = 8;
constexpr int THREADS = 128;
constexpr int REDUCE_THREADS = 256;

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

// lgamma for 0 < x <= 8 via shift-by-8 Stirling (nb._lgamma_pos_small)
__device__ __forceinline__ float lgamma_pos_small(float x) {
  const float xs = x + 8.0f;
  const float inv = 1.0f / xs;
  const float inv2 = inv * inv;
  const float stirling = (xs - 0.5f) * logf(xs) - xs + HALF_LOG_2PI +
                         inv * (1.0f / 12.0f + inv2 * (-1.0f / 360.0f + inv2 * (1.0f / 1260.0f)));
  float shift = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) shift = shift + logf(x + (float)k);
  return stirling - shift;
}

// lgamma(y+phi) - lgamma(y+1) - lgamma(phi), float32-moderate branches
// (nb.nb2_part1), per point
__device__ __forceinline__ float nb2_part1(float yf, float phi) {
  // log(k+1), k = 0..6
  const float log_kp1[7] = {0.0f, 0.6931471805599453f, 1.0986122886681098f,
                            1.3862943611198906f, 1.6094379124341003f,
                            1.791759469228055f, 1.9459101090932196f};
  if (yf <= 7.0f) {
    float part_a = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      if (yf > (float)k) part_a = part_a + (logf(phi + (float)k) - log_kp1[k]);
    return part_a;
  }
  const float d = phi - 1.0f;
  const float a1s = yf + phi;  // max(y, 8) = y here
  const float a2s = yf + 1.0f;
  const float corr12 = (1.0f / 12.0f) * (1.0f / a1s - 1.0f / a2s);
  const float corr360 = (-1.0f / 360.0f) * (1.0f / (a1s * a1s * a1s) - 1.0f / (a2s * a2s * a2s));
  const float pair = (a2s - 0.5f) * log1p_wide(d / a2s) + corr12 + corr360;
  if (phi >= 8.0f) {
    return pair + (phi - 1.0f) * log1p_wide(yf / phi) - 0.5f * logf(phi) + 1.0f -
           HALF_LOG_2PI - 1.0f / (12.0f * phi) + 1.0f / (360.0f * (phi * phi * phi));
  }
  return pair + d * logf(a1s) - d - lgamma_pos_small(phi);
}

// sum_{k < y} table[k] for y in 0..7 (the largest applicable k wins)
__device__ __forceinline__ float select_by_y(float yf, const float (&t)[7]) {
  float out = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) out = yf > (float)k ? t[k] : out;
  return out;
}

// value[b] = sum_g partial[b, g]: one block per b, a fixed strided order and
// a fixed shared-memory tree, accumulated in double, so the value is
// bitwise reproducible from run to run.
__global__ void __launch_bounds__(REDUCE_THREADS)
sum_over_genes_kernel(const float* __restrict__ partial, int G, float* __restrict__ value) {
  __shared__ double buf[REDUCE_THREADS];
  const int b = blockIdx.x;
  double acc = 0.0;
  for (int g = threadIdx.x; g < G; g += REDUCE_THREADS) acc += (double)partial[(size_t)b * G + g];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) value[b] = (float)buf[0];
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

// One-launch form of sum_over_genes_kernel. Every block has written its
// double partial[b, blockIdx.x] for its rows b, each writer followed by a
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
