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
// Two layouts, one launch per call, chosen per shape by
// ops/nb_kernel.py:layout from an H100 sweep (bench_k12.py --sweep):
//
// Tiled (nb_glm_tile_kernel; small B, or S > 32):
//  - A block owns T consecutive genes and BY parameter rows b. Each gene has
//    BY * SY lanes: BY b-lanes (one b each) by SY sample lanes that take a
//    strided share of the samples, so a thread's chain is ceil(S / SY)
//    points instead of S. At B = 1, 32-64 sample lanes and narrow tiles
//    (T = 4, 8) put the call on 65-150 blocks instead of 5.
//  - A warp is 4 genes x 8 lanes. Its b-lanes share every point, so the
//    count branches (y <= 7, the log1p forms) agree across them and the
//    warp diverges over at most 4 genes.
//  - The block's [S, T] tile of counts, mask and d0 (K2: exposure), X and
//    (K1) alpha0/sigma_raw0 are staged in shared memory with cp.async, read
//    once per block for all its b. The terms of a point that do not depend
//    on b (lgamma(y+1) or log(y+1) and 1/(y+1); K1's softplus(d0) and
//    sigmoid(-d0)) are computed once per staged point, not once per (b,
//    point): ~13% fewer instructions at (8, 100, 50000). When the tile
//    exceeds the shared-memory budget (S above ~150 at (8, 100, 50000)'s
//    layout, ~800 at B = 1), S is walked in chunks of SC samples through
//    one slot: stage, wait, hoist, compute, then the next chunk. No
//    workload in the repo reaches that (S <= 100), so the walk is there
//    for correctness at any S and is untimed; it does not prefetch. Rows
//    are padded so that 8 sample lanes of 4 genes hit 32 banks.
//  - The per-(b, g) table (nb_fast._gene_tables) is built once per (b, g):
//    its 8 logs and 7 ratios are spread over the sample lanes, each lane then
//    sums them in the original order.
//  - The sample lanes' partials (value, dalpha[C], dlog_phi) are summed in
//    shared memory in a fixed order.
//
// Row (nb_glm_row_kernel; B >= 32 at S <= 32, the HMC leapfrog and the
// 100-sample ELBO): one thread per (b, g) walks the samples straight from
// L2. There the tiled layout's per-block phases (staging, barriers, the
// reduction) cost more than its hoisting saves.
//
// Both: every block sums its genes' values in double into partial[b, tile];
// the last block to finish sums the partials in double in a fixed order
// (nb_common.cuh last_block_sums_partials), so the outputs are bitwise
// reproducible from run to run and no second kernel is launched. Both run
// add_point, the same per-point code. GRADS=false is the value-only
// instantiation (no_grad calls, the 100-sample ELBO).
//
// Build without --use_fast_math: the float32 smoothness of the delta form
// rests on accurate expf/logf and on the branch thresholds.

#include "nb_common.cuh"

namespace {

using namespace nbk;

constexpr int MAX_THREADS = 256;  // T genes x BY b-lanes x SY sample lanes

// Row stride of a staged plane. A warp is 4 genes x 8 lanes; when the lanes
// are on 8 different samples, rows r..r+7 of the 4 genes then fall in 32
// different banks.
__host__ __device__ constexpr int padded(int T) { return (T / 4) % 2 ? T : T + 4; }

// Shared-memory words (4 bytes) of one staged chunk of `rows` samples and
// of the fixed part; ops/nb_kernel.py:layout computes the same sizes. A
// chunk holds planes [rows][padded(T)] of counts, mask, lgy (lgamma(y+1)
// for y <= 7, else log(y+1)) and inv_y1 (1/(y+1) for y > 7), and for K1 d0,
// softplus(d0) and sigmoid(-d0); then X[rows][C] and (K2) exposure[rows].
template <int C, bool DELTA>
__host__ __device__ constexpr int stage_words(int rows, int T) {
  return rows * padded(T) * (DELTA ? 7 : 4) + rows * C + (DELTA ? 0 : rows);
}
// alpha0[C][T] and sigma_raw0[T] (K1), the gene tables [BY][16][T], the
// lane partials [NQ][BY * SY][T], the (b, g) values [BY][T]
template <int C, bool GRADS, bool DELTA>
__host__ __device__ constexpr int fixed_words(int T, int BY, int SY) {
  return (DELTA ? C * T + T : 0) + 16 * BY * T + (GRADS ? C + 2 : 1) * BY * SY * T + BY * T;
}

template <int C, bool DELTA>
__device__ __forceinline__ void stage_chunk(float* buf, int r0, int rows, int g0, int T, int G,
                                            const float* __restrict__ X,
                                            const float* __restrict__ exposure,
                                            const int32_t* __restrict__ counts,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ d0) {
  const int Tp = padded(T), plane = rows * Tp;
  int32_t* cnt = reinterpret_cast<int32_t*>(buf);
  float* msk = buf + plane;
  float* d0s = buf + 4 * plane;
  float* xs = buf + (DELTA ? 7 : 4) * plane;
  float* ex = xs + rows * C;
  for (int e = threadIdx.x; e < rows * T; e += blockDim.x) {
    const int r = e / T, tt = e - r * T, g = g0 + tt, i = r * Tp + tt;
    if (g < G) {
      const size_t src = (size_t)(r0 + r) * G + g;
      cp_async4(&cnt[i], &counts[src]);
      cp_async4(&msk[i], &mask[src]);
      if (DELTA) cp_async4(&d0s[i], &d0[src]);
    } else {  // past the last gene: a zero point (masked out, finite)
      cnt[i] = 0;
      msk[i] = 0.0f;
      if (DELTA) d0s[i] = 0.0f;
    }
  }
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) cp_async4(&xs[e], &X[r0 * C + e]);
  if (!DELTA)
    for (int e = threadIdx.x; e < rows; e += blockDim.x) cp_async4(&ex[e], &exposure[r0 + e]);
}

// The b-independent terms of every staged point, once per block instead of
// once per (b, point), by the same operations the per-point code used.
template <bool DELTA>
__device__ __forceinline__ void hoist_chunk(float* buf, int rows, int T) {
  const int Tp = padded(T), plane = rows * Tp;
  const int32_t* cnt = reinterpret_cast<const int32_t*>(buf);
  float* lgy = buf + 2 * plane;
  float* iy1 = buf + 3 * plane;
  const float* d0s = buf + 4 * plane;
  float* spd0 = buf + 5 * plane;
  float* sgn0 = buf + 6 * plane;
  for (int e = threadIdx.x; e < rows * T; e += blockDim.x) {
    const int r = e / T, i = r * Tp + (e - r * T);
    const float yf = (float)cnt[i];
    if (yf <= 7.0f) {
      lgy[i] = lgamma_1p_small(yf);
      iy1[i] = 0.0f;
    } else {
      iy1[i] = 1.0f / (yf + 1.0f);
      lgy[i] = logf(yf + 1.0f);
    }
    if (DELTA) {  // baseline constants rebuilt from d0
      const float d0v = d0s[i];
      const float em0 = expf(-fabsf(d0v));
      spd0[i] = fmaxf(d0v, 0.0f) + log1p01(em0);
      sgn0[i] = d0v > 0.0f ? em0 / (1.0f + em0) : 1.0f / (1.0f + em0);
    }
  }
}

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
// b-independent terms come in (lgy: lgamma(y+1) for y <= 7, else log(y+1);
// inv_y1 = 1/(y+1); K1's softplus(d0) and sigmoid(-d0)); otherwise they are
// computed here, where the point needs them.
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

// Tiled layout (small B or large S): T genes x BY b-lanes x SY sample
// lanes per block, the [S, T] tile staged in shared memory.
template <int C, bool GRADS, bool DELTA>
__global__ void __launch_bounds__(MAX_THREADS)
nb_glm_tile_kernel(const float* __restrict__ X, const float* __restrict__ exposure,
                   const int32_t* __restrict__ counts, const float* __restrict__ mask,
                   const float* __restrict__ d0, const float* __restrict__ alpha,
                   const float* __restrict__ alpha0, const float* __restrict__ log_phi,
                   const float* __restrict__ sigma_raw0, int B, int S, int G, int T, int BY,
                   int SY, int SC, double* __restrict__ partial,
                   float* __restrict__ value, float* __restrict__ dalpha,
                   float* __restrict__ dlog_phi, unsigned* __restrict__ ticket) {
  constexpr int NQ = GRADS ? C + 2 : 1;  // value, dalpha[C], dlog_phi
  extern __shared__ __align__(16) float smem[];
  // thread -> (gene t, b-lane yb, sample lane ys); a warp is 4 genes x 8 lanes
  const int L = BY * SY, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, GG = T / 4;
  const int t = 4 * (warp % GG) + (lane & 3);
  const int lam = 8 * (warp / GG) + (lane >> 2);
  const int yb = lam % BY, ys = lam / BY;
  const int g0 = blockIdx.x * T, g = g0 + t, b0 = blockIdx.y * BY, b = b0 + yb;
  const bool live = g < G && b < B;
  const int Tp = padded(T), n_chunks = (S + SC - 1) / SC;

  float* buf = smem;  // the staged chunk
  float* a0s = buf + stage_words<C, DELTA>(SC, T);
  float* sr0s = a0s + C * T;
  float* tab = DELTA ? sr0s + T : a0s;  // [BY][16][T]: log(phi + k), phi / (phi + k)
  float* red = tab + 16 * BY * T;       // [NQ][L][T]
  float* vals = red + NQ * L * T;       // [BY][T]

  if (DELTA) {
    for (int e = threadIdx.x; e < C * T; e += blockDim.x) {
      const int c = e / T, gg = g0 + (e - c * T);
      a0s[e] = gg < G ? alpha0[(size_t)c * G + gg] : 0.0f;
    }
    for (int e = threadIdx.x; e < T; e += blockDim.x)
      sr0s[e] = g0 + e < G ? sigma_raw0[g0 + e] : 0.0f;
  }
  stage_chunk<C, DELTA>(buf, 0, min(SC, S), g0, T, G, X, exposure, counts, mask, d0);

  // ---- the (b, g) row, built once: its 8 logs and 7 ratios are spread over
  // the sample lanes through shared memory while chunk 0 is in flight
  const float lp_raw = live ? log_phi[(size_t)b * G + g] : 0.0f;
  const float phi = expf(fminf(lp_raw, LOG_PHI_CAP));
  float* mytab = tab + yb * 16 * T + t;
  for (int k = ys; k < 8; k += SY) {
    mytab[k * T] = logf(phi + (float)k);
    if (GRADS && k > 0) mytab[(8 + k) * T] = phi / (phi + (float)k);
  }
  cp_async_wait_all();
  __syncthreads();  // the tables, alpha0/sigma_raw0 and chunk 0 are in
  GeneRow<C> row;
  gene_row<C, GRADS, DELTA>(
      row, lp_raw, DELTA ? sr0s[t] : 0.0f, [&](int k) { return mytab[k * T]; },
      [&](int k) { return mytab[(8 + k) * T]; });
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float a = live ? alpha[((size_t)b * C + c) * G + g] : 0.0f;
    row.da[c] = DELTA ? a - a0s[c * T + t] : a;
  }

  float acc_val = 0.0f, acc_dlp = 0.0f;
  float acc_da[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc_da[c] = 0.0f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int r0 = ch * SC, rows = min(SC, S - r0);
    if (ch > 0) {  // chunk ch into the slot, once every lane is done with ch - 1
      __syncthreads();
      stage_chunk<C, DELTA>(buf, r0, rows, g0, T, G, X, exposure, counts, mask, d0);
      cp_async_wait_all();
      __syncthreads();
    }
    hoist_chunk<DELTA>(buf, rows, T);
    __syncthreads();
    const int plane = rows * Tp;
    const int32_t* cnt = reinterpret_cast<const int32_t*>(buf);
    const float* msk = buf + plane;
    const float* lgy = buf + 2 * plane;
    const float* iy1 = buf + 3 * plane;
    const float* d0s = buf + 4 * plane;
    const float* spd0 = buf + 5 * plane;
    const float* sgn0 = buf + 6 * plane;
    const float* xs = buf + (DELTA ? 7 : 4) * plane;
    const float* ex = xs + rows * C;
    for (int r = ys; r < rows; r += SY) {
      const int i = r * Tp + t;
      add_point<C, GRADS, DELTA, true>(row, msk[i], (float)cnt[i], &xs[r * C],
                                       DELTA ? 0.0f : ex[r], DELTA ? d0s[i] : 0.0f, lgy[i],
                                       iy1[i], DELTA ? spd0[i] : 0.0f, DELTA ? sgn0[i] : 0.0f,
                                       acc_val, acc_da, acc_dlp);
    }
  }

  // ---- lanes -> (b, g) sums over the sample lanes in a fixed order --------
  red[lam * T + t] = acc_val;
  if (GRADS) {
#pragma unroll
    for (int c = 0; c < C; ++c) red[((1 + c) * L + lam) * T + t] = acc_da[c];
    red[((C + 1) * L + lam) * T + t] = acc_dlp;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NQ * BY * T; e += blockDim.x) {
    const int tt = e % T, rb = (e / T) % BY, q = e / (T * BY);
    float s = red[(q * L + rb) * T + tt];
    for (int j = 1; j < SY; ++j) s += red[(q * L + rb + BY * j) * T + tt];
    const int gg = g0 + tt, bb = b0 + rb;
    if (q == 0)
      vals[rb * T + tt] = s;
    else if (gg < G && bb < B) {
      if (q <= C)
        dalpha[((size_t)bb * C + q - 1) * G + gg] = s;
      else
        dlog_phi[(size_t)bb * G + gg] = s;
    }
  }
  __syncthreads();

  // ---- the value: per (b, tile) in double, then the last block's sum ------
  const int n_valid = min(T, G - g0);
  for (int rb = threadIdx.x; rb < BY && b0 + rb < B; rb += blockDim.x) {
    double s = 0.0;
    for (int tt = 0; tt < n_valid; ++tt) s += (double)vals[rb * T + tt];
    partial[(size_t)(b0 + rb) * gridDim.x + blockIdx.x] = s;
    __threadfence();  // visible before the ticket says this block is done
  }
  last_block_sums_partials(partial, gridDim.x, B, value, ticket);
}

// Row layout (many b at small S): one thread per (b, g) walks the S samples
// straight from global memory (the [S, G] data stays in L2 across the b),
// no shared memory and no barrier but the value's: at (128, 21, 515) this
// beat every tiled layout on the H100 (PERF.md).
constexpr int ROW_THREADS = 128;

template <int C, bool GRADS, bool DELTA>
__global__ void __launch_bounds__(ROW_THREADS)
nb_glm_row_kernel(const float* __restrict__ X, const float* __restrict__ exposure,
                  const int32_t* __restrict__ counts, const float* __restrict__ mask,
                  const float* __restrict__ d0, const float* __restrict__ alpha,
                  const float* __restrict__ alpha0, const float* __restrict__ log_phi,
                  const float* __restrict__ sigma_raw0, int B, int S, int G,
                  double* __restrict__ partial, float* __restrict__ value,
                  float* __restrict__ dalpha, float* __restrict__ dlog_phi,
                  unsigned* __restrict__ ticket) {
  __shared__ double warp_sums[ROW_THREADS / 32];
  const int g = blockIdx.x * ROW_THREADS + threadIdx.x, b = blockIdx.y;
  double v = 0.0;
  if (g < G) {
    const float lp_raw = log_phi[(size_t)b * G + g];
    const float phi = expf(fminf(lp_raw, LOG_PHI_CAP));
    GeneRow<C> row;
    gene_row<C, GRADS, DELTA>(
        row, lp_raw, DELTA ? sigma_raw0[g] : 0.0f, [&](int k) { return logf(phi + (float)k); },
        [&](int k) { return phi / (phi + (float)k); });
#pragma unroll
    for (int c = 0; c < C; ++c)
      row.da[c] = DELTA ? alpha[((size_t)b * C + c) * G + g] - alpha0[(size_t)c * G + g]
                        : alpha[((size_t)b * C + c) * G + g];
    float acc_val = 0.0f, acc_dlp = 0.0f;
    float acc_da[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc_da[c] = 0.0f;
    for (int s = 0; s < S; ++s) {
      const size_t i = (size_t)s * G + g;
      add_point<C, GRADS, DELTA, false>(row, mask[i], (float)counts[i], &X[s * C],
                                        DELTA ? 0.0f : exposure[s], DELTA ? d0[i] : 0.0f, 0.0f,
                                        0.0f, 0.0f, 0.0f, acc_val, acc_da, acc_dlp);
    }
    if (GRADS) {
#pragma unroll
      for (int c = 0; c < C; ++c) dalpha[((size_t)b * C + c) * G + g] = acc_da[c];
      dlog_phi[(size_t)b * G + g] = acc_dlp;
    }
    v = acc_val;
  }
  // the block's genes in double: a fixed shuffle tree per warp, warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < ROW_THREADS / 32; ++w) s += warp_sums[w];
    partial[(size_t)b * gridDim.x + blockIdx.x] = s;
    __threadfence();  // visible before the ticket says this block is done
  }
  last_block_sums_partials(partial, gridDim.x, B, value, ticket);
}

template <int C, bool GRADS, bool DELTA>
int launch_one(int T, int BY, int SY, int SC, int smem, cudaStream_t st,
               const float* X, const float* exposure, const int32_t* counts, const float* mask,
               const float* d0, const float* alpha, const float* alpha0, const float* log_phi,
               const float* sigma_raw0, int B, int S, int G, double* partial, float* value,
               float* dalpha, float* dlog_phi, unsigned* ticket) {
  if (SY == 0) {  // the row layout
    if (T != ROW_THREADS || BY != 1 || smem != 0) return (int)cudaErrorInvalidValue;
    nb_glm_row_kernel<C, GRADS, DELTA><<<dim3((G + T - 1) / T, B), T, 0, st>>>(
        X, exposure, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, B, S, G, partial,
        value, dalpha, dlog_phi, ticket);
    return (int)cudaGetLastError();
  }
  const int threads = T * BY * SY;
  if (T % 4 != 0 || BY <= 0 || (BY * SY) % 8 != 0 || threads > MAX_THREADS || SC <= 0 ||
      SC > S || smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int words = stage_words<C, DELTA>(SC, T) + fixed_words<C, GRADS, DELTA>(T, BY, SY);
  if (smem != 4 * words) return (int)cudaErrorInvalidValue;  // layout() and the kernel disagree
  auto kernel = nb_glm_tile_kernel<C, GRADS, DELTA>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((G + T - 1) / T, (B + BY - 1) / BY), threads, smem, st>>>(
      X, exposure, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, B, S, G, T, BY, SY, SC,
      partial, value, dalpha, dlog_phi, ticket);
  return (int)cudaGetLastError();
}

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
  auto Xf = static_cast<const float*>(X);
  auto ex = static_cast<const float*>(exposure);
  auto cnt = static_cast<const int32_t*>(counts);
  auto mk = static_cast<const float*>(mask);
  auto d0f = static_cast<const float*>(d0);
  auto al = static_cast<const float*>(alpha);
  auto al0 = static_cast<const float*>(alpha0);
  auto lp = static_cast<const float*>(log_phi);
  auto sr0 = static_cast<const float*>(sigma_raw0);
  auto part = static_cast<double*>(partial);
  auto val = static_cast<float*>(value);
  auto dal = static_cast<float*>(dalpha);
  auto dlp = static_cast<float*>(dlog_phi);
  auto tk = static_cast<unsigned*>(ticket);
#define NB_ONE(n, grads, dl)                                                                   \
  return launch_one<n, grads, dl>(T, BY, SY, SC, smem, st, Xf, ex, cnt, mk, d0f, al, al0, lp, \
                                  sr0, B, S, G, part, val, dal, dlp, tk);
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
