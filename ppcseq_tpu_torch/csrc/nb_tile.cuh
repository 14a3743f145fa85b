// The two launch layouts of the likelihood kernels K1/K2 (nb_glm_delta.cu),
// K3 (nb_glm_fused.cu), K4/K5 (nb_glm_stable.cu) and the float64 forms of
// K1/K2 (nb_glm_fast64.cu), each one launch per call, written once over a
// "form" that holds the kernel's own math.
//
// A form F provides:
//   BASE      true: the delta form (reads d0, alpha0, sigma_raw0; d from the
//             baseline); false: exposure + X alpha
//   NH        how many terms of a point depend on (s, g) alone (hoist)
//   TAB       slots per (b, g) of the table spread over the sample lanes:
//             8 for logf(phi + k), 16 with phi / (phi + k) beside them
//   Row<C>    the per-(b, g) constants, with lpc, phi and da[C]
//   build_row<C, GRADS>(row, lp_raw, sigma_raw0[g], log_k, frac_k)
//   hoist(yf, d0v, h[NH])
//   point<C, GRADS, HOISTED>(row, m, yf, x[C], exposure[s], d0v, h[NH], acc...),
//             taking the per-(s, g) terms from h (HOISTED) or computing
//             them where the point needs them, by the same operations
// and may provide (Form<F> below; K1-K5 take the defaults):
//   Real      its floating-point type, of the inputs but counts, the staged
//             planes, the table and the gradients (float; the float64
//             forms: double). Shared memory is counted in words of Real.
//   NT        how many of the last of its NH planes are inputs, staged as
//             they are from Inputs' tab[0..NT) (0; the float64 delta form:
//             its baseline tables sp_d0, sig_neg_d0, y_sp0). hoist reads
//             them from h and fills the first NH - NT; the row layout puts
//             them in h and lets the point compute the rest.
//
// Tiled (tile_kernel): a block owns T consecutive genes and BY rows b; each
// gene has BY b-lanes by SY sample lanes that take a strided share of the
// samples; a warp is 4 genes x 8 lanes, so lanes sharing a point branch
// alike. The block's [S, T] tile of counts, mask and d0 (or exposure), X and
// alpha0/sigma_raw0 are staged in shared memory with cp.async, once for all
// its b, and the form's per-(s, g) terms are computed once per staged point
// (hoist) instead of once per (b, point). Past the shared-memory budget S is
// walked in chunks of SC through one slot. The (b, g) table's 8 logs (and 8
// ratios) are spread over the sample lanes; the lanes' partials are summed
// in shared memory in a fixed order.
//
// Row (row_kernel): one thread per (b, g) walks the samples straight from
// global memory; its per-(s, g) terms stay per point, where the point needs
// them.
//
// Both: every block sums its genes' values in double into partial[b, tile];
// the last block sums the partials in double in a fixed order
// (last_block_sums_partials), so the outputs are bitwise reproducible and
// one kernel runs per call.

#pragma once

#include <type_traits>

#include "nb_common.cuh"

namespace nbk {

// A form's Real and NT: float and 0 unless the form declares them
template <class F, class = void>
struct Form {
  using Real = float;
  static constexpr int NT = 0;
};
template <class F>
struct Form<F, std::void_t<typename F::Real>> {
  using Real = typename F::Real;
  static constexpr int NT = F::NT;
};

// Device pointers of one call; those a form does not read may be null.
// InputsT<R, NT> adds the NT staged input tables tab[NT] ([S, G] each).
template <class R, int NT = 0>
struct InputsT;
template <class R>
struct InputsT<R, 0> {
  const R* X;               // [S, C]
  const R* exposure;        // [S] (BASE = false)
  const int32_t* counts;    // [S, G]
  const R* mask;            // [S, G]
  const R* d0;              // [S, G] (BASE)
  const R* alpha;           // [B, C, G]
  const R* alpha0;          // [C, G] (BASE)
  const R* log_phi;         // [B, G]
  const R* sigma_raw0;      // [G] (BASE)
};
template <class R, int NT>
struct InputsT : InputsT<R, 0> {
  const R* tab[NT];
};
template <class R>
struct OutputsT {
  double* partial;   // [B, n_tiles] scratch
  double* value;     // [B]
  R* dalpha;         // [B, C, G] (GRADS)
  R* dlog_phi;       // [B, G] (GRADS)
  unsigned* ticket;  // zeroed; left at 0
};
using Inputs = InputsT<float>;
using Outputs = OutputsT<float>;
template <class F>
using InputsOf = InputsT<typename Form<F>::Real, Form<F>::NT>;
template <class F>
using OutputsOf = OutputsT<typename Form<F>::Real>;

// phi = e^min(log_phi, 80) and the table's logs: K1-K5 in float (fminf,
// expf, logf), the float64 forms in double (the cap passes a NaN through,
// as torch.clamp in nb_fast does)
__device__ __forceinline__ float phi_of(float lp_raw) { return expf(fminf(lp_raw, LOG_PHI_CAP)); }
__device__ __forceinline__ double phi_of(double lp_raw) {
  return exp(lp_raw > 80.0 ? 80.0 : lp_raw);
}
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// One word of a staged plane, global -> shared without waiting
template <class R>
__device__ __forceinline__ void cp_async_word(R* smem, const R* gmem) {
  if constexpr (sizeof(R) == 8)
    cp_async8(smem, gmem);
  else
    cp_async4(smem, gmem);
}

// Shared-memory words (of the form's Real: 4 bytes, 8 for the float64
// forms) of one staged chunk of `rows` samples: planes [rows][padded(T)] of
// counts (int32, in the first half of its plane for 8-byte words), mask,
// (base) d0 and the form's nh planes of per-(s, g) terms; X[rows][C]; (no
// base) exposure[rows]. ops/nb_kernel.py's _tiled computes the same sizes.
__host__ __device__ constexpr int stage_words(int rows, int T, int C, int base, int nh) {
  return rows * padded(T) * (2 + base + nh) + rows * C + (base ? 0 : rows);
}
// The fixed part: (base) alpha0[C][T] and sigma_raw0[T], the (b, g) tables
// [BY][tab][T], the lane partials [NQ][BY * SY][T] (NQ = C + 2 with
// gradients, else 1), the (b, g) values [BY][T].
__host__ __device__ constexpr int fixed_words(int T, int BY, int SY, int C, int grads, int base,
                                              int tab) {
  return (base ? C * T + T : 0) + tab * BY * T + (grads ? C + 2 : 1) * BY * SY * T + BY * T;
}

template <class F, int C>
__device__ __forceinline__ void stage_chunk(typename Form<F>::Real* buf, int r0, int rows, int g0,
                                            int T, int G, const InputsOf<F>& in) {
  using R = typename Form<F>::Real;
  constexpr int NT = Form<F>::NT;
  const int Tp = padded(T), plane = rows * Tp;
  int32_t* cnt = reinterpret_cast<int32_t*>(buf);
  R* msk = buf + plane;
  R* d0s = buf + 2 * plane;
  R* tabs = buf + (2 + F::BASE + F::NH - NT) * plane;  // the staged input tables
  R* xs = buf + (2 + F::BASE + F::NH) * plane;
  R* ex = xs + rows * C;
  for (int e = threadIdx.x; e < rows * T; e += blockDim.x) {
    const int r = e / T, tt = e - r * T, g = g0 + tt, i = r * Tp + tt;
    if (g < G) {
      const size_t src = (size_t)(r0 + r) * G + g;
      cp_async4(&cnt[i], &in.counts[src]);
      cp_async_word(&msk[i], &in.mask[src]);
      if (F::BASE) cp_async_word(&d0s[i], &in.d0[src]);
      if constexpr (NT > 0)
        for (int k = 0; k < NT; ++k) cp_async_word(&tabs[k * plane + i], &in.tab[k][src]);
    } else {  // past the last gene: a zero point (masked out, finite)
      cnt[i] = 0;
      msk[i] = R(0);
      if (F::BASE) d0s[i] = R(0);
      if constexpr (NT > 0)
        for (int k = 0; k < NT; ++k) tabs[k * plane + i] = R(0);
    }
  }
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x)
    cp_async_word(&xs[e], &in.X[r0 * C + e]);
  if (!F::BASE)
    for (int e = threadIdx.x; e < rows; e += blockDim.x)
      cp_async_word(&ex[e], &in.exposure[r0 + e]);
}

template <class F, int C, bool GRADS>
__global__ void __launch_bounds__(MAX_THREADS)
tile_kernel(const InputsOf<F> in, const OutputsOf<F> out, int B, int S, int G, int T, int BY,
            int SY, int SC) {
  using R = typename Form<F>::Real;
  constexpr int NT = Form<F>::NT;
  constexpr int NQ = GRADS ? C + 2 : 1;  // value, dalpha[C], dlog_phi
  constexpr int HP = 2 + F::BASE;        // the first hoisted plane
  extern __shared__ __align__(16) float smem[];
  // thread -> (gene t, b-lane yb, sample lane ys); a warp is 4 genes x 8 lanes
  const int L = BY * SY, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, GG = T / 4;
  const int t = 4 * (warp % GG) + (lane & 3);
  const int lam = 8 * (warp / GG) + (lane >> 2);
  const int yb = lam % BY, ys = lam / BY;
  const int g0 = blockIdx.x * T, g = g0 + t, b0 = blockIdx.y * BY, b = b0 + yb;
  const bool live = g < G && b < B;
  const int Tp = padded(T), n_chunks = (S + SC - 1) / SC;

  R* buf = reinterpret_cast<R*>(smem);  // the staged chunk
  R* a0s = buf + stage_words(SC, T, C, F::BASE, F::NH);
  R* sr0s = a0s + C * T;
  R* tab = F::BASE ? sr0s + T : a0s;  // [BY][TAB][T]
  R* red = tab + F::TAB * BY * T;     // [NQ][L][T]
  R* vals = red + NQ * L * T;         // [BY][T]

  if (F::BASE) {
    for (int e = threadIdx.x; e < C * T; e += blockDim.x) {
      const int c = e / T, gg = g0 + (e - c * T);
      a0s[e] = gg < G ? in.alpha0[(size_t)c * G + gg] : R(0);
    }
    for (int e = threadIdx.x; e < T; e += blockDim.x)
      sr0s[e] = g0 + e < G ? in.sigma_raw0[g0 + e] : R(0);
  }
  stage_chunk<F, C>(buf, 0, min(SC, S), g0, T, G, in);

  // ---- the (b, g) row, built once: its 8 logs (and 8 ratios) are spread
  // over the sample lanes through shared memory while chunk 0 is in flight
  const R lp_raw = live ? in.log_phi[(size_t)b * G + g] : R(0);
  const R phi = phi_of(lp_raw);
  R* mytab = tab + yb * F::TAB * T + t;
  for (int k = ys; k < 8; k += SY) {
    mytab[k * T] = log_of(phi + (R)k);
    if (GRADS && F::TAB > 8) mytab[(8 + k) * T] = phi / (phi + (R)k);
  }
  cp_async_wait_all();
  __syncthreads();  // the tables, alpha0/sigma_raw0 and chunk 0 are in
  typename F::template Row<C> row;
  F::template build_row<C, GRADS>(
      row, lp_raw, F::BASE ? sr0s[t] : R(0), [&](int k) { return mytab[k * T]; },
      [&](int k) { return mytab[(8 + k) * T]; });
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const R a = live ? in.alpha[((size_t)b * C + c) * G + g] : R(0);
    row.da[c] = F::BASE ? a - a0s[c * T + t] : a;
  }

  R acc_val = R(0), acc_dlp = R(0);
  R acc_da[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc_da[c] = R(0);

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int r0 = ch * SC, rows = min(SC, S - r0);
    if (ch > 0) {  // chunk ch into the slot, once every lane is done with ch - 1
      __syncthreads();
      stage_chunk<F, C>(buf, r0, rows, g0, T, G, in);
      cp_async_wait_all();
      __syncthreads();
    }
    const int plane = rows * Tp;
    const int32_t* cnt = reinterpret_cast<const int32_t*>(buf);
    const R* msk = buf + plane;
    const R* d0s = buf + 2 * plane;
    R* hp = buf + HP * plane;
    const R* xs = buf + (HP + F::NH) * plane;
    const R* ex = xs + rows * C;
    // the b-independent terms of every staged point, once per block
    for (int e = threadIdx.x; e < rows * T; e += blockDim.x) {
      const int r = e / T, i = r * Tp + (e - r * T);
      R h[F::NH];
      if constexpr (NT > 0) {  // the staged input tables, which hoist may read
#pragma unroll
        for (int k = F::NH - NT; k < F::NH; ++k) h[k] = hp[k * plane + i];
      }
      F::hoist((R)cnt[i], F::BASE ? d0s[i] : R(0), h);
#pragma unroll
      for (int k = 0; k < F::NH - NT; ++k) hp[k * plane + i] = h[k];
    }
    __syncthreads();
    for (int r = ys; r < rows; r += SY) {
      const int i = r * Tp + t;
      R h[F::NH];
#pragma unroll
      for (int k = 0; k < F::NH; ++k) h[k] = hp[k * plane + i];
      F::template point<C, GRADS, true>(row, msk[i], (R)cnt[i], &xs[r * C],
                                  F::BASE ? R(0) : ex[r], F::BASE ? d0s[i] : R(0), h, acc_val,
                                  acc_da, acc_dlp);
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
    R s = red[(q * L + rb) * T + tt];
    for (int j = 1; j < SY; ++j) s += red[(q * L + rb + BY * j) * T + tt];
    const int gg = g0 + tt, bb = b0 + rb;
    if (q == 0)
      vals[rb * T + tt] = s;
    else if (gg < G && bb < B) {
      if (q <= C)
        out.dalpha[((size_t)bb * C + q - 1) * G + gg] = s;
      else
        out.dlog_phi[(size_t)bb * G + gg] = s;
    }
  }
  __syncthreads();

  // ---- the value: per (b, tile) in double, then the last block's sum ------
  const int n_valid = min(T, G - g0);
  for (int rb = threadIdx.x; rb < BY && b0 + rb < B; rb += blockDim.x) {
    double s = 0.0;
    for (int tt = 0; tt < n_valid; ++tt) s += (double)vals[rb * T + tt];
    out.partial[(size_t)(b0 + rb) * gridDim.x + blockIdx.x] = s;
    __threadfence();  // visible before the ticket says this block is done
  }
  last_block_sums_partials(out.partial, gridDim.x, B, out.value, out.ticket);
}

template <class F, int C, bool GRADS>
__global__ void __launch_bounds__(ROW_THREADS)
row_kernel(const InputsOf<F> in, const OutputsOf<F> out, int B, int S, int G) {
  using R = typename Form<F>::Real;
  constexpr int NT = Form<F>::NT;
  __shared__ double warp_sums[ROW_THREADS / 32];
  const int g = blockIdx.x * ROW_THREADS + threadIdx.x, b = blockIdx.y;
  double v = 0.0;
  if (g < G) {
    const R lp_raw = in.log_phi[(size_t)b * G + g];
    const R phi = phi_of(lp_raw);
    typename F::template Row<C> row;
    F::template build_row<C, GRADS>(
        row, lp_raw, F::BASE ? in.sigma_raw0[g] : R(0),
        [&](int k) { return log_of(phi + (R)k); },
        [&](int k) { return phi / (phi + (R)k); });
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const R a = in.alpha[((size_t)b * C + c) * G + g];
      row.da[c] = F::BASE ? a - in.alpha0[(size_t)c * G + g] : a;
    }
    R acc_val = R(0), acc_dlp = R(0);
    R acc_da[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc_da[c] = R(0);
    // the point computes its per-(s, g) terms itself, from the staged input
    // tables where the form has them
    R h[F::NH] = {};
    for (int s = 0; s < S; ++s) {
      const size_t i = (size_t)s * G + g;
      const R yf = (R)in.counts[i];
      const R d0v = F::BASE ? in.d0[i] : R(0);
      if constexpr (NT > 0) {
#pragma unroll
        for (int k = 0; k < NT; ++k) h[F::NH - NT + k] = in.tab[k][i];
      }
      F::template point<C, GRADS, false>(row, in.mask[i], yf, &in.X[s * C],
                                         F::BASE ? R(0) : in.exposure[s], d0v, h, acc_val,
                                         acc_da, acc_dlp);
    }
    if (GRADS) {
#pragma unroll
      for (int c = 0; c < C; ++c) out.dalpha[((size_t)b * C + c) * G + g] = acc_da[c];
      out.dlog_phi[(size_t)b * G + g] = acc_dlp;
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
    out.partial[(size_t)b * gridDim.x + blockIdx.x] = s;
    __threadfence();  // visible before the ticket says this block is done
  }
  last_block_sums_partials(out.partial, gridDim.x, B, out.value, out.ticket);
}

// One launch of form F in the layout (T, BY, SY, SC, smem) that
// ops/nb_kernel.py:layout chose: SY = 0 is the row layout (T = ROW_THREADS,
// BY = 1, no shared memory), otherwise tiled. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a layout the kernel cannot run.
template <class F, int C, bool GRADS>
int launch_layout(const InputsOf<F>& in, const OutputsOf<F>& out, int B, int S, int G, int T,
                  int BY, int SY, int SC, int smem, cudaStream_t st) {
  if (SY == 0) {
    if (T != ROW_THREADS || BY != 1 || smem != 0) return (int)cudaErrorInvalidValue;
    row_kernel<F, C, GRADS><<<dim3((G + T - 1) / T, B), T, 0, st>>>(in, out, B, S, G);
    return (int)cudaGetLastError();
  }
  const int threads = T * BY * SY;
  if (T % 4 != 0 || BY <= 0 || (BY * SY) % 8 != 0 || threads > MAX_THREADS || SC <= 0 ||
      SC > S || smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int words = stage_words(SC, T, C, F::BASE, F::NH) +
                    fixed_words(T, BY, SY, C, GRADS, F::BASE, F::TAB);
  constexpr int word = (int)sizeof(typename Form<F>::Real);
  if (smem != word * words) return (int)cudaErrorInvalidValue;  // layout() and the kernel disagree
  auto kernel = tile_kernel<F, C, GRADS>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((G + T - 1) / T, (B + BY - 1) / BY), threads, smem, st>>>(in, out, B, S, G, T,
                                                                          BY, SY, SC);
  return (int)cudaGetLastError();
}

}  // namespace nbk
