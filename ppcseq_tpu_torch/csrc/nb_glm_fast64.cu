// The float64 form of K1 and K2: NB2-log GLM log-likelihood on the hoisted
// math, with analytic gradients, batched over B parameter vectors, computed
// in double throughout, for NVIDIA Hopper (sm_90a). One source, two kernels,
// chosen by the compile-time switch DELTA:
//
//   DELTA = true  replaces ppcseq_tpu/ops/nb_kernel.py:_fastk_delta
//                 (+ _fast_common) where the caller works in float64;
//                 plain version ppcseq_tpu_torch/ops/nb_fast.py:glm_delta.
//   DELTA = false replaces ppcseq_tpu/ops/nb_kernel.py:_fastk_plain;
//                 plain version ppcseq_tpu_torch/ops/nb_fast.py:glm_plain.
//
// The Pallas kernels take float32 only. The JAX package computes its
// float64 "fast" likelihood with XLA from ops/nb_fast.py (glm_delta,
// glm_plain), the hoisted math these kernels share. This source is that
// math in double: every helper below follows the torch function named beside
// it operation for operation, with the same branches, thresholds,
// polynomials and constants, and calls the double log/exp where nb_fast
// calls torch.log/torch.exp. Unlike K1, it reads the float64 baseline tables
// sp_d0, sig_neg_d0 and y_sp0 from the data instead of rebuilding them from
// d0. phi is capped at e^80, as in K1.
//
//   value[b]      = sum_{s,g} mask[s,g] * lpmf(y[s,g] | d[b,s,g], phi[b,g])
//   dalpha[b,c,g] = sum_s X[s,c] * mask[s,g] * deta[b,s,g]
//   dlog_phi[b,g] = sum_s mask[s,g] * dlogphi[b,s,g]
//   DELTA:  d = d0 + X (alpha[b] - alpha0) - (min(log_phi[b], 80) + sigma_raw0)
//   !DELTA: d = exposure + X alpha[b] - min(log_phi[b], 80)   (C multiply-adds)
//
// What bounds it on the H100: FP64 instruction issue. The card has no
// special-function unit for double, so each log and exp is a software
// sequence of ~20 FP64 instructions and each divide ~10
// (ops/nb_kernel.py:work counts them so), ~30 per point in all, against 44
// bytes of [S, G] input per point with a baseline: operations, not bytes,
// at every shape of the main path.
//
// Layout, kept simple: one thread per (b, g), blocks of ROW_THREADS genes of
// one b, grid (ceil(G / ROW_THREADS), B), each thread walking the S samples
// straight from global memory (reads of the [S, G] arrays are coalesced
// along g). Each block sums its genes' values in double in a fixed order into
// partial[b, blockIdx.x]; the last block to finish sums the partials in a
// fixed order (nb_common.cuh's last_block_sums_partials), so the outputs are
// bitwise reproducible and one kernel runs per call. GRADS = false is the
// value-only instantiation.
//
// Build without --use_fast_math and with --fmad=false (ops/_build.py), so
// every product and sum rounds once, as in the plain torch version.

#include "nb_common.cuh"

namespace {

// Only ROW_THREADS, last_block_sums_partials and MAX_C come from nb_common.cuh:
// its float helpers (log1p01, log1p_wide, ...) have double namesakes here.
using nbk::ROW_THREADS;

constexpr double CAP = 80.0;                      // nb_fast.LOG_PHI_CAP
constexpr double HALF_LOG_2PI_D = 0.9189385332046727;
constexpr double LOG8_D = 2.0794415416798357;    // math.log(8.0)

// torch.clamp's bounds, which pass NaN through
__device__ __forceinline__ double clamp_max(double x, double hi) { return x > hi ? hi : x; }
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }

// log(1+u) for u in [0, 1]: odd atanh series through z^13 (nb_fast._log1p01)
__device__ __forceinline__ double log1p01(double u) {
  const double z = u / (2.0 + u);
  const double z2 = z * z;
  return 2.0 * z *
         (1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0 +
          z2 * (1.0 / 9.0 + z2 * (1.0 / 11.0 + z2 / 13.0))))));
}

// log(1+u), u > -1: atanh series through z^9 on -1/3 < u < 1/2, else
// log(1 + u) (nb_fast._log1p_wide with its fallback torch.log(1.0 + u))
__device__ __forceinline__ double log1p_wide(double u) {
  if (u > -1.0 / 3.0 && u < 0.5) {
    const double z = u / (2.0 + u);
    const double z2 = z * z;
    return 2.0 * z *
           (1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0 + z2 / 9.0))));
  }
  return log(1.0 + u);
}

// sum_{k < y} t[k] for y in 0..7, the largest applicable k winning
// (nb_fast._select_by_y)
__device__ __forceinline__ double select_by_y(double yf, const double (&t)[7]) {
  double out = 0.0;
#pragma unroll
  for (int k = 0; k < 7; ++k) out = yf > (double)k ? t[k] : out;
  return out;
}

// lgamma(y+1) for y = 0..7 (nb_fast.LGAMMA_1P, math.lgamma's doubles)
__device__ __forceinline__ double lgamma_1p_small(double yf) {
  double v = 0.0;
  v = yf >= 2.0 ? 0.693147180559945 : v;
  v = yf >= 3.0 ? 1.7917594692280554 : v;
  v = yf >= 4.0 ? 3.178053830347945 : v;
  v = yf >= 5.0 ? 4.787491742782047 : v;
  v = yf >= 6.0 ? 6.579251212010102 : v;
  v = yf >= 7.0 ? 8.525161361065415 : v;
  return v;
}

// The per-(b, g) tables of nb_fast._gene_tables, and the gene's alpha step
// da (DELTA: alpha - alpha0; else alpha)
template <int C>
struct GeneRow {
  double lpc, phi, lgam_small, psi8, shift_c, log_phi_b, phi_b, inv_phi_b, inv_phi_b3, b_const,
      d_b, delta_log_phi;
  bool below_cap;
  double cum_log[7], cum_frac[7], da[C];
};

template <int C, bool DELTA>
__device__ __forceinline__ void gene_row(GeneRow<C>& r, double lp_raw, double sr0) {
  r.lpc = clamp_max(lp_raw, CAP);
  r.phi = exp(r.lpc);
  const double phi = r.phi;
  double acc_l = log(phi), acc_f = 1.0;
  r.cum_log[0] = acc_l;
  r.cum_frac[0] = acc_f;
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    acc_l = acc_l + log(phi + (double)k);
    acc_f = acc_f + phi / (phi + (double)k);
    r.cum_log[k] = acc_l;
    r.cum_frac[k] = acc_f;
  }
  const double lg7 = log(phi + 7.0);
  const double frac7 = phi / (phi + 7.0);
  // lgamma(min(phi, 8)) by shift-by-8 Stirling
  const double xs = clamp_max(phi, 8.0) + 8.0;
  const double inv = 1.0 / xs;
  const double inv2 = inv * inv;
  const double log_xs = log(xs);
  const double stirl = (xs - 0.5) * log_xs - xs + HALF_LOG_2PI_D +
                       inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)));
  r.lgam_small = stirl - (r.cum_log[6] + lg7);
  r.psi8 = log_xs - 0.5 * inv - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0));
  r.shift_c = r.cum_frac[6] + frac7;
  r.log_phi_b = clamp_min(r.lpc, LOG8_D);
  r.phi_b = clamp_min(phi, 8.0);
  r.inv_phi_b = 1.0 / r.phi_b;
  r.inv_phi_b3 = r.inv_phi_b * r.inv_phi_b * r.inv_phi_b;
  r.b_const = -0.5 * r.log_phi_b + 1.0 - HALF_LOG_2PI_D - (1.0 / 12.0) * r.inv_phi_b +
              (1.0 / 360.0) * r.inv_phi_b3;
  r.d_b = phi - 1.0;
  r.delta_log_phi = DELTA ? r.lpc + sr0 : 0.0;  // log_phi - log_phi0
  r.below_cap = lp_raw < CAP;
}

// One point's value and gradient terms, added to the accumulators: the
// plain version's operations in its order. `x` is the sample's design row,
// `ex` its exposure (!DELTA); b0 = {d0, sp_d0, sig_neg_d0, y_sp0} at the
// point (DELTA).
template <int C, bool GRADS, bool DELTA>
__device__ __forceinline__ void add_point(const GeneRow<C>& r, double m, double yf,
                                          const double* x, double ex, const double (&b0)[4],
                                          double& acc_val, double (&acc_da)[C],
                                          double& acc_dlp) {
  const double lpc = r.lpc, phi = r.phi;
  // DELTA: delta_eta = X (alpha - alpha0); else eta = exposure + X alpha
  // (nb_fast._eta_small: the exposure first, then column by column)
  double eta = DELTA ? 0.0 : ex;
#pragma unroll
  for (int c = 0; c < C; ++c) eta = eta + x[c] * r.da[c];
  const double dlo = eta - r.delta_log_phi;  // DELTA only
  const double d = DELTA ? b0[0] + dlo : eta - lpc;

  // softplus pair sharing one exp (nb_fast._softplus_pair)
  const double em = exp(-fabs(d));
  const double l1pem = log1p01(em);
  const double sp_d = clamp_min(d, 0.0) + l1pem;
  const double sp_nd = clamp_min(-d, 0.0) + l1pem;

  // phi * softplus(d) and the y term (nb_fast.delta_increment_terms)
  double phi_sp, y_term;
  if (DELTA) {
    const double d0 = b0[0], sp_d0 = b0[1], sig_neg_d0 = b0[2];
    double inc_neg;
    if (dlo > -2.0 && dlo < 8.0) {  // here clamp(dlo, -2, 8) = dlo
      const double e1 =
          fabs(dlo) < 0.35
              ? dlo * (1.0 + dlo * (0.5 + dlo * (1.0 / 6.0 + dlo * (1.0 / 24.0 +
                dlo * (1.0 / 120.0 + dlo * (1.0 / 720.0 + dlo / 5040.0))))))
              : exp(dlo) - 1.0;
      const double e1_neg = -e1 / (1.0 + e1);  // expm1(-dlo)
      const double sig_d0 = 1.0 - sig_neg_d0;
      phi_sp = phi * (sp_d0 + log1p_wide(sig_d0 * e1));
      inc_neg = log1p_wide(sig_neg_d0 * e1_neg);
    } else {
      phi_sp = d < -25.0 ? exp(clamp_max(clamp_min(lpc + d, -60.0), 60.0)) : phi * sp_d;
      inc_neg = sp_nd - (sp_d0 - d0);  // softplus(-d) - softplus(-d0)
    }
    y_term = yf * inc_neg;
  } else {
    phi_sp = phi * sp_d;
    y_term = yf * sp_nd;
  }

  // part1 and phi*(digamma(y+phi) - digamma(phi)) (nb_fast._part1_and_digamma)
  double part1, phi_d = 0.0;
  if (yf <= 7.0) {
    part1 = select_by_y(yf, r.cum_log) - lgamma_1p_small(yf);
    if (GRADS) phi_d = select_by_y(yf, r.cum_frac);
  } else {
    const double y1 = yf + 1.0;
    const double inv_y1 = 1.0 / y1;
    const double l1p = log1p_wide(r.d_b * inv_y1);
    const double log_a1 = log(y1) + l1p;  // log(y + phi)
    const double inv_a1 = 1.0 / (clamp_min(yf, 8.0) + phi);
    const double inv_a1_2 = inv_a1 * inv_a1;
    const double corr = (1.0 / 12.0) * (inv_a1 - inv_y1) -
                        (1.0 / 360.0) * (inv_a1 * inv_a1_2 - inv_y1 * inv_y1 * inv_y1);
    const double pair = (yf + 0.5) * l1p + corr;
    if (phi >= 8.0) {
      const double ub = yf * r.inv_phi_b;
      const double l1p_b = ub < 0.5 ? log1p01(clamp_max(ub, 1.0)) : log_a1 - r.log_phi_b;
      part1 = pair + (r.phi_b - 1.0) * l1p_b + r.b_const;
      if (GRADS)
        phi_d = r.phi_b * l1p_b + 0.5 * yf * inv_a1 +
                (1.0 / 12.0) * (r.inv_phi_b - r.phi_b * inv_a1_2) -
                (1.0 / 120.0) * (r.inv_phi_b3 - r.phi_b * inv_a1_2 * inv_a1_2);
    } else {
      part1 = pair + r.d_b * log_a1 - r.d_b - r.lgam_small;
      if (GRADS) {
        const double psi_yphi =
            log_a1 - 0.5 * inv_a1 -
            inv_a1_2 * (1.0 / 12.0 - inv_a1_2 * (1.0 / 120.0 - inv_a1_2 / 252.0));
        phi_d = clamp_max(phi, 8.0) * (psi_yphi - r.psi8) + r.shift_c;
      }
    }
  }

  // DELTA: part1 - phi_sp - y * inc_neg - y * softplus(-d0) (y_sp0, a table);
  // else part1 - phi * softplus(d) - y * softplus(-d)
  const double pts = DELTA ? part1 - phi_sp - y_term - b0[3] : part1 - phi_sp - y_term;
  acc_val = acc_val + m * pts;

  if (GRADS) {
    // (deta, dlogphi) per point (nb_fast._grads_from_d)
    const double rr = 1.0 / (1.0 + em);
    const double q = d > 0.0 ? em * rr : rr;  // sigmoid(-d)
    const double deta = yf * q - exp(lpc - sp_nd);
    double phi_a;
    if (d <= -1.386) {
      const double series =
          0.5 - em * (2.0 / 3.0 - em * (0.75 - em * (0.8 - em * (5.0 / 6.0 -
          em * (6.0 / 7.0 - em * 0.875)))));
      phi_a = exp(lpc + 2.0 * clamp_max(d, 0.0)) * series;
    } else {
      phi_a = phi * (sp_d - (1.0 - q));
    }
    const double dlogphi = r.below_cap ? phi_d - phi_a - yf * q : 0.0;
    const double mdeta = m * deta;
#pragma unroll
    for (int c = 0; c < C; ++c) acc_da[c] = acc_da[c] + x[c] * mdeta;
    acc_dlp = acc_dlp + m * dlogphi;
  }
}

// Device pointers of one call; those a form does not read may be null.
struct Inputs64 {
  const double* X;           // [S, C]
  const double* exposure;    // [S] (!DELTA)
  const int32_t* counts;     // [S, G]
  const double* mask;        // [S, G]
  const double* d0;          // [S, G] (DELTA), then sp_d0, sig_neg_d0, y_sp0
  const double* sp_d0;
  const double* sig_neg_d0;
  const double* y_sp0;
  const double* alpha;       // [B, C, G]
  const double* alpha0;      // [C, G] (DELTA)
  const double* log_phi;     // [B, G]
  const double* sigma_raw0;  // [G] (DELTA)
};
struct Outputs64 {
  double* partial;   // [B, gridDim.x] scratch
  double* value;     // [B]
  double* dalpha;    // [B, C, G] (GRADS)
  double* dlog_phi;  // [B, G] (GRADS)
  unsigned* ticket;  // zeroed; left at 0
};

template <int C, bool GRADS, bool DELTA>
__global__ void __launch_bounds__(ROW_THREADS)
fast64_kernel(const Inputs64 in, const Outputs64 out, int B, int S, int G) {
  __shared__ double warp_sums[ROW_THREADS / 32];
  const int g = blockIdx.x * ROW_THREADS + threadIdx.x, b = blockIdx.y;
  double v = 0.0;
  if (g < G) {
    GeneRow<C> row;
    gene_row<C, DELTA>(row, in.log_phi[(size_t)b * G + g], DELTA ? in.sigma_raw0[g] : 0.0);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double a = in.alpha[((size_t)b * C + c) * G + g];
      row.da[c] = DELTA ? a - in.alpha0[(size_t)c * G + g] : a;
    }
    double acc_val = 0.0, acc_dlp = 0.0;
    double acc_da[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc_da[c] = 0.0;
    for (int s = 0; s < S; ++s) {
      const size_t i = (size_t)s * G + g;
      double b0[4] = {0.0, 0.0, 0.0, 0.0};
      if (DELTA) {
        b0[0] = in.d0[i];
        b0[1] = in.sp_d0[i];
        b0[2] = in.sig_neg_d0[i];
        b0[3] = in.y_sp0[i];
      }
      add_point<C, GRADS, DELTA>(row, in.mask[i], (double)in.counts[i], &in.X[(size_t)s * C],
                                 DELTA ? 0.0 : in.exposure[s], b0, acc_val, acc_da, acc_dlp);
    }
    if (GRADS) {
#pragma unroll
      for (int c = 0; c < C; ++c) out.dalpha[((size_t)b * C + c) * G + g] = acc_da[c];
      out.dlog_phi[(size_t)b * G + g] = acc_dlp;
    }
    v = acc_val;
  }
  // the block's genes: a fixed shuffle tree per warp, warps in order
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
  nbk::last_block_sums_partials(out.partial, gridDim.x, B, out.value, out.ticket);
}

}  // namespace

extern "C" int nb_glm_fast64_max_c() { return nbk::MAX_C; }

// Launches the float64 form of K1 (delta != 0: reads d0, sp_d0, sig_neg_d0,
// y_sp0, alpha0, sigma_raw0; exposure ignored) or of K2 (delta == 0: reads
// exposure; the baseline ignored) on `stream`, one kernel in all: grid
// (ceil(G / ROW_THREADS), B) of ROW_THREADS threads. `partial` is
// [B, ceil(G / ROW_THREADS)] double scratch; `ticket` is a zeroed unsigned
// that launches on this stream share (the kernel leaves it 0);
// `dalpha`/`dlog_phi` are ignored unless want_grads. Every array is double
// but counts (int32). Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a C outside 1..MAX_C or a B the grid cannot hold.
extern "C" int nb_glm_fast64_launch(const void* X, const void* exposure, const void* counts,
                                    const void* mask, const void* d0, const void* sp_d0,
                                    const void* sig_neg_d0, const void* y_sp0, const void* alpha,
                                    const void* alpha0, const void* log_phi,
                                    const void* sigma_raw0, void* partial, void* value,
                                    void* dalpha, void* dlog_phi, void* ticket, int B, int S,
                                    int C, int G, int want_grads, int delta, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  if (S <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const Inputs64 in{static_cast<const double*>(X),          static_cast<const double*>(exposure),
                    static_cast<const int32_t*>(counts),    static_cast<const double*>(mask),
                    static_cast<const double*>(d0),         static_cast<const double*>(sp_d0),
                    static_cast<const double*>(sig_neg_d0), static_cast<const double*>(y_sp0),
                    static_cast<const double*>(alpha),      static_cast<const double*>(alpha0),
                    static_cast<const double*>(log_phi),    static_cast<const double*>(sigma_raw0)};
  const Outputs64 out{static_cast<double*>(partial), static_cast<double*>(value),
                      static_cast<double*>(dalpha), static_cast<double*>(dlog_phi),
                      static_cast<unsigned*>(ticket)};
  const dim3 grid((G + ROW_THREADS - 1) / ROW_THREADS, B);
#define NB_ONE(n, grads, dl)                                                      \
  {                                                                               \
    fast64_kernel<n, grads, dl><<<grid, ROW_THREADS, 0, st>>>(in, out, B, S, G); \
    return (int)cudaGetLastError();                                               \
  }
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
