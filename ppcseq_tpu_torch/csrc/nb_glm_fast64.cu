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
// (ops/nb_kernel.py:work counts them so), ~300 per point in all, on the
// FMA pipe at half the FP32 rate. Tensor cores do not apply: X alpha is
// C <= MAX_C multiply-adds per point, the rest is log/exp/divide sequences.
// Against that, 44 bytes of [S, G] input per point with a baseline (12
// without): operations, not bytes, by work()'s count at every shape. What
// held the one-thread-per-(b, g) kernel of before back: (1) each of the B
// rows of blocks read the [S, G] tables from device memory again (up to
// B x 220 MB at 50k x 100; the 50 MB L2 holds about two rows of blocks),
// (2) log(y + 1), 1/(y + 1) and 1 - sig_neg_d0 were computed per (b, s, g)
// where they depend on (s, g) alone, (3) at small B a few blocks, each
// thread building its (b, g) row (8 logs, 7 divides) and walking all S
// points in one dependent chain. (Measured on the H100, PERF.md: (1) was
// hidden behind the FP64 instruction rate even at (100, 100, 50000), which
// the tile moved by ~2%; (3) held the small calls at ~5x their time now.)
//
// The design: the float64 forms are forms of csrc/nb_tile.cuh (Fast64<DELTA>,
// Real = double), in the launch layout that ops/nb_kernel.py:layout chose
// from an H100 sweep (bench_kernels.py --sweep). Tiled, a block stages its
// [SC, T] chunk of counts, mask and d0, sp_d0, sig_neg_d0, y_sp0 (or the
// exposure) and X in shared memory with 8-byte cp.async, once for its BY
// b-rows: ceil(B / BY) passes over the tables instead of B. The terms of a
// point that depend on (s, g) alone (lgamma(y + 1) for y <= 7, else
// log(y + 1) and 1/(y + 1); the delta form's 1 - sig_neg_d0) are computed
// once per staged point (hoist), not once per (b, point). The (b, g) row's
// 8 logs log(phi + k) and 8 ratios phi / (phi + k) are spread over the SY
// sample lanes, which also share the samples; the lanes' partials are summed
// in shared memory in a fixed order. The row layout (one thread per (b, g),
// the kernel of before) is built beside it for the sweep and the card
// tests; layout() does not take it (no faster at any main-path shape but
// the value-only (100, 21, 515), PERF.md). Either way the blocks' double
// partials are summed in a fixed order by the last block (nb_common.cuh's
// last_block_sums_partials): bitwise reproducible, one kernel per call.
// GRADS = false is the value-only instantiation; a point's value is
// computed by the same operations in both, and layout() gives both the same
// lanes, so their values agree bit for bit. Registers: a (b, g) row holds
// ~30 doubles; a gene's phi takes one side of the y > 7 branch, so the row
// keeps that side's constants only (GeneRow::br), which brought the tiled
// gradient instantiation at C = 2 under the 128 registers at which ptxas
// holds two blocks of 256 threads per SM, without spills.
//
// Build without --use_fast_math and with --fmad=false (ops/_build.py), so
// every product and sum rounds once, as in the plain torch version.

#include "nb_tile.cuh"

namespace {

// Only the layouts (nb_tile.cuh) and MAX_C come from nbk: nb_common.cuh's
// float helpers (log1p01, log1p_wide, ...) have double namesakes here.

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
// da (DELTA: alpha - alpha0; else alpha). A gene's phi takes one side of
// the y > 7 branch at every point, so `br` holds that side's constants only
// (fewer registers): phi >= 8 (there phi_b = max(phi, 8) is phi)
// BR_INV_PHI_B, BR_INV_PHI_B3, BR_B_CONST, BR_LOG_PHI_B; phi < 8
// BR_LGAM_SMALL, BR_PSI8, BR_SHIFT_C.
enum { BR_INV_PHI_B, BR_INV_PHI_B3, BR_B_CONST, BR_LOG_PHI_B };
enum { BR_LGAM_SMALL, BR_PSI8, BR_SHIFT_C };
template <int C>
struct GeneRow {
  double lpc, phi, d_b, delta_log_phi;
  bool below_cap;
  double br[4], cum_log[7], cum_frac[7], da[C];
};

// Builds the row from lp_raw = log_phi[b, g]; log_k(k) = log(phi + k) for
// k = 0..7 and frac_k(k) = phi / (phi + k) for k = 1..7, wherever the caller
// computed them (phi + 0 is phi); the running sums keep the plain version's
// order.
template <int C, bool GRADS, bool DELTA, class LogK, class FracK>
__device__ __forceinline__ void gene_row(GeneRow<C>& r, double lp_raw, double sr0, LogK log_k,
                                         FracK frac_k) {
  r.lpc = clamp_max(lp_raw, CAP);
  r.phi = exp(r.lpc);
  const double phi = r.phi;
  double acc_l = log_k(0), acc_f = 1.0;
  r.cum_log[0] = acc_l;
  r.cum_frac[0] = acc_f;
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    acc_l = acc_l + log_k(k);
    if (GRADS) acc_f = acc_f + frac_k(k);
    r.cum_log[k] = acc_l;
    r.cum_frac[k] = acc_f;
  }
  // lgamma(min(phi, 8)) by shift-by-8 Stirling
  const double xs = clamp_max(phi, 8.0) + 8.0;
  const double inv = 1.0 / xs;
  const double inv2 = inv * inv;
  const double log_xs = log(xs);
  const double stirl = (xs - 0.5) * log_xs - xs + HALF_LOG_2PI_D +
                       inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)));
  const double lgam_small = stirl - (r.cum_log[6] + log_k(7));
  const double psi8 =
      log_xs - 0.5 * inv - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0));
  const double shift_c = GRADS ? r.cum_frac[6] + frac_k(7) : 0.0;
  const double log_phi_b = clamp_min(r.lpc, LOG8_D);
  const double phi_b = clamp_min(phi, 8.0);
  const double inv_phi_b = 1.0 / phi_b;
  const double inv_phi_b3 = inv_phi_b * inv_phi_b * inv_phi_b;
  const double b_const = -0.5 * log_phi_b + 1.0 - HALF_LOG_2PI_D - (1.0 / 12.0) * inv_phi_b +
                         (1.0 / 360.0) * inv_phi_b3;
  const bool big = phi >= 8.0;
  r.br[0] = big ? inv_phi_b : lgam_small;
  r.br[1] = big ? inv_phi_b3 : psi8;
  r.br[2] = big ? b_const : shift_c;
  r.br[3] = log_phi_b;
  r.d_b = phi - 1.0;
  r.delta_log_phi = DELTA ? r.lpc + sr0 : 0.0;  // log_phi - log_phi0
  r.below_cap = lp_raw < CAP;
}

// The per-(s, g) terms of a point, h[NH] (Fast64::hoist):
//   h[0] lgamma(y + 1) for y <= 7, else log(y + 1); h[1] 1/(y + 1) (y > 7);
//   DELTA: h[2] = 1 - sig_neg_d0 (sigmoid(d0)), and the staged tables
//   h[3] = sp_d0, h[4] = sig_neg_d0, h[5] = y_sp0
enum { H_LGY, H_INV_Y1, H_SIG_D0, H_SP_D0, H_SIG_NEG_D0, H_Y_SP0 };

// One point's value and gradient terms, added to the accumulators: the
// plain version's operations in its order. `x` is the sample's design row,
// `ex` its exposure (!DELTA), d0 its baseline (DELTA), h its per-(s, g)
// terms (H_*).
template <int C, bool GRADS, bool DELTA, int NH>
__device__ __forceinline__ void add_point(const GeneRow<C>& r, double m, double yf,
                                          const double* x, double ex, double d0,
                                          const double (&h)[NH], double& acc_val,
                                          double (&acc_da)[C], double& acc_dlp) {
  const double lpc = r.lpc, phi = r.phi;
  // DELTA: delta_eta = X (alpha - alpha0); else eta = exposure + X alpha
  // (nb_fast._eta_small: the exposure first, then column by column)
  double eta = DELTA ? 0.0 : ex;
#pragma unroll
  for (int c = 0; c < C; ++c) eta = eta + x[c] * r.da[c];
  const double dlo = eta - r.delta_log_phi;  // DELTA only
  const double d = DELTA ? d0 + dlo : eta - lpc;

  // softplus pair sharing one exp (nb_fast._softplus_pair)
  const double em = exp(-fabs(d));
  const double l1pem = log1p01(em);
  const double sp_d = clamp_min(d, 0.0) + l1pem;
  const double sp_nd = clamp_min(-d, 0.0) + l1pem;

  // phi * softplus(d) and the y term (nb_fast.delta_increment_terms)
  double phi_sp, y_term;
  if constexpr (DELTA) {
    const double sp_d0 = h[H_SP_D0], sig_neg_d0 = h[H_SIG_NEG_D0];
    double inc_neg;
    if (dlo > -2.0 && dlo < 8.0) {  // here clamp(dlo, -2, 8) = dlo
      const double e1 =
          fabs(dlo) < 0.35
              ? dlo * (1.0 + dlo * (0.5 + dlo * (1.0 / 6.0 + dlo * (1.0 / 24.0 +
                dlo * (1.0 / 120.0 + dlo * (1.0 / 720.0 + dlo / 5040.0))))))
              : exp(dlo) - 1.0;
      const double e1_neg = -e1 / (1.0 + e1);  // expm1(-dlo)
      const double sig_d0 = h[H_SIG_D0];  // 1 - sig_neg_d0
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
    part1 = select_by_y(yf, r.cum_log) - h[H_LGY];  // lgamma(y + 1)
    if (GRADS) phi_d = select_by_y(yf, r.cum_frac);
  } else {
    const double inv_y1 = h[H_INV_Y1];
    const double l1p = log1p_wide(r.d_b * inv_y1);
    const double log_a1 = h[H_LGY] + l1p;  // log(y + 1) + log1p: log(y + phi)
    const double inv_a1 = 1.0 / (clamp_min(yf, 8.0) + phi);
    const double inv_a1_2 = inv_a1 * inv_a1;
    const double corr = (1.0 / 12.0) * (inv_a1 - inv_y1) -
                        (1.0 / 360.0) * (inv_a1 * inv_a1_2 - inv_y1 * inv_y1 * inv_y1);
    const double pair = (yf + 0.5) * l1p + corr;
    if (phi >= 8.0) {  // phi_b = phi
      const double inv_phi_b = r.br[BR_INV_PHI_B], inv_phi_b3 = r.br[BR_INV_PHI_B3];
      const double ub = yf * inv_phi_b;
      const double l1p_b =
          ub < 0.5 ? log1p01(clamp_max(ub, 1.0)) : log_a1 - r.br[BR_LOG_PHI_B];
      part1 = pair + (phi - 1.0) * l1p_b + r.br[BR_B_CONST];
      if (GRADS)
        phi_d = phi * l1p_b + 0.5 * yf * inv_a1 + (1.0 / 12.0) * (inv_phi_b - phi * inv_a1_2) -
                (1.0 / 120.0) * (inv_phi_b3 - phi * inv_a1_2 * inv_a1_2);
    } else {
      part1 = pair + r.d_b * log_a1 - r.d_b - r.br[BR_LGAM_SMALL];
      if (GRADS) {
        const double psi_yphi =
            log_a1 - 0.5 * inv_a1 -
            inv_a1_2 * (1.0 / 12.0 - inv_a1_2 * (1.0 / 120.0 - inv_a1_2 / 252.0));
        phi_d = clamp_max(phi, 8.0) * (psi_yphi - r.br[BR_PSI8]) + r.br[BR_SHIFT_C];
      }
    }
  }

  // DELTA: part1 - phi_sp - y * inc_neg - y * softplus(-d0) (y_sp0, a table);
  // else part1 - phi * softplus(d) - y * softplus(-d)
  double pts = part1 - phi_sp - y_term;
  if constexpr (DELTA) pts = pts - h[H_Y_SP0];
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

// K1 and K2 in float64 (DELTA) as forms of nb_tile.cuh
template <bool DELTA>
struct Fast64 {
  using Real = double;
  static constexpr bool BASE = DELTA;
  static constexpr int NH = DELTA ? 6 : 2;  // H_*: 3 computed + 3 staged; 2 computed
  static constexpr int TAB = 16;            // log(phi + k), phi / (phi + k)
  static constexpr int NT = DELTA ? 3 : 0;  // sp_d0, sig_neg_d0, y_sp0 (Inputs64's tab)

  template <int C>
  using Row = GeneRow<C>;

  template <int C, bool GRADS, class LogK, class FracK>
  static __device__ __forceinline__ void build_row(Row<C>& r, double lp_raw, double sr0,
                                                   LogK log_k, FracK frac_k) {
    gene_row<C, GRADS, DELTA>(r, lp_raw, sr0, log_k, frac_k);
  }

  // The b-independent terms of a point, by the operations the point used
  // (with DELTA, h[H_SIG_NEG_D0] holds the staged sig_neg_d0)
  static __device__ __forceinline__ void hoist(double yf, double, double (&h)[NH]) {
    if (yf <= 7.0) {
      h[H_LGY] = lgamma_1p_small(yf);
      h[H_INV_Y1] = 0.0;
    } else {
      const double y1 = yf + 1.0;
      h[H_INV_Y1] = 1.0 / y1;
      h[H_LGY] = log(y1);
    }
    if constexpr (DELTA) h[H_SIG_D0] = 1.0 - h[H_SIG_NEG_D0];
  }

  template <int C, bool GRADS, bool HOISTED>
  static __device__ __forceinline__ void point(const Row<C>& r, double m, double yf,
                                               const double* x, double ex, double d0v,
                                               const double (&h)[NH], double& acc_val,
                                               double (&acc_da)[C], double& acc_dlp) {
    double hh[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) hh[k] = h[k];
    if (!HOISTED) hoist(yf, d0v, hh);
    add_point<C, GRADS, DELTA, NH>(r, m, yf, x, ex, d0v, hh, acc_val, acc_da, acc_dlp);
  }
};

using Inputs64 = nbk::InputsT<double, 3>;
using Outputs64 = nbk::OutputsT<double>;

}  // namespace

extern "C" int nb_glm_fast64_max_c() { return nbk::MAX_C; }

// Launches the float64 form of K1 (delta != 0: reads d0, sp_d0, sig_neg_d0,
// y_sp0, alpha0, sigma_raw0; exposure ignored) or of K2 (delta == 0: reads
// exposure; the baseline ignored) on `stream`, one kernel in all, with the
// layout of ops/nb_kernel.py:layout, as nb_tile.cuh's launch_layout takes it:
// SY = 0 is the row layout (T = 128 genes of one b per block, BY = 1, no
// shared memory); otherwise tiled blocks of T genes x BY b-lanes x SY sample
// lanes, SC samples per staged chunk, `smem` bytes of dynamic shared memory
// (8-byte words). `partial` is [B, ceil(G / T)] double scratch; `ticket` is
// a zeroed unsigned that launches on this stream share (the kernel leaves it
// 0); `dalpha`/`dlog_phi` are ignored unless want_grads. Every array is
// double but counts (int32). Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a C outside 1..MAX_C, a grid of more than 65535
// rows of blocks or a layout the kernel cannot run.
extern "C" int nb_glm_fast64_launch(const void* X, const void* exposure, const void* counts,
                                    const void* mask, const void* d0, const void* sp_d0,
                                    const void* sig_neg_d0, const void* y_sp0, const void* alpha,
                                    const void* alpha0, const void* log_phi,
                                    const void* sigma_raw0, void* partial, void* value,
                                    void* dalpha, void* dlog_phi, void* ticket, int B, int S,
                                    int C, int G, int want_grads, int delta, int T, int BY,
                                    int SY, int SC, int smem, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  if (S <= 0 || T <= 0 || BY <= 0 || SY < 0 || (B + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  const Inputs64 in{{static_cast<const double*>(X), static_cast<const double*>(exposure),
                     static_cast<const int32_t*>(counts), static_cast<const double*>(mask),
                     static_cast<const double*>(d0), static_cast<const double*>(alpha),
                     static_cast<const double*>(alpha0), static_cast<const double*>(log_phi),
                     static_cast<const double*>(sigma_raw0)},
                    {static_cast<const double*>(sp_d0), static_cast<const double*>(sig_neg_d0),
                     static_cast<const double*>(y_sp0)}};
  const Outputs64 out{static_cast<double*>(partial), static_cast<double*>(value),
                      static_cast<double*>(dalpha), static_cast<double*>(dlog_phi),
                      static_cast<unsigned*>(ticket)};
  const nbk::InputsT<double> in_plain = in;  // the plain form stages no tables
#define NB_CASE(n)                                                                          \
  if (delta) {                                                                              \
    if (want_grads)                                                                         \
      return nbk::launch_layout<Fast64<true>, n, true>(in, out, B, S, G, T, BY, SY, SC,     \
                                                       smem, st);                           \
    return nbk::launch_layout<Fast64<true>, n, false>(in, out, B, S, G, T, BY, SY, SC, smem, \
                                                      st);                                  \
  }                                                                                         \
  if (want_grads)                                                                           \
    return nbk::launch_layout<Fast64<false>, n, true>(in_plain, out, B, S, G, T, BY, SY, SC, \
                                                      smem, st);                            \
  return nbk::launch_layout<Fast64<false>, n, false>(in_plain, out, B, S, G, T, BY, SY, SC,  \
                                                     smem, st);
  NBK_DISPATCH_C(C, NB_CASE)
#undef NB_CASE
  return (int)cudaErrorInvalidValue;  // not reached: every case returns
}
