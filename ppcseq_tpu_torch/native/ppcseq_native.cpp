// Native host runtime of ppcseq_tpu_torch, the PyTorch + CUDA port.
//
// A copy of the JAX package's native/ppcseq_native.cpp, with the same
// entry points and arithmetic. The card runs the likelihood kernels
// (csrc/); what remains on the host per fit is data preparation: pivoting
// the tidy long table into a dense [S, G] array and the TMM trimmed-mean
// inner loop (rank + trim + weighted mean per sample, called once per
// sample against the reference column). ppcseq_tpu_torch/_native.py
// builds this file with the host C++ compiler at first use and loads it
// with ctypes; the NumPy versions in data/ingest.py and norm/tmm.py are the
// plain references the tests hold it against.
//
// Build flags (ppcseq_tpu_torch/_native.py, as native/Makefile):
//   -O3 -march=native -std=c++17 -fPIC -Wall -shared

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Scatter tidy (s_idx, g_idx, value) triplets into a dense row-major
// [S, G] int64 matrix (zero-initialized by the caller).
void pivot_counts(const int64_t* s_idx, const int64_t* g_idx,
                  const int64_t* values, int64_t n, int64_t G, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[s_idx[i] * G + g_idx[i]] = values[i];
  }
}

namespace {

// R rank() with ties.method="average", 1-based.
void rank_average(const std::vector<double>& x, std::vector<double>& ranks) {
  const size_t n = x.size();
  std::vector<size_t> order(n);
  std::iota(order.begin(), order.end(), size_t{0});
  std::stable_sort(order.begin(), order.end(),
                   [&](size_t a, size_t b) { return x[a] < x[b]; });
  ranks.resize(n);
  size_t i = 0;
  while (i < n) {
    size_t j = i;
    while (j + 1 < n && x[order[j + 1]] == x[order[i]]) ++j;
    const double avg = (static_cast<double>(i) + static_cast<double>(j)) / 2.0 + 1.0;
    for (size_t k = i; k <= j; ++k) ranks[order[k]] = avg;
    i = j + 1;
  }
}

}  // namespace

// One TMM factor: edgeR .calcFactorTMM semantics (logratioTrim=0.3,
// sumTrim=0.05, weighted, Acutoff=-1e10). obs/ref are gene count vectors.
double tmm_factor(const double* obs, const double* ref, int64_t n_genes,
                  double lib_obs, double lib_ref) {
  const double logratio_trim = 0.3, sum_trim = 0.05, a_cutoff = -1e10;
  std::vector<double> logR, absE, v;
  logR.reserve(n_genes);
  absE.reserve(n_genes);
  v.reserve(n_genes);
  for (int64_t i = 0; i < n_genes; ++i) {
    const double o = obs[i] / lib_obs, r = ref[i] / lib_ref;
    const double lr = std::log2(o / r);
    const double ae = (std::log2(o) + std::log2(r)) / 2.0;
    if (std::isfinite(lr) && std::isfinite(ae) && ae > a_cutoff) {
      logR.push_back(lr);
      absE.push_back(ae);
      v.push_back((lib_obs - obs[i]) / lib_obs / obs[i] +
                  (lib_ref - ref[i]) / lib_ref / ref[i]);
    }
  }
  if (logR.empty()) return 1.0;
  double max_abs = 0.0;
  for (double lr : logR) max_abs = std::max(max_abs, std::fabs(lr));
  if (max_abs < 1e-6) return 1.0;

  const size_t n = logR.size();
  const double loL = std::floor(n * logratio_trim) + 1.0;
  const double hiL = n + 1.0 - loL;
  const double loS = std::floor(n * sum_trim) + 1.0;
  const double hiS = n + 1.0 - loS;

  std::vector<double> rL, rS;
  rank_average(logR, rL);
  rank_average(absE, rS);

  double num = 0.0, den = 0.0;
  for (size_t i = 0; i < n; ++i) {
    if (rL[i] >= loL && rL[i] <= hiL && rS[i] >= loS && rS[i] <= hiS) {
      num += logR[i] / v[i];
      den += 1.0 / v[i];
    }
  }
  if (den == 0.0 || !std::isfinite(num / den)) return 1.0;
  return std::exp2(num / den);
}

// TMM factors for a [genes, samples] column-major-by-sample layout
// (counts[g * n_samples + s]); factors rescaled to multiply to one.
void tmm_norm_factors(const double* counts, int64_t n_genes, int64_t n_samples,
                      int64_t ref_column, double* out_factors) {
  std::vector<double> lib(n_samples, 0.0);
  for (int64_t g = 0; g < n_genes; ++g)
    for (int64_t s = 0; s < n_samples; ++s) lib[s] += counts[g * n_samples + s];

  std::vector<double> col(n_genes), refcol(n_genes);
  for (int64_t g = 0; g < n_genes; ++g) refcol[g] = counts[g * n_samples + ref_column];

  double log_sum = 0.0;
  for (int64_t s = 0; s < n_samples; ++s) {
    for (int64_t g = 0; g < n_genes; ++g) col[g] = counts[g * n_samples + s];
    out_factors[s] = tmm_factor(col.data(), refcol.data(), n_genes, lib[s], lib[ref_column]);
    log_sum += std::log(out_factors[s]);
  }
  const double scale = std::exp(log_sum / n_samples);
  for (int64_t s = 0; s < n_samples; ++s) out_factors[s] /= scale;
}

// R type-7 quantile of a sorted array.
double quantile7_sorted(const double* sorted, int64_t n, double p) {
  if (n == 0) return NAN;
  const double h = (n - 1) * p;
  const int64_t lo = static_cast<int64_t>(std::floor(h));
  const int64_t hi = std::min(lo + 1, n - 1);
  return sorted[lo] + (h - lo) * (sorted[hi] - sorted[lo]);
}

}  // extern "C"
