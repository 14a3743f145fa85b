"""TMM normalization and exposure rates, reimplemented from scratch.

The reference delegates to edgeR (`calcNormFactors`, `filterByExpr`) from
R/tidybulk.R:150-323 and converts the norm factors into per-sample
`multiplier` / `exposure_rate` in R/methods.R:222-238. This module
reimplements the same math in NumPy:

- `tmm_norm_factors`: trimmed mean of M-values with precision weighting
  (logratioTrim=0.3, sumTrim=0.05, doWeighting=TRUE, Acutoff=-1e10),
  factors rescaled to multiply to one — edgeR's documented TMM algorithm
  (Robinson & Oshlack, Genome Biology 2010), as called by the reference at
  R/tidybulk.R:294-304 with an explicit reference column.
- `filter_by_expr`: edgeR's expression filter as called at
  R/tidybulk.R:75-79 (min.count=10, min.prop=0.7). NOTE: the reference
  computes this flag but never uses it to filter before calcNormFactors
  (SURVEY.md §2.4); we preserve that behavior in the pipeline and expose the
  filter for API completeness.
- `sample_scaling`: reference-sample selection (highest median count,
  R/tidybulk.R:181-196) and multiplier = tot_ref / (tot_s * nf_s)
  (R/tidybulk.R:220-225); exposure_rate = -log(multiplier)
  (R/methods.R:236).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ppcseq_tpu_torch import _native


def _rank_average(x: np.ndarray) -> np.ndarray:
    """R `rank()` with ties.method="average" (1-based)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        ranks[order[i : j + 1]] = avg
        i = j + 1
    return ranks


def _calc_factor_tmm(
    obs: np.ndarray,
    ref: np.ndarray,
    libsize_obs: float | None = None,
    libsize_ref: float | None = None,
    logratio_trim: float = 0.3,
    sum_trim: float = 0.05,
    do_weighting: bool = True,
    a_cutoff: float = -1e10,
) -> float:
    """One TMM factor: obs column vs ref column (edgeR .calcFactorTMM)."""
    obs = np.asarray(obs, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    nO = float(obs.sum()) if libsize_obs is None else float(libsize_obs)
    nR = float(ref.sum()) if libsize_ref is None else float(libsize_ref)

    with np.errstate(divide="ignore", invalid="ignore"):
        logR = np.log2((obs / nO) / (ref / nR))
        absE = (np.log2(obs / nO) + np.log2(ref / nR)) / 2.0
        v = (nO - obs) / nO / obs + (nR - ref) / nR / ref

    fin = np.isfinite(logR) & np.isfinite(absE) & (absE > a_cutoff)
    logR, absE, v = logR[fin], absE[fin], v[fin]
    if logR.size == 0:
        return 1.0
    if np.max(np.abs(logR)) < 1e-6:
        return 1.0

    n = len(logR)
    loL = np.floor(n * logratio_trim) + 1
    hiL = n + 1 - loL
    loS = np.floor(n * sum_trim) + 1
    hiS = n + 1 - loS

    rL = _rank_average(logR)
    rS = _rank_average(absE)
    keep = (rL >= loL) & (rL <= hiL) & (rS >= loS) & (rS <= hiS)

    if do_weighting:
        denom = np.nansum(1.0 / v[keep])
        f = np.nansum(logR[keep] / v[keep]) / denom if denom > 0 else np.nan
    else:
        f = np.nanmean(logR[keep]) if keep.any() else np.nan
    if not np.isfinite(f):
        f = 0.0
    return float(2.0**f)


def tmm_norm_factors(
    counts: np.ndarray,
    ref_column: int | None = None,
    lib_size: np.ndarray | None = None,
    use_native: bool | None = None,
) -> np.ndarray:
    """TMM norm factors for a [genes, samples] count matrix.

    Factors are rescaled to multiply to one, as edgeR does. If `ref_column`
    is None the column whose 0.75-quantile scaled expression is closest to
    the mean is chosen (edgeR default); the reference pipeline always passes
    an explicit reference column (R/tidybulk.R:299-301).

    With an explicit `ref_column` and no custom `lib_size`, the factors come
    from the native C++ host runtime (ppcseq_tpu_torch/_native.py), which
    is built at first use and raises if it cannot be. `use_native=False`
    selects the NumPy version below, the plain reference it is tested
    against.
    """
    x = np.asarray(counts, dtype=np.float64)
    if np.isnan(x).any():
        raise ValueError("NA counts not permitted")
    if use_native is not False and lib_size is None and ref_column is not None:
        return _native.tmm_norm_factors(x, int(ref_column))
    nsamp = x.shape[1]
    if lib_size is None:
        lib_size = x.sum(axis=0)
    lib_size = np.asarray(lib_size, dtype=np.float64)

    if ref_column is None:
        # edgeR .calcFactorQuantile with p=0.75 (type-7 quantile of scaled counts)
        f75 = np.array(
            [np.quantile(x[:, i], 0.75, method="linear") / lib_size[i] for i in range(nsamp)]
        )
        if np.median(f75) < 1e-20:
            ref_column = int(np.argmax(x.sum(axis=0)))
        else:
            ref_column = int(np.argmin(np.abs(f75 - f75.mean())))

    f = np.array(
        [
            _calc_factor_tmm(
                x[:, i], x[:, ref_column], libsize_obs=lib_size[i], libsize_ref=lib_size[ref_column]
            )
            for i in range(nsamp)
        ]
    )
    return f / np.exp(np.mean(np.log(f)))


def filter_by_expr(
    counts: np.ndarray,
    group: np.ndarray | None = None,
    lib_size: np.ndarray | None = None,
    min_count: float = 10,
    min_total_count: float = 15,
    large_n: int = 10,
    min_prop: float = 0.7,
) -> np.ndarray:
    """edgeR filterByExpr for a [genes, samples] matrix; True = keep."""
    x = np.asarray(counts, dtype=np.float64)
    nsamp = x.shape[1]
    if lib_size is None:
        lib_size = x.sum(axis=0)
    lib_size = np.asarray(lib_size, dtype=np.float64)
    if group is None:
        group = np.zeros(nsamp, dtype=np.int64)
    _, counts_per_group = np.unique(np.asarray(group), return_counts=True)
    min_sample_size = float(counts_per_group.min())
    if min_sample_size > large_n:
        min_sample_size = large_n + (min_sample_size - large_n) * min_prop

    median_lib = np.median(lib_size)
    cpm_cutoff = min_count / median_lib * 1e6
    cpm = x / lib_size[None, :] * 1e6
    tol = 1e-14
    keep_cpm = (cpm >= cpm_cutoff).sum(axis=1) >= (min_sample_size - tol)
    keep_total = x.sum(axis=1) >= (min_total_count - tol)
    return keep_cpm & keep_total


def sample_scaling(
    df: pd.DataFrame,
    sample: str,
    transcript: str,
    abundance: str,
    reference_sample: str | None = None,
) -> pd.DataFrame:
    """Per-sample multiplier and exposure_rate from TMM, reference semantics.

    Input is the gene-subset long frame (`my_df`: check + control genes), as
    in the reference where TMM runs on the subset, not the full dataset
    (R/methods.R:222-227). Returns columns [sample, TMM, multiplier,
    exposure_rate, exposure_multiplier].
    """
    if "S" in df.columns and "G" in df.columns:
        # fast path for the pipeline's indexed frame: dense pivot from the
        # S/G codes instead of pandas drop_duplicates+pivot (the latter cost
        # ~7 s on a 5M-row cohort). Gene order is irrelevant to TMM (the
        # trimming is rank-based); sample columns are sorted by name exactly
        # like pandas pivot / tidyr spread.
        s_codes = df["S"].to_numpy()
        g_codes = df["G"].to_numpy()
        vals = df[abundance].to_numpy()
        n_s = int(s_codes.max()) + 1
        n_g = int(g_codes.max()) + 1
        name_by_s = np.empty(n_s, dtype=object)
        name_by_s[s_codes] = df[sample].to_numpy()
        perm = np.argsort(name_by_s, kind="stable")  # sorted sample names
        sorted_samples = list(name_by_s[perm])
        mat = np.zeros((n_g, n_s), dtype=np.float64)
        mat[g_codes, s_codes] = vals
        mat = mat[:, perm]
        med = pd.Series(np.median(mat, axis=0), index=sorted_samples)
        tot = mat.sum(axis=0)
    else:
        med = df.groupby(sample)[abundance].median().sort_index()
        wide = (
            df[[sample, transcript, abundance]]
            .drop_duplicates()
            .pivot(index=transcript, columns=sample, values=abundance)
            .dropna()
        )
        sorted_samples = list(wide.columns)  # pivot sorts samples, like spread()
        mat = wide.to_numpy()
        tot = df.groupby(sample)[abundance].sum()
        tot = tot.reindex(sorted_samples).to_numpy(dtype=np.float64)

    # Reference sample: highest median count; ties broken by sorted sample
    # order (reference R/tidybulk.R:181-196 group_by sorts samples).
    if reference_sample is None:
        diffs = (med.max() - med).abs()
        reference_sample = diffs.idxmin()  # first minimum in sorted-sample order

    ref_idx = sorted_samples.index(reference_sample)
    nf = tmm_norm_factors(mat, ref_column=ref_idx)
    tot_ref = tot[ref_idx]
    multiplier = 1.0 / (tot * nf) * tot_ref
    exposure_rate = -np.log(multiplier)
    return pd.DataFrame(
        {
            sample: sorted_samples,
            "TMM": nf,
            "multiplier": multiplier,
            "exposure_rate": exposure_rate,
            "exposure_multiplier": np.exp(exposure_rate),
        }
    )
