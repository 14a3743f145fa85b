"""Plain reference of the host preparation: gene selection, gene and sample
order, the design matrix and the TMM exposure (reference R/methods.R:
198-238, R/utilities.R:628-649, 887-959; edgeR's TMM as R/tidybulk.R:
150-304 calls it).

Written from those semantics in pandas and torch, independent of the
program. `tmm_exposure` takes a dtype: float64 is the reference, bfloat16
its control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch


@dataclass
class Prepared:
    genes: list           # transcripts in model order: checked first
    n_check: int
    samples: list         # sample names in model order (first appearance)
    counts: np.ndarray    # [S, G] int64 in those orders
    X: np.ndarray         # [S, C] float64, rows in sample order
    covariate: np.ndarray  # [S] the design's second column (zeros when C == 1)
    sorted_samples: list  # the design's and the TMM's sample order


def select(df: pd.DataFrame, transcript: str, sample: str, abundance: str, significance: str,
           do_check: str, n_controls: int) -> pd.DataFrame:
    """The checked rows, then the non-checked rows of the `n_controls`
    least significant transcripts (distinct transcripts after a stable sort
    by significance, the last n), in input order within each part."""
    ranked = df.sort_values(significance, kind="stable")[transcript].drop_duplicates()
    tail = set(ranked.iloc[len(ranked) - min(n_controls, len(ranked)):])
    check = df[do_check].astype(bool)
    control = ~check & df[transcript].isin(tail)
    return pd.concat([df[check], df[control]], ignore_index=True)


def design(samples_sorted: list, covariates: dict) -> np.ndarray:
    """Treatment-contrast design over the sorted samples: an intercept,
    then per covariate its value (numeric) or one indicator per level after
    the first in sorted order (categorical)."""
    cols = [np.ones(len(samples_sorted))]
    for values in covariates.values():
        v = np.asarray([values[s] for s in samples_sorted])
        if v.dtype.kind in "if":
            cols.append(v.astype(np.float64))
        else:
            for level in sorted(set(v.tolist()))[1:]:
                cols.append((v == level).astype(np.float64))
    return np.column_stack(cols)


def prepare(df: pd.DataFrame, *, transcript: str, sample: str, abundance: str,
            significance: str, do_check: str, n_controls: int, covariates: list) -> Prepared:
    sub = select(df, transcript, sample, abundance, significance, do_check, n_controls)
    genes = list(pd.unique(sub[transcript]))
    samples = list(pd.unique(sub[sample]))
    n_check = len(pd.unique(sub.loc[sub[do_check].astype(bool), transcript]))
    g_of = {g: i for i, g in enumerate(genes)}
    s_of = {s: i for i, s in enumerate(samples)}
    counts = np.zeros((len(samples), len(genes)), dtype=np.int64)
    counts[sub[sample].map(s_of).to_numpy(), sub[transcript].map(g_of).to_numpy()] = \
        sub[abundance].to_numpy()
    sorted_samples = sorted(samples)
    per_sample = sub.drop_duplicates(sample).set_index(sample)
    cov = {c: per_sample[c].to_dict() for c in covariates}
    X_sorted = design(sorted_samples, cov)
    pos = {s: i for i, s in enumerate(sorted_samples)}
    X = X_sorted[[pos[s] for s in samples]]
    covariate = X[:, 1] if X.shape[1] > 1 else np.zeros(len(samples))
    return Prepared(genes, n_check, samples, counts, X, covariate, sorted_samples)


def _ranks(x: torch.Tensor) -> torch.Tensor:
    """1-based ranks, ties given their average (R's rank())."""
    vals, order = torch.sort(x, stable=True)
    _, inverse, counts = torch.unique_consecutive(vals, return_inverse=True, return_counts=True)
    end = torch.cumsum(counts, 0).to(torch.float64)
    avg = end - (counts.to(torch.float64) - 1) / 2
    ranks = torch.empty_like(avg[inverse])
    ranks[order] = avg[inverse]
    return ranks


def _tmm_factor(obs, ref, n_obs, n_ref, dtype):
    """edgeR's TMM factor of one column against the reference column
    (logratioTrim 0.3, sumTrim 0.05, precision weights, no A cutoff)."""
    one = torch.ones((), dtype=dtype)
    fo, fr = obs / n_obs, ref / n_ref
    log_r = torch.log2(fo / fr)
    abs_e = (torch.log2(fo) + torch.log2(fr)) / 2
    v = (n_obs - obs) / n_obs / obs + (n_ref - ref) / n_ref / ref
    fin = torch.isfinite(log_r) & torch.isfinite(abs_e)
    log_r, abs_e, v = log_r[fin], abs_e[fin], v[fin]
    if log_r.numel() == 0 or float(torch.max(torch.abs(log_r))) < 1e-6:
        return one
    n = log_r.numel()
    lo_l = np.floor(n * 0.3) + 1
    lo_s = np.floor(n * 0.05) + 1
    r_l, r_s = _ranks(log_r), _ranks(abs_e)
    keep = (r_l >= lo_l) & (r_l <= n + 1 - lo_l) & (r_s >= lo_s) & (r_s <= n + 1 - lo_s)
    f = torch.sum(log_r[keep] / v[keep]) / torch.sum(1 / v[keep])
    return torch.exp2(f) if bool(torch.isfinite(f)) else one


def tmm_exposure(prep: Prepared, dtype=torch.float64) -> dict:
    """{sample: exposure_rate}: TMM factors against the sample of highest
    median count (the first in sorted order on a tie), multiplier =
    total_ref / (total * factor), exposure_rate = -log(multiplier)."""
    order = [prep.samples.index(s) for s in prep.sorted_samples]
    mat = torch.as_tensor(prep.counts[order].T.astype(np.float64)).to(dtype)  # [G, S sorted]
    med = np.median(prep.counts[order], axis=1)
    ref = int(np.flatnonzero(med == med.max())[0])
    tot = torch.sum(mat, dim=0)
    f = torch.stack([_tmm_factor(mat[:, i], mat[:, ref], tot[i], tot[ref], dtype)
                     for i in range(mat.shape[1])])
    f = f / torch.exp(torch.mean(torch.log(f)))
    multiplier = tot[ref] / (tot * f)
    exposure = -torch.log(multiplier)
    return dict(zip(prep.sorted_samples, exposure.to(torch.float64).tolist()))
