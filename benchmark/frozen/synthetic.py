"""The synthetic cohort of the benchmark's large configuration (NumPy).

A frozen copy of `synthetic_cohort` and `synthetic_tidy` in
ppcseq_tpu_torch/utils/synthetic.py at commit dc3b358 (itself a copy of
the JAX package's): NB counts from the reference model's own generative
process (hyperpriors -> gene-wise intercept, slope and overdispersion ->
NB2 counts with per-sample exposure), with a small share of outliers among
the checked genes. The same seed gives the same cohort.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

LAMBDA_MU_MU = 5.612671  # prior location of lambda_mu (reference R/methods.R:218)


def synthetic_cohort(n_genes: int, n_samples: int, n_check: int, outlier_frac: float, seed: int):
    """(counts [S, G] int64, X [S, 2], exposure_rate [S], truth dict)."""
    rng = np.random.default_rng(seed)
    S, G = n_samples, n_genes

    intercept = rng.normal(LAMBDA_MU_MU, 1.5, size=G).clip(0.5, 12.0)
    slope = np.zeros(G)
    slope[:n_check] = rng.normal(0.0, 1.5, size=n_check)
    sigma_raw = rng.normal(-0.1 * intercept - 1.0, 0.4, size=G)
    phi = np.exp(-sigma_raw)

    group = (np.arange(S) >= S // 2).astype(np.float64)
    X = np.column_stack([np.ones(S), group])
    exposure = rng.normal(0.0, 0.3, size=S)

    eta = exposure[:, None] + intercept[None, :] + np.outer(group, slope)
    mu = np.exp(eta).clip(1e-8, 1e7)
    counts = rng.negative_binomial(
        n=np.broadcast_to(phi[None, :], mu.shape), p=phi[None, :] / (phi[None, :] + mu)
    ).astype(np.int64)

    n_out = int(outlier_frac * S * n_check)
    out_s = rng.integers(0, S, n_out)
    out_g = rng.integers(0, n_check, n_out)
    counts[out_s, out_g] = (counts[out_s, out_g] + 5) * rng.integers(5, 12, n_out)

    truth = {"intercept": intercept, "slope": slope, "sigma_raw": sigma_raw,
             "outliers": list(zip(out_s.tolist(), out_g.tolist()))}
    return counts, X, exposure, truth


def synthetic_tidy(n_genes: int, n_samples: int, n_check: int, outlier_frac: float,
                   seed: int) -> pd.DataFrame:
    """The cohort as a tidy table (sample, transcript, count, Label, PValue,
    do_check): the checked genes get small p-values."""
    counts, X, _exposure, _truth = synthetic_cohort(n_genes, n_samples, n_check, outlier_frac,
                                                    seed)
    S, G = counts.shape
    samples = [f"s{i:03d}" for i in range(S)]
    genes = [f"g{j:04d}" for j in range(G)]
    rng = np.random.default_rng(seed + 1)
    pvals = np.where(np.arange(G) < n_check, rng.uniform(1e-8, 1e-4, G), rng.uniform(0.2, 1.0, G))
    return pd.DataFrame({
        "sample": np.repeat(samples, G),
        "transcript": np.tile(genes, S),
        "count": counts.reshape(-1),
        "Label": np.repeat(np.where(X[:, 1] > 0, "High", "Low"), G),
        "PValue": np.tile(pvals, S),
        "do_check": np.tile(np.arange(G) < n_check, S),
    })
