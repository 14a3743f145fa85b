"""Synthetic cohort generation for scale testing (NumPy).

A copy of `synthetic_cohort` from ppcseq_tpu/utils/synthetic.py: NB counts
from the model's own generative process (hyperpriors -> gene-wise
intercept/slope/overdispersion -> NB2 counts with per-sample exposure), at
arbitrary scale — e.g. the 50k-gene x 100-sample benchmark cohort. The same
seed gives the same cohort in both packages.
"""

from __future__ import annotations

import numpy as np

from ppcseq_tpu_torch.utils.constants import LAMBDA_MU_MU


def synthetic_cohort(
    n_genes: int = 50000,
    n_samples: int = 100,
    n_check: int = 100,
    outlier_frac: float = 0.002,
    seed: int = 0,
):
    """Returns (counts [S, G] int64, X [S, 2], exposure_rate [S], truth dict).

    Check genes (the first n_check) get nonzero group slopes; a small
    fraction of points are multiplied into outliers so outlier-detection
    benchmarks have signal.
    """
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

    truth = {
        "intercept": intercept,
        "slope": slope,
        "sigma_raw": sigma_raw,
        "outliers": list(zip(out_s.tolist(), out_g.tolist())),
    }
    return counts, X, exposure, truth
