"""A cohort drawn from the model's own generative process, new for every
seed (frozen/synthetic.py)."""

from __future__ import annotations

import numpy as np
import pandas as pd

from benchmark.frozen.synthetic import synthetic_tidy


def make(spec: dict, seed: int) -> pd.DataFrame:
    cohort_seed = int(np.random.SeedSequence([seed % 2**64, 7]).generate_state(1)[0])
    return synthetic_tidy(spec["n_genes"], spec["n_samples"], spec["n_check"],
                          spec["outlier_frac"], cohort_seed)
