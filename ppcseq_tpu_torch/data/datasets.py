"""Bundled dataset loader.

The reference ships `data/counts.rda` (R/data.R:1-5): 394,821 rows of
21 samples x 18,801 transcripts from a breast-cancer cohort, with edgeR
differential-expression statistics precomputed. We ship the identical table
as a parquet fixture extracted once from the reference's RData file by an
RData reader written from scratch; the port's copy of that reader is
`ppcseq_tpu_torch.data.rdata` (`read_rda`, `r_dataframe_to_pandas`). A copy
of ppcseq_tpu/data/datasets.py reading the same fixture.
"""

from __future__ import annotations

import os

import pandas as pd

_FIXTURE = os.path.join(os.path.dirname(__file__), "..", "..", "fixtures", "counts.parquet")


def load_counts() -> pd.DataFrame:
    """Load the bundled `counts` dataset.

    Columns: sample, symbol, logCPM, LR, PValue, FDR, value (integer counts),
    W, Label (High / Neoadjuvant) — matching the reference's `data(counts)`.
    """
    path = os.environ.get("PPCSEQ_COUNTS_PARQUET", os.path.abspath(_FIXTURE))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"counts fixture not found at {path}; extract it from the reference's "
            "counts.rda with ppcseq_tpu_torch.data.rdata"
        )
    return pd.read_parquet(path)
