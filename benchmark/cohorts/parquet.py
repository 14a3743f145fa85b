"""A cohort read from a table file under the benchmark's folder, with the
checked transcripts flagged by a significance cut."""

from __future__ import annotations

import pandas as pd

from benchmark.harness import ROOT


def make(spec: dict, seed: int) -> pd.DataFrame:
    """The table `spec["file"]` (relative to the checkout's root) with the
    column `spec["flag"]` set where `spec["below"]`'s column is below its
    value. The same table for every seed."""
    df = pd.read_parquet(ROOT / spec["file"])
    (column, cut), = spec["below"].items()
    return df.assign(**{spec["flag"]: df[column] < cut})
