"""Pass-level checkpoint/resume for the two-pass pipeline (a copy of
ppcseq_tpu/utils/checkpoint.py: the same fingerprint, files and layout).

The reference has no checkpointing (SURVEY.md §5): a crash in pass 2 loses
the pass-1 fit. Here each pass's outputs (the per-(S,G) table plus run
metadata) can be persisted; `identify_outliers(..., checkpoint_dir=...)`
writes `pass1.parquet` / `pass2.parquet` + `meta.json` and skips any pass
whose checkpoint matches the current configuration fingerprint.

The fingerprint covers everything that affects a pass's result: data shape
+ content hash, formula, thresholds, draw counts, inference flags, seed,
and in this package the device type and dtype.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pandas as pd


def config_fingerprint(my_df: pd.DataFrame, **config) -> str:
    """Hash of the model inputs + scalar config for checkpoint validity."""
    h = hashlib.sha256()
    h.update(pd.util.hash_pandas_object(my_df, index=False).values.tobytes())
    h.update(json.dumps(config, sort_keys=True, default=str).encode())
    return h.hexdigest()[:16]


def save_pass(checkpoint_dir: str, name: str, table: pd.DataFrame,
              fingerprint: str, extra: dict | None = None) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    table.to_parquet(os.path.join(checkpoint_dir, f"{name}.parquet"))
    meta_path = os.path.join(checkpoint_dir, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta[name] = {"fingerprint": fingerprint, **(extra or {})}
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)


def load_pass(checkpoint_dir: str | None, name: str, fingerprint: str):
    """Return the checkpointed table if it exists and matches, else None."""
    if checkpoint_dir is None:
        return None
    meta_path = os.path.join(checkpoint_dir, "meta.json")
    tab_path = os.path.join(checkpoint_dir, f"{name}.parquet")
    if not (os.path.exists(meta_path) and os.path.exists(tab_path)):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    entry = meta.get(name)
    if not entry or entry.get("fingerprint") != fingerprint:
        return None
    return pd.read_parquet(tab_path)
