"""Host preparation: the genes selected and their order, the samples, the
model's dimension, and the TMM exposure of every sample.

- prep_mismatches (exact): checked transcripts that the program left out,
  added or put at another model index than the reference's order (checked
  genes first, by first appearance), samples it left out or added, and 1
  where its fit's dimension is not the reference's.
- exposure_gap: the largest |exposure_rate| difference over the samples
  between the program's table and the reference's float64 TMM; the
  control is the reference's TMM in bfloat16.
"""

from __future__ import annotations

import torch

from benchmark import harness
from benchmark.harness import long_table
from benchmark.reference import prep

# exposure_gap on an H100 at both cells' sizes: at most 5.6e-16 over the
# sound runs' seeds, at least 7.9e-3 from the bfloat16 control; 1e-4 also
# admits a TMM in float32, the configurations' own precision
LIMITS = {"prep_mismatches": 0.0, "exposure_gap": 1e-4}


def _exposure_gap(table, sample, exposure):
    per = table.drop_duplicates(sample).set_index(sample)["exposure_rate"]
    return max(abs(float(per[s]) - exposure[s]) for s in exposure if s in per.index)


def compare(ctx, an) -> dict:
    cols = ctx.cell.config["columns"]
    t, s = cols["transcript"], cols["sample"]
    table = long_table(an.result, t)
    ref_g = {g: i for i, g in enumerate(ctx.prep.genes[:ctx.prep.n_check])}
    got_g = dict(zip(table[t], table["G"]))
    bad = len(set(ref_g) ^ set(got_g)) + sum(got_g[g] != ref_g[g] for g in set(ref_g) & set(got_g))
    bad += len(set(ctx.prep.samples) ^ set(table[s]))
    bad += sum(int(harness.Fit(ctx, an, p).dim != ctx.shape["D"]) for p in (1, 2))
    return {"prep_mismatches": bad, "exposure_gap": _exposure_gap(table, s, ctx.exposure)}


def control(ctx, an) -> dict:
    low = prep.tmm_exposure(ctx.prep, dtype=torch.bfloat16)
    return {"exposure_gap": max(abs(low[k] - ctx.exposure[k]) for k in ctx.exposure)}
