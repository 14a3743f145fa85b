"""The calls, from the program's own pass-2 bounds (reference
check_if_within_posterior and add_deleterious_if_covariate_exists,
R/utilities.R:493-513, 651-663; merge_results, R/utilities.R:539-608).

- calls_mismatches (exact): cells whose posterior-predictive check or
  deleterious flag is not what the count against the reported interval
  gives (outside the interval is above the mean when above the upper
  bound; deleterious when that side matches the slope's direction for the
  sample's group), and transcripts whose ppc_samples_failed or
  tot_deleterious_outliers is not the sum of those flags.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import long_table

LIMITS = {"calls_mismatches": 0.0}


def compare(ctx, an) -> dict:
    cols = ctx.cell.config["columns"]
    t, s, y_col = cols["transcript"], cols["sample"], cols["abundance"]
    table = long_table(an.result, t)
    y = table[y_col].to_numpy(np.float64)
    lo, hi = table[".lower"].to_numpy(np.float64), table[".upper"].to_numpy(np.float64)
    ppc = (y >= lo) & (y <= hi)
    cov = dict(zip(ctx.prep.samples, ctx.prep.covariate))
    right = table[s].map(cov).to_numpy() > np.mean(ctx.prep.covariate)
    slope = table["slope_after_outlier_filtering"].to_numpy(np.float64)
    high = ((slope > 0) & right) | ((slope < 0) & ~right)
    deleterious = ~ppc & ((y > hi) == high)
    bad = int(np.sum(table["posterior_predictive_check_succeded"].to_numpy(bool) != ppc))
    bad += int(np.sum(table["deleterious_outliers"].to_numpy(bool) != deleterious))
    per = table.assign(_f=~ppc, _d=deleterious).groupby(t)[["_f", "_d"]].sum()
    res = an.result.set_index(t)
    bad += int(np.sum(res.loc[per.index, "ppc_samples_failed"].to_numpy() != per["_f"].to_numpy()))
    bad += int(np.sum(res.loc[per.index, "tot_deleterious_outliers"].to_numpy()
                      != per["_d"].to_numpy()))
    return {"calls_mismatches": bad}


def control(ctx, an) -> dict:
    return {}
