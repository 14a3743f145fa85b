"""Credible-interval plots (reference R/methods.R:408-432, R/utilities.R:408-490);
a copy of ppcseq_tpu/viz/plots.py.

`plot_credible_intervals` takes the nested result of `identify_outliers` and
adds a matplotlib Figure per transcript: per-sample counts with the
posterior-predictive CI as error bars, deleterious outliers in red, point
size proportional to exposure_rate, fill color by the main covariate, y-axis
clipped to max(count, .upper), title = transcript (mirroring the reference's
ggplot).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def produce_plot(
    swd: pd.DataFrame,
    transcript_name: str,
    abundance: str,
    sample: str,
    covariate: str | None,
):
    """One per-transcript figure from its sample_wise_data table."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    x = np.arange(len(swd))
    counts = swd[abundance].to_numpy(dtype=float)

    has_ci = ".lower" in swd.columns
    if has_ci:
        lower = swd[".lower"].to_numpy(dtype=float)
        upper = swd[".upper"].to_numpy(dtype=float)
        if "deleterious_outliers" in swd.columns:
            is_del = swd["deleterious_outliers"].fillna(False).to_numpy(dtype=bool)
        else:
            is_del = np.zeros(len(swd), dtype=bool)
        for sel, color in ((~is_del, "black"), (is_del, "red")):
            if sel.any():
                ax.errorbar(
                    x[sel], (lower[sel] + upper[sel]) / 2,
                    yerr=np.vstack([(upper - lower)[sel] / 2, (upper - lower)[sel] / 2]),
                    fmt="none", ecolor=color, elinewidth=1.2, capsize=0,
                )

    # point size ~ exposure_rate (reference maps size aesthetic to it)
    if "exposure_rate" in swd.columns:
        er = swd["exposure_rate"].to_numpy(dtype=float)
        sizes = 30 + 60 * (er - er.min()) / max(er.max() - er.min(), 1e-9)
    else:
        sizes = np.full(len(swd), 40.0)

    if covariate is not None and covariate in swd.columns:
        levels = sorted(swd[covariate].astype(str).unique())
        cmap = {lev: c for lev, c in zip(levels, plt.cm.Set2.colors)}
        colors = [cmap[str(v)] for v in swd[covariate]]
        for lev in levels:
            ax.scatter([], [], color=cmap[lev], label=str(lev))
        ax.legend(title=covariate, fontsize=8)
    else:
        colors = "black"

    ax.scatter(x, counts, s=sizes, c=colors, edgecolors="black", zorder=3)
    ax.set_xticks(x)
    ax.set_xticklabels(swd[sample].astype(str), rotation=90, fontsize=7)
    ax.set_ylabel(abundance)
    ax.set_xlabel(sample)
    top = max(counts.max(), upper.max() if has_ci else 0)
    ax.set_ylim(None, top * 1.05)
    ax.set_title(transcript_name)
    fig.tight_layout()
    return fig


def plot_credible_intervals(result: pd.DataFrame) -> pd.DataFrame:
    """Add a `plot` column (matplotlib Figures) to an identify_outliers result."""
    from ppcseq_tpu_torch.formula.design import parse_formula

    transcript = result.attrs.get("transcript_column", result.columns[0])
    abundance = result.attrs.get("abundance_column", "value")
    sample = result.attrs.get("sample_column", "sample")
    formula = result.attrs.get("formula", "~ 1")
    covs = parse_formula(formula)
    covariate = covs[0] if covs else None

    plots = [
        produce_plot(row["sample_wise_data"], row[transcript], abundance, sample, covariate)
        for _, row in result.iterrows()
    ]
    out = result.copy()
    out["plot"] = plots
    out.attrs = dict(result.attrs)
    return out
