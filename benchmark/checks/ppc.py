"""The posterior-predictive stage: pass 2's credible intervals, pass 1's
exclusions and both passes' slopes, each against the exact predictive
distribution of the fit the program returned (reference/ci.py).

- ppc_off (exact): among harness.PPC_CELLS checked cells drawn from the seed,
  pass-2 bounds that lie where the order statistics of the program's
  simulated counts could not plausibly lie (probability below ci.ALPHA);
  cells that pass 1 excluded although their count could not be a
  deleterious outlier of pass 1's interval, or kept although it could be
  nothing else; and checked genes whose reported slope (the mean of 1,000
  posterior draws of alpha_sub_1, reference R/utilities.R:1372, 1531) is
  further from the fit's mean than ci.Z_ALPHA standard errors.

The predictive of a cell is the mixture over draws of the returned fit
(harness.REFERENCE_DRAWS draws of a VB fit's distribution, every draw of
an MCMC fit) of NB2(exp(exposure + X alpha), phi), phi = exp(-sigma_raw)
times pass 2's truncation compensation (0.7352941, reference
R/methods.R:339) in pass 2. Each pass simulates
max(10 / threshold, 1000) counts per cell (reference R/methods.R:155-167).
The bf16 control cannot move this stage beyond its own Monte Carlo noise
(PERF.md), so the number is a count at a false-alarm rate, not a
tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness
from benchmark.harness import long_table
from benchmark.reference import ci

LIMITS = {"ppc_off": 0.0}
TRUNCATION_COMPENSATION = 0.7352941
POSTERIOR_DRAWS = 1000  # the program's own posterior sample (R/utilities.R:1372)


def _draws(ctx, an, p, g_idx, R):
    """(eta [R, S, cells-genes], phi [R, genes], slope mean, slope sd) for
    checked genes g_idx under pass p's fit (harness.Fit: R draws of a VB
    fit, every draw of an MCMC fit)."""
    fit = harness.Fit(ctx, an, p)
    G, K, C = ctx.shape["G"], ctx.shape["K"], ctx.shape["C"]
    idx = torch.as_tensor(g_idx, device=ctx.device)
    alpha = [fit.sample(6 + idx, R)]
    slope = (torch.zeros(len(g_idx), dtype=torch.float64), torch.zeros(len(g_idx)))
    if C >= 2:
        a1 = 6 + 2 * G + idx
        alpha.append(fit.sample(a1, R))
        slope = (fit.mean[a1].cpu(), fit.sd[a1].cpu())
    for c in range(2, C):
        alpha.append(fit.sample(6 + 2 * G + K + (c - 2) * K + idx, R))
    sigma_raw = fit.sample(6 + G + idx, R)
    X = torch.as_tensor(ctx.prep.X, dtype=torch.float64, device=ctx.device)
    expo = torch.as_tensor([ctx.exposure[s] for s in ctx.prep.samples], dtype=torch.float64,
                           device=ctx.device)
    eta = expo[None, :, None] + sum(X[None, :, c, None] * alpha[c][:, None, :]
                                    for c in range(C))
    return eta.cpu().numpy(), torch.exp(-sigma_raw).cpu().numpy(), slope


def compare(ctx, an) -> dict:
    cols = ctx.cell.config["columns"]
    t, s, y_col = cols["transcript"], cols["sample"], cols["abundance"]
    table = long_table(an.result, t)
    rng = np.random.default_rng(int(ctx.generator.initial_seed()) % 2**32)
    n_cells = min(len(table), harness.PPC_CELLS)
    cells = table.iloc[np.sort(rng.choice(len(table), n_cells, replace=False))]
    R = harness.REFERENCE_DRAWS
    genes = sorted(set(table["G"]))
    col_of = {g: j for j, g in enumerate(genes)}
    s_of = {n: i for i, n in enumerate(ctx.prep.samples)}
    si = cells[s].map(s_of).to_numpy()
    gj = cells["G"].map(col_of).to_numpy()
    y = cells[y_col].to_numpy(np.float64)
    off = 0

    cov = ctx.prep.covariate
    right = cov[si] > cov.mean()
    ex = an.result.attrs["pass1_excluded"]
    excluded = set(zip(ex[s], ex[t]))
    for p in (1, 2):
        eta, phi, (sm, ssd) = _draws(ctx, an, p, genes, R)
        mu = np.exp(eta[:, si, gj])
        ph = phi[:, gj] * (TRUNCATION_COMPENSATION if p == 2 else 1.0)
        col = "slope_before_outlier_filtering" if p == 1 else "slope_after_outlier_filtering"
        per_gene = table.drop_duplicates("G").set_index("G")[col]
        got = np.array([per_gene[g] for g in genes])
        se = ssd.numpy() / np.sqrt(POSTERIOR_DRAWS)
        off += int(np.sum(np.abs(got - sm.numpy()) > ci.Z_ALPHA * se + 1e-6))
        if p == 2:
            for b_col, level in ((".lower", ctx.thr2), (".upper", 1 - ctx.thr2)):
                b = cells[b_col].to_numpy(np.float64)
                off += int(np.sum(ci.bound_off(b, level, ctx.n2, mu, ph, POSTERIOR_DRAWS)))
        else:
            slope1 = cells[col].to_numpy(np.float64)
            high = ((slope1 > 0) & right) | ((slope1 < 0) & ~right)
            below, above, inside = ci.outside_plausible(y, ctx.thr1, ctx.n1, mu, ph,
                                                        POSTERIOR_DRAWS)
            can_be = (below & ~high) | (above & high)
            can_be_other = inside | (below & high) | (above & ~high)
            was = np.array([(a, b) in excluded for a, b in zip(cells[s], cells[t])])
            off += int(np.sum(was & ~can_be) + np.sum(~was & ~can_be_other))
    return {"ppc_off": off}


def control(ctx, an) -> dict:
    return {}
