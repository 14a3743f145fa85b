"""The two MCMC fits: the program's posterior draws held to the
reference's float64 log density by two of Stein's identities, which hold
under the posterior whatever its shape: E[d log p / d theta_d] = 0 and
E[(theta_d - E theta_d) d log p / d theta_d] = -1 for every coordinate d.

- mcmc_grad_z: per pass, the root mean square over the coordinates of
  z_d, the mean over the chains of each chain's mean gradient at its
  draws over its standard error across the chains (the chains are
  independent; a chain's draws are not). Draws from the posterior give
  z_d ~ N(0, 1) and a root mean square near 1; draws from another
  posterior (one with half of the samples, say) read their shift in
  standard errors. The worse pass counts.
- mcmc_scale_score: per pass, |the median over the coordinates of the
  mean over the draws of (theta_d - mean_d) d log p / d theta_d, plus 1|:
  0 under the posterior, the draws' variance over the posterior's less 1
  where their spread is off (a likelihood tempered by 1/2: ~0.4). The
  worse pass counts.

The gradient is the reference's (reference/model.py) at the program's
draws, with pass 2's likelihood leaving out the cells the program
excluded after pass 1 (harness.Context.model_arrays). The control puts
the program's draws rounded to bfloat16 in their place; faults planted in
the program's likelihood (faults.py) give the upper readings where the
control reads too little.
"""

from __future__ import annotations

import math

import torch

from benchmark import harness
from benchmark.reference.model import log_density_grad

# Each limit lies between its readings on an H100 at the cell's size
# (PERF.md section 2): the largest of the sound runs' seeds, and the
# smallest of the faults that the number is to catch
LIMITS = {"mcmc_grad_z": 2.5, "mcmc_scale_score": 0.08}


def scores(draws, arr) -> tuple[float, float]:
    """(grad z, scale score) of draws[chains, draws per chain, D]."""
    C, N, D = draws.shape
    g = log_density_grad(draws.reshape(C * N, D), arr).reshape(C, N, D)
    per_chain = g.mean(1)
    z = per_chain.mean(0) / (per_chain.std(0) / math.sqrt(C))
    centred = draws - draws.mean((0, 1))
    stein = (centred * g).mean((0, 1)) + 1.0
    return float(torch.sqrt(torch.mean(z * z))), abs(float(stein.median()))


def _readings(ctx, an, round_to=None) -> dict:
    z, scale = 0.0, 0.0
    for p in (1, 2):
        draws = harness.Fit(ctx, an, p).draws
        if round_to is not None:
            draws = draws.to(round_to).to(torch.float64)
        zp, sp = scores(draws, ctx.model_arrays(an, p))
        z, scale = max(z, zp), max(scale, sp)
    return {"mcmc_grad_z": z, "mcmc_scale_score": scale}


def compare(ctx, an) -> dict:
    return _readings(ctx, an)


def control(ctx, an) -> dict:
    return _readings(ctx, an, torch.bfloat16)
