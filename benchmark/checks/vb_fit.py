"""The two VB fits: the ELBO that the program reports at the variational
distribution it returns, against the reference's at the same
distribution; whether each fit moved its scale from its start; and how far
the returned distribution lies from the reference's own optimum, read
from the reference ELBO's gradient there.

- elbo_z: per pass, (program's ELBO - reference's ELBO) over the standard
  error of the difference: the program's ELBO is a mean over ELBO_SAMPLES
  draws (Stan's ADVI default, reference R/utilities.R:1487-1494), the
  reference's over harness.REFERENCE_DRAWS draws of its own, the log
  densities in float64 (reference/model.py); the worse pass counts. The
  control puts the reference's own ELBO_SAMPLES-draw ELBO in bfloat16 in
  the program's place.
- vb_fits_unimproved (exact): passes whose reference ELBO at the returned
  distribution does not exceed the ELBO at the same mean with every log
  scale at the fit's start (-1), on the same draws.
- vb_scale_score: per pass, |the median over the coordinates of the
  reference ELBO's gradient with respect to log sd| at the returned
  distribution, by the reparametrized gradient in float64 over
  GRADIENT_DRAWS draws. It is 0 at the optimum in every coordinate; where
  the fit's scales target another posterior it reads the mismatch of the
  variance, 1 - sd^2 / sd*^2 (a likelihood gradient scaled by 2 or 1/2:
  ~0.4 to ~0.9). The worse pass counts.
- vb_newton_gain: per pass, the ELBO (nats per gene-wise coordinate,
  the six hyperparameters left out) that one diagonal Newton step from
  the returned distribution would gain by the same gradients, each
  squared mean less its Monte Carlo variance, the mean's curvature taken
  as 1 / sd^2 and the log scale's as 2 (their values at the optimum). It
  reads a fit whose means lie off the reference's optimum, which the
  scale score misses. The worse pass counts.

The likelihood of pass 2 leaves out the cells that the program excluded
after pass 1 (harness.Context.model_arrays); ppc.py holds those
exclusions to pass 1's fit. The bfloat16 control puts the reference's
ELBO in bfloat16 in the program's place, and the program's distribution
rounded to bfloat16 in place of the program's for the two gradient
numbers; faults planted in the program's gradient and steps (faults.py)
give those two their upper readings where the control reads too little.
"""

from __future__ import annotations

import math

import torch

from benchmark import harness
from benchmark.reference.model import log_density, log_density_grad

# Each limit lies between its readings on an H100 at both cells' sizes
# (PERF.md section 2): the largest of the sound runs' seeds, and the
# smallest of the control or of the faults that the number is to catch
LIMITS = {"elbo_z": 35.0, "vb_fits_unimproved": 0.0, "vb_scale_score": 0.2,
          "vb_newton_gain": 2.5}
ELBO_SAMPLES = 100
START_LOG_SD = -1.0
GRADIENT_DRAWS = 200
# The state's first six coordinates are the hyperparameters, which pool
# every gene: their gradient, and the Adam noise in their Newton gain,
# grow with G (at 50,000 genes they outweigh the genes' own), so the gain
# is the gene-wise coordinates' mean.
HYPERPARAMETERS = 6


def _fit(an, p, dev):
    fit = an.result.attrs[f"fit {p}"]
    return (fit.mean.detach().to(dev, torch.float64), fit.log_sd.detach().to(dev, torch.float64),
            float(fit.elbo))


def _elbo(m, log_sd, eps, arr, precision="float64"):
    v = log_density(m + torch.exp(log_sd) * eps, arr, precision)
    D = m.numel()
    return (float(v.mean()) + float(log_sd.sum()) + 0.5 * D * (1 + math.log(2 * math.pi)),
            float(v.std()))


def _noise(ctx, n, D):
    return torch.randn((n, D), generator=ctx.generator, device=ctx.device, dtype=torch.float64)


def gradient_scores(m, log_sd, eps, arr) -> tuple[float, float]:
    """(scale score, Newton gain per coordinate) of q = N(m, exp(log_sd)^2)
    from the reparametrized gradients of the ELBO at the draws m + sd * eps."""
    sd = torch.exp(log_sd)
    R = eps.shape[0]
    g = log_density_grad(m + sd * eps, arr)
    t = g * sd * eps + 1.0  # the gradient with respect to log sd, draw by draw
    g1, t1 = g.mean(0), t.mean(0)
    var_g, var_t = g.var(0) / R, t.var(0) / R
    gain = (g1 * g1 - var_g) * sd * sd / 2 + (t1 * t1 - var_t) / 4
    return abs(float(t1.median())), float(gain[HYPERPARAMETERS:].mean())


def compare(ctx, an) -> dict:
    R = harness.REFERENCE_DRAWS
    z, unimproved, scale, gain = 0.0, 0, 0.0, 0.0
    for p in (1, 2):
        arr = ctx.model_arrays(an, p)
        m, log_sd, elbo = _fit(an, p, ctx.device)
        eps = _noise(ctx, R, m.numel())
        ref, sd = _elbo(m, log_sd, eps, arr)
        z = max(z, abs(elbo - ref) / (sd * math.sqrt(1 / ELBO_SAMPLES + 1 / R)))
        start, _ = _elbo(m, torch.full_like(log_sd, START_LOG_SD), eps, arr)
        unimproved += int(not ref > start)
        s, g = gradient_scores(m, log_sd, _noise(ctx, GRADIENT_DRAWS, m.numel()), arr)
        scale, gain = max(scale, s), max(gain, g)
    return {"elbo_z": z, "vb_fits_unimproved": unimproved, "vb_scale_score": scale,
            "vb_newton_gain": gain}


def control(ctx, an) -> dict:
    R = harness.REFERENCE_DRAWS
    z, scale, gain = 0.0, 0.0, 0.0
    for p in (1, 2):
        arr = ctx.model_arrays(an, p)
        m, log_sd, _ = _fit(an, p, ctx.device)
        ref, sd = _elbo(m, log_sd, _noise(ctx, R, m.numel()), arr)
        low, _ = _elbo(m, log_sd, _noise(ctx, ELBO_SAMPLES, m.numel()), arr, "bfloat16")
        z = max(z, abs(low - ref) / (sd * math.sqrt(1 / ELBO_SAMPLES + 1 / R)))
        s, g = gradient_scores(_bf16(m), _bf16(log_sd),
                               _noise(ctx, GRADIENT_DRAWS, m.numel()), arr)
        scale, gain = max(scale, s), max(gain, g)
    return {"elbo_z": z, "vb_scale_score": scale, "vb_newton_gain": gain}


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float64)
