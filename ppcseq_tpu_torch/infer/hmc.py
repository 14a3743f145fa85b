"""Jittered-trajectory HMC on a flat [chains, D] state, in torch
(ppcseq_tpu/infer/hmc.py:74-175, 366-453).

- L_t ~ Uniform{ceil(jitter_low * L), ..., L}, shared by all chains in a
  draw, so a draw costs exactly L_t gradient evaluations; the jitter breaks
  the periodicity pathologies of fixed-L HMC.
- A Metropolis accept per chain; |energy change| > 1000 is a divergence
  (the proposal is rejected).
- Step size by dual averaging during warmup (gamma 0.05, t0 10, kappa 0.75,
  mu = log(10 * step_size0)), then fixed at the averaged value.
- A fixed diagonal inverse mass, normally the ADVI warm start's variances.

The log density takes a batch: `log_density(theta[chains, D]) -> [chains]`
(plus `data`, when given); gradients come from torch.autograd of the sum.
A non-finite log density becomes -inf and a non-finite gradient 0.

The loop runs eagerly, one leapfrog at a time (JAX ran it as one compiled
scan). It does not wait on the device: L_t is drawn on the host from a CPU
generator, and the accept and step-size state stay on the device until the
end of the run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ppcseq_tpu_torch.utils.device import resolve_device

MAX_DELTA_ENERGY = 1000.0
DA_GAMMA, DA_T0, DA_KAPPA = 0.05, 10.0, 0.75


@dataclass
class HMCResult:
    draws: torch.Tensor  # [chains, num_draws, D], left on the device
    accept_prob: np.ndarray  # [chains, num_draws]
    divergences: np.ndarray  # [chains] count in the sampling phase
    step_size: float
    num_leapfrog: int  # executed leapfrog steps, all chains, warmup + sampling


def logp_and_grad(log_density, z, data=None):
    """(lp[chains], grad[chains, D]) with non-finite lp -> -inf and
    non-finite gradient entries -> 0 (hmc.py:80-88)."""
    with torch.enable_grad():
        zg = z.detach().requires_grad_(True)
        lp = log_density(zg) if data is None else log_density(zg, data)
        (g,) = torch.autograd.grad(lp.sum(), zg)
    lp = lp.detach().to(z.dtype)
    lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -math.inf))
    g = torch.where(torch.isfinite(g), g.to(z.dtype), torch.zeros_like(z))
    return lp, g


def leapfrog(z, r, g, eps, inv_mass, grad_fn):
    """One leapfrog step: (z, r, g, lp) after it; grad_fn(z) -> (lp, g)."""
    r_half = r + 0.5 * eps * g
    z1 = z + eps * (r_half * inv_mass[None, :])
    lp1, g1 = grad_fn(z1)
    return z1, r_half + 0.5 * eps * g1, g1, lp1


def dual_average(log_eps_avg, h_sum, accept_mean, i, mu, target_accept):
    """Dual-averaging update after warmup draw i (0-based): returns
    (log_eps, log_eps_avg, h_sum) (hmc.py:134-146)."""
    count = i + 1.0
    w = 1.0 / (count + DA_T0)
    h_sum = (1 - w) * h_sum + w * (target_accept - accept_mean)
    log_eps = mu - math.sqrt(count) / DA_GAMMA * h_sum
    eta = count ** (-DA_KAPPA)
    log_eps_avg = eta * log_eps + (1 - eta) * log_eps_avg
    return log_eps, log_eps_avg, h_sum


def run_hmc(
    log_density,
    dim: int,
    generator: torch.Generator,
    *,
    data=None,
    num_chains: int = 128,
    num_warmup: int = 100,
    num_draws: int = 100,
    num_leapfrog: int = 32,
    jitter_low: float = 0.4,
    target_accept: float = 0.8,
    init_theta=None,
    init_jitter: float = 0.1,
    inv_mass=None,
    step_size0: float = 0.05,
    mesh=None,
    adapt_trajectory: bool = False,
    device="cuda",
    dtype=torch.float32,
) -> HMCResult:
    """Run jittered-trajectory HMC on a flat [D] unconstrained state.

    `generator` (on `device`) drives the initial jitter, the momenta and the
    accept draws; a CPU generator seeded from it draws the trajectory
    lengths. `inv_mass` is the diagonal inverse mass (e.g. exp(2*log_sd)
    from ADVI). Returns the post-warmup draws stacked [chains, num_draws, D].
    `device` defaults to the card and must exist (utils/device.resolve_device).
    """
    if adapt_trajectory:
        raise NotImplementedError(
            "adapt_trajectory=True (ChEES) is not ported yet (ROADMAP.md, queue 1, item 9)"
        )
    if mesh is not None:
        raise NotImplementedError("mesh is not ported yet (ROADMAP.md, queue 1, item 12)")
    device = resolve_device(device)
    D = int(dim)
    L = int(num_leapfrog)
    L_min = max(1, int(np.ceil(jitter_low * L)))
    kw = dict(device=device, dtype=dtype)
    inv_mass = (torch.ones(D, **kw) if inv_mass is None
                else torch.as_tensor(inv_mass, **kw))
    sqrt_inv_mass = torch.sqrt(inv_mass)
    length_gen = torch.Generator().manual_seed(
        int(torch.randint(2**62, (1,), generator=generator, device=device))
    )

    if init_theta is None:
        z = 4.0 * torch.rand((num_chains, D), generator=generator, **kw) - 2.0
    else:
        base = torch.as_tensor(init_theta, **kw)
        z = base[None, :] + init_jitter * torch.randn((num_chains, D), generator=generator, **kw)

    def grad_fn(x):
        return logp_and_grad(log_density, x, data)

    def kinetic(r):
        return 0.5 * torch.sum(r * r * inv_mass[None, :], dim=1)

    def transition(z, lp, g, eps):
        L_t = int(torch.randint(L_min, L + 1, (1,), generator=length_gen))
        r0 = torch.randn(z.shape, generator=generator, **kw) / sqrt_inv_mass[None, :]
        energy0 = -lp + kinetic(r0)
        zp, rp, gp, lpp = z, r0, g, lp
        for _ in range(L_t):
            zp, rp, gp, lpp = leapfrog(zp, rp, gp, eps, inv_mass, grad_fn)
        delta = -lpp + kinetic(rp) - energy0
        delta = torch.where(torch.isnan(delta), torch.full_like(delta, math.inf), delta)
        diverging = delta > MAX_DELTA_ENERGY
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        u = torch.rand((num_chains,), generator=generator, **kw)
        take = (u < accept_prob) & ~diverging
        z = torch.where(take[:, None], zp, z)
        lp = torch.where(take, lpp, lp)
        g = torch.where(take[:, None], gp, g)
        return z, lp, g, accept_prob, diverging, L_t

    lp, g = grad_fn(z)
    mu = math.log(10.0 * step_size0)
    log_eps = torch.tensor(mu - math.log(10.0), **kw)
    log_eps_avg = log_eps.clone()
    h_sum = torch.zeros((), **kw)
    executed = 0
    for i in range(num_warmup):
        z, lp, g, accept, _, L_t = transition(z, lp, g, torch.exp(log_eps))
        log_eps, log_eps_avg, h_sum = dual_average(
            log_eps_avg, h_sum, torch.mean(accept), i, mu, target_accept
        )
        executed += L_t

    eps = torch.exp(log_eps_avg)
    draws = torch.empty((num_draws, num_chains, D), **kw)
    accepts, divs = [], []
    for k in range(num_draws):
        z, lp, g, accept, div, L_t = transition(z, lp, g, eps)
        draws[k] = z
        accepts.append(accept)
        divs.append(div)
        executed += L_t

    accept_np = torch.stack(accepts, dim=1).cpu().numpy() if accepts else np.zeros((num_chains, 0))
    div_np = torch.stack(divs, dim=1).cpu().numpy() if divs else np.zeros((num_chains, 0))
    return HMCResult(
        draws=draws.transpose(0, 1).contiguous(),
        accept_prob=accept_np,
        divergences=div_np.sum(axis=1),
        step_size=float(eps),
        num_leapfrog=executed * num_chains,
    )
