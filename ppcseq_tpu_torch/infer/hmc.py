"""Jittered-trajectory HMC on a flat [chains, D] state, in torch
(ppcseq_tpu/infer/hmc.py:47-496).

- L_t ~ Uniform{ceil(jitter_low * L), ..., L}, shared by all chains in a
  draw, so a draw costs exactly L_t gradient evaluations; the jitter breaks
  the periodicity pathologies of fixed-L HMC.
- A Metropolis accept per chain; |energy change| > 1000 is a divergence
  (the proposal is rejected).
- Step size by dual averaging during warmup (gamma 0.05, t0 10, kappa 0.75,
  mu = log(10 * step_size0)), then fixed at the averaged value.
- A fixed diagonal inverse mass, normally the ADVI warm start's variances.
- With adapt_trajectory=True, ChEES/SNAPER (Sountsov & Hoffman 2022): the
  warmup also ascends the trajectory length T by Adam on the squared change
  of the squared projection on the leading principal component of the
  whitened chain batch (tracked by Oja's rule), with T jittered by a Halton
  sequence; the draws then run at a bucketed leapfrog cap.

The log density takes a batch: `log_density(theta[chains, D]) -> [chains]`
(plus `data`, when given); gradients come from torch.autograd of the sum.
A non-finite log density becomes -inf and a non-finite gradient 0. The log
density, the energies, their differences and the accept probabilities are
float64 whatever the state's dtype: at a log joint of -3e7 float32 rounds
an energy difference to nats.

The loop runs eagerly, one leapfrog at a time (JAX ran it as one compiled
scan). The plain sampler does not wait on the device: L_t is drawn on the
host from a CPU generator, and the accept and step-size state stay on the
device until the end of the run. The ChEES warmup reads its L_t from the
device once per draw; its sampler reads all the draws' L_t at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ppcseq_tpu_torch.utils.device import resolve_device

MAX_DELTA_ENERGY = 1000.0
DA_GAMMA, DA_T0, DA_KAPPA = 0.05, 10.0, 0.75
ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 0.05, 0.9, 0.999, 1e-8

# leapfrog caps the trajectory adaptation's sampler can select
_L_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64)


def _halton_seq(n, base=2):
    """Halton low-discrepancy sequence, host-side, values in (0, 1)."""
    out = np.empty(n)
    for k in range(n):
        f, r, i = 1.0, 0.0, k + 1
        while i > 0:
            f /= base
            r += f * (i % base)
            i //= base
        out[k] = r
    return out


@dataclass
class HMCResult:
    draws: torch.Tensor  # [chains, num_draws, D], left on the device
    accept_prob: np.ndarray  # [chains, num_draws]
    divergences: np.ndarray  # [chains] count in the sampling phase
    step_size: float
    num_leapfrog: int  # executed leapfrog steps, all chains, warmup + sampling
    trajectory_length: float | None = None  # adapted T (adapt_trajectory=True)


class GeneratorDraws:
    """The random numbers of the samplers' transitions, from one
    torch.Generator: `momentum(shape)` standard normals and `uniform(n,
    what)` uniforms on [0, 1), `what` naming the decision ("accept",
    "direction", "leaf", "merge"). Another object with these two methods
    can replay a reference's random stream."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.generator, self.device, self.dtype = generator, device, dtype

    def momentum(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device, dtype=self.dtype)

    def uniform(self, n: int, what: str):
        return torch.rand((n,), generator=self.generator, device=self.device, dtype=self.dtype)


def logp_and_grad(log_density, z, data=None):
    """(lp[chains] float64, grad[chains, D]) with non-finite lp -> -inf and
    non-finite gradient entries -> 0 (hmc.py:80-88)."""
    with torch.enable_grad():
        zg = z.detach().requires_grad_(True)
        lp = log_density(zg) if data is None else log_density(zg, data)
        (g,) = torch.autograd.grad(lp.sum(), zg)
    lp = lp.detach().to(torch.float64)
    lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -math.inf))
    g = torch.where(torch.isfinite(g), g.to(z.dtype), torch.zeros_like(z))
    return lp, g


def leapfrog(z, r, g, eps, inv_mass, grad_fn):
    """One leapfrog step: (z, r, g, lp) after it; grad_fn(z) -> (lp, g).
    `eps` is a scalar or a [chains, 1] column, `inv_mass` [D] or [chains, D]."""
    r_half = r + 0.5 * eps * g
    z1 = z + eps * (r_half * inv_mass)
    lp1, g1 = grad_fn(z1)
    return z1, r_half + 0.5 * eps * g1, g1, lp1


def kinetic(r, inv_mass):
    """0.5 r' M^-1 r per chain, summed in float64: r[chains, D] -> [chains]."""
    return 0.5 * torch.sum(r * r * inv_mass, dim=-1, dtype=torch.float64)


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


def _energy_change(lp0, r0, lp1, r1, inv_mass):
    """H(end) - H(start) in float64, NaN -> +inf."""
    delta = (-lp1 + kinetic(r1, inv_mass)) - (-lp0 + kinetic(r0, inv_mass))
    return torch.where(torch.isnan(delta), torch.full_like(delta, math.inf), delta)


def _snapshot_transition(grad_fn, z, lp, g, eps, L_t, inv_mass, draws):
    """One ChEES-path draw of L_t leapfrogs from momenta
    draws.momentum / sqrt(inv_mass) (hmc.py:192-229): a divergence is
    rejected and reported with accept probability 0. Returns (z, lp, g,
    accept_prob, diverging, z_end, r_end), z_end/r_end the trajectory's
    end before the accept."""
    r0 = draws.momentum(z.shape) / torch.sqrt(inv_mass)
    zp, rp, gp, lpp = z, r0, g, lp
    for _ in range(L_t):
        zp, rp, gp, lpp = leapfrog(zp, rp, gp, eps, inv_mass, grad_fn)
    delta = _energy_change(lp, r0, lpp, rp, inv_mass)
    diverging = delta > MAX_DELTA_ENERGY
    accept_prob = torch.where(diverging, torch.zeros_like(delta),
                              torch.clamp(torch.exp(-delta), max=1.0))
    take = (draws.uniform(z.shape[0], "accept") < accept_prob) & ~diverging
    z_new = torch.where(take[:, None], zp, z)
    lp_new = torch.where(take, lpp, lp)
    g_new = torch.where(take[:, None], gp, g)
    return z_new, lp_new, g_new, accept_prob, diverging, zp, rp


def _trajectory_steps(u, T, eps, cap):
    """clip(ceil(u T / eps), 1, cap) on the device, in the state's dtype."""
    return torch.clamp(torch.ceil(u * T / eps), 1, cap).to(torch.int64)


def _chees_warmup(grad_fn, z0, inv_mass, mu, num_warmup, L_cap, target_accept, draws, u_seq):
    """ChEES/SNAPER warmup (hmc.py:234-336): dual averaging on the step size
    and Adam ascent on log T, T jittered by u_seq[i]. Returns (z, lp, g,
    eps, T, leapfrogs per chain); eps and T are 0-dim tensors in the state's
    dtype, the adaptation runs in float64."""
    dtype = z0.dtype
    num_chains = z0.shape[0]
    sqrt_inv_mass = torch.sqrt(inv_mass)
    w = 1.0 / sqrt_inv_mass  # whitening
    lp, g = grad_fn(z0)
    f64 = dict(dtype=torch.float64, device=z0.device)
    le0 = torch.tensor(mu - math.log(10.0), **f64)
    lT0 = le0 + math.log(0.5 * L_cap)  # start at half the cap
    log_eps, log_eps_avg, h_sum = le0, le0, torch.zeros((), **f64)
    log_T, log_T_avg = lT0, lT0
    m_adam, v_adam = torch.zeros((), **f64), torch.zeros((), **f64)
    pc = z0[0] - z0[-1]  # initial direction from the chain spread
    pc = pc / torch.clamp(torch.linalg.vector_norm(pc), min=1e-20)
    z, total = z0, 0

    def centered(x):
        return x - x.mean(dim=0, keepdim=True)

    for i in range(num_warmup):
        eps = torch.exp(log_eps).to(dtype)
        u = u_seq[i]
        L_t = int(_trajectory_steps(u, torch.exp(log_T).to(dtype), eps, L_cap))
        total += L_t
        z1, lp, g, accept, _, zp, rp = _snapshot_transition(grad_fn, z, lp, g, eps, L_t,
                                                            inv_mass, draws)
        xw_c, xwp_c = centered(z * w), centered(zp * w)
        vw_p = (rp * inv_mass) * w  # whitened end velocity
        # Oja's rule on the post-accept batch: pc tracks the leading
        # eigenvector of the whitened posterior covariance (sums, not
        # matmuls, so TF32 cannot touch them)
        x1w_c = centered(z1 * w)
        cov_pc = torch.sum(x1w_c * torch.sum(x1w_c * pc, dim=1, keepdim=True), dim=0) / num_chains
        pc_new = pc + (3.0 / (i + 10.0)) * cov_pc
        pc = pc_new / torch.clamp(torch.linalg.vector_norm(pc_new), min=1e-20)
        # SNAPER criterion on the principal projection
        proj0 = torch.sum(xw_c * pc, dim=1)
        proj1 = torch.sum(xwp_c * pc, dim=1)
        projv = torch.sum(vw_p * pc, dim=1)
        h = proj1 * proj1 - proj0 * proj0
        dh = 2.0 * proj1 * projv
        wsum = torch.clamp(torch.sum(accept), min=1e-6)
        # d/dlog T with the jitter chain rule (T_t = u T)
        grad = torch.sum(accept * h * dh) / wsum * u * torch.exp(log_T)
        grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
        count = i + 1.0
        m_adam = ADAM_B1 * m_adam + (1 - ADAM_B1) * grad
        v_adam = ADAM_B2 * v_adam + (1 - ADAM_B2) * grad * grad
        m_hat = m_adam / (1 - ADAM_B1**count)
        v_hat = v_adam / (1 - ADAM_B2**count)
        log_T = log_T + ADAM_LR * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)  # ascent
        log_T = torch.minimum(torch.maximum(log_T, torch.log(eps)), torch.log(eps * L_cap))
        eta = count ** (-DA_KAPPA)
        log_T_avg = eta * log_T + (1 - eta) * log_T_avg
        log_eps, log_eps_avg, h_sum = dual_average(log_eps_avg, h_sum, torch.mean(accept), i,
                                                   mu, target_accept)
        z = z1
    return z, lp, g, torch.exp(log_eps_avg).to(dtype), torch.exp(log_T_avg).to(dtype), total


def _chees_sample(grad_fn, z, lp, g, eps, T, inv_mass, num_draws, L_static, draws, u_seq):
    """The draws after the ChEES warmup (hmc.py:339-363): draw k takes
    clip(ceil(u_seq[k] T / eps), 1, L_static) leapfrogs, all read from the
    device at once. Returns (draws [num_draws, chains, D], accept, diverging,
    leapfrogs per chain)."""
    steps = _trajectory_steps(u_seq, T, eps, L_static).tolist()
    out = torch.empty((num_draws,) + tuple(z.shape), dtype=z.dtype, device=z.device)
    accepts, divs = [], []
    for k in range(num_draws):
        z, lp, g, accept, div, _, _ = _snapshot_transition(grad_fn, z, lp, g, eps, steps[k],
                                                           inv_mass, draws)
        out[k] = z
        accepts.append(accept)
        divs.append(div)
    return out, accepts, divs, sum(steps)


def _stack_np(rows, num_chains):
    """[chains, n] host array of n per-draw [chains] tensors."""
    return torch.stack(rows, dim=1).cpu().numpy() if rows else np.zeros((num_chains, 0))


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
    from ADVI). With adapt_trajectory=True the warmup adapts the trajectory
    length by ChEES/SNAPER and `num_leapfrog` is the cap on a draw's
    leapfrogs. Returns the post-warmup draws stacked [chains, num_draws, D].
    `device` defaults to the card and must exist (utils/device.resolve_device).
    """
    if mesh is not None:
        raise NotImplementedError("mesh is not ported yet (ROADMAP.md, queue 1, item 6)")
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

    mu = math.log(10.0 * step_size0)
    if adapt_trajectory:
        return _run_chees(grad_fn, z, inv_mass, mu, num_warmup, num_draws, L, target_accept,
                          GeneratorDraws(generator, device, dtype))

    def transition(z, lp, g, eps):
        L_t = int(torch.randint(L_min, L + 1, (1,), generator=length_gen))
        r0 = torch.randn(z.shape, generator=generator, **kw) / sqrt_inv_mass[None, :]
        zp, rp, gp, lpp = z, r0, g, lp
        for _ in range(L_t):
            zp, rp, gp, lpp = leapfrog(zp, rp, gp, eps, inv_mass, grad_fn)
        delta = _energy_change(lp, r0, lpp, rp, inv_mass)
        diverging = delta > MAX_DELTA_ENERGY
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        u = torch.rand((num_chains,), generator=generator, **kw)
        take = (u < accept_prob) & ~diverging
        z = torch.where(take[:, None], zp, z)
        lp = torch.where(take, lpp, lp)
        g = torch.where(take[:, None], gp, g)
        return z, lp, g, accept_prob, diverging, L_t

    lp, g = grad_fn(z)
    log_eps = torch.tensor(mu - math.log(10.0), device=device, dtype=torch.float64)
    log_eps_avg = log_eps.clone()
    h_sum = torch.zeros((), device=device, dtype=torch.float64)
    executed = 0
    for i in range(num_warmup):
        z, lp, g, accept, _, L_t = transition(z, lp, g, torch.exp(log_eps).to(dtype))
        log_eps, log_eps_avg, h_sum = dual_average(
            log_eps_avg, h_sum, torch.mean(accept), i, mu, target_accept
        )
        executed += L_t

    eps = torch.exp(log_eps_avg).to(dtype)
    draws = torch.empty((num_draws, num_chains, D), **kw)
    accepts, divs = [], []
    for k in range(num_draws):
        z, lp, g, accept, div, L_t = transition(z, lp, g, eps)
        draws[k] = z
        accepts.append(accept)
        divs.append(div)
        executed += L_t

    return HMCResult(
        draws=draws.transpose(0, 1).contiguous(),
        accept_prob=_stack_np(accepts, num_chains),
        divergences=_stack_np(divs, num_chains).sum(axis=1),
        step_size=float(eps),
        num_leapfrog=executed * num_chains,
    )


def _run_chees(grad_fn, z0, inv_mass, mu, num_warmup, num_draws, L_cap, target_accept, draws):
    """The adapt_trajectory=True branch of run_hmc (hmc.py:455-496): the
    ChEES warmup, then the draws at the smallest _L_BUCKETS cap that holds
    the adapted T / eps (L_cap if none)."""
    kw = dict(device=z0.device, dtype=z0.dtype)
    num_chains = z0.shape[0]
    u_warm = torch.as_tensor(_halton_seq(num_warmup), **kw)
    z, lp, g, eps, T, warm_lf = _chees_warmup(grad_fn, z0, inv_mass, mu, num_warmup, L_cap,
                                              target_accept, draws, u_warm)
    eps_f, T_f = float(eps), float(T)
    L_star = max(1, int(np.ceil(T_f / max(eps_f, 1e-12))))
    bucket = next((b for b in _L_BUCKETS if b >= min(L_star, L_cap)), L_cap)
    u_draws = torch.as_tensor(_halton_seq(num_draws, base=3), **kw)
    out, accepts, divs, samp_lf = _chees_sample(grad_fn, z, lp, g, eps, T, inv_mass, num_draws,
                                                bucket, draws, u_draws)
    return HMCResult(
        draws=out.transpose(0, 1).contiguous(),
        accept_prob=_stack_np(accepts, num_chains),
        divergences=_stack_np(divs, num_chains).sum(axis=1),
        step_size=eps_f,
        num_leapfrog=(warm_lf + samp_lf) * num_chains,
        trajectory_length=T_f,
    )
