"""Multi-chain NUTS on a flat [chains, D] state, in torch
(ppcseq_tpu/infer/nuts.py).

Multinomial NUTS (Hoffman & Gelman 2014; Betancourt 2017) with the
generalized U-turn criterion, built iteratively with O(max_depth) momentum
checkpoints (Phan et al., arXiv:1912.11554), and Stan's windowed warmup:
dual-averaged step size (target accept 0.8) and a diagonal Welford mass
matrix over expanding windows (init 75, term 50, base window 25), each
window's end restarting the dual averaging at the current step size.

JAX vmaps a per-chain while_loop. Here the chains run in lockstep:
- the trajectory loop runs over depth while any chain is still building;
- inside it the subtree loop runs over leaves while any chain is still
  active in that subtree. Every active chain is at the same leaf index, so
  the checkpoint slots of a leaf are host integers (`_leaf_to_ckpt`) and the
  U-turn test over them is one masked tensor op over [chains, slots, D];
- each chain keeps its own direction, step size and inverse mass, as
  device tensors;
- a chain that is done is still evaluated in the batched log density (one
  launch for all chains), but its state never changes.
Deciding "any chain still active" reads one boolean from the device: one
host sync per leaf and per depth, counted in NUTSResult.host_syncs. Each
chain's own leapfrogs (`num_leapfrog`) are counted apart from the lockstep
ones (`lockstep_leapfrog`, leaf steps x chains): their ratio is what the
lockstep costs.

The log density, the energies and every quantity derived from energy
differences (multinomial weights, accept statistics, the divergence test)
are float64; the state, momenta and gradients are in the state's dtype.
The random numbers come from a `draws` object (infer/hmc.GeneratorDraws by
default), which a test can replace to replay another random stream.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ppcseq_tpu_torch.infer.hmc import GeneratorDraws, leapfrog, logp_and_grad
from ppcseq_tpu_torch.utils.device import resolve_device

MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold
F64 = torch.float64


def _dot(a, b):
    """Per-chain dot product over the last axis, summed in float64."""
    return torch.sum(a * b, dim=-1, dtype=F64)


def _energy(logp, r, inv_mass):
    """-logp + 0.5 r' M^-1 r per chain, in float64."""
    return -logp.to(F64) + 0.5 * _dot(r, inv_mass * r)


def _is_turning(r_sum, r_first, r_last, inv_mass):
    """Generalized U-turn: rho against the velocities at both subtree ends.
    Reduces over the last axis; the others broadcast."""
    return (_dot(r_sum, inv_mass * r_first) <= 0) | (_dot(r_sum, inv_mass * r_last) <= 0)


def _leaf_to_ckpt(i: int) -> tuple[int, int]:
    """Checkpoint slot range (lo, hi) of leaf i (0-based) of a subtree."""
    idx_max = bin(i >> 1).count("1")
    n, t = i, 0
    while n & 1:
        n, t = n >> 1, t + 1
    return idx_max - t + 1, idx_max


def _inf_for_nan(delta):
    return torch.nan_to_num(delta, nan=math.inf, posinf=math.inf, neginf=-math.inf)


def _where(mask, a, b):
    """Per-chain select: mask [chains] against [chains] or [chains, ...]."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


class _Counters:
    """Lockstep bookkeeping of one run: batched gradient evaluations, leaf
    steps (each one batched leapfrog over all chains), host syncs, and the
    sum of the chains' tree depths over their transitions."""

    def __init__(self):
        self.evals = 0
        self.leaf_steps = 0
        self.host_syncs = 0
        self.depth_sum = 0  # a device tensor once a transition has run
        self.transitions = 0

    def any(self, mask) -> bool:
        self.host_syncs += 1
        return bool(mask.any())


def _build_subtree(grad_fn, z0, r0, g0, eps_signed, inv_mass, depth, energy0, active,
                   max_depth, draws, counters):
    """Up to 2^depth leapfrogs from (z0, r0, g0) for the chains in `active`,
    each stopping at its own U-turn or divergence (nuts.py:110-178).
    Returns a dict of per-chain results: the end point (z, r, g), the
    multinomial proposal (z_prop, logp_prop, grad_prop) and its log weight,
    r_sum, turning, diverging, sum_accept and i (the chain's own leaves)."""
    C, D = z0.shape
    kw64 = dict(dtype=F64, device=z0.device)
    z, r, g = z0, r0, g0
    z_prop, g_prop = z0, g0
    logp_prop = torch.full((C,), -math.inf, **kw64)
    log_weight = torch.full((C,), -math.inf, **kw64)
    r_sum = torch.zeros_like(r0)
    turning = torch.zeros(C, dtype=torch.bool, device=z0.device)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros((C,), **kw64)
    steps = torch.zeros(C, dtype=torch.int64, device=z0.device)
    r_ckpts = torch.zeros((C, max_depth + 1, D), dtype=r0.dtype, device=z0.device)
    r_sum_ckpts = torch.zeros_like(r_ckpts)

    for i in range(1 << depth):
        m = active & ~turning & ~diverging
        # at leaf 0, m is `active`, which the caller found non-empty
        if i > 0 and not counters.any(m):
            break
        z1, r1, g1, lp1 = leapfrog(z, r, g, eps_signed, inv_mass, grad_fn)
        counters.evals += 1
        counters.leaf_steps += 1
        delta = _inf_for_nan(_energy(lp1, r1, inv_mass) - energy0)
        log_w = -delta
        accept = torch.exp(log_w).clamp_(max=1.0)
        new_total = torch.logaddexp(log_weight, log_w)
        take = (draws.uniform(C, "leaf") < torch.exp(log_w - new_total)) & m
        z_prop = _where(take, z1, z_prop)
        logp_prop = torch.where(take, lp1, logp_prop)
        g_prop = _where(take, g1, g_prop)

        r_sum1 = r_sum + r1
        lo, hi = _leaf_to_ckpt(i)
        if i % 2 == 0:
            mc = m.view(C, 1)
            r_ckpts[:, hi] = torch.where(mc, r1, r_ckpts[:, hi])
            r_sum_ckpts[:, hi] = torch.where(mc, r_sum1, r_sum_ckpts[:, hi])
            turned = torch.zeros_like(turning)
        else:
            rj = r_ckpts[:, lo:hi + 1]
            block_sum = r_sum1[:, None, :] - r_sum_ckpts[:, lo:hi + 1] + rj
            turned = torch.any(_is_turning(block_sum, rj, r1[:, None, :], inv_mass[:, None, :]),
                               dim=1)

        z, r, g = _where(m, z1, z), _where(m, r1, r), _where(m, g1, g)
        log_weight = torch.where(m, new_total, log_weight)
        r_sum = _where(m, r_sum1, r_sum)
        turning = torch.where(m, turned, turning)
        diverging = torch.where(m, delta > MAX_DELTA_ENERGY, diverging)
        sum_accept = torch.where(m, sum_accept + accept, sum_accept)
        steps += m
    return dict(z=z, r=r, g=g, z_prop=z_prop, logp_prop=logp_prop, grad_prop=g_prop,
                log_weight=log_weight, r_sum=r_sum, turning=turning, diverging=diverging,
                sum_accept=sum_accept, i=steps)


def _nuts_transition(grad_fn, z, logp, grad, eps, inv_mass, max_depth, draws, counters=None):
    """One NUTS draw for every chain (nuts.py:201-275): z[chains, D],
    logp[chains] (float64), grad[chains, D], eps[chains], inv_mass[chains, D].
    Returns (z, logp, grad, stats) with stats accept_prob, diverging,
    num_steps and depth, each [chains]."""
    counters = counters or _Counters()
    C = z.shape[0]
    dev = z.device
    r0 = draws.momentum(z.shape) / torch.sqrt(inv_mass)
    energy0 = _energy(logp, r0, inv_mass)
    eps_col = eps.to(z.dtype).view(C, 1)

    zl, rl, gl = z, r0, grad
    zr, rr, gr = z, r0, grad
    z_prop, logp_prop, g_prop = z, logp.to(F64), grad
    depth = torch.zeros(C, dtype=torch.int64, device=dev)
    log_weight = torch.zeros(C, dtype=F64, device=dev)  # the initial point: exp(-(H0 - H0))
    r_sum = r0
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros(C, dtype=F64, device=dev)
    num_steps = torch.zeros(C, dtype=torch.int64, device=dev)

    for d in range(max_depth):
        building = ~turning & ~diverging
        if not counters.any(building):
            break
        go_right = draws.uniform(C, "direction") < 0.5
        eps_signed = torch.where(go_right.view(C, 1), eps_col, -eps_col)
        sub = _build_subtree(grad_fn, _where(go_right, zr, zl), _where(go_right, rr, rl),
                             _where(go_right, gr, gl), eps_signed, inv_mass, d, energy0,
                             building, max_depth, draws, counters)
        right = building & go_right
        left = building & ~go_right
        zl, rl, gl = (_where(left, sub["z"], zl), _where(left, sub["r"], rl),
                      _where(left, sub["g"], gl))
        zr, rr, gr = (_where(right, sub["z"], zr), _where(right, sub["r"], rr),
                      _where(right, sub["g"], gr))

        # biased progressive sampling across the doubling (Stan/Betancourt)
        p_new = torch.clamp(torch.exp(sub["log_weight"] - log_weight), max=1.0)
        take = ((draws.uniform(C, "merge") < p_new) & ~sub["turning"] & ~sub["diverging"]
                & building)
        z_prop = _where(take, sub["z_prop"], z_prop)
        logp_prop = torch.where(take, sub["logp_prop"], logp_prop)
        g_prop = _where(take, sub["grad_prop"], g_prop)

        r_sum_new = r_sum + sub["r_sum"]
        turned = sub["turning"] | _is_turning(r_sum_new, rl, rr, inv_mass)
        r_sum = _where(building, r_sum_new, r_sum)
        turning = torch.where(building, turned, turning)
        diverging = torch.where(building, sub["diverging"], diverging)
        log_weight = torch.where(building, torch.logaddexp(log_weight, sub["log_weight"]),
                                 log_weight)
        sum_accept = torch.where(building, sum_accept + sub["sum_accept"], sum_accept)
        num_steps = num_steps + torch.where(building, sub["i"], 0)
        depth = depth + building.to(depth.dtype)

    counters.transitions += C
    counters.depth_sum = counters.depth_sum + depth.sum()
    stats = {
        "accept_prob": sum_accept / torch.clamp(num_steps, min=1),
        "diverging": diverging,
        "num_steps": num_steps,
        "depth": depth,
    }
    return z_prop, logp_prop, g_prop, stats


# ----------------------------------------------------------------------------
# Warmup adaptation (Stan-style)
# ----------------------------------------------------------------------------


class DualAveragingState(NamedTuple):
    """Per-chain [chains] float64 tensors, and the shared update count."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: int


def _da_init(eps0):
    log_eps = torch.log(eps0.to(F64))
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps.clone(),
                              h_sum=torch.zeros_like(log_eps), mu=torch.log(10.0 * eps0.to(F64)),
                              count=0)


def _da_update(state: DualAveragingState, accept_prob, target=0.8):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = state.count + 1
    w = 1.0 / (count + t0)
    h_sum = (1 - w) * state.h_sum + w * (target - accept_prob)
    log_eps = state.mu - math.sqrt(count) / gamma * h_sum
    eta = float(count) ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_sum, state.mu, count)


class WelfordState(NamedTuple):
    count: int
    mean: torch.Tensor  # [chains, D]
    m2: torch.Tensor


def _welford_init(proto):
    return WelfordState(0, torch.zeros_like(proto), torch.zeros_like(proto))


def _welford_update(state: WelfordState, x):
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def _welford_variance(state: WelfordState):
    """Stan's estimate regularized toward unity, its weights computed in
    float32 as nuts.py:335 does."""
    n = np.float32(state.count)
    shrink = float(n / (n + np.float32(5.0)))
    prior = float(np.float32(1e-3) * (np.float32(5.0) / (n + np.float32(5.0))))
    return (shrink * (state.m2 / max(float(n) - 1.0, 1.0)) + prior).to(state.m2.dtype)


def build_warmup_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's windowed schedule: iteration indices where a metric window closes."""
    if num_warmup < 20:
        return [], 0, 0
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    ends = []
    pos = init_buffer
    w = base_window
    while pos + w <= num_warmup - term_buffer:
        if pos + 2 * w > num_warmup - term_buffer:
            w = num_warmup - term_buffer - pos
        ends.append(pos + w)
        pos += w
        w *= 2
    return ends, init_buffer, term_buffer


def _find_eps(grad_fn, z, lp, g, mass0, draws, counters):
    """The reasonable-epsilon search of nuts.py:407-420, per chain: eight
    doublings or halvings from 0.1 towards a first-step accept of 0.8, one
    momentum draw for all eight; clipped to [1e-6, 10]."""
    C = z.shape[0]
    r = draws.momentum(z.shape) / torch.sqrt(mass0)
    e0 = _energy(lp, r, mass0)
    eps = torch.full((C,), 0.1, dtype=z.dtype, device=z.device)
    for _ in range(8):
        _, r1, _, lp1 = leapfrog(z, r, g, eps.view(C, 1), mass0, grad_fn)
        counters.evals += 1
        delta = torch.nan_to_num(e0 - _energy(lp1, r1, mass0), nan=-math.inf, posinf=math.inf,
                                 neginf=-math.inf)
        eps = torch.where(delta > math.log(0.8), eps * 2.0, eps * 0.5)
    return torch.clamp(eps, 1e-6, 10.0)


@dataclass
class NUTSResult:
    draws: torch.Tensor  # [chains, num_draws, D], left on the device
    accept_prob: np.ndarray  # [chains, num_draws]
    divergences: np.ndarray  # [chains] count in the sampling phase
    step_size: np.ndarray  # [chains]
    inv_mass: np.ndarray  # [chains, D]
    num_leapfrog: int  # the chains' own leapfrog steps, warmup + sampling
    lockstep_leapfrog: int = 0  # leapfrogs computed: leaf steps x chains
    num_evals: int = 0  # batched log-density + gradient calls (B = chains each)
    host_syncs: int = 0  # device reads that decided the loops
    mean_depth: float = 0.0  # tree depth per chain and transition


def run_nuts(
    log_density,
    dim: int,
    generator: torch.Generator,
    *,
    data=None,
    num_chains: int = 4,
    num_warmup: int = 150,
    num_draws: int = 250,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_theta=None,
    init_scale: float = 2.0,
    init_jitter: float = 0.1,
    inv_mass_init=None,
    mesh=None,
    dims=None,
    device="cuda",
    dtype=torch.float32,
) -> NUTSResult:
    """Run multi-chain NUTS on a flat [dim] state; returns the post-warmup
    draws [chains, num_draws, D].

    `log_density(theta[chains, D]) -> [chains]` (plus `data`, when given).
    Chains start at uniform(-init_scale, init_scale), or at init_theta
    jittered by init_jitter normals; the inverse mass starts at
    inv_mass_init (ones by default). `generator` (on `device`) drives every
    random number. `device` defaults to the card and must exist
    (utils/device.resolve_device).
    """
    if mesh is not None or dims is not None:
        raise NotImplementedError(
            "mesh and dims= (sharded NUTS) are not ported yet (ROADMAP.md, queue 1, item 6)")
    if not isinstance(dim, (int, np.integer)):
        raise NotImplementedError(
            "only a flat state of int dim is ported; a pytree prototype is not "
            "(ROADMAP.md, queue 1, item 6)")
    device = resolve_device(device)
    D = int(dim)
    kw = dict(device=device, dtype=dtype)
    draws = GeneratorDraws(generator, device, dtype)
    if init_theta is None:
        z = (2.0 * init_scale) * torch.rand((num_chains, D), generator=generator, **kw) - init_scale
    else:
        base = torch.as_tensor(init_theta, **kw)
        z = base[None, :] + init_jitter * torch.randn((num_chains, D), generator=generator, **kw)
    mass0 = (torch.ones(D, **kw) if inv_mass_init is None
             else torch.as_tensor(inv_mass_init, **kw))
    inv_mass = mass0.expand(num_chains, D).contiguous()

    def grad_fn(x):
        return logp_and_grad(log_density, x, data)

    counters = _Counters()
    lp, g = grad_fn(z)
    counters.evals += 1
    steps = torch.zeros(num_chains, dtype=torch.int64, device=device)  # each chain's leapfrogs

    # ---- warmup (nuts.py:401-456) ----
    schedule, metric_start, term_buffer = build_warmup_schedule(num_warmup)
    eps0 = _find_eps(grad_fn, z, lp, g, inv_mass, draws, counters)
    da = _da_init(eps0)
    wf = _welford_init(z)
    for i in range(num_warmup):
        eps = torch.exp(da.log_eps)
        z, lp, g, stats = _nuts_transition(grad_fn, z, lp, g, eps, inv_mass, max_depth, draws,
                                           counters)
        steps = steps + stats["num_steps"]
        da = _da_update(da, stats["accept_prob"], target_accept)
        if metric_start <= i < num_warmup - term_buffer:
            wf = _welford_update(wf, z)
        if i + 1 in schedule:  # a metric window closes
            inv_mass = _welford_variance(wf)
            da = _da_init(torch.exp(da.log_eps))
            wf = _welford_init(z)
    eps = torch.exp(da.log_eps_avg)

    # ---- sampling (nuts.py:458-468) ----
    out = torch.empty((num_draws, num_chains, D), **kw)
    accepts, divs = [], []
    for k in range(num_draws):
        z, lp, g, stats = _nuts_transition(grad_fn, z, lp, g, eps, inv_mass, max_depth, draws,
                                           counters)
        out[k] = z
        accepts.append(stats["accept_prob"])
        divs.append(stats["diverging"])
        steps = steps + stats["num_steps"]

    accept = torch.stack(accepts, dim=1) if accepts else torch.zeros((num_chains, 0))
    div = torch.stack(divs, dim=1) if divs else torch.zeros((num_chains, 0), dtype=torch.bool)
    return NUTSResult(
        draws=out.transpose(0, 1).contiguous(),
        accept_prob=accept.cpu().numpy(),
        divergences=div.sum(dim=1).cpu().numpy(),
        step_size=eps.to(dtype).cpu().numpy(),
        inv_mass=inv_mass.cpu().numpy(),
        num_leapfrog=int(steps.sum()),
        lockstep_leapfrog=counters.leaf_steps * num_chains,
        num_evals=counters.evals,
        host_syncs=counters.host_syncs,
        mean_depth=float(counters.depth_sum) / max(counters.transitions, 1),
    )
