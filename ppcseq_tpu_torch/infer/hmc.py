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

Sharded runs (parallel/sharding.py): `run_hmc(mesh=)` splits the chain
batch over a `chains` axis and, given the model's dims, the genes over a
`genes` axis, each rank holding its local flat vector. `run_hmc_tree`, the
counterpart of JAX's tree-state runner (hmc.py:500-732), takes JAX's
prototype (an int D, an example tensor, or a dict, model/params.state_spec)
and runs run_hmc on its flat vector; with the model's dims a dict is the
model's tree in the model's flat layout, the one state a `genes` axis
shards.
They run the single-device sampler's code, with the energies summed over
the global state (one all-reduce per transition), every statistic across
chains (the dual-averaging accept mean, ChEES's chain means, principal
component and criterion) taken over the global chain batch, and random
numbers drawn for the global state and sliced (`LayoutDraws`), so a
sharded run draws the unsharded run's numbers. ChEES runs over a `chains`
axis only, as in JAX.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ppcseq_tpu_torch.model.params import state_spec
from ppcseq_tpu_torch.parallel.sharding import Layout, mesh_axes, shard_data
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
    # a sharded run's draws are the rank's own: chains [c0, c1) of the global
    # batch and, under a genes axis, genes [g0, g1) in its local layout
    # (accept_prob and divergences cover every chain)
    chains: tuple[int, int] | None = None
    genes: tuple[int, int] | None = None


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

    def init_uniform(self, shape):
        """Uniforms on [0, 1) of a [chains, D] initial state."""
        return torch.rand(shape, generator=self.generator, device=self.device, dtype=self.dtype)


class LayoutDraws(GeneratorDraws):
    """GeneratorDraws of a sharded run (parallel/sharding.Layout): each
    normal is drawn for the global [num_chains, dim] state from a generator
    seeded alike on every rank, and the rank keeps its chains and its local
    coordinates; uniforms are drawn for every chain. So every rank consumes
    its generator as the unsharded run does, and a sharded run draws exactly
    the unsharded run's numbers (at the same padding)."""

    def __init__(self, generator, device, dtype, layout, num_chains: int, dim: int):
        super().__init__(generator, device, dtype)
        self.layout, self.num_chains, self.dim = layout, int(num_chains), int(dim)
        self.c0, self.c1 = layout.chain_range(self.num_chains)

    def _mine(self, full):
        return self.layout.local(full[self.c0:self.c1])

    def momentum(self, shape):
        return self._mine(super().momentum((self.num_chains, self.dim)))

    def uniform(self, n: int, what: str):
        return super().uniform(self.num_chains, what)[self.c0:self.c1]

    def init_uniform(self, shape):
        return self._mine(super().init_uniform((self.num_chains, self.dim)))


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


_SINGLE = Layout()  # one process: every reduction is the plain local one


def sampler_density(log_density, data, mesh, dims, device, who):
    """(layout, grad_fn) of a sampler run on `mesh` (None: one process).
    A `genes` axis needs `dims` and `data`; log_density is then
    nb_model.flat_logp(dims): `f(theta, data, shard)` over a rank's local
    vector, and `data` the whole model data (sharded here) or the rank's
    shard already. grad_fn(theta) -> (global lp, gradient) as logp_and_grad."""
    if mesh is None:
        layout = _SINGLE
    else:
        if "genes" in mesh_axes(mesh) and (dims is None or data is None):
            raise ValueError(f"{who} over a 'genes' mesh axis needs dims= and data=")
        layout = Layout.from_mesh(mesh, dims)
    shard = layout.genes
    if shard is None:
        return layout, functools.partial(logp_and_grad, log_density, data=data)
    if data.counts.shape[-1] == dims.G != shard.G_local:
        data = shard_data(data, shard, device)
    density = layout.density(functools.partial(log_density, data=data, shard=shard))
    return layout, functools.partial(logp_and_grad, density)


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


def _energy_change(lp0, r0, lp1, r1, inv_mass, layout=_SINGLE):
    """H(end) - H(start) in float64, NaN -> +inf; both kinetic energies in
    one reduction over the (global) state."""
    k0, k1 = layout.sums([r0 * r0 * inv_mass, r1 * r1 * inv_mass])
    delta = (-lp1 + 0.5 * k1) - (-lp0 + 0.5 * k0)
    return torch.where(torch.isnan(delta), torch.full_like(delta, math.inf), delta)


def _snapshot_transition(grad_fn, z, lp, g, eps, L_t, inv_mass, draws, layout=_SINGLE):
    """One ChEES-path draw of L_t leapfrogs from momenta
    draws.momentum / sqrt(inv_mass) (hmc.py:192-229): a divergence is
    rejected and reported with accept probability 0. Returns (z, lp, g,
    accept_prob, diverging, z_end, r_end), z_end/r_end the trajectory's
    end before the accept."""
    r0 = draws.momentum(z.shape) / torch.sqrt(inv_mass)
    zp, rp, gp, lpp = z, r0, g, lp
    for _ in range(L_t):
        zp, rp, gp, lpp = leapfrog(zp, rp, gp, eps, inv_mass, grad_fn)
    delta = _energy_change(lp, r0, lpp, rp, inv_mass, layout)
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


def _chees_warmup(grad_fn, z0, inv_mass, mu, num_warmup, L_cap, target_accept, draws, u_seq,
                  layout=_SINGLE):
    """ChEES/SNAPER warmup (hmc.py:234-336): dual averaging on the step size
    and Adam ascent on log T, T jittered by u_seq[i]. Returns (z, lp, g,
    eps, T, leapfrogs per chain); eps and T are 0-dim tensors in the state's
    dtype, the adaptation runs in float64. Under a chains `layout` z0 is the
    rank's slice of the chain batch and every statistic across chains is
    the global batch's (three all-reduces per draw)."""
    dtype = z0.dtype
    num_chains = z0.shape[0] * layout.chains_size
    sqrt_inv_mass = torch.sqrt(inv_mass)
    w = 1.0 / sqrt_inv_mass  # whitening
    lp, g = grad_fn(z0)
    f64 = dict(dtype=torch.float64, device=z0.device)
    le0 = torch.tensor(mu - math.log(10.0), **f64)
    lT0 = le0 + math.log(0.5 * L_cap)  # start at half the cap
    log_eps, log_eps_avg, h_sum = le0, le0, torch.zeros((), **f64)
    log_T, log_T_avg = lT0, lT0
    m_adam, v_adam = torch.zeros((), **f64), torch.zeros((), **f64)
    every = layout.gather_chains(z0)
    pc = every[0] - every[-1]  # initial direction from the chain spread
    pc = pc / torch.clamp(torch.linalg.vector_norm(pc), min=1e-20)
    z, total = z0, 0
    for i in range(num_warmup):
        eps = torch.exp(log_eps).to(dtype)
        u = u_seq[i]
        L_t = int(_trajectory_steps(u, torch.exp(log_T).to(dtype), eps, L_cap))
        total += L_t
        z1, lp, g, accept, _, zp, rp = _snapshot_transition(grad_fn, z, lp, g, eps, L_t,
                                                            inv_mass, draws, layout)
        xw, xwp, x1w = z * w, zp * w, z1 * w
        m_xw, m_xwp, m_x1w, accept_mean = layout.chain_means([xw, xwp, x1w, accept])
        xw_c, xwp_c, x1w_c = xw - m_xw, xwp - m_xwp, x1w - m_x1w
        vw_p = (rp * inv_mass) * w  # whitened end velocity
        # Oja's rule on the post-accept batch: pc tracks the leading
        # eigenvector of the whitened posterior covariance (sums, not
        # matmuls, so TF32 cannot touch them)
        (cov_sum,) = layout.chain_sums([x1w_c * torch.sum(x1w_c * pc, dim=1, keepdim=True)])
        cov_pc = cov_sum / num_chains
        pc_new = pc + (3.0 / (i + 10.0)) * cov_pc
        pc = pc_new / torch.clamp(torch.linalg.vector_norm(pc_new), min=1e-20)
        # SNAPER criterion on the principal projection
        proj0 = torch.sum(xw_c * pc, dim=1)
        proj1 = torch.sum(xwp_c * pc, dim=1)
        projv = torch.sum(vw_p * pc, dim=1)
        h = proj1 * proj1 - proj0 * proj0
        dh = 2.0 * proj1 * projv
        accept_sum, weighted = layout.chain_sums([accept, accept * h * dh])
        wsum = torch.clamp(accept_sum, min=1e-6)
        # d/dlog T with the jitter chain rule (T_t = u T)
        grad = weighted / wsum * u * torch.exp(log_T)
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
        log_eps, log_eps_avg, h_sum = dual_average(log_eps_avg, h_sum, accept_mean, i,
                                                   mu, target_accept)
        z = z1
    return z, lp, g, torch.exp(log_eps_avg).to(dtype), torch.exp(log_T_avg).to(dtype), total


def _chees_sample(grad_fn, z, lp, g, eps, T, inv_mass, num_draws, L_static, draws, u_seq,
                  layout=_SINGLE):
    """The draws after the ChEES warmup (hmc.py:339-363): draw k takes
    clip(ceil(u_seq[k] T / eps), 1, L_static) leapfrogs, all read from the
    device at once. Returns (draws [num_draws, chains, D], accept, diverging,
    leapfrogs per chain)."""
    steps = _trajectory_steps(u_seq, T, eps, L_static).tolist()
    out = torch.empty((num_draws,) + tuple(z.shape), dtype=z.dtype, device=z.device)
    accepts, divs = [], []
    for k in range(num_draws):
        z, lp, g, accept, div, _, _ = _snapshot_transition(grad_fn, z, lp, g, eps, steps[k],
                                                           inv_mass, draws, layout)
        out[k] = z
        accepts.append(accept)
        divs.append(div)
    return out, accepts, divs, sum(steps)


def _stack_np(rows, num_chains):
    """[chains, n] host array of n per-draw [chains] tensors."""
    return torch.stack(rows, dim=1).cpu().numpy() if rows else np.zeros((num_chains, 0))


def _chain_stats(layout, accepts, divs, num_chains):
    """(accept_prob [chains, n], divergences [chains]) of every chain of the
    global batch, on every rank, from per-draw [its chains] tensors."""
    if layout.chain_collectives:
        accepts = [layout.gather_chains(a) for a in accepts]
        divs = [layout.gather_chains(d.to(torch.int32)).bool() for d in divs]
    return _stack_np(accepts, num_chains), _stack_np(divs, num_chains).sum(axis=1)


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
    dims=None,
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

    `mesh` (a DeviceMesh; every rank calls with the same arguments): a
    `chains` axis splits the chain batch over its ranks; a `genes` axis
    needs `dims` and `data` and shards the state (sampler_density). Each
    rank returns its own chains' draws in its local layout (`chains` and
    `genes` say which); accept_prob and divergences cover every chain.
    init_theta and inv_mass may be global or local. ChEES runs over a
    `chains` axis, not a `genes` one (JAX's refusal). `device` defaults to
    the card and must exist (utils/device.resolve_device).
    """
    device = resolve_device(device)
    layout, grad_fn = sampler_density(log_density, data, mesh, dims, device, "run_hmc")
    if adapt_trajectory and layout.genes is not None:
        raise ValueError("adapt_trajectory is not supported with a 'genes' mesh axis (the "
                         "trajectory-adaptive runner is flat-state only)")
    D = int(dim)
    kw = dict(device=device, dtype=dtype)
    d_local = D if layout.genes is None else layout.genes.dim
    inv_mass = (torch.ones(d_local, **kw) if inv_mass is None
                else layout.local(torch.as_tensor(inv_mass, **kw)))
    if layout is _SINGLE:
        draws = GeneratorDraws(generator, device, dtype)
    else:
        draws = LayoutDraws(generator, device, dtype, layout, num_chains, D)

    length_gen = _length_generator(generator, device)
    if adapt_trajectory:
        z = _initial_state(draws, num_chains, D, init_theta, init_jitter, kw, layout)
        return _run_chees(grad_fn, z, inv_mass, math.log(10.0 * step_size0), num_warmup,
                          num_draws, int(num_leapfrog), target_accept, draws, layout)
    return _run_jittered(grad_fn, inv_mass, draws, layout, length_gen, num_chains=num_chains,
                         num_warmup=num_warmup, num_draws=num_draws, num_leapfrog=num_leapfrog,
                         jitter_low=jitter_low, target_accept=target_accept,
                         init_theta=init_theta, init_jitter=init_jitter,
                         step_size0=step_size0, D=D, kw=kw)


def sampler_spec(prototype, dims, mesh, who):
    """The StateSpec of a sampler's prototype (model/params.state_spec).
    Under a `genes` mesh axis a rank's state is its local flat vector in
    the global layout, so the state must be flat or the model's tree;
    anything else is a ValueError, raised before any collective."""
    spec = state_spec(prototype, dims)
    if (mesh is not None and spec.structured and spec.dims is None
            and "genes" in mesh_axes(mesh)):
        raise ValueError(
            f"{who} over a 'genes' mesh axis takes a flat state or the model's tree "
            "(a dict of model_tree_names(dims), with dims=): a rank's state is its local "
            "flat vector in the global layout, and only the model's layout says which "
            "coordinates are its genes")
    return spec


def structured_draws(spec, draws, genes):
    """Flat per-chain values [chains, ..., D] (draws, or the inverse mass;
    a tensor or an array) in the state's structure; under a gene shard,
    genes = (g0, g1), in the rank's local layout."""
    if spec.dims is not None and genes is not None:
        spec = spec.localized(replace(spec.dims, G=genes[1] - genes[0]))
    return spec.unflatten(draws)


def run_hmc_tree(log_density, prototype, generator: torch.Generator, *, data=None,
                 num_chains: int = 8, init_theta=None, inv_mass=None, mesh=None, dims=None,
                 device="cuda", dtype=torch.float32, **kwargs) -> HMCResult:
    """Jittered-trajectory HMC over the state `prototype` defines
    (hmc.py:633-732 of the JAX package): an int D, an example tensor, or a
    dict of them. The chains start at `init_theta` (the prototype's values
    when None, zeros for an int) jittered by init_jitter normals, as in
    JAX; `init_theta` and `inv_mass` may be flat or in the prototype's
    structure. The density receives the state in its structure, with a
    leading [chains] axis on every leaf, and the draws come back in it with
    leading [chains, num_draws] axes.

    With `dims`, a dict prototype whose keys are the model tree's is the
    model's tree and enters the sampler through tree_to_theta, in the
    model's flat layout: the run draws the flat run's random numbers, and
    under a `genes` mesh axis each rank holds its local vector (the density
    is then called with `shard=`, as nb_model.tree_logp(dims) takes it).
    Any other structured state under a `genes` axis is a ValueError. The
    other arguments are run_hmc's."""
    device = resolve_device(device)
    spec = sampler_spec(prototype, dims, mesh, "run_hmc_tree")
    if init_theta is None:
        init_theta = (torch.zeros(spec.dim, dtype=dtype, device=device)
                      if isinstance(prototype, (int, np.integer)) else prototype)
    kw = dict(dtype=dtype, device=device)
    res = run_hmc(spec.bind(log_density), spec.dim, generator, data=data,
                  num_chains=num_chains, init_theta=spec.flatten(init_theta, **kw),
                  inv_mass=None if inv_mass is None else spec.flatten(inv_mass, **kw),
                  mesh=mesh, dims=dims, device=device, dtype=dtype, **kwargs)
    res.draws = structured_draws(spec, res.draws, res.genes)
    return res


def _length_generator(generator, device):
    """The CPU generator of the trajectory lengths, seeded from `generator`."""
    return torch.Generator().manual_seed(
        int(torch.randint(2**62, (1,), generator=generator, device=device)))


def _initial_state(draws, num_chains, D, init_theta, init_jitter, kw, layout):
    """The chains' start: uniform(-2, 2), or init_theta jittered by
    init_jitter normals (the rank's chains and local coordinates under a
    sharded layout)."""
    c = draws.c1 - draws.c0 if isinstance(draws, LayoutDraws) else num_chains
    d = D if layout.genes is None else layout.genes.dim
    if init_theta is None:
        return 4.0 * draws.init_uniform((c, d)) - 2.0
    base = layout.local(torch.as_tensor(init_theta, **kw))
    return base[None, :] + init_jitter * draws.momentum((c, d))


def _run_jittered(grad_fn, inv_mass, draws, layout, length_gen, *, num_chains, num_warmup,
                  num_draws, num_leapfrog, jitter_low, target_accept, init_theta, init_jitter,
                  step_size0, D, kw) -> HMCResult:
    """The plain sampler of run_hmc (hmc.py:91-180 of the JAX package): dual
    averaging over the warmup, then the draws. Under a sharded `layout` the
    state is the rank's [its chains, its coordinates]."""
    L = int(num_leapfrog)
    L_min = max(1, int(np.ceil(jitter_low * L)))
    sqrt_inv_mass = torch.sqrt(inv_mass)
    z = _initial_state(draws, num_chains, D, init_theta, init_jitter, kw, layout)
    n_local = z.shape[0]

    def transition(z, lp, g, eps):
        L_t = int(torch.randint(L_min, L + 1, (1,), generator=length_gen))
        r0 = draws.momentum(z.shape) / sqrt_inv_mass[None, :]
        zp, rp, gp, lpp = z, r0, g, lp
        for _ in range(L_t):
            zp, rp, gp, lpp = leapfrog(zp, rp, gp, eps, inv_mass, grad_fn)
        delta = _energy_change(lp, r0, lpp, rp, inv_mass, layout)
        diverging = delta > MAX_DELTA_ENERGY
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        u = draws.uniform(n_local, "accept")
        take = (u < accept_prob) & ~diverging
        z = torch.where(take[:, None], zp, z)
        lp = torch.where(take, lpp, lp)
        g = torch.where(take[:, None], gp, g)
        return z, lp, g, accept_prob, diverging, L_t

    mu = math.log(10.0 * step_size0)
    lp, g = grad_fn(z)
    log_eps = torch.tensor(mu - math.log(10.0), device=kw["device"], dtype=torch.float64)
    log_eps_avg = log_eps.clone()
    h_sum = torch.zeros((), device=kw["device"], dtype=torch.float64)
    executed = 0
    for i in range(num_warmup):
        z, lp, g, accept, _, L_t = transition(z, lp, g, torch.exp(log_eps).to(kw["dtype"]))
        log_eps, log_eps_avg, h_sum = dual_average(
            log_eps_avg, h_sum, layout.chains_mean(accept), i, mu, target_accept
        )
        executed += L_t

    eps = torch.exp(log_eps_avg).to(kw["dtype"])
    out = torch.empty((num_draws,) + tuple(z.shape), **kw)
    accepts, divs = [], []
    for k in range(num_draws):
        z, lp, g, accept, div, L_t = transition(z, lp, g, eps)
        out[k] = z
        accepts.append(accept)
        divs.append(div)
        executed += L_t

    accept_prob, divergences = _chain_stats(layout, accepts, divs, num_chains)
    return HMCResult(
        draws=out.transpose(0, 1).contiguous(),
        accept_prob=accept_prob,
        divergences=divergences,
        step_size=float(eps),
        num_leapfrog=executed * num_chains,
        chains=None if layout is _SINGLE else (draws.c0, draws.c1),
        genes=None if layout.genes is None else (layout.genes.g0, layout.genes.g1),
    )


def _run_chees(grad_fn, z0, inv_mass, mu, num_warmup, num_draws, L_cap, target_accept, draws,
               layout=_SINGLE):
    """The adapt_trajectory=True branch of run_hmc (hmc.py:455-496): the
    ChEES warmup, then the draws at the smallest _L_BUCKETS cap that holds
    the adapted T / eps (L_cap if none)."""
    kw = dict(device=z0.device, dtype=z0.dtype)
    num_chains = z0.shape[0] * layout.chains_size
    u_warm = torch.as_tensor(_halton_seq(num_warmup), **kw)
    z, lp, g, eps, T, warm_lf = _chees_warmup(grad_fn, z0, inv_mass, mu, num_warmup, L_cap,
                                              target_accept, draws, u_warm, layout)
    eps_f, T_f = float(eps), float(T)
    L_star = max(1, int(np.ceil(T_f / max(eps_f, 1e-12))))
    bucket = next((b for b in _L_BUCKETS if b >= min(L_star, L_cap)), L_cap)
    u_draws = torch.as_tensor(_halton_seq(num_draws, base=3), **kw)
    out, accepts, divs, samp_lf = _chees_sample(grad_fn, z, lp, g, eps, T, inv_mass, num_draws,
                                                bucket, draws, u_draws, layout)
    accept_prob, divergences = _chain_stats(layout, accepts, divs, num_chains)
    return HMCResult(
        draws=out.transpose(0, 1).contiguous(),
        accept_prob=accept_prob,
        divergences=divergences,
        step_size=eps_f,
        num_leapfrog=(warm_lf + samp_lf) * num_chains,
        trajectory_length=T_f,
        chains=None if layout is _SINGLE else (draws.c0, draws.c1),
    )
