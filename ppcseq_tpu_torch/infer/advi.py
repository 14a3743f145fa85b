"""Meanfield ADVI in torch (ppcseq_tpu/infer/advi.py).

A meanfield Gaussian q(theta) = N(m, diag(s^2)) in unconstrained space,
fitted by Adam on the reparametrized one-sample ELBO gradient, with the
reference's convergence rule (relative ELBO change vs tol_rel_obj over a
rolling window, assessed every `eval_every` steps) and its
retry-until-success wrapper (`vb_iterative`, R/utilities.R:246-278).

Adam is written out to match `optax.adam(lr / sqrt(1 + step / 100))`:
b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0, the schedule read at the
pre-increment step count. Each step takes its noise `eps` as an argument,
so the same noise can drive both packages.

The log density takes a batch: `log_density(theta[B, D]) -> [B]`, or
`log_density(theta, data)` when the fit is given `data` (JAX's operand
form, `f(theta, data)` as nb_model.flat_logp returns it). The state is
defined by a prototype, as in JAX: an int D, an example tensor, or a dict
of them (model/params.state_spec). A structured state is fitted as its
flat vector, and the density receives a dict of batched leaves
[B, *leaf_shape]: the port's batched form of JAX's vmapped density. The
result's mean and log_sd come back in the prototype's structure. The
steps run eagerly, one small op at a time (~40 per step plus one
likelihood launch); JAX ran each 100-step chunk as one compiled scan.

With a `layout` (parallel/sharding.Layout with a gene shard) the fit is
gene-sharded: `log_density` is a rank's local log density over its local
vector, every evaluation reduces its value and the replicated gradients in
one all-reduce, Adam runs on the local vector, the noise is drawn for the
global vector and sliced, and the ELBO (entropy included), the stop rule
and the retry decision are global, so every rank takes the same branch.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ppcseq_tpu_torch.model.params import StateSpec, state_spec
from ppcseq_tpu_torch.utils.device import resolve_device

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    mu: dict  # first moments, keyed like the parameters
    nu: dict  # second moments
    count: int  # steps taken


@dataclass
class ADVIResult:
    mean: torch.Tensor | dict  # [D] variational mean, on the fit's device (or the state's tree)
    log_sd: torch.Tensor | dict  # [D] variational log-stddev (or the state's tree)
    elbo: float
    elbo_trace: np.ndarray
    converged: bool
    iterations: int
    spec: StateSpec | None = field(default=None, repr=False)  # the state's layout

    def flat(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, log_sd) as [D] vectors."""
        spec = self.spec or state_spec(self.mean)
        return spec.flatten(self.mean), spec.flatten(self.log_sd)


def elbo_estimate(log_density, m, log_s, eps):
    """Reparametrized ELBO from noise eps[n, D]: E_q[logp] + entropy(q)."""
    logps = log_density(m + torch.exp(log_s) * eps)
    entropy = torch.sum(log_s) + 0.5 * m.shape[-1] * (1.0 + math.log(2.0 * math.pi))
    return torch.mean(logps) + entropy


def _sharded_elbo(local_density, m, log_s, eps, layout, global_dim):
    """The global ELBO of a gene-sharded fit, under no_grad: the local
    values and the gene part of sum(log_s) in one all-reduce."""
    lo, hi = layout.genes.gene_block
    logps, _, (gene_s,) = layout.reduce(local_density(m + torch.exp(log_s) * eps),
                                        extra=(torch.sum(log_s[lo:hi], dtype=torch.float64),))
    rep_s = torch.sum(log_s[:lo], dtype=torch.float64) + torch.sum(log_s[hi:],
                                                                   dtype=torch.float64)
    entropy = rep_s + gene_s + 0.5 * global_dim * (1.0 + math.log(2.0 * math.pi))
    return torch.mean(logps) + entropy


def normal_noise(generator, shape, dim, layout, device, dtype):
    """Standard normals [*shape, D]: drawn for the global vector and sliced
    to the local one under a gene layout, so every rank draws the numbers of
    the unsharded fit."""
    eps = torch.randn(tuple(shape) + (dim,), generator=generator, device=device, dtype=dtype)
    return eps if layout is None else layout.local(eps)


def adam_init(params: dict) -> AdamState:
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(mu=zeros, nu=dict(zeros), count=0)


def schedule(learning_rate: float, count: int) -> float:
    """Inverse-sqrt step-size decay (advi.py:71-73 of the JAX package)."""
    return learning_rate / math.sqrt(1.0 + count / 100.0)


def advi_step(params: dict, state: AdamState, eps, log_density, learning_rate: float):
    """One Adam step on -ELBO at noise eps[grad_samples, D].

    Returns (params, state, loss); the inputs are not modified.
    """
    m = params["m"].detach().requires_grad_(True)
    log_s = params["log_s"].detach().requires_grad_(True)
    loss = -elbo_estimate(log_density, m, log_s, eps)
    grads = dict(zip(("m", "log_s"), torch.autograd.grad(loss, (m, log_s))))
    count = state.count + 1
    bc1 = 1.0 - B1**count
    bc2 = 1.0 - B2**count
    step = -schedule(learning_rate, state.count)
    new_params, mu, nu = {}, {}, {}
    with torch.no_grad():
        for k, g in grads.items():
            mu[k] = (1.0 - B1) * g + B1 * state.mu[k]
            nu[k] = (1.0 - B2) * (g * g) + B2 * state.nu[k]
            update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
            new_params[k] = params[k] + step * update
    return new_params, AdamState(mu=mu, nu=nu, count=count), loss.detach()


def fit_advi(
    log_density,
    prototype,
    generator: torch.Generator,
    *,
    data=None,
    max_iter: int = 50000,
    tol_rel_obj: float = 0.005,
    eval_every: int = 100,
    elbo_samples: int = 100,
    grad_samples: int = 1,
    learning_rate: float = 0.1,
    window: int = 8,
    init_mean=None,
    init_log_sd: float | None = None,
    layout=None,
    device="cuda",
    dtype=torch.float32,
) -> ADVIResult:
    """Fit meanfield ADVI over the state `prototype` defines: an int D (a
    [D] vector), an example tensor, or a dict of them (the module's
    docstring). With `data`, the density is called as
    `log_density(theta, data)`. `init_mean` may be given flat or in the
    prototype's structure.

    Noise comes from `generator` (which must live on `device`). ELBO is
    estimated with `elbo_samples` draws every `eval_every` steps; stop when
    the mean or the median of the last `window` relative changes drops
    below tol_rel_obj (Stan ADVI's rule). `device` defaults to the card and
    must exist (utils/device.resolve_device). With a gene `layout` the
    state is flat: the prototype is the global dimension, `log_density` the
    rank's local one, and `init_mean` global or local; the result's mean
    and log_sd are local.
    """
    device = resolve_device(device)
    if layout is not None and layout.genes is None:
        layout = None  # no gene shard: the single-device fit
    spec = state_spec(prototype)
    if layout is not None and spec.structured:
        raise ValueError("a gene-sharded fit takes a flat state (an int dim): a rank's state "
                         "is its local flat vector in the global layout")
    dim = spec.dim
    local_dim = dim if layout is None else layout.genes.dim
    if init_log_sd is None:
        init_log_sd = -1.0 if init_mean is not None else 0.0
    m0 = (
        spec.flatten(init_mean, dtype=dtype, device=device).clone()
        if init_mean is not None
        else torch.zeros(dim, dtype=dtype, device=device)
    )
    if layout is not None:
        m0 = layout.local(m0).clone()
    params = {"m": m0,
              "log_s": torch.full((local_dim,), float(init_log_sd), dtype=dtype, device=device)}
    state = adam_init(params)
    if data is not None:
        log_density = functools.partial(_call_with_data, log_density, data)
    log_density = spec.bind(log_density)
    density = log_density if layout is None else layout.density(log_density)

    elbos: list[float] = []
    deltas: list[float] = []
    converged = False
    it = 0
    while it < max_iter:
        noise = normal_noise(generator, (eval_every, grad_samples), dim, layout, device, dtype)
        for k in range(eval_every):
            params, state, _ = advi_step(params, state, noise[k], density, learning_rate)
        it += eval_every
        eps = normal_noise(generator, (elbo_samples,), dim, layout, device, dtype)
        with torch.no_grad():
            if layout is None:
                elbo = float(elbo_estimate(log_density, params["m"], params["log_s"], eps))
            else:
                elbo = float(_sharded_elbo(log_density, params["m"], params["log_s"], eps,
                                           layout, dim))
        if not np.isfinite(elbo):
            break
        if elbos:
            prev = elbos[-1]
            deltas.append(abs((elbo - prev) / prev) if prev != 0 else np.inf)
            recent = deltas[-window:]
            if len(recent) >= 2 and (
                np.mean(recent) < tol_rel_obj or np.median(recent) < tol_rel_obj
            ):
                elbos.append(elbo)
                converged = True
                break
        elbos.append(elbo)

    return ADVIResult(
        mean=spec.unflatten(params["m"]),
        log_sd=spec.unflatten(params["log_s"]),
        elbo=elbos[-1] if elbos else float("nan"),
        elbo_trace=np.asarray(elbos),
        converged=converged,
        iterations=it,
        spec=spec,
    )


def _call_with_data(log_density, data, theta):
    return log_density(theta, data)


def advi_sample(result: ADVIResult, generator: torch.Generator, n_draws: int, dtype=None, *,
                layout=None, dim: int | None = None):
    """n_draws samples from the fitted meanfield posterior: [n, D] for a
    flat state, else the state's tree with a leading [n] axis on every
    leaf; in `dtype` (the fit's by default). Under a gene `layout` the
    local coordinates of draws made for the global `dim`."""
    spec = result.spec or state_spec(result.mean)
    m, log_s = result.flat()
    if dtype is not None:
        m, log_s = m.to(dtype), log_s.to(dtype)
    if layout is not None and layout.genes is None:
        layout = None
    eps = normal_noise(generator, (n_draws,), m.shape[0] if layout is None else dim, layout,
                       m.device, m.dtype)
    return spec.unflatten(m + torch.exp(log_s) * eps)


def vb_iterative(
    log_density,
    prototype,
    generator: torch.Generator,
    *,
    data=None,
    max_attempts: int = 5,
    min_elbo: float = -1e15,
    init_mean=None,
    layout=None,
    **advi_kwargs,
) -> ADVIResult:
    """Retry ADVI until it succeeds (reference `vb_iterative`,
    R/utilities.R:246-278). After the first failure the data-driven init
    is dropped in favour of the zero init. Under a gene `layout` the mean
    must be finite on every rank. `prototype` and `data` are fit_advi's."""
    last = None
    for attempt in range(max_attempts):
        res = fit_advi(
            log_density, prototype, generator,
            data=data,
            init_mean=init_mean if attempt == 0 else None,
            layout=layout,
            **advi_kwargs,
        )
        finite_mean = bool(torch.isfinite(res.flat()[0]).all())
        if layout is not None:
            finite_mean = layout.all(finite_mean, res.mean.device)
        if np.isfinite(res.elbo) and res.elbo > min_elbo and finite_mean:
            return res
        last = res
        print(f"Further attempt with Variational Bayes: attempt {attempt + 1} failed")
    if last is None:
        raise RuntimeError("ADVI failed to produce any result")
    raise RuntimeError(f"ADVI failed after {max_attempts} attempts (elbo={last.elbo})")
