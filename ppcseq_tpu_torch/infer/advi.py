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
result's mean and log_sd come back in the prototype's structure.

On a CUDA device (infer/graphs.py) the fit replays CUDA graphs, the
counterpart of JAX's compiled chunk and ELBO (_get_advi_fns): one Adam
step captured over static buffers and replayed `eval_every` times per
chunk, and the ELBO evaluation. The noise is drawn
eagerly, one randn per chunk, and copied into the graph's buffer, so the
generator advances as in the eager fit and no generator lives in a graph;
the stop rule reads the ELBO on the host once per chunk, as JAX does. The
entry is cached per (density, configuration, shapes, dtype, device) with
the data as an operand, so both passes of the pipeline and every retry of
vb_iterative replay one capture. On the CPU the steps run eagerly, one op
at a time, and the graphs' results are those bits.

With a `layout` (parallel/sharding.Layout with a gene shard) the fit is
gene-sharded: `log_density` is a rank's local log density over its local
vector, every evaluation reduces its value and the replicated gradients in
one all-reduce, Adam runs on the local vector, the noise is drawn for the
global vector and sliced, and the ELBO (entropy included), the stop rule
and the retry decision are global, so every rank takes the same branch.
Over an NCCL group (Layout.capturable) the sharded fit replays graphs too,
its all-reduces inside them (the step's value-and-gradient one, the ELBO's
sum over the ranks), as JAX's GSPMD program holds its psums; over gloo it
runs eagerly.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ppcseq_tpu_torch.infer import graphs
from ppcseq_tpu_torch.model.params import StateSpec, state_spec
from ppcseq_tpu_torch.utils.device import resolve_device

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    mu: dict  # first moments, keyed like the parameters
    nu: dict  # second moments
    count: torch.Tensor  # steps taken: a 0-dim int64 tensor on the parameters' device


@dataclass
class ADVIResult:
    mean: torch.Tensor | dict  # [D] variational mean, on the fit's device (or the state's tree)
    log_sd: torch.Tensor | dict  # [D] variational log-stddev (or the state's tree)
    elbo: float
    elbo_trace: np.ndarray
    converged: bool
    iterations: int
    spec: StateSpec | None = field(default=None, repr=False)  # the state's layout
    attempts: int = 1  # vb_iterative's fits until this one succeeded

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


def _elbo(log_density, m, log_s, eps, layout, global_dim):
    """The ELBO at noise eps, under no_grad: the single-device estimate, or
    the gene-sharded one under a `layout`."""
    with torch.no_grad():
        if layout is None:
            return elbo_estimate(log_density, m, log_s, eps)
        return _sharded_elbo(log_density, m, log_s, eps, layout, global_dim)


def normal_noise(generator, shape, dim, layout, device, dtype):
    """Standard normals [*shape, D]: drawn for the global vector and sliced
    to the local one under a gene layout, so every rank draws the numbers of
    the unsharded fit."""
    eps = torch.randn(tuple(shape) + (dim,), generator=generator, device=device, dtype=dtype)
    return eps if layout is None else layout.local(eps)


def adam_init(params: dict) -> AdamState:
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    count = torch.zeros((), dtype=torch.int64, device=params["m"].device)
    return AdamState(mu=zeros, nu=dict(zeros), count=count)


def adam_scalars(count: torch.Tensor, learning_rate: float, dtype):
    """(bc1, bc2, step) of the Adam step taken after `count` steps, 0-dim
    tensors in `dtype` on count's device: the bias corrections
    1 - B1^(count+1) and 1 - B2^(count+1), and the step
    -learning_rate / sqrt(1 + count/100), the inverse-sqrt decay read at the
    pre-increment count (advi.py:71-73 of the JAX package, as optax reads
    it). Computed in float64 on the device by the eager and the captured
    step alike, so the two share their bits: a Python float would be frozen
    into a graph, and CUDA divides by a host scalar as a product with its
    reciprocal but by a tensor truly."""
    c = count.to(torch.float64)
    n = c + 1.0
    bc1 = (1.0 - torch.pow(B1, n)).to(dtype)
    bc2 = (1.0 - torch.pow(B2, n)).to(dtype)
    step = (-learning_rate / torch.sqrt(1.0 + c / 100.0)).to(dtype)
    return bc1, bc2, step


def advi_step(params: dict, state: AdamState, eps, log_density, learning_rate: float):
    """One Adam step on -ELBO at noise eps[grad_samples, D].

    Returns (params, state, loss); the inputs are not modified.
    """
    m = params["m"].detach().requires_grad_(True)
    log_s = params["log_s"].detach().requires_grad_(True)
    loss = -elbo_estimate(log_density, m, log_s, eps)
    grads = dict(zip(("m", "log_s"), torch.autograd.grad(loss, (m, log_s))))
    new_params, mu, nu = {}, {}, {}
    with torch.no_grad():
        bc1, bc2, step = adam_scalars(state.count, learning_rate, params["m"].dtype)
        for k, g in grads.items():
            mu[k] = (1.0 - B1) * g + B1 * state.mu[k]
            nu[k] = (1.0 - B2) * (g * g) + B2 * state.nu[k]
            update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
            new_params[k] = params[k] + step * update
    return new_params, AdamState(mu=mu, nu=nu, count=state.count + 1), loss.detach()


class _EagerFit:
    """fit_advi's chunk of Adam steps and its ELBO, one op at a time: the
    CPU's fit, the gene-sharded one over gloo and, under graphs.disabled(),
    the card's reference."""

    def __init__(self, log_density, density, params, learning_rate, layout, dim):
        self.log_density, self.density = log_density, density
        self.params, self.state = params, adam_init(params)
        self.learning_rate, self.layout, self.dim = learning_rate, layout, dim

    def chunk(self, noise):
        for k in range(noise.shape[0]):
            self.params, self.state, _ = advi_step(self.params, self.state, noise[k],
                                                   self.density, self.learning_rate)

    def elbo(self, eps):
        return _elbo(self.log_density, self.params["m"], self.params["log_s"], eps, self.layout,
                     self.dim)

    def result(self):
        return self.params["m"], self.params["log_s"]


class CapturedFit:
    """fit_advi's chunk and ELBO as CUDA graphs (graphs.Region) over static
    buffers, the counterpart of JAX's _get_advi_fns: one Adam step, replayed
    `eval_every` times per chunk, reading its noise from the chunk's
    [eval_every, grad_samples, D] buffer at count mod eval_every (a device
    index, so one graph serves every step of a chunk), and writing the
    parameters, moments and count back into their buffers; and the ELBO at
    the [elbo_samples, D] noise buffer. The step runs advi_step, the eager
    fit's function, so the two fits share their bits. `load` starts a fit:
    its initial parameters, zero moments and count, its data. Under a gene
    `layout` (an NCCL group's) the buffers hold the rank's local vector, the
    density is the layout's global one and the ELBO the sharded one, their
    all-reduces captured with them; `dim` is the global dimension."""

    def __init__(self, log_density, spec, data, m, log_s, *, eval_every, grad_samples,
                 elbo_samples, learning_rate, layout=None, dim=None):
        kw = dict(dtype=m.dtype, device=m.device)
        self.m, self.log_s = m.clone(), log_s.clone()
        self.mu = {"m": torch.zeros_like(m), "log_s": torch.zeros_like(m)}
        self.nu = {"m": torch.zeros_like(m), "log_s": torch.zeros_like(m)}
        self.count = torch.zeros((), dtype=torch.int64, device=m.device)
        self.noise = torch.zeros((eval_every, grad_samples, m.shape[0]), **kw)
        self.eps = torch.zeros((elbo_samples, m.shape[0]), **kw)
        self.data = graphs.static_operand(data)
        if data is not None:
            log_density = functools.partial(_call_with_data, log_density, self.data)
        self.log_density = spec.bind(log_density)
        self.density = self.log_density if layout is None else layout.density(self.log_density)
        self.layout, self.dim = layout, dim
        self.eval_every, self.learning_rate = eval_every, learning_rate
        self.step_graph = graphs.Region(self._step, m.device, "ADVI step")
        self.elbo_graph = graphs.Region(self._elbo, m.device, "ADVI ELBO")

    def _step(self):
        k = torch.remainder(self.count, self.eval_every).reshape(1)
        params = {"m": self.m, "log_s": self.log_s}
        state = AdamState(mu=self.mu, nu=self.nu, count=self.count)
        new, new_state, _ = advi_step(params, state, self.noise.index_select(0, k)[0],
                                      self.density, self.learning_rate)
        with torch.no_grad():
            for name, buf in params.items():
                buf.copy_(new[name])
                self.mu[name].copy_(new_state.mu[name])
                self.nu[name].copy_(new_state.nu[name])
            self.count.copy_(new_state.count)

    def _elbo(self):
        return _elbo(self.log_density, self.m, self.log_s, self.eps, self.layout, self.dim)

    def load(self, m, log_s, data):
        with torch.no_grad():
            self.m.copy_(m)
            self.log_s.copy_(log_s)
            for buf in (*self.mu.values(), *self.nu.values(), self.count):
                buf.zero_()
            if data is not None:
                graphs.load_operand(self.data, data)

    def chunk(self, noise):
        self.noise.copy_(noise)
        self.step_graph.replay(self.eval_every)

    def elbo(self, eps):
        self.eps.copy_(eps)
        self.elbo_graph.replay()
        return self.elbo_graph.outputs

    def result(self):
        return self.m.clone(), self.log_s.clone()


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
    must exist (utils/device.resolve_device); there the steps replay CUDA
    graphs, except under a gene `layout` that no graph can hold
    (Layout.capturable: gloo's). With a gene `layout` the
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
    log_s0 = torch.full((local_dim,), float(init_log_sd), dtype=dtype, device=device)
    if graphs.enabled(device) and (layout is None or layout.capturable(device)):
        key = (log_density, spec, graphs.operand_key(data), eval_every, grad_samples,
               elbo_samples, float(learning_rate), dim, dtype, device,
               None if layout is None else layout.key())
        fit = graphs.cached("advi", key, lambda: CapturedFit(
            log_density, spec, data, m0, log_s0, eval_every=eval_every,
            grad_samples=grad_samples, elbo_samples=elbo_samples, learning_rate=learning_rate,
            layout=layout, dim=dim))
        fit.load(m0, log_s0, data)
    else:
        if data is not None:
            log_density = functools.partial(_call_with_data, log_density, data)
        log_density = spec.bind(log_density)
        density = log_density if layout is None else layout.density(log_density)
        fit = _EagerFit(log_density, density, {"m": m0, "log_s": log_s0}, learning_rate,
                        layout, dim)

    elbos: list[float] = []
    deltas: list[float] = []
    converged = False
    it = 0
    while it < max_iter:
        fit.chunk(normal_noise(generator, (eval_every, grad_samples), dim, layout, device, dtype))
        it += eval_every
        elbo = float(fit.elbo(normal_noise(generator, (elbo_samples,), dim, layout, device,
                                           dtype)))
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

    m, log_s = fit.result()
    return ADVIResult(
        mean=spec.unflatten(m),
        log_sd=spec.unflatten(log_s),
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
            res.attempts = attempt + 1
            return res
        last = res
        print(f"Further attempt with Variational Bayes: attempt {attempt + 1} failed")
    if last is None:
        raise RuntimeError("ADVI failed to produce any result")
    raise RuntimeError(f"ADVI failed after {max_attempts} attempts (elbo={last.elbo})")
