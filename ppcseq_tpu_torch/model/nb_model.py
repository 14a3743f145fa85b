"""The hierarchical negative-binomial GLM as a batched torch log-joint.

A port of ppcseq_tpu/model/nb_model.py (flat state, the centered and the
non-centered parametrization, delta-form likelihood). See that module for
the model (reference inst/stan/negBinomial_MPI.stan): parameters,
transforms, priors with the double lambda_mu_mu shift, the masked NB2-log
likelihood and the pad pseudo-prior.

Differences in form, not in math:
- `theta` carries a leading batch axis: `log_joint(theta[B, D]) -> [B]`,
  so the ADVI samples go through the likelihood kernel in one launch.
- Host arrays stay on the host: `prepare_data` keeps NumPy copies of the
  uploaded arrays (`ModelData.host`), and `smart_init`/`with_baseline`
  compute from them in float64 without reading the device back.
- The likelihood is chosen by `flat_logp(dims, likelihood)` (or
  `tree_logp` over the model's tree): the default ("auto" = "fast") is the
  hoisted kernel pair K1/K2 through ops/nb_kernel (the CUDA kernels on the
  card, their plain versions on the CPU); "plain" is torch autograd
  through `masked_likelihood`; "pallas" and "pallas_fused" are the stable
  form (K5 under grad, K4 under no_grad) and the one-pass K3; "analytic"
  and "fused" are `masked_likelihood` with the closed-form gradients of
  ops/nb_grad (JAX's XLA custom-VJP forms, torch ops here too).
- A gene shard (parallel/sharding.GeneShard) evaluates the same log joint
  on its own genes: `log_joint(..., shard=)` sums the per-gene terms over
  the shard's genes and adds the terms that appear once (the hyperpriors,
  the log-Jacobian, the checked-gene slope priors) on the shard of genes
  rank 0 only, so the shards' values and gradients sum to the unsharded
  ones.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ppcseq_tpu_torch.model.params import theta_to_tree
from ppcseq_tpu_torch.model.params import offsets as _offsets
from ppcseq_tpu_torch.ops import nb_grad, nb_kernel
from ppcseq_tpu_torch.ops.nb import (
    _softplus,
    double_exponential_lpdf,
    expm1_precise,
    log1p_precise,
    nb2_log_lpmf,
    nb2_log_lpmf_stable,
    nb2_part1,
    normal_lpdf,
    skew_normal_lpdf,
)
from ppcseq_tpu_torch.utils.constants import LAMBDA_MU_MU
from ppcseq_tpu_torch.utils.device import resolve_device

@dataclass(frozen=True)
class ModelDims:
    """Static dimensions of one fit."""

    S: int  # samples
    G: int  # genes incl. negative controls (possibly padded)
    C: int  # design-matrix columns
    n_check: int  # genes under test; G indices [0, n_check)
    G_unpadded: int  # real genes; [G_unpadded, G) are padding
    # Non-centered gene hierarchy: the intercept/sigma_raw coordinates hold
    # standardized residuals and unpack rebuilds the centered values (the
    # same posterior over the constrained parameters, without the funnel)
    non_centered: bool = False

    @property
    def n_alpha2(self) -> int:
        return max(0, self.C - 2) * self.n_check

    @property
    def dim(self) -> int:
        """Unconstrained parameter dimension."""
        return 6 + 2 * self.G + self.n_check + self.n_alpha2


def unpack_tree(tree: dict, non_centered: bool = False) -> tuple[dict, torch.Tensor]:
    """Unconstrained tree -> constrained parameters + log-Jacobian [...].

    With non_centered=True the intercept/sigma_raw leaves are standardized
    residuals: intercept = (lambda_mu + lambda_mu_mu) + lambda_sigma * t_i,
    sigma_raw = sigma_slope * intercept + sigma_intercept + sigma_sigma * t_s
    (nb_model.py:140-180 of the JAX package).
    """
    lambda_mu = tree["lambda_mu"] + LAMBDA_MU_MU
    lambda_sigma = torch.exp(tree["lambda_sigma"])
    sigma_slope = -torch.exp(tree["sigma_slope"])
    sigma_sigma = torch.exp(tree["sigma_sigma"])
    if non_centered:
        col = lambda v: v.unsqueeze(-1)  # noqa: E731  [...] -> [..., 1]
        intercept = col(lambda_mu + LAMBDA_MU_MU) + col(lambda_sigma) * tree["intercept"]
        sigma_raw = (col(sigma_slope) * intercept + col(tree["sigma_intercept"])
                     + col(sigma_sigma) * tree["sigma_raw"])
    else:
        intercept = tree["intercept"]
        sigma_raw = tree["sigma_raw"]
    a1 = tree["alpha_sub_1"]
    params = {
        "lambda_mu": lambda_mu,
        "lambda_sigma": lambda_sigma,
        "lambda_skew": tree["lambda_skew"],
        "sigma_slope": sigma_slope,
        "sigma_intercept": tree["sigma_intercept"],
        "sigma_sigma": sigma_sigma,
        "intercept": intercept,
        "sigma_raw": sigma_raw,
        "alpha_sub_1": a1,
        "alpha_2": tree.get("alpha_2", a1.new_zeros(a1.shape[:-1] + (0, a1.shape[-1]))),
    }
    log_jac = tree["lambda_sigma"] + tree["sigma_slope"] + tree["sigma_sigma"]
    return params, log_jac


def unpack(theta: torch.Tensor, dims: ModelDims) -> tuple[dict, torch.Tensor]:
    """theta[..., D] -> constrained parameters + log-Jacobian [...]."""
    return unpack_tree(theta_to_tree(theta, dims), dims.non_centered)


def make_alpha(params: dict, dims: ModelDims, checked=None) -> torch.Tensor:
    """alpha[..., C, G]: merge_coefficients with zero-padding (stan:122-139).

    G is the intercept's length. `checked` = (k0, k1) are the checked genes
    among them, as indices into alpha_sub_1 (the whole block by default; a
    gene shard's own range, which starts at its first gene)."""
    C = dims.C
    k0, k1 = (0, dims.n_check) if checked is None else checked
    icpt = params["intercept"]
    batch, G = icpt.shape[:-1], icpt.shape[-1]
    rows = [icpt.unsqueeze(-2)]
    if C >= 2:
        pad = icpt.new_zeros(batch + (1, G - (k1 - k0)))
        rows.append(torch.cat([params["alpha_sub_1"][..., k0:k1].unsqueeze(-2), pad], dim=-1))
    if C >= 3:
        pad = icpt.new_zeros(batch + (C - 2, G - (k1 - k0)))
        rows.append(torch.cat([params["alpha_2"][..., k0:k1], pad], dim=-1))
    return torch.cat(rows, dim=-2)


@dataclass(frozen=True)
class ModelData:
    """Model inputs on one device, with the host copies they were made from.

    Tensors: counts[S, G] int32, X[S, C], exposure_rate[S], like_mask[S, G]
    (1 = in the likelihood), gene_mask[G] (1 = real gene), and the delta-form
    baseline (None until with_baseline): alpha0[C, G], sigma_raw0[G],
    d0/sp_d0/sig_neg_d0/y_sp0 [S, G]. `host` holds NumPy copies of counts,
    X, exposure_rate, like_mask and gene_mask with the values on the device.
    """

    counts: torch.Tensor
    X: torch.Tensor
    exposure_rate: torch.Tensor
    like_mask: torch.Tensor
    gene_mask: torch.Tensor
    host: dict = field(default_factory=dict, repr=False)
    alpha0: torch.Tensor | None = None
    sigma_raw0: torch.Tensor | None = None
    d0: torch.Tensor | None = None
    sp_d0: torch.Tensor | None = None
    sig_neg_d0: torch.Tensor | None = None
    y_sp0: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.X.device


def upload(host: dict, device, dtype) -> ModelData:
    """ModelData from host arrays (counts, X, exposure_rate, like_mask,
    gene_mask); `host` is stored rounded to what the device holds."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    host = {
        "counts": np.array(host["counts"], dtype=np.int32),
        **{k: np.array(host[k], dtype=np_dtype)
           for k in ("X", "exposure_rate", "like_mask", "gene_mask")},
    }
    t = {k: torch.as_tensor(v, device=device).contiguous() for k, v in host.items()}
    return ModelData(host=host, **t)


def prepare_data(
    counts: np.ndarray,
    X: np.ndarray,
    exposure_rate: np.ndarray,
    n_check: int,
    exclude_mask: np.ndarray | None = None,
    pad_genes_to: int | None = None,
    non_centered: bool = False,
    device="cuda",
    dtype=torch.float32,
) -> tuple[ModelData, ModelDims]:
    """Pad + upload model arrays to `device` (the card by default; it must
    exist: utils/device.resolve_device); returns (data, dims)."""
    device = resolve_device(device)
    S, G_real = counts.shape
    G = int(pad_genes_to) if pad_genes_to else G_real
    if G < G_real:
        raise ValueError("pad_genes_to smaller than gene count")
    counts_p = np.zeros((S, G), dtype=np.int32)
    counts_p[:, :G_real] = counts
    gene_mask = np.zeros(G, dtype=np.float64)
    gene_mask[:G_real] = 1.0
    like = np.tile(gene_mask[None, :], (S, 1))
    if exclude_mask is not None:
        like[:, :G_real] *= ~np.asarray(exclude_mask, dtype=bool)
    dims = ModelDims(S=S, G=G, C=X.shape[1], n_check=n_check, G_unpadded=G_real,
                     non_centered=non_centered)
    data = upload(
        {"counts": counts_p, "X": X, "exposure_rate": exposure_rate,
         "like_mask": like, "gene_mask": gene_mask},
        device, dtype,
    )
    return data, dims


def with_baseline(data: ModelData, dims: ModelDims) -> ModelData:
    """Attach delta-form baseline constants at the smart-init point.

    Computed in float64 on the host from `data.host`, then stored on the
    device in the data's dtype (nb_model.py:368-398 of the JAX package).
    """
    theta0 = torch.as_tensor(smart_init(data, dims), dtype=torch.float64)
    params0, _ = unpack(theta0, dims)
    alpha0 = make_alpha(params0, dims).numpy()
    sigma_raw0 = params0["sigma_raw"].numpy()
    X = np.asarray(data.host["X"], dtype=np.float64)
    exposure = np.asarray(data.host["exposure_rate"], dtype=np.float64)
    eta0 = exposure[:, None] + X @ alpha0
    d0 = eta0 + sigma_raw0[None, :]  # eta0 - log_phi0, log_phi0 = -sigma_raw0
    sp_d0 = np.logaddexp(0.0, d0)  # softplus
    sig_neg_d0 = 1.0 / (1.0 + np.exp(d0))
    y = np.asarray(data.host["counts"], dtype=np.float64)

    def dev(a):
        return torch.as_tensor(a, dtype=data.X.dtype, device=data.device).contiguous()

    return replace(
        data,
        alpha0=dev(alpha0),
        sigma_raw0=dev(sigma_raw0),
        d0=dev(d0),
        sp_d0=dev(sp_d0),
        sig_neg_d0=dev(sig_neg_d0),
        y_sp0=dev(y * np.logaddexp(0.0, -d0)),
    )


def stable_likelihood(data: ModelData, alpha: torch.Tensor, log_phi: torch.Tensor):
    """Masked likelihood in the float32-stable form, ignoring any baseline:
    alpha[B, C, G], log_phi[B, G] -> [B]. The plain version of K4."""
    eta = data.exposure_rate[:, None] + torch.matmul(data.X, alpha)  # [B, S, G]
    pts = nb2_log_lpmf_stable(data.counts, eta, log_phi.unsqueeze(1))
    return torch.sum(data.like_mask * pts, dim=(1, 2), dtype=torch.float64)


def masked_likelihood(data: ModelData, alpha: torch.Tensor, log_phi: torch.Tensor):
    """Masked NB2-log likelihood [B]: the delta form when baseline constants
    are attached (with_baseline), the stable form otherwise (nb_model.py:
    348-365 of the JAX package)."""
    if data.d0 is not None:
        return delta_likelihood(data, alpha, log_phi)
    return stable_likelihood(data, alpha, log_phi)


def delta_likelihood(data: ModelData, alpha: torch.Tensor, log_phi: torch.Tensor):
    """Delta-form masked likelihood on the unhoisted math, batched: the
    value half of K3's plain version (nb_model.py:401-475 of the JAX
    package, which derives each branch).

    softplus(d0 + dlo) = softplus(d0) + log1p(sigmoid(d0) * expm1(dlo)) near
    the baseline (-2 < dlo < 8), the direct stable forms outside, and the
    Poisson limit exp(log_phi + d) below d = -25; phi is capped at e^80.
    """
    delta_eta = torch.matmul(data.X, alpha - data.alpha0)  # [B, S, G]
    log_phi_c = torch.clamp(log_phi, max=80.0).unsqueeze(1)  # [B, 1, G]
    dlo = delta_eta - (log_phi_c + data.sigma_raw0)
    d_full = data.d0 + dlo

    y = data.counts.to(dlo.dtype)
    phi = torch.exp(log_phi_c)
    sig_d0 = 1.0 - data.sig_neg_d0

    dlo_m = torch.clamp(dlo, -2.0, 8.0)
    sp_d_mid = data.sp_d0 + log1p_precise(sig_d0 * expm1_precise(dlo_m))
    inc_neg_mid = log1p_precise(data.sig_neg_d0 * expm1_precise(-dlo_m))

    spn0 = data.sp_d0 - data.d0  # softplus(-d0)
    phi_sp_far = torch.where(
        d_full < -25.0,
        torch.exp(torch.clamp(log_phi_c + d_full, -60.0, 60.0)),
        phi * _softplus(d_full),
    )
    inc_neg_far = _softplus(-d_full) - spn0

    mid = (dlo > -2.0) & (dlo < 8.0)
    phi_sp = torch.where(mid, phi * sp_d_mid, phi_sp_far)
    inc_neg = torch.where(mid, inc_neg_mid, inc_neg_far)

    part1 = nb2_part1(y, phi.expand_as(dlo), log_phi_c.expand_as(dlo))
    pts = part1 - phi_sp - y * inc_neg - data.y_sp0
    return torch.sum(data.like_mask * pts, dim=(1, 2), dtype=torch.float64)


def _grads(data: ModelData, alpha: torch.Tensor, log_phi: torch.Tensor):
    """The closed-form (dalpha[B, C, G], dlog_phi[B, G]) at the plain eta,
    with or without a baseline, as JAX's analytic and fused forms take them
    (nb_model.py:489-494 of the JAX package)."""
    return nb_grad.likelihood_grads(data.X, data.exposure_rate, data.counts, data.like_mask,
                                    alpha, log_phi)


class _Analytic(torch.autograd.Function):
    """masked_likelihood forward, closed-form backward scaled by the
    cotangent; first-order only."""

    @staticmethod
    def forward(ctx, alpha, log_phi, data):
        ctx.data = data
        ctx.save_for_backward(alpha, log_phi)
        return masked_likelihood(data, alpha, log_phi)

    @staticmethod
    def backward(ctx, grad_out):
        alpha, log_phi = ctx.saved_tensors
        dalpha, dlog_phi = _grads(ctx.data, alpha, log_phi)
        grad_out = grad_out.to(dalpha.dtype)
        return grad_out[:, None, None] * dalpha, grad_out[:, None] * dlog_phi, None


def analytic_likelihood(data: ModelData, alpha: torch.Tensor, log_phi: torch.Tensor):
    """masked_likelihood [B] with closed-form gradients (nb_model.py:
    478-567 of the JAX package): the same forward (the delta form under a
    baseline, the stable form otherwise) and ops/nb_grad.likelihood_grads
    at the plain eta as its backward. Not differentiable twice: the
    samplers and ADVI take first derivatives only."""
    return _Analytic.apply(alpha, log_phi, data)


def _value_and_grads(data, alpha, log_phi, want_grads):
    """(value, dalpha, dlog_phi) in one call, the `compute` of
    nb_kernel._GradsInForward."""
    return (masked_likelihood(data, alpha, log_phi),) + _grads(data, alpha, log_phi)


def fused_likelihood(data: ModelData, alpha: torch.Tensor, log_phi: torch.Tensor):
    """masked_likelihood [B] with the closed-form gradients computed in the
    forward and stashed; the backward scales them by the cotangent
    (nb_model.py:570-670 of the JAX package). When nothing asks for a
    gradient (no_grad, or inputs that do not require one: the ADVI ELBO,
    the MH re-evaluation) only the value is computed, as JAX's primal.
    First-order only."""
    if nb_kernel._wants_grad(alpha, log_phi):
        return nb_kernel._GradsInForward.apply(alpha, log_phi, data, _value_and_grads)
    return masked_likelihood(data, alpha, log_phi)


def fast_likelihood(data: ModelData, alpha: torch.Tensor, log_phi: torch.Tensor):
    """The hoisted value + gradient likelihood (ops/nb_fast) [B], a drop-in
    `likelihood_fn` (nb_model.py:738-751 of the JAX package): the delta form
    when baseline constants are attached. On the card K1/K2
    (nb_kernel.nb_glm_likelihood_fast; in float64 their float64 forms), on
    the CPU their plain versions, nb_fast.glm_delta/glm_plain. First-order
    only, like the analytic and fused forms."""
    return nb_kernel.nb_glm_likelihood_fast(data, alpha, log_phi)


def nb_glm_loglik_reference(X, alpha, log_phi, exposure, counts, mask):
    """Unfolded lgamma form of the masked likelihood, batched: alpha[B, C, G],
    log_phi[B, G] -> [B] (ground truth of the kernel tests; nb_kernel.py:
    217-220 of the JAX package)."""
    eta = exposure[:, None] + torch.matmul(X, alpha)
    return torch.sum(mask * nb2_log_lpmf(counts, eta, log_phi.unsqueeze(1)), dim=(1, 2),
                     dtype=torch.float64)


def log_joint_tree(tree: dict, data: ModelData, dims: ModelDims, *, likelihood_fn=None,
                   shard=None) -> torch.Tensor:
    """Unnormalized log posterior in unconstrained space from a tree of
    leaves with a batch axis [B] (model/params.py) -> [B].

    The terms are evaluated in the leaves' dtype and summed in float64, so
    the result is float64 whatever their dtype: at -3e7 a float32 sum would
    round energy differences to nats. `likelihood_fn(data, alpha[B, C, G],
    log_phi[B, G]) -> [B]` picks the likelihood; None takes the default
    route, nb_kernel.nb_glm_likelihood_fast. With `shard` (a
    parallel.sharding.GeneShard; `data` then holds its genes) this is the
    shard's local part: per-gene terms over its genes, and the terms that
    appear once only on genes rank 0.
    """
    params, log_jac = unpack_tree(tree, dims.non_centered)
    gm = data.gene_mask
    col = lambda v: v.unsqueeze(-1)  # noqa: E731  [B] -> [B, 1] against [B, G]
    f64 = torch.float64
    once = shard is None or shard.rank == 0

    def total(x, dim=-1):
        return torch.sum(x, dim=dim, dtype=f64)

    lp = log_jac.to(f64) if once else torch.zeros(log_jac.shape, dtype=f64, device=gm.device)
    if once:
        # Hyperpriors (stan:210-216)
        for name, loc, scale in (("lambda_mu", LAMBDA_MU_MU, 2.0), ("lambda_sigma", 0.0, 2.0),
                                 ("lambda_skew", 0.0, 1.0), ("sigma_intercept", 0.0, 2.0),
                                 ("sigma_slope", 0.0, 2.0), ("sigma_sigma", 0.0, 2.0)):
            lp = lp + normal_lpdf(params[name], loc, scale).to(f64)

    if dims.non_centered:
        # Standardized-residual priors; unpack_tree rebuilds the centered
        # values. The same posterior as the centered form (stan:219, 223).
        lp = lp + total(gm * skew_normal_lpdf(tree["intercept"], 0.0, 1.0,
                                              col(params["lambda_skew"])))
        lp = lp + total(gm * normal_lpdf(tree["sigma_raw"], 0.0, 1.0))
    else:
        # Gene-wise priors, with the double lambda_mu_mu shift (stan:219)
        lp = lp + total(
            gm * skew_normal_lpdf(
                params["intercept"],
                col(params["lambda_mu"] + LAMBDA_MU_MU),
                col(params["lambda_sigma"]),
                col(params["lambda_skew"]),
            )
        )
        # Mean-overdispersion trend (stan:223)
        lp = lp + total(
            gm * normal_lpdf(
                params["sigma_raw"],
                col(params["sigma_slope"]) * params["intercept"] + col(params["sigma_intercept"]),
                col(params["sigma_sigma"]),
            )
        )
    if once and dims.C >= 2:
        lp = lp + total(double_exponential_lpdf(params["alpha_sub_1"], 0.0, 1.0))
    if once and dims.C >= 3:
        lp = lp + total(normal_lpdf(params["alpha_2"], 0.0, 2.5), dim=(-2, -1))

    # Pseudo-prior keeping padded-gene coordinates well-conditioned
    pad = 1.0 - gm
    lp = lp + total(pad * normal_lpdf(tree["intercept"], 0.0, 1.0))
    lp = lp + total(pad * normal_lpdf(tree["sigma_raw"], 0.0, 1.0))

    # Likelihood (stan:97-115): log phi = -sigma_raw (stan:203)
    alpha = make_alpha(params, dims, None if shard is None else shard.checked)
    if likelihood_fn is None:
        likelihood_fn = nb_kernel.nb_glm_likelihood_fast
    return lp + likelihood_fn(data, alpha, -params["sigma_raw"]).to(f64)


def log_joint(theta: torch.Tensor, data: ModelData, dims: ModelDims, *,
              likelihood_fn=None, shard=None) -> torch.Tensor:
    """log_joint_tree on a flat state theta[B, D] -> [B]; with `shard`,
    theta is the shard's local vector (parallel/sharding.py)."""
    tree = theta_to_tree(theta, dims if shard is None else shard.local_dims)
    return log_joint_tree(tree, data, dims, likelihood_fn=likelihood_fn, shard=shard)


def make_log_density(data: ModelData, dims: ModelDims, likelihood_fn=None, tree: bool = False):
    """Bind data: theta[B, D] -> [B], or with tree=True the model's tree
    (leaves with a leading [B]) -> [B]."""
    fn = log_joint_tree if tree else log_joint
    return functools.partial(fn, data=data, dims=dims, likelihood_fn=likelihood_fn)


def _resolve_likelihood_fn(likelihood: str):
    fns = {
        "plain": masked_likelihood,
        "analytic": analytic_likelihood,
        "fused": fused_likelihood,
        "fast": fast_likelihood,
        "pallas": nb_kernel.nb_glm_likelihood,
        "pallas_fused": nb_kernel.nb_glm_likelihood_fused,
    }
    if likelihood not in fns:
        raise ValueError(f"unknown likelihood {likelihood!r} (use one of {sorted(fns)} or 'auto')")
    return fns[likelihood]


def flat_logp(dims: ModelDims, likelihood: str = "auto"):
    """Data-parametrized flat log density `f(theta[B, D], data) -> [B]`.

    likelihood: "plain" (torch autograd through `masked_likelihood`, delta
    form when a baseline is attached), "analytic" (the same forward, the
    closed-form backward of ops/nb_grad), "fused" (the same value with the
    closed-form gradients computed in the forward, the value alone when no
    gradient is wanted), "fast" (fast_likelihood: K1 with a baseline, K2
    without, or in float64 their float64 forms), "pallas" (nb_kernel.nb_glm_likelihood:
    the stable form, value and gradients in one K5 launch, K4 under no_grad;
    baseline ignored),
    "pallas_fused" (nb_kernel.nb_glm_likelihood_fused: K3, needs a
    baseline), or "auto" (= "fast" on every device).

    With `shard` (a parallel.sharding.GeneShard) theta is the shard's local
    flat vector and data its genes, and f is the shard's local part of the
    log joint (the counterpart of JAX's tree_logp, nb_model.py:833-875), so
    every route also runs per shard.
    """
    lfn = _resolve_likelihood_fn("fast" if likelihood == "auto" else likelihood)

    def f(theta, data, shard=None):
        return log_joint(theta, data, dims, likelihood_fn=lfn, shard=shard)

    return f


def tree_logp(dims: ModelDims, likelihood: str = "auto"):
    """The model-tree counterpart of flat_logp (nb_model.py:824-838 of the
    JAX package): `f(tree, data, shard=None) -> [B]` over the model's tree
    with a leading [B] on every leaf (params.theta_to_tree), a gene shard's
    local tree with `shard`. The likelihood routes are flat_logp's."""
    lfn = _resolve_likelihood_fn("fast" if likelihood == "auto" else likelihood)

    def f(tree, data, shard=None):
        return log_joint_tree(tree, data, dims, likelihood_fn=lfn, shard=shard)

    return f


def _x_alpha(X: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """X[S, C] @ alpha[..., C, G] -> [..., S, G] as C explicit multiply-adds,
    so no matmul setting (TF32 on CUDA) can round it."""
    out = X[:, 0, None] * alpha[..., None, 0, :]
    for c in range(1, X.shape[1]):
        out = out + X[:, c, None] * alpha[..., None, c, :]
    return out


def lambda_log(params: dict, data: ModelData, dims: ModelDims) -> torch.Tensor:
    """lambda_log_param[..., S, G] = X @ alpha (stan:205; nb_model.py:275 of
    the JAX package) from constrained parameters with any leading axes."""
    return _x_alpha(data.X, make_alpha(params, dims))


def extract_lambda_sigma_draws(thetas: torch.Tensor, data: ModelData, dims: ModelDims):
    """(lambda_log_param[n, S, n_check], sigma_raw[n, n_check]) from draws
    thetas[n, D] (reference R/utilities.R:1373): lambda_log's multiply-adds
    on the checked genes alone."""
    params, _ = unpack(thetas, dims)
    alpha = make_alpha(params, dims)[..., : dims.n_check]  # [n, C, K]
    return _x_alpha(data.X, alpha), params["sigma_raw"][..., : dims.n_check]


def extract_alpha_sub_1_draws(thetas: torch.Tensor, dims: ModelDims) -> torch.Tensor:
    lo, hi = _offsets(dims)["alpha_sub_1"]
    return thetas[:, lo:hi]


def smart_init(data: ModelData, dims: ModelDims, as_tree: bool = False):
    """Data-driven initialization point in unconstrained space (float64):
    a [D] NumPy vector, or with as_tree=True the model's tree of float64
    tensors (params.theta_to_tree).

    Pure NumPy on `data.host` (the arrays that were uploaded): per-gene
    least squares of log depth-adjusted counts on the design gives
    intercept/slope, method-of-moments gives overdispersion, and the
    hyperparameters are the empirical moments of those estimates.
    """
    counts = np.asarray(data.host["counts"], dtype=np.float64)
    X = np.asarray(data.host["X"], dtype=np.float64)
    exposure = np.asarray(data.host["exposure_rate"], dtype=np.float64)
    mask = np.asarray(data.host["like_mask"], dtype=bool)

    adj = counts / np.exp(exposure)[:, None]  # depth-adjusted counts [S, G]
    y = np.log(adj + 0.5)
    # exclude masked points from the regression by imputing the column mean
    col_mean = np.where(
        mask.sum(0) > 0, (y * mask).sum(0) / np.maximum(mask.sum(0), 1), 0.0
    )
    y = np.where(mask, y, col_mean[None, :])
    # normal equations (C is tiny); fall back on rank deficiency
    try:
        beta = np.linalg.solve(X.T @ X, X.T @ y)  # [C, G]
    except np.linalg.LinAlgError:
        beta, *_ = np.linalg.lstsq(X, y, rcond=None)

    intercept = beta[0]
    mu_hat = np.exp(X @ beta)  # [S, G]
    resid_var = ((adj - mu_hat) ** 2 * mask).sum(0) / np.maximum(mask.sum(0) - X.shape[1], 1)
    mu_bar = np.maximum((mu_hat * mask).sum(0) / np.maximum(mask.sum(0), 1), 1e-3)
    phi = mu_bar**2 / np.maximum(resid_var - mu_bar, mu_bar * 1e-2)
    phi = np.clip(phi, 1e-3, 1e4)
    sigma_raw = -np.log(phi)

    real = np.asarray(data.host["gene_mask"], dtype=bool)
    ic_real = intercept[real]
    sr_real = sigma_raw[real]
    lam_mu = float(ic_real.mean())
    lam_sd = float(max(ic_real.std(), 0.1))
    # sigma_raw ~ a + b * intercept trend
    A = np.column_stack([np.ones(real.sum()), ic_real])
    (s_int, s_slope), *_ = np.linalg.lstsq(A, sr_real, rcond=None)
    s_slope = min(s_slope, -1e-3)  # constrained negative in the model
    trend_resid = sr_real - (s_int + s_slope * ic_real)
    s_sigma = float(max(trend_resid.std(), 0.1))

    theta = np.zeros(dims.dim)
    o = _offsets(dims)
    theta[o["lambda_mu"][0]] = lam_mu - 2 * LAMBDA_MU_MU
    theta[o["lambda_sigma"][0]] = np.log(lam_sd)
    theta[o["lambda_skew"][0]] = 0.0
    theta[o["sigma_slope"][0]] = np.log(-s_slope)
    theta[o["sigma_intercept"][0]] = s_int
    theta[o["sigma_sigma"][0]] = np.log(s_sigma)
    theta[o["intercept"][0] : o["intercept"][1]] = np.where(real, intercept, 0.0)
    theta[o["sigma_raw"][0] : o["sigma_raw"][1]] = np.where(real, sigma_raw, 0.0)
    if dims.C >= 2:
        lo, hi = o["alpha_sub_1"]
        theta[lo:hi] = beta[1, : dims.n_check]
    if dims.C >= 3:
        lo, hi = o["alpha_2"]
        theta[lo:hi] = beta[2:, : dims.n_check].reshape(-1)

    if dims.non_centered:
        # the centered estimates as standardized residuals
        ic = theta[o["intercept"][0] : o["intercept"][1]]
        sr = theta[o["sigma_raw"][0] : o["sigma_raw"][1]]
        t_i = (ic - lam_mu) / lam_sd
        t_s = (sr - (s_int + s_slope * ic)) / s_sigma
        theta[o["intercept"][0] : o["intercept"][1]] = np.where(real, t_i, 0.0)
        theta[o["sigma_raw"][0] : o["sigma_raw"][1]] = np.where(real, t_s, 0.0)

    if as_tree:
        return theta_to_tree(torch.as_tensor(theta), dims)
    return theta
