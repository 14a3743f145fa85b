"""The hierarchical negative-binomial GLM as a batched torch log-joint.

A port of ppcseq_tpu/model/nb_model.py (flat state, centered
parametrization, delta-form likelihood). See that module for the model
(reference inst/stan/negBinomial_MPI.stan): parameters, transforms,
priors with the double lambda_mu_mu shift, the masked NB2-log likelihood
and the pad pseudo-prior.

Differences in form, not in math:
- `theta` carries a leading batch axis: `log_joint(theta[B, D]) -> [B]`,
  so the ADVI samples go through the likelihood kernel in one launch.
- Host arrays stay on the host: `prepare_data` keeps NumPy copies of the
  uploaded arrays (`ModelData.host`), and `smart_init`/`with_baseline`
  compute from them in float64 without reading the device back.
- The likelihood is chosen by `flat_logp(dims, likelihood)`: the default
  ("auto" = "fast") is the hoisted kernel pair K1/K2 through ops/nb_kernel
  (the CUDA kernels on the card, their plain versions on the CPU);
  "plain" is torch autograd through `masked_likelihood`; "pallas" and
  "pallas_fused" are the stable form (K5 under grad, K4 under no_grad) and
  the one-pass K3.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ppcseq_tpu_torch.ops import nb_kernel
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

_SCALARS = ("lambda_mu", "lambda_sigma", "lambda_skew", "sigma_slope",
            "sigma_intercept", "sigma_sigma")


@dataclass(frozen=True)
class ModelDims:
    """Static dimensions of one fit."""

    S: int  # samples
    G: int  # genes incl. negative controls (possibly padded)
    C: int  # design-matrix columns
    n_check: int  # genes under test; G indices [0, n_check)
    G_unpadded: int  # real genes; [G_unpadded, G) are padding

    @property
    def n_alpha2(self) -> int:
        return max(0, self.C - 2) * self.n_check

    @property
    def dim(self) -> int:
        """Unconstrained parameter dimension."""
        return 6 + 2 * self.G + self.n_check + self.n_alpha2


def _offsets(d: ModelDims):
    """Offsets into the flat unconstrained vector (same layout as JAX)."""
    o = {}
    pos = 0
    for name, size in [
        ("lambda_mu", 1),
        ("lambda_sigma", 1),
        ("lambda_skew", 1),
        ("sigma_slope", 1),
        ("sigma_intercept", 1),
        ("sigma_sigma", 1),
        ("intercept", d.G),
        ("sigma_raw", d.G),
        ("alpha_sub_1", d.n_check),
        ("alpha_2", d.n_alpha2),
    ]:
        o[name] = (pos, pos + size)
        pos += size
    return o


def theta_to_tree(theta: torch.Tensor, dims: ModelDims) -> dict:
    """theta[..., D] -> dict of views: scalars [...], vectors [..., n]."""
    o = _offsets(dims)
    tree = {n: theta[..., o[n][0]] for n in _SCALARS}
    for n in ("intercept", "sigma_raw", "alpha_sub_1"):
        tree[n] = theta[..., o[n][0]:o[n][1]]
    if dims.C > 2:
        lo, hi = o["alpha_2"]
        tree["alpha_2"] = theta[..., lo:hi].reshape(theta.shape[:-1] + (dims.C - 2, dims.n_check))
    return tree


def unpack(theta: torch.Tensor, dims: ModelDims) -> tuple[dict, torch.Tensor]:
    """theta[..., D] -> constrained parameters + log-Jacobian [...]."""
    tree = theta_to_tree(theta, dims)
    params = {
        "lambda_mu": tree["lambda_mu"] + LAMBDA_MU_MU,
        "lambda_sigma": torch.exp(tree["lambda_sigma"]),
        "lambda_skew": tree["lambda_skew"],
        "sigma_slope": -torch.exp(tree["sigma_slope"]),
        "sigma_intercept": tree["sigma_intercept"],
        "sigma_sigma": torch.exp(tree["sigma_sigma"]),
        "intercept": tree["intercept"],
        "sigma_raw": tree["sigma_raw"],
        "alpha_sub_1": tree["alpha_sub_1"],
        "alpha_2": tree.get(
            "alpha_2", theta.new_zeros(theta.shape[:-1] + (0, dims.n_check))
        ),
    }
    log_jac = tree["lambda_sigma"] + tree["sigma_slope"] + tree["sigma_sigma"]
    return params, log_jac


def make_alpha(params: dict, dims: ModelDims) -> torch.Tensor:
    """alpha[..., C, G]: merge_coefficients with zero-padding (stan:122-139)."""
    G, C, K = dims.G, dims.C, dims.n_check
    icpt = params["intercept"]
    batch = icpt.shape[:-1]
    rows = [icpt.unsqueeze(-2)]
    if C >= 2:
        pad = icpt.new_zeros(batch + (1, G - K))
        rows.append(torch.cat([params["alpha_sub_1"].unsqueeze(-2), pad], dim=-1))
    if C >= 3:
        pad = icpt.new_zeros(batch + (C - 2, G - K))
        rows.append(torch.cat([params["alpha_2"], pad], dim=-1))
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
    dims = ModelDims(S=S, G=G, C=X.shape[1], n_check=n_check, G_unpadded=G_real)
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


def nb_glm_loglik_reference(X, alpha, log_phi, exposure, counts, mask):
    """Unfolded lgamma form of the masked likelihood, batched: alpha[B, C, G],
    log_phi[B, G] -> [B] (ground truth of the kernel tests; nb_kernel.py:
    217-220 of the JAX package)."""
    eta = exposure[:, None] + torch.matmul(X, alpha)
    return torch.sum(mask * nb2_log_lpmf(counts, eta, log_phi.unsqueeze(1)), dim=(1, 2),
                     dtype=torch.float64)


def log_joint(theta: torch.Tensor, data: ModelData, dims: ModelDims, *,
              likelihood_fn=None) -> torch.Tensor:
    """Unnormalized log posterior in unconstrained space: theta[B, D] -> [B].

    The terms are evaluated in theta's dtype and summed in float64, so the
    result is float64 whatever theta's dtype: at -3e7 a float32 sum would
    round energy differences to nats. `likelihood_fn(data, alpha[B, C, G],
    log_phi[B, G]) -> [B]` picks the likelihood; None takes the default
    route, nb_kernel.nb_glm_likelihood_fast.
    """
    params, log_jac = unpack(theta, dims)
    gm = data.gene_mask
    col = lambda v: v.unsqueeze(-1)  # noqa: E731  [B] -> [B, 1] against [B, G]
    f64 = torch.float64

    def total(x, dim=-1):
        return torch.sum(x, dim=dim, dtype=f64)

    lp = log_jac.to(f64)
    # Hyperpriors (stan:210-216)
    for name, loc, scale in (("lambda_mu", LAMBDA_MU_MU, 2.0), ("lambda_sigma", 0.0, 2.0),
                             ("lambda_skew", 0.0, 1.0), ("sigma_intercept", 0.0, 2.0),
                             ("sigma_slope", 0.0, 2.0), ("sigma_sigma", 0.0, 2.0)):
        lp = lp + normal_lpdf(params[name], loc, scale).to(f64)

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
    if dims.C >= 2:
        lp = lp + total(double_exponential_lpdf(params["alpha_sub_1"], 0.0, 1.0))
    if dims.C >= 3:
        lp = lp + total(normal_lpdf(params["alpha_2"], 0.0, 2.5), dim=(-2, -1))

    # Pseudo-prior keeping padded-gene coordinates well-conditioned
    pad = 1.0 - gm
    lp = lp + total(pad * normal_lpdf(params["intercept"], 0.0, 1.0))
    lp = lp + total(pad * normal_lpdf(params["sigma_raw"], 0.0, 1.0))

    # Likelihood (stan:97-115): log phi = -sigma_raw (stan:203)
    alpha = make_alpha(params, dims)
    if likelihood_fn is None:
        likelihood_fn = nb_kernel.nb_glm_likelihood_fast
    return lp + likelihood_fn(data, alpha, -params["sigma_raw"]).to(f64)


def make_log_density(data: ModelData, dims: ModelDims, likelihood_fn=None):
    """Bind data: theta[B, D] -> [B]."""
    return functools.partial(log_joint, data=data, dims=dims, likelihood_fn=likelihood_fn)


_NOT_TO_PORT = ("the XLA-only likelihood variants 'analytic' and 'fused' are not ported "
                "(ROADMAP.md, queue 1: not to port)")


def _resolve_likelihood_fn(likelihood: str):
    fns = {
        "plain": masked_likelihood,
        "fast": nb_kernel.nb_glm_likelihood_fast,
        "pallas": nb_kernel.nb_glm_likelihood,
        "pallas_fused": nb_kernel.nb_glm_likelihood_fused,
    }
    if likelihood in ("analytic", "fused"):
        raise NotImplementedError(_NOT_TO_PORT)
    if likelihood not in fns:
        raise ValueError(f"unknown likelihood {likelihood!r} (use one of {sorted(fns)} or 'auto')")
    return fns[likelihood]


def flat_logp(dims: ModelDims, likelihood: str = "auto"):
    """Data-parametrized flat log density `f(theta[B, D], data) -> [B]`.

    likelihood: "plain" (torch autograd through `masked_likelihood`, delta
    form when a baseline is attached), "fast" (nb_kernel.nb_glm_likelihood_fast:
    K1 with a baseline, K2 without), "pallas" (nb_kernel.nb_glm_likelihood:
    the stable form, value and gradients in one K5 launch, K4 under no_grad;
    baseline ignored),
    "pallas_fused" (nb_kernel.nb_glm_likelihood_fused: K3, needs a
    baseline), or "auto" (= "fast" on every device).
    """
    lfn = _resolve_likelihood_fn("fast" if likelihood == "auto" else likelihood)

    def f(theta, data):
        return log_joint(theta, data, dims, likelihood_fn=lfn)

    return f


def extract_lambda_sigma_draws(thetas: torch.Tensor, data: ModelData, dims: ModelDims):
    """(lambda_log_param[n, S, n_check], sigma_raw[n, n_check]) from draws
    thetas[n, D] (reference R/utilities.R:1373). X @ alpha is C explicit
    multiply-adds, so no matmul setting (TF32 on CUDA) can round it."""
    params, _ = unpack(thetas, dims)
    alpha = make_alpha(params, dims)[..., : dims.n_check]  # [n, C, K]
    lam = data.X[:, 0, None] * alpha[:, None, 0, :]  # [S, 1] * [n, 1, K] -> [n, S, K]
    for c in range(1, dims.C):
        lam = lam + data.X[:, c, None] * alpha[:, None, c, :]
    return lam, params["sigma_raw"][..., : dims.n_check]


def extract_alpha_sub_1_draws(thetas: torch.Tensor, dims: ModelDims) -> torch.Tensor:
    lo, hi = _offsets(dims)["alpha_sub_1"]
    return thetas[:, lo:hi]


def smart_init(data: ModelData, dims: ModelDims) -> np.ndarray:
    """Data-driven initialization point in unconstrained space (float64).

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
    return theta
