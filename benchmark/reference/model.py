"""Plain reference of the model's log density (reference
inst/stan/negBinomial_MPI.stan:97-223), in torch.

The unconstrained state theta[B, D] is laid out as the reference's
parameters block: the six hyperparameters (lambda_mu - lambda_mu_mu,
log lambda_sigma, lambda_skew, log(-sigma_slope), sigma_intercept,
log sigma_sigma), intercept[G], sigma_raw[G], alpha_sub_1[K], then
alpha_2[C-2, K] row by row. The density is the unnormalized log posterior
with every constant of the lpdfs and lpmfs and the log-Jacobian of the
transforms; the NB2 likelihood is the plain lgamma form over the points
that `like_mask` keeps.

`precision` "float64" is the reference; "bfloat16" is its control: every
elementwise result rounded to bfloat16, the sums accumulated in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LAMBDA_MU_MU = 5.612671
LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


@dataclass
class ModelArrays:
    counts: torch.Tensor     # [S, G] float64
    X: torch.Tensor          # [S, C] float64
    exposure: torch.Tensor   # [S] float64
    like_mask: torch.Tensor  # [S, G] float64, 1 = in the likelihood
    n_check: int

    @property
    def dim(self) -> int:
        S, G = self.counts.shape
        C = self.X.shape[1]
        return 6 + 2 * G + self.n_check + max(0, C - 2) * self.n_check


def _rounding(precision: str):
    if precision == "float64":
        return lambda t: t, torch.float64
    if precision == "bfloat16":
        return lambda t: t.to(torch.bfloat16).to(torch.float32), torch.float32
    raise ValueError(precision)


def log_density(theta: torch.Tensor, m: ModelArrays, precision: str = "float64") -> torch.Tensor:
    """theta[B, D] -> [B] (float64)."""
    r, acc = _rounding(precision)
    th = r(theta.to(acc))
    S, G = m.counts.shape
    C, K = m.X.shape[1], m.n_check

    def normal(x, mu, sd):
        z = r((x - mu) / sd)
        return r(-0.5 * z * z - torch.log(torch.as_tensor(sd, dtype=acc, device=x.device))
                 - LOG_SQRT_2PI)

    lambda_mu = r(th[:, 0] + LAMBDA_MU_MU)
    lambda_sigma = r(torch.exp(th[:, 1]))
    lambda_skew = th[:, 2]
    sigma_slope = r(-torch.exp(th[:, 3]))
    sigma_intercept = th[:, 4]
    sigma_sigma = r(torch.exp(th[:, 5]))
    intercept = th[:, 6:6 + G]
    sigma_raw = th[:, 6 + G:6 + 2 * G]
    a1 = th[:, 6 + 2 * G:6 + 2 * G + K]
    a2 = th[:, 6 + 2 * G + K:].reshape(th.shape[0], max(0, C - 2), K)

    lp = th[:, 1] + th[:, 3] + th[:, 5]
    for x, mu, sd in ((lambda_mu, LAMBDA_MU_MU, 2.0), (lambda_sigma, 0.0, 2.0),
                      (lambda_skew, 0.0, 1.0), (sigma_intercept, 0.0, 2.0),
                      (sigma_slope, 0.0, 2.0), (sigma_sigma, 0.0, 2.0)):
        lp = lp + normal(x, mu, sd)
    # intercept ~ skew_normal(lambda_mu + lambda_mu_mu, lambda_sigma, lambda_skew)
    xi, om = r(lambda_mu + LAMBDA_MU_MU)[:, None], lambda_sigma[:, None]
    z = r((intercept - xi) / om)
    sn = r(math.log(2.0) - 0.5 * z * z - torch.log(om) - LOG_SQRT_2PI
           + torch.special.log_ndtr(r(lambda_skew[:, None] * z)))
    lp = lp + torch.sum(sn, dim=1, dtype=acc)
    # sigma_raw ~ normal(sigma_slope * intercept + sigma_intercept, sigma_sigma)
    trend = r(sigma_slope[:, None] * intercept + sigma_intercept[:, None])
    zs = r((sigma_raw - trend) / sigma_sigma[:, None])
    lp = lp + torch.sum(r(-0.5 * zs * zs - torch.log(sigma_sigma)[:, None] - LOG_SQRT_2PI),
                        dim=1, dtype=acc)
    if C >= 2:
        lp = lp + torch.sum(r(-torch.abs(a1) - math.log(2.0)), dim=1, dtype=acc)
    if C >= 3:
        z2 = r(a2 / 2.5)
        lp = lp + torch.sum(r(-0.5 * z2 * z2 - math.log(2.5) - LOG_SQRT_2PI), dim=(1, 2),
                            dtype=acc)
    return (lp.to(torch.float64) + likelihood(intercept, sigma_raw, a1, a2, m, precision))


def likelihood(intercept, sigma_raw, a1, a2, m: ModelArrays, precision: str = "float64",
               block_points: int = 1 << 25) -> torch.Tensor:
    """Sum over kept points of log NB2(y | exp(eta), phi): eta = exposure +
    X @ alpha, alpha's rows the intercept, alpha_sub_1 and alpha_2 on the
    checked genes (zero elsewhere), phi = exp(-sigma_raw). Evaluated in
    blocks of the batch so that at most `block_points` points live at once."""
    r, acc = _rounding(precision)
    B, G = intercept.shape
    S, C, K = m.X.shape[0], m.X.shape[1], m.n_check
    X, y = r(m.X.to(acc)), m.counts.to(acc)
    expo, mask = r(m.exposure.to(acc)), m.like_mask.to(acc)
    lg_y1 = r(torch.lgamma(y + 1))
    out = []
    step = max(1, block_points // (S * G))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        alpha = torch.zeros((b1 - b0, C, G), dtype=acc, device=intercept.device)
        alpha[:, 0] = intercept[b0:b1]
        if C >= 2:
            alpha[:, 1, :K] = a1[b0:b1]
        if C >= 3:
            alpha[:, 2:, :K] = a2[b0:b1]
        eta = expo[None, :, None]
        for c in range(C):  # X @ alpha as multiply-adds
            eta = r(eta + r(X[None, :, c, None] * alpha[:, None, c, :]))
        log_phi = r(-sigma_raw[b0:b1])[:, None, :]
        phi = r(torch.exp(log_phi))
        log_mu_phi = r(torch.logaddexp(eta, log_phi))
        pts = (r(torch.lgamma(r(y + phi))) - r(torch.lgamma(phi)) - lg_y1
               + r(phi * r(log_phi - log_mu_phi)) + r(y * r(eta - log_mu_phi)))
        out.append(torch.sum(r(pts) * mask, dim=(1, 2), dtype=acc).to(torch.float64))
    return torch.cat(out)


def log_density_grad(theta: torch.Tensor, m: ModelArrays, block_points: int = 1 << 25
                     ) -> torch.Tensor:
    """The gradient of the float64 log density at each row of theta[B, D]:
    [B, D], by autograd, in blocks of rows so that at most `block_points`
    data points live at once."""
    step = max(1, block_points // m.counts.numel())
    out = []
    for b0 in range(0, theta.shape[0], step):
        x = theta[b0:b0 + step].detach().to(torch.float64).requires_grad_(True)
        (g,) = torch.autograd.grad(log_density(x, m).sum(), x)
        out.append(g)
    return torch.cat(out)
