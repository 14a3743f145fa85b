"""Negative-binomial (NB2) log-pmf and the prior densities, in torch
(ppcseq_tpu/ops/nb.py).

The priors are the model's (reference inst/stan/negBinomial_MPI.stan:
210-223). The stable lpmf family below is the plain math of the stable-form
likelihood kernels (K4 in csrc/nb_glm_stable.cu) and of the one-pass
delta-form kernel (K3 in csrc/nb_glm_fused.cu): every intermediate stays
O(|lpmf|)-moderate so a float32 sum over millions of points keeps absolute
accuracy. See the JAX module for the branch derivations. All functions are
elementwise and broadcast; integer counts are cast to the dtype of eta.
"""

from __future__ import annotations

import math

import torch

LOG2 = 0.6931471805599453
LOG_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))
LOG_PHI_CAP = 80.0
# log(k+1) for k = 0..6
LOG_KP1 = [0.0] + [math.log(k + 1) for k in range(1, 7)]


def _float(y, like):
    return y.to(like.dtype) if not y.is_floating_point() else y


def nb2_log_lpmf(y, eta, log_phi):
    """log NegBinomial2(y | mu=exp(eta), phi=exp(log_phi)), elementwise
    (Stan neg_binomial_2_log_lpmf, stan:98-103), with lgamma."""
    phi = torch.exp(log_phi)
    yf = _float(y, eta)
    log_mu_phi = torch.logaddexp(eta, log_phi)
    return (
        torch.lgamma(yf + phi)
        - torch.lgamma(phi)
        - torch.lgamma(yf + 1.0)
        + phi * log_phi
        + yf * eta
        - (yf + phi) * log_mu_phi
    )


def nb2_log_lpmf_stable(y, eta, log_phi):
    """NB2-log lpmf as float32-moderate terms (phi capped at e^80):
    part1 + part23, part23 = -phi*softplus(d) - y*softplus(-d), d = eta - log_phi."""
    yf = _float(y, eta)
    log_phi = torch.clamp(log_phi, max=LOG_PHI_CAP)
    phi = torch.exp(log_phi)
    d = eta - log_phi
    part23 = -phi * _softplus(d) - yf * _softplus(-d)
    return nb2_part1(yf, phi, log_phi) + part23


def nb2_part1(yf, phi, log_phi):
    """lgamma(y+phi) - lgamma(y+1) - lgamma(phi), float32-moderate branches:
    the exact product for y <= 7, Stirling differences above (fully
    cancelled for phi >= 8)."""
    part_a = torch.zeros_like(phi)
    for k in range(7):
        part_a = part_a + torch.where(yf > k, torch.log(phi + k) - LOG_KP1[k], 0.0)

    d = phi - 1.0
    ys = torch.clamp(yf, min=8.0)  # keep the unused branch finite
    a1s = ys + phi
    a2s = ys + 1.0
    corr12 = (1.0 / 12.0) * (1.0 / a1s - 1.0 / a2s)
    corr360 = (-1.0 / 360.0) * (1.0 / a1s**3 - 1.0 / a2s**3)
    pair = (a2s - 0.5) * log1p_precise(d / a2s) + corr12 + corr360

    phis = torch.clamp(phi, min=8.0)
    part_b = (
        pair
        + (phis - 1.0) * log1p_precise(ys / phis)
        - 0.5 * torch.log(phis)
        + 1.0
        - 0.5 * math.log(2.0 * math.pi)
        - 1.0 / (12.0 * phis)
        + 1.0 / (360.0 * phis**3)
    )
    part_c = pair + d * torch.log(a1s) - d - _lgamma_pos_small(torch.clamp(phi, max=8.0))
    return torch.where(yf <= 7.0, part_a, torch.where(phi >= 8.0, part_b, part_c))


def log1p_precise(u):
    """log(1+u): odd atanh series on -1/3 < u < 1/2, log(1+u) outside."""
    z = u / (2.0 + u)
    z2 = z * z
    small = 2.0 * z * (1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0 + z2 / 9.0))))
    return torch.where((u > -1.0 / 3.0) & (u < 0.5), small, torch.log(1.0 + u))


def expm1_precise(x):
    """exp(x)-1: Taylor polynomial for |x| < 0.35, exp(x)-1 outside."""
    p = x * (1.0 + x * (0.5 + x * (1.0 / 6.0 + x * (1.0 / 24.0 + x * (
        1.0 / 120.0 + x * (1.0 / 720.0 + x / 5040.0))))))
    return torch.where(torch.abs(x) < 0.35, p, torch.exp(x) - 1.0)


def _softplus(x):
    """log(1 + exp(x)), stable for both signs."""
    return torch.clamp(x, min=0.0) + log1p_precise(torch.exp(-torch.abs(x)))


def _lgamma_pos_small(x):
    """lgamma for 0 < x <= 8 via shift-by-8 Stirling."""
    xs = x + 8.0
    inv = 1.0 / xs
    inv2 = inv * inv
    stirling = (
        (xs - 0.5) * torch.log(xs)
        - xs
        + 0.5 * math.log(2.0 * math.pi)
        + inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)))
    )
    shift = torch.zeros_like(x)
    for k in range(8):
        shift = shift + torch.log(x + k)
    return stirling - shift


def normal_lpdf(x, mu, sigma):
    z = (x - mu) / sigma
    log_sigma = torch.log(sigma) if isinstance(sigma, torch.Tensor) else math.log(sigma)
    return -0.5 * z * z - log_sigma - LOG_SQRT_2PI


def skew_normal_lpdf(x, xi, omega, alpha):
    """Stan skew_normal_lpdf: log(2) + normal_lpdf(x|xi,omega) + log Phi(alpha*z)."""
    z = (x - xi) / omega
    return LOG2 + normal_lpdf(x, xi, omega) + torch.special.log_ndtr(alpha * z)


def double_exponential_lpdf(x, mu, sigma):
    return -torch.abs(x - mu) / sigma - math.log(2.0 * sigma)


def nb2_log_rng(generator: torch.Generator, eta, phi) -> torch.Tensor:
    """NegBinomial2(mu = exp(eta), phi) draws as int64, Stan's
    neg_binomial_2_log_rng (stan:259-265; ops/nb.py:192 of the JAX
    package): rate = exp(eta) / phi * Gamma(phi, 1), then Poisson(rate).
    The Gamma is drawn in phi's dtype, the Poisson on float64 rates (exact
    integers to 2^53; torch.poisson returns floating point), so float64
    inputs keep the prior's extreme-precision corner (phi up to ~1e16 mu)
    exact. eta and phi broadcast."""
    shape = torch.broadcast_shapes(eta.shape, phi.shape)
    g = torch._standard_gamma(phi.expand(shape).contiguous(), generator=generator)
    rate = torch.exp(eta) / phi * g
    return torch.poisson(rate.double(), generator=generator).to(torch.int64)
