"""Prior densities of the log-joint, in torch (ppcseq_tpu/ops/nb.py).

Only the densities the model's priors need (reference
inst/stan/negBinomial_MPI.stan:210-223); the NB2 likelihood lives in
ops/nb_fast.py (plain version) and ops/nb_kernel.py (the CUDA kernel).
"""

from __future__ import annotations

import math

import torch

LOG2 = 0.6931471805599453
LOG_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))


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
