"""Analytic gradients of the masked NB2-log GLM likelihood, in torch
(ppcseq_tpu/ops/nb_grad.py), batched over a leading B.

    d lpmf / d eta      = y - (y + phi) * sigmoid(d),          d = eta - log_phi
    d lpmf / d log_phi  = phi*(digamma(y+phi) - digamma(phi))
                          - phi*(softplus(d) - sigmoid(d)) - y*sigmoid(-d)

The second line is the float32-moderate regrouping: every term is O(y).
See the JAX module for the branch derivations. `likelihood_grads` is the
gradient half of the plain version of the stable-form backward kernel (K5
in csrc/nb_glm_stable.cu) and of the one-pass delta-form kernel (K3 in
csrc/nb_glm_fused.cu, which evaluates the same terms at d = d0 + dlo).
"""

from __future__ import annotations

import torch

from ppcseq_tpu_torch.ops.nb import _float, _softplus, log1p_precise
from ppcseq_tpu_torch.ops.nb_fast import _dalpha_small

LOG_PHI_CAP = 80.0


def _psi_asym(x):
    """digamma(x) for x >= 8: asymptotic series."""
    inv = 1.0 / x
    inv2 = inv * inv
    return torch.log(x) - 0.5 * inv - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))


def phi_digamma_diff(yf, phi):
    """phi * (digamma(y + phi) - digamma(phi)), float32-moderate (O(y))."""
    part_a = torch.zeros_like(phi)
    for k in range(7):
        part_a = part_a + torch.where(yf > k, phi / (phi + k), 0.0)

    ys = torch.clamp(yf, min=8.0)  # keep unselected branches finite
    phis = torch.clamp(phi, min=8.0)
    a = ys + phis
    part_b = (
        phis * log1p_precise(ys / phis)
        + 0.5 * ys / a
        + (1.0 / 12.0) * (1.0 / phis - phis / (a * a))
        - (1.0 / 120.0) * (1.0 / phis**3 - phis / (a**2) ** 2)
    )

    phic = torch.clamp(phi, max=8.0)
    shift = torch.zeros_like(phi)
    for k in range(8):
        shift = shift + phic / (phic + k)
    part_c = phic * (_psi_asym(ys + phic) - _psi_asym(phic + 8.0)) + shift
    return torch.where(yf <= 7.0, part_a, torch.where(phi >= 8.0, part_b, part_c))


def phi_softplus_minus_sigmoid(d, log_phi):
    """phi * (softplus(d) - sigmoid(d)) >= 0: a log-space series for
    d <= -1.386, the direct difference above."""
    dn = torch.clamp(d, max=0.0)
    u = torch.exp(dn)
    series = 0.5 - u * (
        2.0 / 3.0 - u * (0.75 - u * (0.8 - u * (5.0 / 6.0 - u * (6.0 / 7.0 - u * 0.875))))
    )
    small = torch.exp(log_phi + 2.0 * dn) * series
    em = torch.exp(-torch.abs(d))
    sig = torch.where(d > 0, 1.0 / (1.0 + em), em / (1.0 + em))
    direct = torch.exp(log_phi) * (_softplus(d) - sig)
    return torch.where(d <= -1.386, small, direct)


def nb2_grads(y, eta, log_phi):
    """(d lpmf/d eta, d lpmf/d log_phi) of the NB2-log lpmf, elementwise;
    log_phi is capped at 80 and the log_phi-gradient is 0 beyond the cap."""
    yf = _float(y, eta)
    log_phi_c = torch.clamp(log_phi, max=LOG_PHI_CAP)
    phi = torch.exp(log_phi_c)
    d = eta - log_phi_c
    em = torch.exp(-torch.abs(d))
    q = torch.where(d > 0, em / (1.0 + em), 1.0 / (1.0 + em))  # sigmoid(-d)
    phi_p = torch.exp(log_phi_c - _softplus(-d))  # phi * sigmoid(d), log space
    deta = yf * q - phi_p
    dlogphi = torch.where(
        log_phi < LOG_PHI_CAP,
        phi_digamma_diff(yf, phi) - phi_softplus_minus_sigmoid(d, log_phi_c) - yf * q,
        0.0,
    )
    return deta, dlogphi


def likelihood_grads(X, exposure, counts, mask, alpha, log_phi):
    """(dalpha[B, C, G], dlog_phi[B, G]) of the masked GLM likelihood.

    X[S, C], exposure[S], counts/mask [S, G]; alpha[B, C, G], log_phi[B, G].
    """
    eta = exposure[:, None] + torch.matmul(X, alpha)  # [B, S, G]
    deta, dlogphi = nb2_grads(counts, eta, log_phi.unsqueeze(1))
    return _dalpha_small(X, mask * deta), torch.sum(mask * dlogphi, dim=1)
