"""NB2-log GLM likelihood on the hoisted math, value + analytic gradients,
in plain torch: `glm_delta` is the plain version of K1 and `glm_plain` of
K2 (csrc/nb_glm_delta.cu, wrapped in ops/nb_kernel.py).

A port of ppcseq_tpu/ops/nb_fast.py (`glm_delta`, `glm_plain` and their helpers) with the
same branch structure, thresholds and polynomials, plus a leading batch
axis B over parameter vectors (the ADVI samples):

    alpha[B, C, G], log_phi[B, G]  ->  value[B]
                                       (+ dalpha[B, C, G], dlog_phi[B, G])

The model data ([S, G] counts/mask/baseline constants, [S, C] design) carry
no batch axis. Per-gene tables are [B, G] and broadcast over S as
[B, 1, G]; per-data tables are [S, G]; per-point work is [B, S, G]. The
per-point work is ~3 exp + 1 log plus short polynomials; see the JAX
module's docstring for the derivation of each hoisted table and for the
cancellation guards that make the delta form float32-smooth.
"""

from __future__ import annotations

import math

import torch

LOG_PHI_CAP = 80.0
HALF_LOG_2PI = 0.9189385332046727
LOG8 = math.log(8.0)
# lgamma(y+1) for y = 0..7 (branch-A data constant)
LGAMMA_1P = [0.0, 0.0] + [math.lgamma(k + 1) for k in range(2, 8)]


def _log1p01(u):
    """log(1+u) for u in [0, 1]: pure odd atanh series, f32-relative exact."""
    z = u / (2.0 + u)
    z2 = z * z
    return 2.0 * z * (
        1.0
        + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0
            + z2 * (1.0 / 9.0 + z2 * (1.0 / 11.0 + z2 / 13.0)))))
    )


def _log1p_wide(u, log_fallback):
    """log(1+u) for u > -1: atanh series for -1/3 < u < 1/2, else the
    caller's already-available logarithm `log_fallback`."""
    z = u / (2.0 + u)
    z2 = z * z
    small = 2.0 * z * (1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0 + z2 / 9.0))))
    return torch.where((u > -1.0 / 3.0) & (u < 0.5), small, log_fallback)


def _gene_tables(log_phi):
    """Per-gene ([B, G]) tables, amortized over S samples."""
    log_phi_c = torch.clamp(log_phi, max=LOG_PHI_CAP)
    phi = torch.exp(log_phi_c)
    # branch A running sums: cum_log[k] = sum_{j<=k} log(phi+j),
    # cum_frac[k] = sum_{j<=k} phi/(phi+j), k = 0..6
    cum_log, cum_frac = [], []
    acc_l = torch.log(phi)
    acc_f = torch.ones_like(phi)
    cum_log.append(acc_l)
    cum_frac.append(acc_f)
    for k in range(1, 7):
        acc_l = acc_l + torch.log(phi + k)
        acc_f = acc_f + phi / (phi + k)
        cum_log.append(acc_l)
        cum_frac.append(acc_f)
    lg7 = torch.log(phi + 7.0)
    frac7 = phi / (phi + 7.0)

    # lgamma(min(phi,8)) via shift-by-8 Stirling
    xs = torch.clamp(phi, max=8.0) + 8.0
    inv = 1.0 / xs
    inv2 = inv * inv
    log_xs = torch.log(xs)
    stirl = (
        (xs - 0.5) * log_xs - xs + HALF_LOG_2PI
        + inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)))
    )
    lgam_small = stirl - (cum_log[6] + lg7)

    # psi(min(phi,8)+8), asymptotic
    psi8 = log_xs - 0.5 * inv - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    # digamma shift sum_{k<8} phic/(phic+k)
    shift_c = cum_frac[6] + frac7

    # branch-B phi-only constants, clamped so inactive lanes stay finite
    log_phi_b = torch.clamp(log_phi_c, min=LOG8)
    phi_b = torch.clamp(phi, min=8.0)
    inv_phi_b = 1.0 / phi_b
    inv_phi_b3 = inv_phi_b * inv_phi_b * inv_phi_b
    b_const = (
        -0.5 * log_phi_b + 1.0 - HALF_LOG_2PI
        - (1.0 / 12.0) * inv_phi_b + (1.0 / 360.0) * inv_phi_b3
    )
    return {
        "log_phi_c": log_phi_c,
        "phi": phi,
        "cum_log": cum_log,
        "cum_frac": cum_frac,
        "lgam_small": lgam_small,
        "psi8": psi8,
        "shift_c": shift_c,
        "log_phi_b": log_phi_b,
        "phi_b": phi_b,
        "inv_phi_b": inv_phi_b,
        "inv_phi_b3": inv_phi_b3,
        "b_const": b_const,
        "d_b": phi - 1.0,
    }


def _data_tables(counts, dtype):
    """Per-data ([S, G]) constants."""
    yf = counts.to(dtype)
    y1 = yf + 1.0
    inv_y1 = 1.0 / y1
    lg_y1_small = torch.zeros_like(yf)
    for k in range(2, 8):
        lg_y1_small = torch.where(yf >= k, LGAMMA_1P[k], lg_y1_small)
    return {
        "yf": yf,
        "inv_y1": inv_y1,
        "inv_y1_3": inv_y1 * inv_y1 * inv_y1,
        "log_y1": torch.log(y1),
        "lg_y1_small": lg_y1_small,
        "y_le7": yf <= 7.0,
        "y_ge8_f": torch.clamp(yf, min=8.0),
    }


def _select_by_y(yf, cums):
    """sum_{k < y} table-term for y in 0..7: nested select over 7 cumsums."""
    out = torch.zeros(torch.broadcast_shapes(yf.shape, cums[0].shape), dtype=yf.dtype,
                      device=yf.device)
    for k in range(7):  # ascending: the largest applicable k wins
        out = torch.where(yf > k, cums[k], out)
    return out


def _part1_and_digamma(gt, dt, want_grads):
    """part1 = lgamma(y+phi) - lgamma(y+1) - lgamma(phi) (value) and
    phi*(digamma(y+phi) - digamma(phi)) (gradient), sharing one log1p.

    `gt` holds [B, 1, G] gene rows, `dt` [S, G] data tables; results are
    [B, S, G].
    """
    yf, inv_y1, log_y1 = dt["yf"], dt["inv_y1"], dt["log_y1"]
    phi, d_b = gt["phi"], gt["d_b"]

    # the one per-point log1p: r = (phi-1)/(y+1) in (-1, inf)
    u = d_b * inv_y1
    l1p = _log1p_wide(u, torch.log(1.0 + u))
    log_a1 = log_y1 + l1p  # log(y + phi)

    inv_a1 = 1.0 / (dt["y_ge8_f"] + phi)
    inv_a1_2 = inv_a1 * inv_a1
    corr = (1.0 / 12.0) * (inv_a1 - inv_y1) - (1.0 / 360.0) * (
        inv_a1 * inv_a1_2 - dt["inv_y1_3"]
    )
    pair = (yf + 0.5) * l1p + corr

    # branch B (y >= 8, phi >= 8): (phi-1)*log1p(y/phi) without cancellation
    ub = yf * gt["inv_phi_b"]
    l1p_b = torch.where(ub < 0.5, _log1p01(torch.clamp(ub, max=1.0)), log_a1 - gt["log_phi_b"])
    part_b = pair + (gt["phi_b"] - 1.0) * l1p_b + gt["b_const"]

    # branch C (y >= 8, phi < 8)
    part_c = pair + d_b * log_a1 - d_b - gt["lgam_small"]

    # branch A (y <= 7): exact running sums minus lgamma(y+1)
    part_a = _select_by_y(yf, gt["cum_log"]) - dt["lg_y1_small"]

    part1 = torch.where(dt["y_le7"], part_a, torch.where(phi >= 8.0, part_b, part_c))
    if not want_grads:
        return part1, None

    g_b = (
        gt["phi_b"] * l1p_b
        + 0.5 * yf * inv_a1
        + (1.0 / 12.0) * (gt["inv_phi_b"] - gt["phi_b"] * inv_a1_2)
        - (1.0 / 120.0) * (gt["inv_phi_b3"] - gt["phi_b"] * inv_a1_2 * inv_a1_2)
    )
    psi_yphi = (
        log_a1 - 0.5 * inv_a1
        - inv_a1_2 * (1.0 / 12.0 - inv_a1_2 * (1.0 / 120.0 - inv_a1_2 / 252.0))
    )
    phic = torch.clamp(phi, max=8.0)
    g_c = phic * (psi_yphi - gt["psi8"]) + gt["shift_c"]
    g_a = _select_by_y(yf, gt["cum_frac"])
    phi_d = torch.where(dt["y_le7"], g_a, torch.where(phi >= 8.0, g_b, g_c))
    return part1, phi_d


def _softplus_pair(d):
    """(softplus(d), softplus(-d), exp(-|d|)) sharing one exp + one poly."""
    em = torch.exp(-torch.abs(d))
    l1pem = _log1p01(em)
    sp_d = torch.clamp(d, min=0.0) + l1pem
    sp_nd = torch.clamp(-d, min=0.0) + l1pem
    return sp_d, sp_nd, em


def _grads_from_d(gt, dt, d, sp_d, sp_nd, em, phi_d, log_phi_raw):
    """(deta, dlogphi) per point, sharing d/em/softplus with the value."""
    yf = dt["yf"]
    r = 1.0 / (1.0 + em)
    q = torch.where(d > 0, em * r, r)  # sigmoid(-d)
    phi_p = torch.exp(gt["log_phi_c"] - sp_nd)  # phi*sigmoid(d), log space
    deta = yf * q - phi_p

    # phi*(softplus(d) - sigmoid(d)): log-space odd series for d <= -1.386
    dn = torch.clamp(d, max=0.0)
    useries = em  # == e^d on the lanes the series is selected on
    series = 0.5 - useries * (
        2.0 / 3.0
        - useries * (0.75 - useries * (0.8 - useries * (5.0 / 6.0
            - useries * (6.0 / 7.0 - useries * 0.875))))
    )
    small = torch.exp(gt["log_phi_c"] + 2.0 * dn) * series
    sig = 1.0 - q
    direct = gt["phi"] * (sp_d - sig)
    phi_a = torch.where(d <= -1.386, small, direct)

    dlogphi = torch.where(log_phi_raw < LOG_PHI_CAP, phi_d - phi_a - yf * q, 0.0)
    return deta, dlogphi


def _eta_small(X, exposure, alpha):
    """eta[B, S, G] = exposure[:, None] + X @ alpha[b], as C multiply-adds
    in the kernel's order (exposure first, then column by column)."""
    B, _, G = alpha.shape
    eta = exposure[None, :, None].expand(B, X.shape[0], G)
    for c in range(X.shape[1]):
        eta = eta + X[None, :, c, None] * alpha[:, None, c, :]
    return eta


def _dalpha_small(X, deta):
    """dalpha[B, C, G] = X^T deta[b] as C reductions over S."""
    return torch.stack(
        [torch.sum(X[None, :, c, None] * deta, dim=1) for c in range(X.shape[1])], dim=1
    )


def glm_plain(X, exposure, counts, mask, alpha, log_phi, want_grads):
    """Masked likelihood without a baseline (the stable plain form) with the
    hoisted math, batched over B: the plain version of K2.

    X[S, C], exposure[S], counts/mask [S, G]; alpha[B, C, G], log_phi[B, G].
    Returns value[B], or (value[B], dalpha[B, C, G], dlog_phi[B, G]) with
    `want_grads`.
    """
    dtype = X.dtype
    gt = _gene_tables(log_phi.to(dtype))
    dt = _data_tables(counts, dtype)
    gt_b = {k: ([t.unsqueeze(1) for t in v] if isinstance(v, list) else v.unsqueeze(1))
            for k, v in gt.items()}

    eta = _eta_small(X, exposure, alpha)
    d = eta - gt_b["log_phi_c"]
    sp_d, sp_nd, em = _softplus_pair(d)
    part1, phi_d = _part1_and_digamma(gt_b, dt, want_grads)
    pts = part1 - gt_b["phi"] * sp_d - dt["yf"] * sp_nd
    value = torch.sum(torch.sum(mask * pts, dim=1), dim=1)
    if not want_grads:
        return value

    deta, dlogphi = _grads_from_d(
        gt_b, dt, d, sp_d, sp_nd, em, phi_d, log_phi.to(dtype).unsqueeze(1)
    )
    return value, _dalpha_small(X, mask * deta), torch.sum(mask * dlogphi, dim=1)


def delta_increment_terms(gt, dlo, d, sp_d, sp_nd, d0, sp_d0, sig_neg_d0):
    """Hybrid delta-form softplus increments -> (phi_sp, inc_neg).

    phi_sp = phi*softplus(d) and inc_neg = softplus(-d) - softplus(-d0):
    exact increments from the baseline for -2 < dlo < 8, the direct stable
    forms outside (with the Poisson-limit log-space branch below d = -25).
    """
    sig_d0 = 1.0 - sig_neg_d0
    dlo_m = torch.clamp(dlo, -2.0, 8.0)
    e1 = torch.where(
        torch.abs(dlo_m) < 0.35,
        dlo_m * (1.0 + dlo_m * (0.5 + dlo_m * (1.0 / 6.0 + dlo_m * (1.0 / 24.0
            + dlo_m * (1.0 / 120.0 + dlo_m * (1.0 / 720.0 + dlo_m / 5040.0)))))),
        torch.exp(dlo_m) - 1.0,
    )
    e1_neg = -e1 / (1.0 + e1)  # expm1(-dlo_m), exact identity
    arg_p = sig_d0 * e1
    arg_n = sig_neg_d0 * e1_neg
    sp_d_mid = sp_d0 + _log1p_wide(arg_p, torch.log(1.0 + arg_p))
    inc_neg_mid = _log1p_wide(arg_n, torch.log(1.0 + arg_n))
    phi_sp_far = torch.where(
        d < -25.0,
        torch.exp(torch.clamp(gt["log_phi_c"] + d, -60.0, 60.0)),
        gt["phi"] * sp_d,
    )
    spn0 = sp_d0 - d0  # softplus(-d0)
    mid = (dlo > -2.0) & (dlo < 8.0)
    phi_sp = torch.where(mid, gt["phi"] * sp_d_mid, phi_sp_far)
    inc_neg = torch.where(mid, inc_neg_mid, sp_nd - spn0)
    return phi_sp, inc_neg


def glm_delta(
    X, counts, mask,
    alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi, want_grads,
):
    """Delta-form masked likelihood with the hoisted math, batched over B.

    X[S, C], counts[S, G] (integer), mask/d0/sp_d0/sig_neg_d0/y_sp0 [S, G],
    alpha0[C, G], sigma_raw0[G]; alpha[B, C, G], log_phi[B, G]. Returns
    value[B], or (value[B], dalpha[B, C, G], dlog_phi[B, G]) with
    `want_grads`. The delta machinery only changes the value's part23;
    part1 and the gradients are the plain forms on the full d = d0 + dlo.
    """
    dtype = X.dtype
    gt = _gene_tables(log_phi.to(dtype))
    dt = _data_tables(counts, dtype)
    # gene rows broadcast over S: [B, G] -> [B, 1, G]
    gt_b = {k: ([t.unsqueeze(1) for t in v] if isinstance(v, list) else v.unsqueeze(1))
            for k, v in gt.items()}

    delta_eta = _eta_small(X, torch.zeros_like(X[:, 0]), alpha - alpha0)
    delta_log_phi = gt_b["log_phi_c"] + sigma_raw0  # log_phi - log_phi0
    dlo = delta_eta - delta_log_phi
    d = d0 + dlo
    sp_d, sp_nd, em = _softplus_pair(d)
    phi_sp, inc_neg = delta_increment_terms(gt_b, dlo, d, sp_d, sp_nd, d0, sp_d0, sig_neg_d0)

    part1, phi_d = _part1_and_digamma(gt_b, dt, want_grads)
    pts = part1 - phi_sp - dt["yf"] * inc_neg - y_sp0
    # reduce over S first, then G (the JAX module's order)
    value = torch.sum(torch.sum(mask * pts, dim=1), dim=1)
    if not want_grads:
        return value

    deta, dlogphi = _grads_from_d(
        gt_b, dt, d, sp_d, sp_nd, em, phi_d, log_phi.to(dtype).unsqueeze(1)
    )
    return value, _dalpha_small(X, mask * deta), torch.sum(mask * dlogphi, dim=1)
