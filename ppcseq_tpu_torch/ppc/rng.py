"""Posterior-predictive simulation and credible intervals, in torch
(ppcseq_tpu/ppc/rng.py).

- `counts_rng_draws`: the generated-quantities simulation (stan:259-266),
  one NB2 draw per posterior draw per (sample, checked gene) via
  Gamma-Poisson, with `sigma * truncation_compensation` inflating
  overdispersion.
- `exact_ci`: quantile/mean/sd summary over those draws (reference
  R/utilities.R:685-703).
- `approximated_ci`: bootstrap-supersample the posterior draws of
  (lambda, sigma_raw) up to `how_many_posterior_draws`, simulate, summarize
  (reference R/utilities.R:733-784), one gene block at a time.

Quantiles are R type-7 taken from exact integer order statistics
(`torch.topk`; `torch.quantile` refuses inputs above 2^24 elements).
`torch.poisson` returns floating point, so it runs on float64 rates (exact
integers up to 2^53) and is cast to int64 before any order statistic.
"""

from __future__ import annotations

import numpy as np
import torch

from ppcseq_tpu_torch.ops.nb import nb2_log_rng

MAX_TILE_ELEMS = 64_000_000


def counts_rng_draws(
    generator: torch.Generator,
    lambda_log: torch.Tensor,  # [n_draws, S, K] posterior draws of lambda_log_param
    sigma_raw: torch.Tensor,  # [n_draws, K]
    exposure_rate: torch.Tensor,  # [S]
    truncation_compensation: float = 1.0,
) -> torch.Tensor:
    """Simulate counts_rng[n_draws, S, K] (stan:259-266), int64."""
    eta = lambda_log + exposure_rate[None, :, None]
    phi = torch.exp(-sigma_raw)[:, None, :] * truncation_compensation
    return nb2_log_rng(generator, eta, phi)


def _summarize_split(draws: torch.Tensor, adj_prob_threshold: float) -> dict:
    """Scale-safe [S, K] summaries: exact integer bases + float32 corrections.

    The two order statistics of each R type-7 quantile are taken in the
    draws' own integer dtype (exact); only the interpolation term and the
    residuals around an integer center pass through float32, and
    `finalize_summary` recombines in float64 on the host.
    """
    n = draws.shape[0]
    thr = float(adj_prob_threshold)
    i_lo = int(np.floor(thr * (n - 1)))
    i_hi = int(np.floor((1.0 - thr) * (n - 1)))
    # tail thresholds: the order statistics live near each end, so two
    # top-k calls replace a full sort
    k_lo = min(i_lo + 2, n)
    k_hi = min(n - i_hi, n)
    if k_lo + k_hi <= max(n // 4, 2):
        xt = torch.movedim(draws, 0, -1)  # [S, K, n]
        lo_vals = torch.topk(xt, k_lo, dim=-1, largest=False, sorted=True).values  # ascending
        hi_vals = torch.topk(xt, k_hi, dim=-1, largest=True, sorted=True).values  # descending

        def get(i):  # global sorted index -> [S, K]
            return lo_vals[..., i] if i < k_lo else hi_vals[..., n - 1 - i]

    else:
        s = torch.sort(draws, dim=0).values

        def get(i):
            return s[i]

    def order_stat(i0, h):
        # R type-7: x[i0] + frac * (x[i0+1] - x[i0]), h = p*(n-1)
        base = get(i0)
        delta = (get(min(i0 + 1, n - 1)) - base).to(torch.float32)
        return base, delta * float(np.float32(h - i0))  # float32 product, as in JAX

    lo_base, lo_corr = order_stat(i_lo, thr * (n - 1))
    hi_base, hi_corr = order_stat(i_hi, (1.0 - thr) * (n - 1))
    center = get(i_lo)  # any integer anchor works for the residual trick
    resid = (draws - center[None]).to(torch.float32)
    return {
        "lower_base": lo_base, "lower_corr": lo_corr,
        "upper_base": hi_base, "upper_corr": hi_corr,
        "mean_base": center, "mean_corr": torch.mean(resid, dim=0),
        "sd": torch.std(resid, dim=0, correction=1),  # shift-invariant
    }


def finalize_summary(split: dict) -> dict:
    """Recombine `_summarize_split` output into float64 host arrays."""
    host = {k: v.cpu().numpy() for k, v in split.items()}
    out = {
        k: np.asarray(host[f"{k}_base"], np.float64) + np.asarray(host[f"{k}_corr"], np.float64)
        for k in ("lower", "upper", "mean")
    }
    out["sd"] = np.asarray(host["sd"], np.float64)
    return out


def summarize_draws(draws: torch.Tensor, adj_prob_threshold: float) -> dict:
    """CI (R type-7 quantiles at thr, 1-thr), mean, sd over axis 0, as
    float64 [S, K] host arrays exact to the unit at any count scale."""
    return finalize_summary(_summarize_split(draws, adj_prob_threshold))


def _concat_summaries(outs: list[dict]) -> dict:
    return {k: np.concatenate([o[k] for o in outs], axis=-1) for k in outs[0]}


def exact_ci(
    generator: torch.Generator,
    lambda_log: torch.Tensor,
    sigma_raw: torch.Tensor,
    exposure_rate: torch.Tensor,
    adj_prob_threshold: float,
    truncation_compensation: float = 1.0,
    max_tile_elems: int = MAX_TILE_ELEMS,
    return_draws: bool = True,
):
    """counts_rng summary over the actual posterior draws (reference exact
    path). Genes are chunked so at most `max_tile_elems` simulated counts
    exist at a time. Returns (summary, draws): the draws as a host
    [n, S, K] array only with `return_draws`, else None — without it the
    simulated counts never leave the device."""
    n, S, K = lambda_log.shape
    kb_max = max(1, int(max_tile_elems / max(n * S, 1)))
    outs, blocks = [], []
    for start in range(0, K, kb_max):
        draws = counts_rng_draws(
            generator,
            lambda_log[:, :, start : start + kb_max],
            sigma_raw[:, start : start + kb_max],
            exposure_rate,
            truncation_compensation,
        )
        outs.append(summarize_draws(draws, adj_prob_threshold))
        if return_draws:
            blocks.append(draws.cpu().numpy())
        del draws
    return _concat_summaries(outs), (np.concatenate(blocks, axis=-1) if return_draws else None)


def approximated_ci(
    generator: torch.Generator,
    lambda_log: torch.Tensor,  # [n_actual, S, K]
    sigma_raw: torch.Tensor,  # [n_actual, K]
    exposure_rate: torch.Tensor,
    adj_prob_threshold: float,
    how_many_posterior_draws: int,
    truncation_compensation: float = 1.0,
) -> dict:
    """Bootstrap-supersample the posterior, simulate NB, summarize.

    Bootstrap indices are drawn per supersample and shared across a gene
    block's cells (whole posterior-draw rows resampled with replacement):
    each cell's marginal is the reference's per-cell `sample(1:n,
    replace=TRUE)` (R/utilities.R:753-781). Genes are chunked so the
    [n_super, S, kb] tile stays below 64M elements.
    """
    n_actual, S, K = lambda_log.shape
    n_super = int(how_many_posterior_draws)
    kb = max(1, min(int(MAX_TILE_ELEMS / (n_super * S)), K))
    outs = []
    for start in range(0, K, kb):
        lam_blk = lambda_log[:, :, start : start + kb]
        sig_blk = sigma_raw[:, start : start + kb]
        idx = torch.randint(0, n_actual, (n_super,), generator=generator, device=lam_blk.device)
        lam = lam_blk[idx]  # [n_super, S, kb] row take
        sig = sig_blk[idx][:, None, :]  # [n_super, 1, kb]
        eta = lam + exposure_rate[None, :, None]
        phi = torch.exp(-sig) * truncation_compensation
        draws = nb2_log_rng(generator, eta, phi)
        outs.append(summarize_draws(draws, adj_prob_threshold))
    return _concat_summaries(outs)
