"""MCMC convergence diagnostics: split-R-hat and effective sample size.

A NumPy copy of ppcseq_tpu/infer/diagnostics.py (no framework code; the
port cannot import the JAX package). Callers pass host arrays: copy the
draws off the device with `.cpu().numpy()` first.

The reference explicitly drops rstan's n_eff/Rhat columns from its summaries
(R/utilities.R:699) and offers no diagnostics of its own; a production
framework needs them. Implements the split-chain rank-normalized-free
classics (Gelman et al., BDA3 / Stan reference):

- split_rhat: potential scale reduction over chains split in half
- ess_bulk-style ESS from chain-autocorrelation (Geyer initial positive
  sequence estimator)

Inputs are [chains, draws] or [chains, draws, dim] arrays (numpy).
"""

from __future__ import annotations

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """[chains, draws] -> [2*chains, draws//2]."""
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, n - half:]], axis=0)


def split_rhat(x: np.ndarray) -> np.ndarray:
    """Split-R-hat. x: [chains, draws] or [chains, draws, D] -> scalar or [D]."""
    if x.ndim == 3:
        return np.stack([split_rhat(x[:, :, d]) for d in range(x.shape[2])])
    x = _split_chains(np.asarray(x, np.float64))
    m, n = x.shape
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    B = n * chain_mean.var(ddof=1)
    W = chain_var.mean()
    if W == 0:
        return np.float64(1.0)
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / W)


def ess(x: np.ndarray) -> np.ndarray:
    """Effective sample size via Geyer's initial positive sequence.

    x: [chains, draws] or [chains, draws, D] -> scalar or [D].
    """
    if x.ndim == 3:
        return np.stack([ess(x[:, :, d]) for d in range(x.shape[2])])
    x = _split_chains(np.asarray(x, np.float64))
    m, n = x.shape
    if n < 4:
        return np.float64(m * n)
    chain_mean = x.mean(axis=1, keepdims=True)
    xc = x - chain_mean
    # per-chain autocovariance via FFT
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real / n
    chain_var = acov[:, 0] * n / (n - 1)
    W = chain_var.mean()
    B_over_n = chain_mean[:, 0].var(ddof=1)
    var_plus = (n - 1) / n * W + B_over_n
    if var_plus == 0:
        return np.float64(m * n)
    # combined autocorrelation (Stan's formulation)
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus  # [n]
    # Geyer: sum consecutive pairs while positive
    tau = 1.0
    t = 1
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        tau += 2.0 * pair
        t += 2
    return m * n / max(tau, 1.0 / (m * n))


def summarize(draws: np.ndarray, names: list[str] | None = None) -> dict:
    """Per-dimension diagnostics for [chains, draws, D] draws."""
    draws = np.asarray(draws)
    rh = split_rhat(draws)
    es = ess(draws)
    out = {
        "rhat_max": float(np.max(rh)),
        "ess_min": float(np.min(es)),
        "rhat": rh,
        "ess": es,
    }
    if names is not None:
        worst = int(np.argmax(rh))
        out["worst_rhat_name"] = names[worst]
    return out
