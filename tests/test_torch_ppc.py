"""The port's posterior-predictive simulation and CIs
(ppcseq_tpu_torch.ppc.rng): summaries identical to the JAX package's on the
same integer draws, plus analogs of tests/test_ppc.py. torch and JAX draw
different random numbers, so the simulations are checked by their moments."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ppcseq_tpu.ppc import rng as jrng
from ppcseq_tpu_torch.ppc.rng import (
    _summarize_split,
    approximated_ci,
    counts_rng_draws,
    exact_ci,
    summarize_draws,
)

torch.set_num_threads(2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize(
    "n, thr", [(4096, 0.001), (200, 0.1)], ids=["top_k", "sort"]
)
def test_summarize_split_identical_to_jax(n, thr):
    draws = np.random.default_rng(n).integers(0, 1_000_000, size=(n, 3, 2))
    got = _summarize_split(torch.as_tensor(draws), thr)
    want = jrng._summarize_split(jnp.asarray(draws), thr)
    for k in ("lower_base", "upper_base", "mean_base", "lower_corr", "upper_corr"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # float32 mean/sd of the residuals: only the summation order differs
    for k in ("mean_corr", "sd"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)


def test_quantile_type7_matches_r():
    # R: quantile(1:10, c(.1,.9), type=7) == (1.9, 9.1)
    draws = torch.arange(1, 11)[:, None, None]
    out = summarize_draws(draws, 0.1)
    assert np.isclose(out["lower"][0, 0], 1.9)
    assert np.isclose(out["upper"][0, 0], 9.1)


def test_counts_rng_moments_and_truncation_compensation():
    n, S, K = 60000, 2, 1
    lam = torch.full((n, S, K), 3.0, dtype=torch.float64)
    sig = torch.zeros((n, K), dtype=torch.float64)  # sigma_raw=0 -> phi=1
    exposure = torch.tensor([0.0, 1.0], dtype=torch.float64)
    draws = counts_rng_draws(_gen(0), lam, sig, exposure, truncation_compensation=1.0)
    assert draws.dtype == torch.int64
    mu0, mu1 = np.exp(3.0), np.exp(4.0)
    assert abs(float(draws[:, 0, 0].double().mean()) - mu0) / mu0 < 0.03
    assert abs(float(draws[:, 1, 0].double().mean()) - mu1) / mu1 < 0.03
    # trunc_comp < 1 shrinks phi -> inflates variance, keeps mean
    draws_tc = counts_rng_draws(_gen(0), lam, sig, exposure, truncation_compensation=0.7352941)
    v = draws[:, 0, 0].double().var().item()
    v_tc = draws_tc[:, 0, 0].double().var().item()
    expected = mu0 + mu0**2  # phi=1
    expected_tc = mu0 + mu0**2 / 0.7352941
    assert abs(v - expected) / expected < 0.1
    assert abs(v_tc - expected_tc) / expected_tc < 0.1


def test_exact_vs_approximated_ci_agree():
    n, S, K = 4000, 3, 2
    rng = np.random.default_rng(2)
    lam = torch.as_tensor(rng.normal(2.0, 0.05, size=(n, S, K)))
    sig = torch.as_tensor(rng.normal(-1.0, 0.05, size=(n, K)))
    exposure = torch.as_tensor(rng.normal(0, 0.1, size=S))
    ci_exact, draws = exact_ci(_gen(1), lam, sig, exposure, 0.05, return_draws=False)
    assert draws is None
    ci_approx = approximated_ci(_gen(3), lam, sig, exposure, 0.05, 20000)
    np.testing.assert_allclose(ci_exact["mean"], ci_approx["mean"], rtol=0.05)
    np.testing.assert_allclose(ci_exact["lower"], ci_approx["lower"], rtol=0.12, atol=1.0)
    np.testing.assert_allclose(ci_exact["upper"], ci_approx["upper"], rtol=0.12, atol=1.0)


def test_gene_chunking_consistent():
    """Gene blocks concatenate in order: with constant per-gene parameters
    that differ by gene, each block's CI stays with its gene."""
    n, S, K = 500, 2, 5
    lam = torch.log(torch.tensor([5.0, 50.0, 500.0, 5000.0, 50000.0]))[None, None, :].expand(n, S, K)
    sig = torch.full((n, K), -4.0)
    exposure = torch.zeros(S)
    out = approximated_ci(_gen(4), lam, sig, exposure, 0.1, 1000)
    assert out["lower"].shape == (S, K) and np.isfinite(out["mean"]).all()
    ci, draws = exact_ci(_gen(5), lam.contiguous(), sig, exposure, 0.1, max_tile_elems=2 * n * S)
    assert draws.shape == (n, S, K)
    for o in (out, ci):
        np.testing.assert_allclose(o["mean"], np.broadcast_to([5, 50, 500, 5000, 50000], (S, K)),
                                   rtol=0.1)


def test_ci_unit_resolution_at_large_counts():
    """float32 spacing at 1e8 counts is 8 units; the summaries must still be
    exact to the unit."""
    base = 100_000_000
    draws = torch.as_tensor(base + np.arange(10), dtype=torch.int64)[:, None, None]
    out = summarize_draws(draws, 0.1)
    assert abs(out["lower"][0, 0] - (base + 0.9)) < 1e-4
    assert abs(out["upper"][0, 0] - (base + 8.1)) < 1e-4
    assert abs(out["mean"][0, 0] - (base + 4.5)) < 1e-4
    assert abs(out["sd"][0, 0] - np.std(np.arange(10), ddof=1)) < 1e-4


def test_exact_ci_large_counts_end_to_end():
    """exact_ci at mu ~ 1e8: bounds finite, ordered, float64, and the
    simulated counts resolved to the unit (Poisson drawn in float64)."""
    n, S, K = 400, 2, 1
    lam = torch.full((n, S, K), np.log(1e8), dtype=torch.float32)
    sig = torch.full((n, K), -4.0, dtype=torch.float32)  # phi = e^4 ~ 55
    exposure = torch.zeros(S, dtype=torch.float32)
    ci, draws = exact_ci(_gen(7), lam, sig, exposure, 0.05, return_draws=True)
    mu, phi = 1e8, np.exp(4.0)
    sd = np.sqrt(mu + mu**2 / phi)
    assert np.all(ci["lower"] < ci["mean"]) and np.all(ci["mean"] < ci["upper"])
    assert np.all(np.abs(ci["mean"] - mu) < 4 * sd / np.sqrt(n))
    assert ci["lower"].dtype == np.float64 and ci["upper"].dtype == np.float64
    assert np.any(draws % 8 != 0)  # not on the float32 grid


def test_topk_quantile_path_matches_numpy_type7():
    rng = np.random.default_rng(5)
    n, S, K = 4096, 3, 2
    draws = torch.as_tensor(rng.integers(0, 1_000_000, size=(n, S, K)))
    thr = 0.001
    out = summarize_draws(draws, thr)
    d64 = draws.double().numpy()
    np.testing.assert_allclose(out["lower"], np.quantile(d64, thr, axis=0, method="linear"),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["upper"], np.quantile(d64, 1 - thr, axis=0, method="linear"),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["mean"], d64.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(out["sd"], d64.std(axis=0, ddof=1), rtol=1e-4)
