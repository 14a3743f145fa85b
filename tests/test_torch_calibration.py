"""Simulation-based calibration (SBC) on the port: the JAX package's suite
(tests/test_calibration.py) with its constants, prior simulation and bars
(ppcseq_tpu_torch/utils/sbc.py), run on the card.

(a) The suite proper runs in float64 through flat_logp(dims, "plain"), as
    the JAX suite runs on the CPU: its flat_logp(dims) = "auto" is "plain"
    in float64 off the TPU (JAX nb_model.py:783-797). The port's kernels
    take float32 only, so "auto" (K1) cannot serve a float64 suite.
(b) The same replications in float32 through flat_logp(dims) = K1, the
    route identify_outliers takes on the card. Its statistics are printed
    beside (a)'s; it is held to the same bars only when (a) passes.

At the eager loop's cost (20 replications x 640 transitions x up to 32
leapfrogs at 64 chains) the suite takes minutes on the card and hours on a
CPU, so it carries the `cuda` marker and skips here. It imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_calibration.py
The CPU smoke at the end runs one replication at a cut depth in seconds;
it makes no calibration claim.
"""

import json

import numpy as np
import pytest
import torch

from ppcseq_tpu_torch.utils import sbc


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the suite's 409,600 batched evaluations take hours "
                    "on a CPU")


def _report(tag, result):
    st = {k: v for k, v in result.items() if k != "ranks"}
    print(f"SBC {tag} {json.dumps(st)}", flush=True)


@pytest.fixture(scope="module")
def sbc_f64():
    """(a): every replication in float64 on "plain"."""
    _needs_card()
    result = sbc.suite(torch.float64, "plain")
    _report("float64 plain", result)
    return result


@pytest.fixture(scope="module")
def sbc_f32_k1(sbc_f64):
    """(b): every replication in float32 on flat_logp(dims) (K1)."""
    result = sbc.suite(torch.float32, "auto")
    _report("float32 K1", result)
    return result


def _assert_uniform(result, name):
    chi2, obs = sbc.chi2(result["ranks"][name])
    assert chi2 < result["bar"], (name, chi2, result["bar"], obs.tolist())


def _assert_not_too_narrow(result):
    for name in ("predictive", "alpha_sub_1"):
        extreme = sbc.extreme_share(result["ranks"][name])
        assert extreme < 0.15, (name, extreme)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sbc.NAMES)
def test_sbc_rank_uniformity(sbc_f64, name):
    """Chi-square on binned SBC ranks. The bar is generous (p ~ 1e-4 at
    nominal df, and ranks pooled within one replication are positively
    correlated through the shared fit, inflating the statistic further) so
    only systematic miscalibration fails, not MCMC noise - the bug the JAX
    suite caught scored chi2 = 127 on a bar of 22."""
    _assert_uniform(sbc_f64, name)


@pytest.mark.cuda
def test_sbc_posterior_not_too_narrow(sbc_f64):
    """The U-shape check on held-out predictive ranks: extreme ranks (truth
    outside all draws) must not dominate. Under uniformity each extreme
    value {0, L} has mass 2/(L+1) ~ 3.1%; a too-narrow predictive - the
    failure mode that would manufacture spurious outlier calls - piles mass
    there."""
    _assert_not_too_narrow(sbc_f64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sbc.NAMES)
def test_sbc_float32_k1_rank_uniformity(sbc_f64, sbc_f32_k1, name):
    if not sbc.passes(sbc_f64):
        pytest.skip("(a), the float64 suite, fails its bars: (b) is recorded, not held")
    _assert_uniform(sbc_f32_k1, name)


@pytest.mark.cuda
def test_sbc_float32_k1_not_too_narrow(sbc_f64, sbc_f32_k1):
    if not sbc.passes(sbc_f64):
        pytest.skip("(a), the float64 suite, fails its bars: (b) is recorded, not held")
    _assert_not_too_narrow(sbc_f32_k1)


def test_sbc_replication_smoke_on_the_cpu():
    """One replication on the CPU at warmup 40, 10 draws and L = 8 (the
    suite: 600, 40, 32): the path runs end to end, the draws are finite,
    every rank lies in {0..N_CHAINS}, and the held-out cells are out of
    the likelihood (like_mask 0). No calibration claim: one cut
    replication says nothing about uniformity."""
    torch.set_num_threads(2)
    out = sbc.replication(0, dtype=torch.float64, likelihood="plain", device="cpu",
                          num_warmup=40, num_draws=10, num_leapfrog=8)
    assert out["draws_finite"]
    assert [len(out["ranks"][k]) for k in sbc.NAMES] == [sbc.N_CHECK, sbc.N_CHECK,
                                                          len(sbc.HOLD_S) * sbc.N_CHECK]
    for k in sbc.NAMES:
        r = out["ranks"][k]
        assert ((r >= 0) & (r <= sbc.N_CHAINS)).all(), (k, r)
    np.testing.assert_array_equal(out["held_out_like_mask"], 0.0)
    assert out["max_count"] < np.iinfo(np.int32).max
    pooled = sbc.pooled([out])
    assert set(pooled["stats"]) == set(sbc.NAMES) and pooled["bar"] > 0
