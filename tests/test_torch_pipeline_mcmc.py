"""The port's MCMC branch of identify_outliers on the CPU: the reference's
3-gene (0, 1, 0) calls through jittered HMC and through NUTS (as
tests/test_pipeline_mcmc.py:42-58 runs them on the JAX package), and the
options that are not ported yet raising NotImplementedError."""

import pytest
import torch

from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.infer.hmc import HMCResult
from ppcseq_tpu_torch.pipeline import identify

torch.set_num_threads(2)

_COMMON = dict(
    formula="~ Label",
    sample="sample",
    transcript="symbol",
    abundance="value",
    significance="PValue",
    do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=50,
    approximate_posterior_inference=False,
    approximate_posterior_analysis=True,
    seed=42,
    device="cpu",
)


@pytest.fixture(scope="module")
def sig_counts():
    counts = load_counts()
    return counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))


def test_mcmc_hmc_pipeline(sig_counts):
    res = identify_outliers(sig_counts, mcmc_sampler="hmc", pass_fit=True, **_COMMON)
    assert dict(zip(res.symbol, res.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0,
    }
    for key in ("fit 1", "fit 2"):
        fit = res.attrs[key]
        assert isinstance(fit, HMCResult)
        # 128 chains x ceil(1000 / 128) draws, D = 6 + 2 * 53 + 3
        assert tuple(fit.draws.shape) == (128, 8, 115)
        assert fit.divergences.sum() <= 0.02 * 128 * 8
        assert torch.isfinite(fit.draws).all()
    assert "vb_iterations" not in res.attrs


def test_mcmc_nuts_pipeline(sig_counts, monkeypatch):
    """tests/test_pipeline_mcmc.py:54-58 on the port: NUTS from the ADVI
    warm start, 3 chains (chains_for_run(1000, cores)) of 334 draws after
    150 warmup, in both passes; the fit info names the sampler and carries
    the convergence diagnostics."""
    infos = []
    fit = identify._mcmc_fit

    def spy(*args, **kwargs):
        res, info = fit(*args, **kwargs)
        infos.append(info)
        return res, info

    monkeypatch.setattr(identify, "_mcmc_fit", spy)
    res = identify_outliers(sig_counts, mcmc_sampler="nuts", **_COMMON)
    assert dict(zip(res.symbol, res.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0,
    }
    assert len(infos) == 2
    for info in infos:
        assert info["method"] == "nuts" and info["chains"] == 3
        assert len(info["step_size"]) == 3 and sum(info["divergences"]) <= 0.02 * 3 * 334
        assert info["rhat_max"] < 1.1 and info["ess_min"] > 0


# The options nuts and adapt_trajectory run since they were ported (above,
# and tests/test_torch_pipeline_extra.py); what stays refused of them is the
# mesh that shards their chains or genes.
@pytest.mark.parametrize("option", [dict(mcmc_sampler="nuts", mesh=object()),
                                    dict(hmc_adapt_trajectory=True, mesh=object()),
                                    dict(save_generated_quantities=True)],
                         ids=["nuts", "adapt_trajectory", "generated_quantities"])
def test_mcmc_options_not_ported_raise(sig_counts, option):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        identify_outliers(sig_counts, **{**_COMMON, **option})


def test_generated_quantities_with_vb_is_a_value_error(sig_counts):
    with pytest.raises(ValueError, match="Variational Bayes"):
        identify_outliers(sig_counts, save_generated_quantities=True,
                          **{**_COMMON, "approximate_posterior_inference": True})


def test_unknown_sampler_is_a_value_error(sig_counts):
    with pytest.raises(ValueError, match="mcmc_sampler"):
        identify_outliers(sig_counts, mcmc_sampler="gibbs", **_COMMON)
