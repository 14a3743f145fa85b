"""The port's NUTS branch of identify_outliers on the CPU: the reference's
3-gene (0, 1, 0) calls through NUTS (as tests/test_pipeline_mcmc.py:54-58
runs them on the JAX package, ~5 min here on 2 threads), and the MCMC
options that stay refused. Apart from tests/test_torch_pipeline_mcmc.py
(the HMC case), and named to be collected before the port's other test
files, so that a run that hands out whole files to its workers starts this
long case early, beside the others, with quick cases queued behind it."""

import pytest
import torch

from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.pipeline import identify
from test_torch_pipeline_mcmc import _COMMON

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sig_counts():
    counts = load_counts()
    return counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))


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


# The options nuts, adapt_trajectory and save_generated_quantities run since
# they were ported (above, tests/test_torch_pipeline_extra.py and
# tests/test_torch_product.py), and over a DeviceMesh since the mesh was
# (tests/test_torch_pipeline_mesh.py, ChEES over a `chains` axis too). What
# stays refused with either option: a mesh that is not a DeviceMesh.
@pytest.mark.parametrize("option,error", [
    (dict(mcmc_sampler="nuts", mesh=object()), TypeError),
    (dict(hmc_adapt_trajectory=True, mesh=object()), TypeError)],
    ids=["nuts", "adapt_trajectory"])
def test_mcmc_options_not_ported_raise(sig_counts, option, error):
    with pytest.raises(error, match="DeviceMesh"):
        identify_outliers(sig_counts, **{**_COMMON, **option})


def test_generated_quantities_with_vb_is_a_value_error(sig_counts):
    with pytest.raises(ValueError, match="Variational Bayes"):
        identify_outliers(sig_counts, save_generated_quantities=True,
                          **{**_COMMON, "approximate_posterior_inference": True})


def test_unknown_sampler_is_a_value_error(sig_counts):
    with pytest.raises(ValueError, match="mcmc_sampler"):
        identify_outliers(sig_counts, mcmc_sampler="gibbs", **_COMMON)
