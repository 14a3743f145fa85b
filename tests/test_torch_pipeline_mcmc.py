"""The port's MCMC branch of identify_outliers on the CPU: the reference's
3-gene (0, 1, 0) calls through jittered HMC (as
tests/test_pipeline_mcmc.py:42-52 runs them on the JAX package). The NUTS
case and the options that stay refused are in
tests/test_torch_3gene_nuts.py."""

import pytest
import torch

from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.infer.hmc import HMCResult

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
