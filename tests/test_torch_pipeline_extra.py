"""The port's identify_outliers beyond the core parity tests, on the CPU:
ChEES trajectory adaptation through the product path
(tests/test_pipeline_extra.py:110-132), multi-covariate designs (C = 3 and
C = 4), the intercept-only formula, the auto-switch to the approximated CI,
a custom scaling factor (tests/test_pipeline_extra.py:35-96) and
just_discovery (tests/test_pipeline.py:99-103)."""

import numpy as np
import pytest
import torch

from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.utils.synthetic import synthetic_tidy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_counts():
    """3 check genes + enough controls, with a synthetic batch covariate."""
    counts = load_counts()
    counts = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    samples = sorted(counts["sample"].unique())
    batch = {s: ("b1" if i % 2 == 0 else "b2") for i, s in enumerate(samples)}
    return counts.assign(batch=counts["sample"].map(batch))


_BASE = dict(
    sample="sample",
    transcript="symbol",
    abundance="value",
    significance="PValue",
    do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=30,
    seed=11,
    device="cpu",
)


def _calls(res):
    return dict(zip(res.symbol, res.tot_deleterious_outliers))


def test_hmc_adapt_trajectory_in_product():
    """ChEES reaches the product path: the adapted trajectory length is in
    the fit of pass 2, and with a mesh the port refuses."""
    df = synthetic_tidy(n_genes=48, n_samples=8, n_check=3, outlier_frac=0.15, seed=0)
    kw = dict(formula="~ Label", how_many_negative_controls=30,
              approximate_posterior_inference=False, mcmc_sampler="hmc",
              hmc_adapt_trajectory=True, seed=11, device="cpu")
    res = identify_outliers(df, pass_fit=True, **kw)
    assert len(res) == 3
    fit2 = res.attrs["fit 2"]
    assert fit2.trajectory_length is not None and fit2.trajectory_length > 0
    assert torch.isfinite(fit2.draws).all()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        identify_outliers(df, mesh=object(), **kw)


@pytest.mark.parametrize("formula", ["~ Label + batch", "~ Label * batch"], ids=["C3", "C4"])
def test_multi_covariate_formula(small_counts, formula):
    """~ Label + batch exercises the alpha_2 block (C = 3); ~ Label * batch
    the interaction column as well (C = 4)."""
    res = identify_outliers(small_counts, formula=formula, **_BASE)
    assert len(res) == 3
    assert _calls(res)["CYP1A1"] >= 1
    swd = res.sample_wise_data.iloc[0]
    assert "Label" in swd.columns and "batch" in swd.columns
    assert res.attrs["formula"] == formula


def test_intercept_only_formula(small_counts):
    """~ 1: no covariates, so no deleterious classification, only the PPC."""
    res = identify_outliers(small_counts, formula="~ 1", **_BASE)
    assert "tot_deleterious_outliers" not in res.columns
    assert "ppc_samples_failed" in res.columns
    assert len(res) == 3


def test_approx_analysis_auto_switch(small_counts):
    """approximate_posterior_analysis=None flips to the approximated CI
    above 20k draws (reference R/methods.R:169-175)."""
    res = identify_outliers(small_counts, formula="~ Label", approximate_posterior_analysis=None,
                            adj_prob_theshold_2=1e-4, **_BASE)
    assert len(res) == 3
    assert res.attrs["total_draws"] == 21 * 3 * 100_000
    assert _calls(res)["CYP1A1"] >= 1


def test_custom_scaling_factor(small_counts):
    df = small_counts.copy()
    tot = df.groupby("sample")["value"].transform("sum")
    df["my_scaling"] = tot.max() / tot
    res = identify_outliers(df, formula="~ Label", scaling_factor="my_scaling", **_BASE)
    swd = res.sample_wise_data.iloc[0]
    np.testing.assert_allclose(swd["exposure_rate"], -np.log(swd["multiplier"]), rtol=1e-10)
    given = df.drop_duplicates("sample").set_index("sample")["my_scaling"]
    np.testing.assert_allclose(swd["multiplier"], swd["sample"].map(given), rtol=1e-12)


def test_just_discovery(small_counts):
    res = identify_outliers(small_counts, formula="~ Label", just_discovery=True, **_BASE)
    assert {"S", "G", ".lower", ".upper", "ppc", "slope"} <= set(res.columns)
    assert res.G.max() == 2  # only checked genes
    assert len(res) == 3 * 21


@pytest.mark.parametrize("flag", [True, False], ids=["tf32_on", "tf32_off"])
def test_tf32_setting_is_left_as_found(small_counts, flag, monkeypatch):
    """identify_outliers, and each do_inference call it makes, leave
    torch.backends.cuda.matmul.allow_tf32 as the caller set it (X @ alpha
    in the CI is multiply-adds, so the pipeline needs no global switch)."""
    from ppcseq_tpu_torch.pipeline import identify

    seen = []
    inner = identify.do_inference

    def spy(*args, **kwargs):
        before = torch.backends.cuda.matmul.allow_tf32
        out = inner(*args, **kwargs)
        seen.append((before, torch.backends.cuda.matmul.allow_tf32))
        return out

    monkeypatch.setattr(identify, "do_inference", spy)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = flag
    try:
        identify_outliers(small_counts, formula="~ Label", just_discovery=True, **_BASE)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert seen == [(flag, flag)]
