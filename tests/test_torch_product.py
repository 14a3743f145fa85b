"""The port's product options against the JAX package, on the CPU:
`unpack` over a batch of draws, `additional_parameters_to_save`,
`save_generated_quantities` on the HMC branch with the exact CI, the
credible-interval plots, and the recovery of injected outliers
(tests/test_truth_recovery.py)."""

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pandas as pd
import pytest
import torch

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu.viz import plots as jplots
from ppcseq_tpu_torch import identify_outliers, load_counts, plot_credible_intervals
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort
from ppcseq_tpu_torch.viz import plots

matplotlib.use("Agg")
torch.set_num_threads(2)

_COMMON = dict(
    formula="~ Label",
    sample="sample", transcript="symbol", abundance="value",
    significance="PValue", do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=20,
    device="cpu",
)


@pytest.fixture(scope="module")
def tiny_counts():
    counts = load_counts()
    return counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))


@pytest.mark.parametrize("C", [1, 2, 3])
def test_unpack_of_draws_equals_jax_vmap(C):
    rng = np.random.default_rng(C)
    S, G, K = 7, 9, 3
    counts = rng.integers(0, 200, size=(S, G))
    X = np.column_stack([np.ones(S)] + [rng.integers(0, 2, S).astype(float) for _ in range(C - 1)])
    exposure = rng.normal(0.0, 0.2, S)
    _, jdims = jnb.prepare_data(counts, X, exposure, K, dtype=jnp.float64)
    _, dims = nb_model.prepare_data(counts, X, exposure, K, device="cpu", dtype=torch.float64)
    assert dims.dim == jdims.dim
    thetas = rng.normal(0.0, 0.7, size=(5, dims.dim))
    got = nb_model.unpack(torch.as_tensor(thetas), dims)[0]
    want = jax.vmap(lambda th: jnb.unpack(th, jdims)[0])(jnp.asarray(thetas))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(torch.exp(got["sigma_raw"]).numpy() ** -1,
                               np.asarray(jnp.exp(want["sigma_raw"]) ** -1), rtol=1e-12)


def test_additional_parameters_to_save_on_vb(tiny_counts):
    """tests/test_cli.py:22-45 on the port, with the derived names too."""
    names = ("lambda_mu", "sigma_raw", "sigma", "lambda_log_param", "counts_rng")
    res = identify_outliers(tiny_counts, additional_parameters_to_save=names, seed=3, **_COMMON)
    extra = res.attrs["additional_parameters"]
    assert set(extra) == {"lambda_mu", "sigma_raw", "sigma", "lambda_log_param"}
    n_draws = extra["lambda_mu"].shape[0]
    assert n_draws == 1000  # the approximated CI's practical draws
    assert all(isinstance(v, np.ndarray) for v in extra.values())
    assert extra["sigma_raw"].shape == (n_draws, 23)  # 3 checked + 20 controls
    assert extra["lambda_log_param"].shape == (n_draws, 21, 3)
    np.testing.assert_allclose(extra["sigma"], np.exp(-extra["sigma_raw"]), rtol=1e-5)


def test_additional_parameters_unknown_name(tiny_counts):
    with pytest.raises(ValueError, match="unknown parameter 'not_a_param'.*sigma_raw"):
        identify_outliers(tiny_counts, additional_parameters_to_save=("not_a_param",), seed=3,
                          **_COMMON)


def test_generated_quantities_on_hmc_exact(tiny_counts):
    """The HMC branch with the exact CI keeps each checked point's simulated
    counts (JAX identify.py:448-456): a frame of .draw (1..n) and .value
    per point, beside the reference's calls."""
    res = identify_outliers(
        tiny_counts, seed=42, approximate_posterior_inference=False, mcmc_sampler="hmc",
        approximate_posterior_analysis=False, save_generated_quantities=True,
        additional_parameters_to_save=("sigma_raw",), **_COMMON,
    )
    assert dict(zip(res.symbol, res.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    n_draws = res.attrs["additional_parameters"]["sigma_raw"].shape[0]
    assert n_draws == 128 * int(np.ceil(10 / (0.01 / 21 * 2) / 128))
    for swd in res.sample_wise_data:
        assert len(swd) == 21
        for gq in swd["generated quantities"]:
            assert list(gq.columns) == [".draw", ".value"]
            np.testing.assert_array_equal(gq[".draw"], np.arange(1, n_draws + 1))
            assert (gq[".value"] >= 0).all()


def _swd(seed, n=12):
    rng = np.random.default_rng(seed)
    lower = rng.integers(0, 50, n).astype(float)
    return pd.DataFrame({
        "sample": [f"s{i}" for i in range(n)],
        "value": rng.integers(0, 120, n),
        "Label": rng.choice(["High", "Low"], n),
        ".lower": lower,
        ".upper": lower + rng.integers(1, 80, n),
        "deleterious_outliers": rng.uniform(size=n) < 0.3,
        "exposure_rate": rng.normal(0.0, 0.3, n),
    })


def _artists(fig):
    ax = fig.axes[0]
    out = {"title": ax.get_title(), "ylim": ax.get_ylim(),
           "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
           "legend": [t.get_text() for t in ax.get_legend().get_texts()] if ax.get_legend() else []}
    for i, c in enumerate(ax.collections):
        if hasattr(c, "get_segments"):
            out[f"{i} segments"] = [s.tolist() for s in c.get_segments()]
            out[f"{i} color"] = c.get_color().tolist()
        else:
            out[f"{i} offsets"] = np.asarray(c.get_offsets()).tolist()
            out[f"{i} sizes"] = np.asarray(c.get_sizes()).tolist()
            out[f"{i} colors"] = np.asarray(c.get_facecolors()).tolist()
    return out


@pytest.mark.parametrize("covariate", ["Label", None])
def test_produce_plot_equals_jax(covariate):
    import matplotlib.pyplot as plt

    swd = _swd(4)
    got = plots.produce_plot(swd, "CYP1A1", "value", "sample", covariate)
    want = jplots.produce_plot(swd, "CYP1A1", "value", "sample", covariate)
    a, b = _artists(got), _artists(want)
    assert any(k.endswith("segments") for k in a) and any(k.endswith("offsets") for k in a)
    assert a == b
    plt.close(got)
    plt.close(want)


def test_plot_credible_intervals_equals_jax():
    import matplotlib.pyplot as plt

    result = pd.DataFrame({"symbol": ["A", "B"], "sample_wise_data": [_swd(1), _swd(2, 9)],
                           "ppc_samples_failed": [0, 1]})
    result.attrs.update(transcript_column="symbol", abundance_column="value",
                        sample_column="sample", formula="~ Label")
    got, want = plot_credible_intervals(result), jplots.plot_credible_intervals(result)
    assert list(got.columns) == list(result.columns) + ["plot"]
    assert got.attrs == result.attrs
    for f, g in zip(got["plot"], want["plot"]):
        assert _artists(f) == _artists(g)
        assert f.axes[0].get_title() in ("A", "B")
        plt.close(f)
        plt.close(g)


@pytest.fixture(scope="module")
def synthetic_run():
    """tests/test_truth_recovery.py's cohort, seeds and settings on the port."""
    S, G, n_check = 16, 200, 30
    counts, X, _exposure, truth = synthetic_cohort(
        n_genes=G, n_samples=S, n_check=n_check, outlier_frac=0.06, seed=3
    )
    s_idx, g_idx = np.meshgrid(np.arange(S), np.arange(G), indexing="ij")
    df = pd.DataFrame({
        "sample": [f"s{s:02d}" for s in s_idx.ravel()],
        "transcript": [f"g{g:04d}" for g in g_idx.ravel()],
        "count": counts.ravel().astype(int),
        "group": np.where(X[s_idx.ravel(), 1] > 0, "B", "A"),
    })
    gidx = g_idx.ravel()
    df["PValue"] = np.where(gidx < n_check, 1e-8, gidx / G)
    df["do_check"] = gidx < n_check

    res = identify_outliers(
        df, formula="~ group",
        sample="sample", transcript="transcript", abundance="count",
        significance="PValue", do_check="do_check",
        percent_false_positive_genes=5,
        how_many_negative_controls=60,
        do_check_only_on_detrimental=False,  # count every PPC failure
        seed=17, device="cpu",
    )
    injected = {(s, g) for s, g in truth["outliers"] if g < n_check}
    med = np.median(counts, axis=0)
    detectable = {(s, g) for s, g in injected if counts[s, g] >= 5 * max(med[g], 1.0)}
    return res, injected, detectable


def test_injected_outliers_detected(synthetic_run):
    res, _injected, detectable = synthetic_run
    flagged = set()
    for name, swd in zip(res.transcript, res.sample_wise_data):
        bad = swd[~swd["posterior_predictive_check_succeded"].astype(bool)]
        flagged |= {(int(s), name) for s in bad["S"]}
    det_named = {(s, f"g{g:04d}") for s, g in detectable}
    assert len(det_named) >= 15  # the seed must give signal to detect
    recall = len(flagged & det_named) / len(det_named)
    assert recall >= 0.85, (recall, sorted(det_named), sorted(flagged))


def test_false_positive_rate_bounded(synthetic_run):
    res, injected, _detectable = synthetic_run
    total_cells = sum(len(swd) for swd in res.sample_wise_data)
    total_failed = int(res["ppc_samples_failed"].sum())
    extra = total_failed - len(injected)
    assert extra <= max(3, 0.02 * total_cells), (total_failed, len(injected), total_cells)
