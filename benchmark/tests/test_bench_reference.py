"""The plain references against the program on the CPU: the host
preparation on the bundled table and on a small synthetic cohort, the log
density at points around the data-driven start, and the predictive
interval test on simulated quantiles."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import stats

from benchmark import harness
from benchmark.reference import ci
from benchmark.reference.model import ModelArrays, log_density
from benchmark.tests.tiny import tiny_cell
from ppcseq_tpu_torch.data import ingest
from ppcseq_tpu_torch.formula.design import create_design_matrix
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.norm.tmm import sample_scaling


def _cells():
    return [harness.load_cell("readme15.vb"), tiny_cell()]


def _program_prep(cell, df):
    cols, ident = cell.config["columns"], cell.config["identify"]
    my_df = ingest.format_input(df, cell.config["formula"], cols["sample"], cols["transcript"],
                                cols["abundance"], cols["do_check"], cols["significance"],
                                ident["how_many_negative_controls"])
    X, _, rows = create_design_matrix(my_df, cell.config["formula"], cols["sample"])
    scal = sample_scaling(my_df, cols["sample"], cols["transcript"], cols["abundance"])
    md = ingest.build_model_data(my_df, cols["sample"], cols["transcript"], cols["abundance"],
                                 cols["do_check"], X, list(rows[cols["sample"]]),
                                 dict(zip(scal[cols["sample"]], scal["exposure_rate"])))
    return md, dict(zip(scal[cols["sample"]], scal["exposure_rate"]))


@pytest.mark.parametrize("which", [0, 1], ids=["readme15", "tiny"])
def test_host_prep_is_the_programs(which):
    cell = _cells()[which]
    df = harness.make_cohort(cell, 3)
    ctx = harness.Context(cell, df, 3, "cpu")
    md, exposure = _program_prep(cell, df)
    assert ctx.prep.genes == md.gene_names and ctx.prep.samples == md.sample_names
    assert ctx.prep.n_check == md.n_check
    np.testing.assert_array_equal(ctx.prep.counts, md.counts)
    np.testing.assert_array_equal(ctx.prep.X, md.X)
    for s, v in exposure.items():
        assert abs(ctx.exposure[s] - v) < 1e-12


def test_log_density_is_the_programs():
    cell = tiny_cell()
    df = harness.make_cohort(cell, 4)
    ctx = harness.Context(cell, df, 4, "cpu")
    md, _ = _program_prep(cell, df)
    data, dims = nb_model.prepare_data(md.counts, md.X, md.exposure_rate, md.n_check,
                                       device="cpu", dtype=torch.float64)
    theta0 = torch.as_tensor(nb_model.smart_init(data, dims))
    theta = theta0 + 0.1 * torch.randn((5, dims.dim), generator=torch.Generator().manual_seed(0),
                                       dtype=torch.float64)
    want = nb_model.log_joint(theta, data, dims, likelihood_fn=nb_model.masked_likelihood)
    f64 = dict(dtype=torch.float64)
    arr = ModelArrays(torch.as_tensor(ctx.prep.counts, **f64), torch.as_tensor(ctx.prep.X, **f64),
                      torch.as_tensor([ctx.exposure[s] for s in ctx.prep.samples], **f64),
                      torch.ones(ctx.prep.counts.shape, **f64), ctx.prep.n_check)
    got = log_density(theta, arr)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9)


def test_nb_cdf_is_scipys():
    rng = np.random.default_rng(1)
    mu, phi = rng.uniform(0.5, 5000, 200), rng.uniform(0.2, 60, 200)
    x = np.floor(rng.uniform(0, 3, 200) * mu)
    np.testing.assert_allclose(ci.nb_cdf(x, mu, phi),
                               stats.nbinom.cdf(x, phi, phi / (phi + mu)), rtol=1e-9, atol=1e-12)


def test_simulated_quantiles_lie_in_their_band_and_moved_ones_do_not():
    rng = np.random.default_rng(2)
    R, cells, n, p = 60, 150, 2100, 0.0047619
    mu = np.exp(rng.normal(5, 1, cells))[None, :] * np.exp(rng.normal(0, 0.1, (R, cells)))
    phi = np.exp(rng.normal(2, 0.5, cells))[None, :] * np.exp(rng.normal(0, 0.1, (R, cells)))
    idx = rng.integers(0, R, (n, cells))
    m, f = np.take_along_axis(mu, idx, 0), np.take_along_axis(phi, idx, 0)
    sims = rng.negative_binomial(f, f / (f + m))
    lo, hi = np.quantile(sims, p, axis=0), np.quantile(sims, 1 - p, axis=0)
    assert not ci.bound_off(lo, p, n, mu, phi, 0).any()
    assert not ci.bound_off(hi, 1 - p, n, mu, phi, 0).any()
    assert ci.bound_off(hi * 1.5 + 5, 1 - p, n, mu, phi, 0).mean() > 0.9


def test_tmm_of_a_permuted_table_is_the_same():
    cell = tiny_cell()
    df = harness.make_cohort(cell, 5)
    a = harness.Context(cell, df, 5, "cpu").exposure
    b = harness.Context(cell, df.sample(frac=1.0, random_state=0).pipe(pd.DataFrame), 5,
                        "cpu").exposure
    assert all(abs(a[s] - b[s]) < 1e-12 for s in a)
