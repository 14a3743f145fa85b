"""Pass-level checkpoint/resume of the port (ppcseq_tpu_torch.utils.checkpoint
and its wiring in identify_outliers) on the CPU, after tests/test_checkpoint.py:
the fingerprint equal to the JAX package's, a resume that runs no fit and
gives the cold run's result, and the changes that must invalidate a
checkpoint (a threshold, the device, the dtype, pass_fit)."""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from ppcseq_tpu.utils import checkpoint as jckpt
from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.pipeline import identify
from ppcseq_tpu_torch.utils import checkpoint as ckpt
from torch_mesh_stub import MeshOf

torch.set_num_threads(2)

_ARGS = dict(
    formula="~ Label",
    sample="sample", transcript="symbol", abundance="value",
    significance="PValue", do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=20,
    seed=19,
    device="cpu",
)


@pytest.fixture(scope="module")
def tiny_counts():
    counts = load_counts()
    return counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))


@pytest.fixture(scope="module")
def cold(tiny_counts, tmp_path_factory):
    """One cold run with a checkpoint: (result, checkpoint dir)."""
    path = str(tmp_path_factory.mktemp("ck") / "cold")
    return identify_outliers(tiny_counts, checkpoint_dir=path, **_ARGS), path


@pytest.fixture
def copy_of(cold, tmp_path):
    dst = str(tmp_path / "ck")
    shutil.copytree(cold[1], dst)
    return dst


@pytest.fixture
def fits(monkeypatch):
    """The passes that ran a fit, by their do_inference threshold."""
    calls = []
    real = identify.do_inference

    def spy(*args, **kwargs):
        calls.append(kwargs["adj_prob_theshold"])
        return real(*args, **kwargs)

    monkeypatch.setattr(identify, "do_inference", spy)
    return calls


def _fingerprints(path):
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return meta["pass1"]["fingerprint"], meta["pass2"]["fingerprint"]


def test_fingerprint_equals_jax(tiny_counts):
    cfg = dict(which="pass2", thr=0.00095, draws=10500.0, approx_analysis=True,
               excluded=[(3, 1), (7, 0)], formula="~ Label", seed=19, dtype="float32")
    frame = tiny_counts.head(500)
    assert ckpt.config_fingerprint(frame, **cfg) == jckpt.config_fingerprint(frame, **cfg)
    assert ckpt.config_fingerprint(frame, **cfg) != ckpt.config_fingerprint(frame.head(499), **cfg)


def test_resume_runs_no_fit_and_equals_the_cold_run(tiny_counts, cold, copy_of, fits):
    res_cold, _ = cold
    assert os.path.exists(os.path.join(copy_of, "pass1.parquet"))
    assert os.path.exists(os.path.join(copy_of, "pass2.parquet"))
    res = identify_outliers(tiny_counts, checkpoint_dir=copy_of, **_ARGS)
    assert fits == []
    pd.testing.assert_frame_equal(res.drop(columns="sample_wise_data"),
                                  res_cold.drop(columns="sample_wise_data"))
    for a, b in zip(res.sample_wise_data, res_cold.sample_wise_data):
        pd.testing.assert_frame_equal(a, b)
    assert res.attrs["vb_iterations"] == res_cold.attrs["vb_iterations"]
    assert all(it >= 100 for it in res.attrs["vb_iterations"])
    assert res.attrs["total_draws"] == res_cold.attrs["total_draws"] > 0
    pd.testing.assert_frame_equal(res.attrs["pass1_excluded"], res_cold.attrs["pass1_excluded"])
    with open(os.path.join(copy_of, "meta.json")) as f:
        meta = json.load(f)
    for i, name in enumerate(("pass1", "pass2")):
        assert meta[name]["total_draws"] > 0
        assert meta[name]["vb_iterations"] == res_cold.attrs["vb_iterations"][i]


def test_threshold_change_refits_pass2_only(tiny_counts, copy_of, fits):
    """A new user FP level changes pass 2's threshold; pass 1's (the
    permissive 0.05) is unchanged, so pass 1 resumes."""
    before = _fingerprints(copy_of)
    identify_outliers(tiny_counts, checkpoint_dir=copy_of,
                      **{**_ARGS, "percent_false_positive_genes": 2})
    assert fits == [pytest.approx(0.02 / 21 * 2)]
    after = _fingerprints(copy_of)
    assert after[0] == before[0] and after[1] != before[1]


def test_dtype_change_refits_both_passes(tiny_counts, copy_of, fits):
    before = _fingerprints(copy_of)
    res = identify_outliers(tiny_counts, checkpoint_dir=copy_of, dtype=torch.float64, **_ARGS)
    assert len(fits) == 2
    after = _fingerprints(copy_of)
    assert after[0] != before[0] and after[1] != before[1]
    assert np.isfinite(res.sample_wise_data.iloc[0][".upper"]).all()


def test_device_change_invalidates(tiny_counts, copy_of, fits, monkeypatch):
    """The card's result must not resume a CPU run, nor the reverse: a run
    on another device type (float32 on both, so only the device differs)
    reaches pass 1's fit instead of the checkpoint."""
    class _Stop(Exception):
        pass

    def no_fit(*args, **kwargs):
        fits.append(kwargs["device"])
        raise _Stop

    monkeypatch.setattr(identify, "resolve_device", torch.device)
    monkeypatch.setattr(identify, "do_inference", no_fit)
    with pytest.raises(_Stop):
        identify_outliers(tiny_counts, checkpoint_dir=copy_of, **{**_ARGS, "device": "cuda"})
    assert fits == [torch.device("cuda")]


def test_pass_fit_refits_instead_of_silent_none(tiny_counts, copy_of, fits):
    """tests/test_checkpoint.py:103 on the port: with pass_fit neither pass
    resumes, since a checkpoint holds no fit object."""
    res = identify_outliers(tiny_counts, checkpoint_dir=copy_of, pass_fit=True, **_ARGS)
    assert len(fits) == 2
    assert res.attrs["fit 1"] is not None and res.attrs["fit 2"] is not None
    assert res.attrs["total_draws"] > 0


def test_mesh_change_invalidates(tiny_counts, copy_of, fits, monkeypatch):
    """The fingerprint takes the mesh's (axis, size) pairs, as JAX's
    mesh_desc (identify.py:792-801): a gene-sharded run (another gene
    padding) does not resume the unsharded run's checkpoint, and the
    fingerprints of two meshes differ."""
    from ppcseq_tpu_torch.parallel import sharding

    class _Stop(Exception):
        pass

    def no_fit(*args, **kwargs):
        fits.append(sharding.mesh_desc(kwargs["mesh"]))
        raise _Stop

    monkeypatch.setattr(identify, "do_inference", no_fit)
    with pytest.raises(_Stop):
        identify_outliers(tiny_counts, checkpoint_dir=copy_of, mesh=MeshOf(genes=2), **_ARGS)
    assert fits == [(("genes", 2),)]
    frame = tiny_counts.head(50)
    prints = {ckpt.config_fingerprint(frame, which="pass1", mesh=sharding.mesh_desc(m))
              for m in (None, MeshOf(genes=2), MeshOf(genes=4), MeshOf(chains=2, genes=2))}
    assert len(prints) == 4
