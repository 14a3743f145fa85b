"""End-to-end checks of the port (ppcseq_tpu_torch) on the CPU: the
reference's 3-gene (0, 1, 0) calls on both CI paths, host prep equal to the
JAX package's, no JAX in the port's imports, and chip_smoke.py refusing to
run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppcseq_tpu.data import ingest as jingest
from ppcseq_tpu.formula.design import create_design_matrix as j_design
from ppcseq_tpu.norm.tmm import sample_scaling as j_scaling
from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.data import ingest
from ppcseq_tpu_torch.formula.design import create_design_matrix
from ppcseq_tpu_torch.norm.tmm import sample_scaling
from ppcseq_tpu_torch.utils.device import resolve_device, working_dtype

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMON = dict(
    formula="~ Label",
    sample="sample",
    transcript="symbol",
    abundance="value",
    significance="PValue",
    do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=50,
    seed=42,
    device="cpu",
)


@pytest.fixture(scope="module")
def sig_counts():
    counts = load_counts()
    return counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))


@pytest.mark.parametrize("approx", [True, False], ids=["approximated", "exact"])
def test_vb_calls_match_reference(sig_counts, approx):
    """Reference tests 'VB post approx no correction' / 'VB post full'
    (test-ppcSeq.R:7-57), on the port's CPU path."""
    res = identify_outliers(sig_counts, approximate_posterior_analysis=approx, **_COMMON)
    assert list(res.columns[:2]) == ["symbol", "sample_wise_data"]
    assert dict(zip(res.symbol, res.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0,
    }
    swd = res.sample_wise_data.iloc[0]
    assert len(swd) == 21
    for col in [
        "S", "G", "value", "sample", "Label",
        "slope_before_outlier_filtering", "slope_after_outlier_filtering",
        ".lower", ".upper", "posterior_predictive_check_succeded",
        "deleterious_outliers", "exposure_rate", "multiplier",
    ]:
        assert col in swd.columns, col
    assert res.attrs["total_draws"] > 0 and res.attrs["formula"] == "~ Label"


def test_host_prep_equals_jax(sig_counts):
    work = sig_counts.assign(do_check___=sig_counts.is_significant)
    args = (work, "~ Label", "sample", "symbol", "value", "do_check___", "PValue", 50)
    my_df = ingest.format_input(*args)
    assert my_df.equals(jingest.format_input(*args))
    X, names, rows = create_design_matrix(my_df, "~ Label", "sample")
    jX, jnames, _ = j_design(my_df, "~ Label", "sample")
    np.testing.assert_array_equal(X, jX)
    assert names == jnames
    scal = sample_scaling(my_df, "sample", "symbol", "value")
    np.testing.assert_allclose(scal["exposure_rate"], j_scaling(my_df, "sample", "symbol", "value")[
        "exposure_rate"], rtol=1e-12)
    expo = dict(zip(scal["sample"], scal["exposure_rate"]))
    md = ingest.build_model_data(my_df, "sample", "symbol", "value", "do_check___", X,
                                 list(rows["sample"]), expo, exclude=my_df[["S", "G"]].head(3))
    jmd = jingest.build_model_data(my_df, "sample", "symbol", "value", "do_check___", X,
                                   list(rows["sample"]), expo, exclude=my_df[["S", "G"]].head(3))
    for k in ("counts", "X", "exposure_rate", "exclude_mask"):
        np.testing.assert_array_equal(getattr(md, k), getattr(jmd, k), err_msg=k)
    assert md.n_check == jmd.n_check == 3


def test_unported_options_raise(sig_counts):
    for kw in (dict(approximate_posterior_inference=False, mcmc_sampler="nuts", mesh=object()),
               dict(mesh=object()),
               dict(checkpoint_dir="ckpt"), dict(additional_parameters_to_save=("sigma",))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            identify_outliers(sig_counts, **{**_COMMON, **kw})


def test_empty_do_check_warns(sig_counts):
    with pytest.warns(UserWarning, match="no transcripts"):
        res = identify_outliers(sig_counts.assign(is_significant=False), **_COMMON)
    assert len(res) == 0


def test_device_policy():
    assert working_dtype("cpu", torch.float64) == torch.float64
    assert working_dtype("cuda", torch.float64) == torch.float32
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_port_imports_no_jax():
    code = ("import sys, ppcseq_tpu_torch, ppcseq_tpu_torch.utils.convert, "
            "ppcseq_tpu_torch.infer.nuts, ppcseq_tpu_torch.infer.chains; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'ppcseq_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result with no CUDA
    device, and also where nothing of the repo but the script exists."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
