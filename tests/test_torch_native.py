"""The port's native host runtime (ppcseq_tpu_torch/_native.py, built from
ppcseq_tpu_torch/native/ppcseq_native.cpp with the host C++ compiler)
against its NumPy versions and the JAX package's, on the CPU: TMM factors
at rtol 1e-12, the pivot exactly, the type-7 quantile; the product path
(sample_scaling, build_model_data) against JAX's on the README subset; and
the build itself: no fallback when the compiler is missing or fails, a
rebuild when the source changes, and concurrent builds."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ppcseq_tpu import _native as jax_native
from ppcseq_tpu.data import ingest as jingest
from ppcseq_tpu.formula.design import create_design_matrix as j_design
from ppcseq_tpu.norm import tmm as jtmm
from ppcseq_tpu_torch import _native
from ppcseq_tpu_torch.data import ingest
from ppcseq_tpu_torch.norm import tmm

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12


def _gamma_poisson(genes, samples, seed):
    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, 50.0, size=genes)
    depth = rng.uniform(0.5, 2.0, size=samples)
    noise = rng.gamma(10.0, 0.1, size=(genes, samples))
    return rng.poisson(lam[:, None] * noise * depth[None, :]).astype(float)


def _identical():
    col = np.random.default_rng(0).poisson(50, size=500)
    return np.column_stack([col, col, col]).astype(float)


def _depth():
    base = np.random.default_rng(1).poisson(100, size=2000).astype(float)
    return np.column_stack([base, base * 2, base * 4])


def _composition():
    rng = np.random.default_rng(2)
    base = rng.poisson(200, size=1000).astype(float)
    biased = base.copy()
    biased[:20] *= 200  # a handful of hugely expressed genes
    return np.column_stack([base, biased, rng.poisson(base).astype(float)])


def _trim_ties():
    # duplicated logR values: tied average ranks at the trim boundaries
    rng = np.random.default_rng(7)
    base = rng.poisson(20, size=400).astype(float) + 1
    obs = base.copy()
    obs[::2] = base[::2] * 2
    return np.column_stack([base, obs])


def _single_overlap():
    # one gene positive in both columns: the trim windows collapse
    return np.array([[0.0, 0.0], [3.0, 0.0], [10.0, 5.0], [0.0, 0.0]])


def _empty_trim():
    # column 1 against column 0: logR ranks 1.5, 1.5, 3.5, 3.5 while the
    # logR window is [2, 3], so no gene is kept and the raw factor is 1.0
    # (C++: den == 0; NumPy: 2**0)
    return np.array([[10.0, 5.0, 10.0], [10.0, 5.0, 12.0], [10.0, 20.0, 9.0], [10.0, 20.0, 11.0]])


CASES = {
    "identical": _identical,
    "depth": _depth,
    "composition": _composition,
    "trim_ties": _trim_ties,
    "single_overlap": _single_overlap,
    "empty_trim": _empty_trim,
    "gamma_poisson_2000x30": lambda: _gamma_poisson(2000, 30, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_tmm_matches_numpy_and_jax(case):
    counts = CASES[case]()
    ref = 0
    got = tmm.tmm_norm_factors(counts, ref_column=ref)
    want = tmm.tmm_norm_factors(counts, ref_column=ref, use_native=False)
    np.testing.assert_array_equal(got, _native.tmm_norm_factors(counts, ref))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, jtmm.tmm_norm_factors(counts, ref_column=ref,
                                                          use_native=False), rtol=RTOL)
    assert np.isfinite(got).all() and np.isclose(np.prod(got), 1.0, rtol=RTOL)
    if case == "empty_trim":
        assert jtmm._calc_factor_tmm(counts[:, 1], counts[:, 0]) == 1.0
        # the reference column's raw factor is 1.0 too: both scale alike
        assert got[1] == got[0] and want[1] == want[0]
        assert got[2] != got[0]
    if case == "single_overlap":
        assert got[1] != got[0]  # the one kept gene sets the factor


@pytest.mark.parametrize("case", list(CASES))
def test_jax_native_tmm_matches_the_ports(case):
    """The JAX package's own C++ TMM on the same inputs, where its library
    loads."""
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built (make -C native)")
    counts = CASES[case]()
    np.testing.assert_allclose(jax_native.tmm_norm_factors(counts, 0),
                               tmm.tmm_norm_factors(counts, ref_column=0), rtol=RTOL)


@pytest.mark.parametrize("S,G", [(1, 1), (13, 57), (100, 5000)])
def test_pivot_counts_matches_numpy(S, G):
    rng = np.random.default_rng(S * G)
    cells = rng.permutation(S * G)[: max(1, S * G * 3 // 4)]  # some cells left 0
    s, g = cells // G, cells % G
    v = rng.integers(0, 2**40, size=len(cells))
    got = _native.pivot_counts(s, g, v, S, G)
    assert got.dtype == np.int64 and got.shape == (S, G)
    np.testing.assert_array_equal(got, ingest._pivot_numpy(s, g, v, S, G))


def test_pivot_counts_rejects_indices_outside_the_matrix():
    with pytest.raises(ValueError, match="outside"):
        _native.pivot_counts(np.array([0, 3]), np.array([0, 1]), np.array([1, 2]), 3, 2)
    with pytest.raises(ValueError, match="outside"):
        _native.pivot_counts(np.array([0]), np.array([-1]), np.array([1]), 3, 2)


@pytest.mark.parametrize("n", [1, 2, 10, 1001])
def test_quantile7_matches_numpy_linear(n):
    x = np.sort(np.random.default_rng(n).gamma(2.0, 3.0, size=n))
    for p in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0):
        np.testing.assert_allclose(_native.quantile7_sorted(x, p),
                                   np.quantile(x, p, method="linear"), rtol=RTOL)
    if n == 10:  # R: quantile(1:10, .1, type=7) == 1.9
        assert np.isclose(_native.quantile7_sorted(np.arange(1.0, 11.0), 0.1), 1.9)
    assert np.isnan(_native.quantile7_sorted(np.array([]), 0.5))


def _refuse_native(*args, **kwargs):
    raise AssertionError("the native path ran")


@pytest.mark.parametrize("kwargs", [dict(use_native=False), dict(lib_size="custom"),
                                    dict(ref_column=None)])
def test_numpy_path_when_asked_or_when_native_cannot_serve(kwargs, monkeypatch):
    """use_native=False, a custom lib_size and no reference column take the
    NumPy version, as JAX's guard (norm/tmm.py:113-119) does."""
    counts = _gamma_poisson(300, 4, 8)
    kwargs = {"ref_column": 0, **kwargs}
    if kwargs.get("lib_size") == "custom":
        kwargs["lib_size"] = counts.sum(0) * np.array([1.0, 2.0, 0.5, 1.5])
    want = jtmm.tmm_norm_factors(counts, **{**kwargs, "use_native": False})
    monkeypatch.setattr(_native, "tmm_norm_factors", _refuse_native)
    np.testing.assert_array_equal(tmm.tmm_norm_factors(counts, **kwargs), want)


def _fake_compiler(tmp_path, body):
    path = tmp_path / "fake-cxx"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("which", ["missing", "failing"])
def test_no_fallback_when_the_compiler_cannot_build(which, tmp_path, monkeypatch):
    """A compiler that cannot be run, or one that fails, raises with its
    output from every native entry; nothing falls back to NumPy."""
    monkeypatch.setenv("PPCSEQ_TORCH_BUILD_DIR", str(tmp_path / "build"))
    if which == "missing":
        monkeypatch.setenv("CXX", str(tmp_path / "nonexistent-cxx"))
        match = "cannot be run"
    else:
        monkeypatch.setenv("CXX", _fake_compiler(tmp_path, (
            'if [ "$1" = --version ]; then echo fake-cxx 1.0; exit 0; fi\n'
            'echo "fake-cxx: error: no such target" >&2; exit 1\n')))
        match = "fake-cxx: error: no such target"
    counts = _gamma_poisson(50, 3, 9)
    with pytest.raises(RuntimeError, match=match):
        tmm.tmm_norm_factors(counts, ref_column=0)
    with pytest.raises(RuntimeError, match=match):
        _native.pivot_counts(np.array([0]), np.array([0]), np.array([1]), 1, 1)
    assert not list((tmp_path / "build").rglob("*.so"))
    # the plain reference still answers when asked for by name
    assert np.isfinite(tmm.tmm_norm_factors(counts, ref_column=0, use_native=False)).all()


def test_the_library_is_the_ports_own(monkeypatch):
    """Built from the port's source into build/native/, never the JAX
    package's native/libppcseq_native.so."""
    monkeypatch.delenv("PPCSEQ_TORCH_BUILD_DIR", raising=False)
    assert _native.SOURCE == REPO / "ppcseq_tpu_torch" / "native" / "ppcseq_native.cpp"
    lib = _native.load()
    path = _native.lib_path()
    assert _native._LOADED[path] is lib and path.is_file()
    assert path.parent.parent == REPO / "build" / "native"
    assert path.parent.name.startswith("ppcseq_native-")


def test_rebuild_when_the_source_changes(tmp_path, monkeypatch):
    monkeypatch.setenv("PPCSEQ_TORCH_BUILD_DIR", str(tmp_path / "build"))
    source = tmp_path / "ppcseq_native.cpp"
    source.write_bytes(_native.SOURCE.read_bytes())
    monkeypatch.setattr(_native, "SOURCE", source)
    monkeypatch.setattr(_native, "_LOADED", {})
    counts = _gamma_poisson(200, 4, 10)

    first = _native.load()
    assert not _native.BUILD_INFO["cached"]
    path1 = Path(_native.BUILD_INFO["path"])
    assert path1.parent.parent == tmp_path / "build" / "native"
    assert _native.load() is first  # loaded once per process
    f1 = _native.tmm_norm_factors(counts, 0)

    source.write_text(source.read_text() + "\n// changed\n")
    _native.load()
    path2 = Path(_native.BUILD_INFO["path"])
    assert path2 != path1 and not _native.BUILD_INFO["cached"]
    np.testing.assert_array_equal(_native.tmm_norm_factors(counts, 0), f1)

    monkeypatch.setattr(_native, "_LOADED", {})  # a new process finds it built
    _native.load()
    assert _native.BUILD_INFO["cached"] and Path(_native.BUILD_INFO["path"]) == path2
    assert sorted(p.name for p in (tmp_path / "build" / "native").rglob("*")
                  if p.is_file()) == ["libppcseq_native.so"] * 2


def test_concurrent_builds_share_one_library(tmp_path):
    """Processes that build at the same time (xdist workers, torchrun ranks)
    each load a whole library; the rename leaves one file and no temp."""
    code = ("import numpy as np\nfrom ppcseq_tpu_torch import _native\n"
            "f = _native.tmm_norm_factors(np.arange(1.0, 41.0).reshape(20, 2), 0)\n"
            "print(_native.BUILD_INFO['path'], f.tolist())\n")
    env = {**os.environ, "PPCSEQ_TORCH_BUILD_DIR": str(tmp_path / "build")}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _, err in outs]
    assert len({out for out, _ in outs}) == 1
    files = [p for p in (tmp_path / "build").rglob("*") if p.is_file()]
    assert [p.name for p in files] == ["libppcseq_native.so"]


@pytest.fixture(scope="module")
def readme_prep():
    """The README configuration's host prep on the bundled data (FDR < 0.01
    checked, 500 controls), as scripts/readme_run.py calls it."""
    from ppcseq_tpu_torch import load_counts

    counts = load_counts()
    df = counts.assign(do_check___=counts.FDR < 0.01)
    my_df = ingest.format_input(df, "~ Label", "sample", "symbol", "value", "do_check___",
                                "PValue", 500)
    return my_df


def test_readme_subset_scaling_and_model_data_equal_jax(readme_prep, monkeypatch):
    """The product path runs the native TMM and pivot, and its frames equal
    JAX's: the pivot exactly, the scaling columns at rtol 1e-12."""
    my_df = readme_prep
    calls = []
    for name in ("tmm_norm_factors", "pivot_counts"):
        fn = getattr(_native, name)
        monkeypatch.setattr(_native, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    scal = tmm.sample_scaling(my_df, "sample", "symbol", "value")
    jscal = jtmm.sample_scaling(my_df, "sample", "symbol", "value")
    assert list(scal["sample"]) == list(jscal["sample"])
    for col in ("TMM", "multiplier", "exposure_rate", "exposure_multiplier"):
        np.testing.assert_allclose(scal[col], jscal[col], rtol=RTOL, err_msg=col)
    X, _, rows = j_design(my_df, "~ Label", "sample")
    expo = dict(zip(scal["sample"], scal["exposure_rate"]))
    args = (my_df, "sample", "symbol", "value", "do_check___", X, list(rows["sample"]), expo)
    md = ingest.build_model_data(*args, exclude=my_df[["S", "G"]].head(5))
    jmd = jingest.build_model_data(*args, exclude=my_df[["S", "G"]].head(5))
    for k in ("counts", "X", "exposure_rate", "exclude_mask"):
        np.testing.assert_array_equal(getattr(md, k), getattr(jmd, k), err_msg=k)
    assert (md.gene_names, md.sample_names, md.n_check) == (jmd.gene_names, jmd.sample_names,
                                                            jmd.n_check)
    assert calls == ["tmm_norm_factors", "pivot_counts"]
    np.testing.assert_array_equal(md.counts, ingest._pivot_numpy(
        my_df["S"].to_numpy(), my_df["G"].to_numpy(), my_df["value"].to_numpy(),
        len(md.sample_names), len(md.gene_names)))
