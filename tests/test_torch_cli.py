"""The port's command-line interface (ppcseq_tpu_torch.cli, `python -m
ppcseq_tpu_torch`) against the JAX package's (tests/test_cli.py), on the
CPU, and the package data that an installed copy needs to build its
kernels."""

import json
import os
import re
import subprocess
import sys
import tomllib
from fnmatch import fnmatch
from pathlib import Path

import pandas as pd
import pytest
import torch

from ppcseq_tpu.cli import build_parser as jax_build_parser
from ppcseq_tpu_torch import _native, load_counts
from ppcseq_tpu_torch.cli import build_parser
from ppcseq_tpu_torch.cli import main as cli_main
from ppcseq_tpu_torch.pipeline import identify

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny_csv(tmp_path_factory):
    counts = load_counts()
    counts = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    path = tmp_path_factory.mktemp("cli") / "input.csv"
    counts.to_csv(path, index=False)
    return str(path)


def _args(inp, out, *extra):
    return [inp, "-o", str(out), "--formula", "~ Label", "--sample", "sample",
            "--transcript", "symbol", "--abundance", "value", "--significance", "PValue",
            "--do-check", "is_significant", "--negative-controls", "20", *extra]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default) for a in parser._actions}


def test_parser_mirrors_jax_plus_device():
    """Every option of the JAX CLI, with its dest, flags and default; the
    port adds only --device (default: the card)."""
    jax_opts, opts = _options(jax_build_parser()), _options(build_parser())
    assert set(opts) - set(jax_opts) == {"device"}
    assert opts["device"] == (("--device",), "cuda")
    for dest, want in jax_opts.items():
        assert opts[dest] == want, dest


def test_cli_sampler_flag_reaches_do_inference(tiny_csv, tmp_path, monkeypatch):
    """tests/test_cli.py:56 on the port: --full-posterior --mcmc-sampler nuts
    selects MCMC and NUTS in do_inference."""
    seen = {}

    class _Stop(Exception):
        pass

    def spy(*args, **kwargs):
        seen["mcmc_sampler"] = kwargs.get("mcmc_sampler")
        seen["approximate_posterior_inference"] = kwargs.get("approximate_posterior_inference")
        raise _Stop

    monkeypatch.setattr(identify, "do_inference", spy)
    with pytest.raises(_Stop):
        cli_main(_args(tiny_csv, tmp_path / "r", "--full-posterior", "--mcmc-sampler", "nuts",
                       "--device", "cpu"))
    assert seen == {"mcmc_sampler": "nuts", "approximate_posterior_inference": False}


def test_cli_end_to_end(tiny_csv, tmp_path, capsys):
    """tests/test_cli.py:87-106 on the port, with --json and --plots: the
    summary, the flattened per-sample table and one PNG per transcript."""
    out = tmp_path / "results"
    assert cli_main(_args(tiny_csv, out, "--seed", "5", "--json", "--plots",
                          "--device", "cpu")) == 0
    summary = pd.read_csv(out / "result.csv")
    assert set(summary.symbol) == {"SLC16A12", "CYP1A1", "ART3"}
    assert list(summary.columns) == ["symbol", "ppc_samples_failed", "tot_deleterious_outliers"]
    assert dict(zip(summary.symbol, summary.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    flat = pd.read_csv(out / "sample_wise_data.csv")
    assert len(flat) == 3 * 21
    assert {".lower", ".upper", "posterior_predictive_check_succeded", "symbol"} <= set(flat.columns)
    assert sorted(os.listdir(out / "plots")) == ["ART3.png", "CYP1A1.png", "SLC16A12.png"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary.to_dict("records")


def test_cli_mesh_is_not_ported(tiny_csv, tmp_path, monkeypatch):
    """--mesh is ported: outside torchrun a mesh of several processes is a
    SystemExit that says how to launch them (test_cli_mesh_under_torchrun
    runs one)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        cli_main(_args(tiny_csv, tmp_path / "r", "--mesh", "genes=4", "--device", "cpu"))


def test_cli_default_device_is_the_card(tiny_csv, tmp_path):
    """No fallback: without a card the default run fails instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(_args(tiny_csv, tmp_path / "r"))
    assert not (tmp_path / "r").exists()


def test_module_entry_point_help():
    out = subprocess.run([sys.executable, "-m", "ppcseq_tpu_torch", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert "--device" in out and "--checkpoint-dir" in out
    code = ("import sys, runpy; sys.argv = ['x', '--help']\n"
            "try:\n    runpy.run_module('ppcseq_tpu_torch', run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'ppcseq_tpu')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                   capture_output=True)


def test_console_script_and_package_data_cover_the_kernels():
    """pyproject.toml names the port's console script; its `torch` extra
    names what the port imports beyond the JAX package's dependencies
    (pyarrow for parquet: data/datasets.py, cli.py, utils/checkpoint.py;
    scipy: utils/sbc.py); its package data match every kernel source (the
    float64 form's nb_glm_fast64.cu among them) and every header a source
    includes with quotes (ops/_build.py hashes and compiles them), and the
    native host runtime's source (_native.py builds it at first use)."""
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert meta["project"]["scripts"]["ppcseq-tpu-torch"] == "ppcseq_tpu_torch.cli:main"
    assert {"torch", "pyarrow", "scipy"} <= set(meta["project"]["optional-dependencies"]["torch"])
    globs = meta["tool"]["setuptools"]["package-data"]["ppcseq_tpu_torch"]
    csrc = REPO / "ppcseq_tpu_torch" / "csrc"
    needed, todo = set(), sorted(csrc.glob("*.cu"))
    while todo:
        path = todo.pop()
        rel = path.relative_to(csrc.parent).as_posix()
        if rel in needed:
            continue
        needed.add(rel)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            todo.append(path.parent / inc)
    assert {"csrc/nb_common.cuh", "csrc/nb_tile.cuh", "csrc/nb_glm_fast64.cu"} <= needed
    needed.add(_native.SOURCE.relative_to(csrc.parent).as_posix())
    for rel in sorted(needed):
        assert (csrc.parent / rel).exists(), rel
        assert any(fnmatch(rel, g) for g in globs), f"{rel} matches none of {globs}"


@pytest.mark.parametrize("spec,message", [
    ("replicas=2", "bad axis"), ("genes=two", "bad axis"),
    ("genes=1,genes=1", "duplicate axis 'genes'"),
    ("genes=0", "at least 1 process"),  # JAX's cli.py:93 accepts it (ROADMAP §3)
    ("chains=2,genes=2", "needs 4 processes, but WORLD_SIZE is 2")])
def test_parse_mesh_spec_errors(spec, message, monkeypatch):
    """Each bad --mesh is a SystemExit naming the fault, before any
    process group starts."""
    from ppcseq_tpu_torch.cli import parse_mesh_spec

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=message):
        parse_mesh_spec(spec, "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    if "WORLD_SIZE" in message:
        with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
            parse_mesh_spec(spec, "cpu")


def test_cli_mesh_under_torchrun(tiny_csv, tmp_path):
    """`torchrun --nproc-per-node 2 -m ppcseq_tpu_torch ... --mesh genes=2
    --device cpu`: the gene-sharded run gives the unsharded run's calls
    (0, 1, 0), and only rank 0 prints the summary and writes the files."""
    out = tmp_path / "mesh"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "ppcseq_tpu_torch", *_args(tiny_csv, out, "--mesh", "genes=2",
                                                  "--device", "cpu", "--seed", "5", "--json")]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    printed = [line for line in proc.stdout.splitlines() if line.startswith("[{")]
    assert len(printed) == 1, proc.stdout
    summary = pd.read_csv(out / "result.csv")
    assert json.loads(printed[0]) == summary.to_dict("records")
    assert dict(zip(summary.symbol, summary.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    assert len(pd.read_csv(out / "sample_wise_data.csv")) == 3 * 21
