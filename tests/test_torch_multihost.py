"""Process-group start-up of the port (ppcseq_tpu_torch/parallel/multihost.py)
in two CPU processes started as torchrun starts them (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT), after
tests/test_multihost.py:196-224: initialize() twice, the default
pod_mesh() and gene_mesh(), and a gene-sharded identify_outliers over
pod_mesh(chains_axis=1) that gives the reference's (0, 1, 0)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r'''
import json, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.parallel import multihost

multihost.initialize("cpu")
multihost.initialize("cpu")  # already up: a no-op
pod = multihost.pod_mesh(device="cpu")  # chains = the ranks per host
genes = multihost.gene_mesh(device="cpu")
fit_mesh = multihost.pod_mesh(chains_axis=1, device="cpu")
counts = load_counts()
sig = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
res = identify_outliers(sig, formula="~ Label", sample="sample", transcript="symbol",
                        abundance="value", significance="PValue", do_check="is_significant",
                        percent_false_positive_genes=1, how_many_negative_controls=50, seed=42,
                        mesh=fit_mesh, pass_fit=True, device="cpu")
out = dict(rank=dist.get_rank(), world=dist.get_world_size(), backend=str(dist.get_backend()),
           pod=[list(pod.mesh_dim_names), list(pod.shape)],
           genes=[list(genes.mesh_dim_names), list(genes.shape)],
           fit=[list(fit_mesh.mesh_dim_names), list(fit_mesh.shape)],
           calls=dict(zip(res.symbol, map(int, res.tot_deleterious_outliers))),
           local_dim=int(res.attrs["fit 2"].mean.shape[0]))
print("MULTIHOST " + json.dumps(out), flush=True)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        line = next(x for x in out.splitlines() if x.startswith("MULTIHOST "))
        results.append(json.loads(line[len("MULTIHOST "):]))
    return results


def test_initialize_and_meshes(ranks):
    """initialize() brings up a gloo group of the world torchrun describes;
    pod_mesh() puts the ranks per host on `chains`, gene_mesh() every rank
    on `genes`."""
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["world"] == 2 and "gloo" in r["backend"]
        assert r["pod"] == [["chains", "genes"], [2, 1]]
        assert r["genes"] == [["genes"], [2]]
        assert r["fit"] == [["chains", "genes"], [1, 2]]


def test_two_process_distributed_fit(ranks):
    """The gene-sharded fit across the two processes gives (0, 1, 0) on
    both, each holding half of the 54 (53 padded) genes."""
    for r in ranks:
        assert r["calls"] == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
        assert r["local_dim"] == 6 + 2 * 27 + 3


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    """Like every entry point of the port, the process group and the meshes
    default to the card, and without one they raise: nothing silently
    builds a CPU group or mesh."""
    import torch

    from ppcseq_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (multihost.initialize, lambda: multihost.gene_mesh(1),
                  lambda: multihost.pod_mesh(1)):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
