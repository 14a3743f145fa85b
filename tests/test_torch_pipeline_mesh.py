"""`identify_outliers(mesh=...)` on the port: tests/test_pipeline_mesh.py's
five cases on gloo CPU ranks. One 4-process group, started once for the
module, runs them as a 2 x 2 ("chains", "genes") mesh and its rows and
columns (every rank calls with the same arguments, as the JAX package's
processes do):
- the genes pairs (ranks 0+1 and 2+3): gene-sharded VB on the 3-gene case;
- the chains pairs: ranks 0+2 chain-sharded HMC, ranks 1+3 VB on a chains
  axis (which warns), then chain-sharded ChEES;
- all four: a mesh axis of an unknown name, then the 2-D mesh through the
  MCMC branch on a synthetic cohort.
The reference's bar (tests/testthat/test-ppcSeq.R:26-30) is
tot_deleterious_outliers == (0, 1, 0) on (SLC16A12, CYP1A1, ART3).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REFERENCE = {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}

_WORKER = r'''
import json, sys, warnings
import torch
import torch.distributed as dist

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh

from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.utils.synthetic import synthetic_tidy

mesh2d = init_device_mesh("cpu", (2, 2), mesh_dim_names=("chains", "genes"))
replicas = init_device_mesh("cpu", (4,), mesh_dim_names=("replicas",))
genes_rank = mesh2d.get_local_rank("genes")
counts = load_counts()
sig = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
common = dict(formula="~ Label", sample="sample", transcript="symbol", abundance="value",
              significance="PValue", do_check="is_significant",
              percent_false_positive_genes=1, how_many_negative_controls=50, seed=42,
              device="cpu")
result = {}


def calls(res):
    return dict(zip(res.symbol, map(int, res.tot_deleterious_outliers)))


def table(res):
    return [swd[[".lower", ".upper", "posterior_predictive_check_succeded"]].to_json()
            for swd in res.sample_wise_data]


try:
    identify_outliers(sig, mesh=replicas, **common)
    result["unknown_axis"] = "no error"
except ValueError as e:
    result["unknown_axis"] = str(e)

res = identify_outliers(sig, mesh=mesh2d["genes"], approximate_posterior_inference=True,
                        pass_fit=True, **common)
result["genes_vb"] = dict(calls=calls(res), table=table(res),
                          mesh=res.attrs["fit 2"].mean.shape[0])

if genes_rank == 0:
    res = identify_outliers(sig, mesh=mesh2d["chains"], approximate_posterior_inference=False,
                            mcmc_sampler="hmc", pass_fit=True, **common)
    fit2 = res.attrs["fit 2"]
    result["chains_hmc"] = dict(calls=calls(res), ndim=fit2.draws.dim(),
                                shape=list(fit2.draws.shape), chains=list(fit2.chains),
                                table=table(res))
else:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = identify_outliers(sig, mesh=mesh2d["chains"], approximate_posterior_inference=True,
                                **common)
    result["chains_vb"] = dict(calls=calls(res),
                               warnings=[str(w.message) for w in caught
                                         if issubclass(w.category, UserWarning)])
    res = identify_outliers(sig, mesh=mesh2d["chains"], approximate_posterior_inference=False,
                            mcmc_sampler="hmc", hmc_adapt_trajectory=True, pass_fit=True,
                            **common)
    fit2 = res.attrs["fit 2"]
    result["chains_chees"] = dict(calls=calls(res), chains=list(fit2.chains),
                                  T=fit2.trajectory_length, step=fit2.step_size,
                                  table=table(res))

df = synthetic_tidy(n_genes=64, n_samples=8, n_check=3, seed=0)
res = identify_outliers(df, formula="~ Label", how_many_negative_controls=40,
                        approximate_posterior_inference=False, mcmc_sampler="hmc", seed=42,
                        mesh=mesh2d, pass_fit=True, device="cpu")
fit2 = res.attrs["fit 2"]
result["mesh2d_hmc"] = dict(rows=len(res), calls=[int(c) for c in res.tot_deleterious_outliers],
                            genes=list(fit2.genes), chains=list(fit2.chains),
                            shape=list(fit2.draws.shape), table=table(res),
                            finite=bool(torch.isfinite(fit2.draws).all()),
                            genes_rank=genes_rank, chains_rank=mesh2d.get_local_rank("chains"))
with open(out, "w") as f:
    json.dump(result, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh4")
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    outs = [tmp / f"rank{r}.json" for r in range(4)]
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r),
                               str(tmp / "store"), str(outs[r])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [json.loads(o.read_text()) for o in outs]


def test_gene_sharded_vb_pipeline(ranks):
    """VB with the model data and the per-gene parameters split over a
    2-rank `genes` axis (53 genes padded to 54): (0, 1, 0), and every rank
    returns the same table; pass 2's fit holds the rank's 27 genes."""
    for res in ranks:
        assert res["genes_vb"]["calls"] == REFERENCE
        assert res["genes_vb"]["mesh"] == 6 + 2 * 27 + 3
    assert all(r["genes_vb"]["table"] == ranks[0]["genes_vb"]["table"] for r in ranks)


def test_chain_sharded_hmc_pipeline(ranks):
    """Jittered HMC with its 128 chains split over a 2-rank `chains` axis:
    (0, 1, 0); pass 2's draws are 3-D, 64 chains per rank, and both ranks
    return the same table."""
    hmc = [r["chains_hmc"] for r in ranks if "chains_hmc" in r]
    assert len(hmc) == 2
    for res in hmc:
        assert res["calls"] == REFERENCE and res["ndim"] == 3 and res["shape"][0] == 64
    assert sorted(tuple(r["chains"]) for r in hmc) == [(0, 64), (64, 128)]
    assert hmc[0]["table"] == hmc[1]["table"]


def test_mesh_unknown_axis_rejected(ranks):
    for res in ranks:
        assert "genes" in res["unknown_axis"] and "chains" in res["unknown_axis"]


def test_gene_sharded_hmc_pipeline_synthetic(ranks):
    """The 2-D mesh through the MCMC branch (gene-sharded ADVI warm start ->
    run_hmc on the local state -> gathered extraction and PPC): 3 rows,
    each rank's draws hold its own chains and its own gene slice (3 checked
    + 40 controls = 43 genes, padded to 44), and every rank returns the
    same table."""
    for res in (r["mesh2d_hmc"] for r in ranks):
        assert res["rows"] == 3 and all(c >= 0 for c in res["calls"]) and res["finite"]
        g0 = 22 * res["genes_rank"]
        assert res["genes"] == [g0, g0 + 22]
        assert res["chains"] == [64 * res["chains_rank"], 64 * res["chains_rank"] + 64]
        assert res["shape"][0] == 64 and res["shape"][2] == 6 + 2 * 22 + 3
    assert all(r["mesh2d_hmc"]["table"] == ranks[0]["mesh2d_hmc"]["table"] for r in ranks)


def test_chains_mesh_with_vb_warns(ranks):
    """A chains-only mesh cannot shard the variational fit: the pipeline
    says so, and still gives (0, 1, 0)."""
    vb = [r["chains_vb"] for r in ranks if "chains_vb" in r]
    assert len(vb) == 2
    for res in vb:
        assert res["calls"] == REFERENCE
        assert any("chains" in w and "variational" in w for w in res["warnings"])


def test_chain_sharded_chees_pipeline(ranks):
    """ChEES with its 128 chains split over a 2-rank `chains` axis, the
    warmup's cross-chain statistics all-reduced: (0, 1, 0); both ranks adapt
    the same step size and trajectory length and return the same table."""
    chees = [r["chains_chees"] for r in ranks if "chains_chees" in r]
    assert len(chees) == 2
    for res in chees:
        assert res["calls"] == REFERENCE and res["T"] > 0
    assert sorted(tuple(r["chains"]) for r in chees) == [(0, 64), (64, 128)]
    assert (chees[0]["T"], chees[0]["step"]) == (chees[1]["T"], chees[1]["step"])
    assert chees[0]["table"] == chees[1]["table"]
