"""Gene and chain sharding of the port (ppcseq_tpu_torch/parallel/sharding.py)
against its unsharded runs and against JAX (tests/test_sharding.py).

- In one process, with no process group: every rank's local log density
  and gradient, summed by hand over the ranks, equal the unsharded ones
  (n = 1-4, float64; n = 3 pads G and splits the checked block), and the
  port's sharded log joint equals JAX's make_log_density(tree=True).
- In a real 4-process gloo group on the CPU, started once for the module: a
  `genes` axis of 2 (the genes rows of a 2 x 2 mesh) and the 2 x 2
  ("chains", "genes") mesh run ADVI, jittered HMC and NUTS in float64,
  which must equal the unsharded runs at the same padding (the parent
  process computes those), keep the replicated coordinates bitwise equal
  across ranks, and make exactly one all-reduce per value+gradient; the
  chains columns of the mesh run ChEES, which must equal its unsharded run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ppcseq_tpu_torch.infer.advi import fit_advi
from ppcseq_tpu_torch.infer.hmc import run_hmc, run_hmc_tree
from ppcseq_tpu_torch.infer.nuts import run_nuts
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.parallel import sharding

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# the sizes of tests/test_sharding.py:21-28, with a third design column
S, G, K = 6, 48, 4


def _cohort(C=2, seed=0, genes=G):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(40.0, size=(S, genes))
    cols = [np.ones(S), rng.integers(0, 2, size=S).astype(float), rng.normal(size=S)]
    exposure = rng.normal(0, 0.2, size=S)
    return counts, np.column_stack(cols[:C]), exposure


def _model(n_check=K, pad_to=None, C=2, non_centered=False, genes=G):
    counts, X, exposure = _cohort(C, genes=genes)
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, pad_genes_to=pad_to,
                                       non_centered=non_centered, device="cpu",
                                       dtype=torch.float64)
    return nb_model.with_baseline(data, dims), dims


def _value_and_grad(f, theta, *args):
    t = theta.detach().clone().requires_grad_(True)
    lp = f(t, *args)
    (g,) = torch.autograd.grad(lp.sum(), t)
    return lp.detach(), g


@pytest.mark.parametrize("n,n_check,likelihood", [
    (1, K, "auto"), (2, K, "auto"), (3, 20, "auto"), (4, K, "auto"),
    (3, 20, "plain"), (2, K, "pallas"), (3, 20, "pallas_fused"), (2, K, "analytic"),
    (3, 20, "fused")],
    ids=["n1", "n2", "n3-pad-span", "n4", "n3-plain", "n2-pallas", "n3-pallas_fused",
         "n2-analytic", "n3-fused"])
def test_local_densities_sum_to_the_unsharded(n, n_check, likelihood):
    """Satellite 1c: sum over r < n of rank r's local lp equals the
    unsharded lp (rtol 1e-12), and the gene gradients of each rank plus the
    replicated gradients summed by hand equal the unsharded gradient
    (rtol 1e-9), at C = 3 on 50 genes. n = 3 pads them to 51 and, with 20
    checked genes over shards of 17, splits the checked block across
    ranks; n = 4 pads to 52."""
    data, dims = _model(n_check, sharding.pad_genes(50, n), C=3, genes=50)
    f = nb_model.flat_logp(dims, likelihood)
    rng = np.random.default_rng(n)
    theta = (torch.as_tensor(nb_model.smart_init(data, dims))[None]
             + 0.05 * torch.as_tensor(rng.normal(size=(3, dims.dim))))
    lp, g = _value_and_grad(f, theta, data)
    lp_sum, g_sum = torch.zeros_like(lp), torch.zeros_like(g)
    for r in range(n):
        shard = sharding.GeneShard(dims, r, n)
        layout = sharding.Layout(genes=shard)
        lp_r, g_r = _value_and_grad(f, layout.local(theta), sharding.shard_data(data, shard),
                                    shard)
        lp_sum += lp_r
        cols = torch.as_tensor(shard.cols)
        g_sum[:, cols] += g_r  # gene columns are each rank's own; replicated ones sum
    np.testing.assert_allclose(lp_sum.numpy(), lp.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_sum.numpy(), g.numpy(), rtol=1e-9, atol=1e-9)


def test_shard_layout_and_data():
    """pad_genes pads shard-even (no 128-lane rule); a shard's columns and
    data are its contiguous gene range."""
    assert sharding.pad_genes(515, 8) == 520 and sharding.pad_genes(48, 4) == 48
    data, dims = _model(20, sharding.pad_genes(50, 3), genes=50)
    shard = sharding.GeneShard(dims, 1, 3)
    assert (shard.g0, shard.g1, shard.checked) == (17, 34, (17, 20))
    assert shard.dim == 6 + 2 * 17 + 20 and len(shard.cols) == shard.dim
    local = sharding.shard_data(data, shard)
    np.testing.assert_array_equal(local.counts.numpy(), data.counts[:, 17:34].numpy())
    np.testing.assert_array_equal(local.host["like_mask"], data.host["like_mask"][:, 17:34])
    np.testing.assert_array_equal(local.d0.numpy(), data.d0[:, 17:34].numpy())
    assert local.X is data.X or torch.equal(local.X, data.X)
    with pytest.raises(ValueError, match="multiple"):
        sharding.GeneShard(dims, 0, 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharding.mesh_axes(object())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_log_joint_matches_jax_tree(n):
    """Satellite 1b, tests/test_sharding.py:35-56 on the port: JAX's
    make_log_density(tree=True) on its smart-init tree, against the sum of
    the port's shards of the same state carried across by utils/convert."""
    import jax
    import jax.numpy as jnp

    from ppcseq_tpu.model import nb_model as jnb
    from ppcseq_tpu_torch.utils import convert

    counts, X, exposure = _cohort()
    jdata, jdims = jnb.prepare_data(counts, X, exposure, K, dtype=jnp.float64)
    jdata = jnb.with_baseline(jdata, jdims)
    tree = jnb.smart_init(jdata, jdims, as_tree=True)
    ld = jnb.make_log_density(jdata, jdims, tree=True)
    want_lp, want_g = jax.value_and_grad(ld)(tree)

    data, dims = convert.model_from_arrays(jdata, jdims)
    theta = convert.theta_from_tree({k: np.asarray(v) for k, v in tree.items()}, dims)
    f = nb_model.flat_logp(dims, "plain")
    total, grads = 0.0, torch.zeros(dims.dim, dtype=torch.float64)
    for r in range(n):
        shard = sharding.GeneShard(dims, r, n)
        local = convert.local_theta(theta, shard)
        lp_r, g_r = _value_and_grad(f, local[None], sharding.shard_data(data, shard), shard)
        total += float(lp_r[0])
        grads[torch.as_tensor(shard.cols)] += g_r[0]
    np.testing.assert_allclose(total, float(want_lp), rtol=1e-12)
    want = convert.theta_from_tree({k: np.asarray(v) for k, v in want_g.items()}, dims)
    np.testing.assert_allclose(grads.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)


# ---- a real 4-process gloo group ---------------------------------------------

_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh

from ppcseq_tpu_torch.infer.advi import fit_advi
from ppcseq_tpu_torch.infer.hmc import run_hmc, run_hmc_tree
from ppcseq_tpu_torch.infer.nuts import run_nuts
from ppcseq_tpu_torch.model import nb_model, params
from ppcseq_tpu_torch.parallel import sharding
sys.path.insert(0, os.path.dirname(out))
import cohort  # noqa: E402  written beside this script by the test

mesh2d = init_device_mesh("cpu", (2, 2), mesh_dim_names=("chains", "genes"))
meshes = {"genes2": mesh2d["genes"], "chains2xgenes2": mesh2d}
data, dims = cohort.model()
logp = nb_model.flat_logp(dims)
init = torch.as_tensor(nb_model.smart_init(data, dims))
result = {}
for name, mesh in meshes.items():
    layout = sharding.Layout.from_mesh(mesh, dims)
    local = sharding.shard_data(data, layout.genes)
    density = lambda t: logp(t, local, layout.genes)
    # exactly one all-reduce per value+gradient, and per value alone
    sharding.reset_collectives()
    th = layout.local(init)[None].clone().requires_grad_(True)
    lp = layout.density(density)(th)
    torch.autograd.grad(lp.sum(), th)
    with_grad = sharding.COLLECTIVES["all_reduce"]
    with torch.no_grad():
        layout.density(density)(th)
    counts = [with_grad, sharding.COLLECTIVES["all_reduce"] - with_grad,
              sharding.COLLECTIVES["logp"]]
    sharding.reset_collectives()
    advi = fit_advi(density, dims.dim, torch.Generator().manual_seed(0), max_iter=50,
                    eval_every=25, init_mean=init, layout=layout, device="cpu",
                    dtype=torch.float64)
    advi_logp = sharding.COLLECTIVES["logp"]
    hmc_kw = dict(data=data, mesh=mesh, dims=dims, num_chains=4, num_warmup=20, num_draws=10,
                  num_leapfrog=4, device="cpu", dtype=torch.float64)
    hmc = run_hmc_tree(logp, dims.dim, torch.Generator().manual_seed(1), init_theta=init,
                       **hmc_kw)
    # the model's tree as the prototype: the chains start at its values
    tree = run_hmc_tree(nb_model.tree_logp(dims), nb_model.smart_init(data, dims, as_tree=True),
                        torch.Generator().manual_seed(1), **hmc_kw)
    nuts = run_nuts(logp, dims.dim, torch.Generator().manual_seed(2), data=data, mesh=mesh,
                    dims=dims, num_chains=2, num_warmup=20, num_draws=5, max_depth=5,
                    init_theta=init, device="cpu", dtype=torch.float64)
    lo, hi = layout.genes.gene_block
    result[name] = dict(
        one_reduce=counts, advi_logp_reduces=advi_logp, advi_iterations=advi.iterations,
        advi_mean=layout.gather(advi.mean[None])[0].tolist(),
        advi_log_sd=layout.gather(advi.log_sd[None])[0].tolist(),
        advi_replicated=[advi.mean[:lo].tolist() + advi.mean[hi:].tolist(),
                         advi.log_sd[:lo].tolist() + advi.log_sd[hi:].tolist()],
        hmc_draws=layout.gather(hmc.draws).tolist(), hmc_step=hmc.step_size,
        hmc_accept=hmc.accept_prob.tolist(), hmc_genes=list(hmc.genes),
        hmc_chains=list(hmc.chains),
        tree_is_flat=torch.equal(params.tree_to_theta(tree.draws, layout.genes.local_dims),
                                 hmc.draws),
        tree_shapes=sorted((k, list(v.shape)) for k, v in tree.draws.items()),
        hmc_replicated=torch.cat([hmc.draws[..., :lo], hmc.draws[..., hi:]], -1).tolist(),
        nuts_draws=layout.gather(nuts.draws).tolist(), nuts_step=nuts.step_size.tolist(),
        nuts_replicated=torch.cat([nuts.draws[..., :lo], nuts.draws[..., hi:]], -1).tolist(),
        nuts_leapfrog=nuts.num_leapfrog, nuts_syncs=nuts.host_syncs,
        genes_rank=layout.genes.rank, chains_rank=layout.chains_rank)
# ChEES over the chains axis alone (each rank holds every gene)
chains = sharding.Layout.from_mesh(mesh2d["chains"])
sharding.reset_collectives()
chees = run_hmc(logp, dims.dim, torch.Generator().manual_seed(3), data=data,
                mesh=mesh2d["chains"], num_chains=4, num_warmup=20, num_draws=10,
                num_leapfrog=8, adapt_trajectory=True, init_theta=init, device="cpu",
                dtype=torch.float64)
result["chees"] = dict(
    chain_reduces=sharding.COLLECTIVES["chains"], draws=chains.gather(chees.draws).tolist(),
    step=chees.step_size, T=chees.trajectory_length, accept=chees.accept_prob.tolist(),
    leapfrog=chees.num_leapfrog, chains=list(chees.chains), chains_rank=chains.chains_rank)
with open(out, "w") as f:
    json.dump(result, f)
dist.destroy_process_group()
'''

_COHORT = f'''
import numpy as np, torch
from ppcseq_tpu_torch.model import nb_model

def model():
    rng = np.random.default_rng(0)
    S, G = {S}, {G - 1}
    counts = rng.poisson(40.0, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    exposure = rng.normal(0, 0.2, size=S)
    data, dims = nb_model.prepare_data(counts, X, exposure, {K}, pad_genes_to={G},
                                       device="cpu", dtype=torch.float64)
    return nb_model.with_baseline(data, dims), dims
'''


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4 ranks' results, and the unsharded model (47 real genes padded
    to 48, so the genes axis of 2 splits it evenly)."""
    tmp = tmp_path_factory.mktemp("gloo4")
    (tmp / "worker.py").write_text(_WORKER)
    (tmp / "cohort.py").write_text(_COHORT)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    outs = [tmp / f"rank{r}.json" for r in range(4)]
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), "4",
                               str(tmp / "store"), str(outs[r])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    import json

    sys.path.insert(0, str(tmp))
    try:
        import cohort
    finally:
        sys.path.remove(str(tmp))
    data, dims = cohort.model()
    return [json.loads(o.read_text()) for o in outs], data, dims


@pytest.fixture(scope="module")
def unsharded(group):
    """The same fits on the whole state in this process."""
    _, data, dims = group
    logp = nb_model.flat_logp(dims)
    init = torch.as_tensor(nb_model.smart_init(data, dims))
    advi = fit_advi(lambda t: logp(t, data), dims.dim, torch.Generator().manual_seed(0),
                    max_iter=50, eval_every=25, init_mean=init, device="cpu",
                    dtype=torch.float64)
    hmc = run_hmc_tree(logp, dims.dim, torch.Generator().manual_seed(1), data=data, dims=dims,
                       num_chains=4, num_warmup=20, num_draws=10, num_leapfrog=4,
                       init_theta=init, device="cpu", dtype=torch.float64)
    nuts = run_nuts(logp, dims.dim, torch.Generator().manual_seed(2),
                    data=data, num_chains=2, num_warmup=20, num_draws=5, max_depth=5,
                    init_theta=init, device="cpu", dtype=torch.float64)
    return advi, hmc, nuts


@pytest.fixture(scope="module")
def unsharded_chees(group):
    _, data, dims = group
    init = torch.as_tensor(nb_model.smart_init(data, dims))
    return run_hmc(nb_model.flat_logp(dims), dims.dim, torch.Generator().manual_seed(3),
                   data=data, num_chains=4, num_warmup=20, num_draws=10, num_leapfrog=8,
                   adapt_trajectory=True, init_theta=init, device="cpu", dtype=torch.float64)


def _close(got, want):
    """rtol 1e-8 of the array's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


@pytest.mark.parametrize("mesh", ["genes2", "chains2xgenes2"])
def test_sharded_fits_equal_unsharded(group, unsharded, mesh):
    """Satellite 1d: ADVI (50 steps), jittered HMC (20 warmup + 10 draws)
    and NUTS (20 warmup + 5 draws) in float64 on a genes axis of 2 and on
    the 2 x 2 mesh equal the unsharded runs at rtol 1e-8 on every rank.
    The sharded log density differs from the unsharded one by the order of
    its float64 sums, a few ulps. HMC runs L = 4 leapfrogs: at L = 8 this
    warmup's dual averaging amplifies a 1-ulp change of the unsharded run's
    own log density to 6e-9 in its draws and 7e-9 in its step size."""
    advi, hmc, nuts = unsharded
    close = _close
    for res in (r[mesh] for r in group[0]):
        assert res["advi_iterations"] == advi.iterations
        close(res["advi_mean"], advi.mean.numpy())
        close(res["advi_log_sd"], advi.log_sd.numpy())
        close(res["hmc_draws"], hmc.draws.numpy())
        close(res["hmc_step"], hmc.step_size)
        close(res["hmc_accept"], hmc.accept_prob)
        close(res["nuts_draws"], nuts.draws.numpy())
        close(res["nuts_step"], nuts.step_size)
        assert res["nuts_leapfrog"] == nuts.num_leapfrog
        assert res["nuts_syncs"] == nuts.host_syncs


def test_replicated_coordinates_are_bitwise_equal_across_ranks(group):
    """Satellite 1e: the scalars and the checked-gene blocks of the ADVI
    state and of every HMC and NUTS draw are the same bits on the ranks
    that share a chain slice."""
    for mesh in ("genes2", "chains2xgenes2"):
        by_chains = {}
        for res in (r[mesh] for r in group[0]):
            by_chains.setdefault(tuple(res["hmc_chains"]), []).append(res)
        for ranks in by_chains.values():
            assert len(ranks) >= 2 and len({r["genes_rank"] for r in ranks}) == 2
            for other in ranks[1:]:
                for key in ("advi_replicated", "hmc_replicated", "nuts_replicated"):
                    assert other[key] == ranks[0][key], (mesh, key)


def test_one_all_reduce_per_value_and_gradient(group):
    """Satellite 1f: a value+gradient evaluation makes one all-reduce, a
    value alone one; ADVI's 50 steps and 2 ELBOs make 52 log-density
    all-reduces; and the rank's draws carry its gene and chain range."""
    for r, res in enumerate(group[0]):
        for mesh, expect_chains in (("genes2", [0, 4]), ("chains2xgenes2", None)):
            got = res[mesh]
            assert got["one_reduce"] == [1, 1, 2], (r, mesh)
            assert got["advi_logp_reduces"] == 52
            g0 = 24 * got["genes_rank"]
            assert got["hmc_genes"] == [g0, g0 + 24]
            c0 = 2 * got["chains_rank"]
            assert got["hmc_chains"] == (expect_chains or [c0, c0 + 2])


def test_model_tree_state_under_a_genes_mesh(group):
    """run_hmc_tree over the model's tree (smart_init(as_tree=True), with
    dims=) enters through tree_to_theta: on every rank its draws are the
    flat run's bits, handed back as the rank's local tree (24 of 48 genes,
    leading [its chains, 10 draws])."""
    for r, res in enumerate(group[0]):
        for mesh, chains in (("genes2", 4), ("chains2xgenes2", 2)):
            got = res[mesh]
            assert got["tree_is_flat"], (r, mesh)
            shapes = dict((k, v) for k, v in got["tree_shapes"])
            assert shapes["intercept"] == shapes["sigma_raw"] == [chains, 10, 24]
            assert shapes["alpha_sub_1"] == [chains, 10, K] and shapes["lambda_mu"] == [chains, 10]


def test_chain_sharded_chees_equals_unsharded(group, unsharded_chees):
    """ChEES over a `chains` axis of 2 (20 warmup + 10 draws at cap 8,
    float64): every cross-chain statistic of the warmup (the whitened chain
    means, Oja's covariance product, the criterion's weighted sums, the mean
    accept) is the global batch's, in three all-reduces per warmup draw, so
    the run equals the unsharded one at rtol 1e-8, and both chain ranks
    adapt the same bits of step size and trajectory length."""
    want = unsharded_chees
    runs = [r["chees"] for r in group[0]]
    for res in runs:
        assert res["chain_reduces"] == 3 * 20
        _close(res["draws"], want.draws.numpy())
        _close(res["step"], want.step_size)
        _close(res["T"], want.trajectory_length)
        _close(res["accept"], want.accept_prob)
        assert res["leapfrog"] == want.num_leapfrog
        assert res["chains"] == [2 * res["chains_rank"], 2 * res["chains_rank"] + 2]
    assert len({(r["step"], r["T"]) for r in runs}) == 1
