"""The samplers' CUDA-graph routes under a mesh (ppcseq_tpu_torch.infer:
advi.CapturedFit, hmc.CapturedTrajectory and nuts.CapturedTree over a
parallel/sharding.Layout) on the CPU, with tests/test_torch_graphs.py's
stub standing in for torch.cuda.CUDAGraph.

A one-rank gloo process group stands in for an NCCL one: where a test
patches `Layout.capturable` and `Layout.all_capturable` to True, the
samplers take their graph route over it, the stub's replay running the
all-reduces again eagerly and taking back the counts they make, as a
graph's replay books what its capture holds. Each route must then draw
its graphs.disabled() run's numbers bit for bit, with equal kernel
launches and equal all-reduces by kind (sharding.COLLECTIVES, the host
seconds apart, and NUTS's idle all-reduces, which only a graph makes,
apart too), and capture only on the graph side. Without the patch a gloo
mesh keeps the eager route."""

import contextlib
import functools
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ppcseq_tpu_torch.infer import graphs, hmc, nuts
from ppcseq_tpu_torch.infer.advi import fit_advi
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.ops import nb_kernel
from ppcseq_tpu_torch.parallel import sharding
from test_torch_graphs import _fit_kw, _nb_case, _same_fit, _stub

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def gloo_world(tmp_path_factory):
    """A world of one process over gloo for the module's meshes."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _mesh(*names):
    return init_device_mesh("cpu", (1,) * len(names), mesh_dim_names=names)


_CAPTURABLE = sharding.Layout.capturable, sharding.Layout.all_capturable


@pytest.fixture
def capturable(monkeypatch):
    """The graph route on the CPU over the gloo meshes: the stub for the
    CUDA graph, and every layout capturable."""
    _stub(monkeypatch)
    monkeypatch.setattr(sharding.Layout, "capturable", lambda self, device: True)
    monkeypatch.setattr(sharding.Layout, "all_capturable", lambda self, device: True)
    graphs.release()
    graphs.reset_stats()
    yield
    graphs.release()
    graphs.reset_stats()


def _counting(logp, kernel="nb_glm_delta"):
    """flat_logp(dims)'s f(theta, data, shard) booking one launch of
    `kernel` per call, as the card's density does (on the CPU the kernel's
    plain version launches nothing)."""

    def counted(theta, data, shard=None):
        nb_kernel.LAUNCHES[kernel] += 1
        return logp(theta, data, shard)

    return counted


def _both(run):
    """run() through the graph route and inside graphs.disabled(): each
    path's (result, kernel launches, all-reduces by kind, captures,
    replays). Returns the graph route's result and the eager one's, the
    graph route's all-reduces by kind (its idle ones too) and launches, and
    its replays."""
    out = {}
    for path in ("graphs", "eager"):
        nb_kernel.reset_launches()
        sharding.reset_collectives()
        graphs.reset_stats()
        with graphs.disabled() if path == "eager" else contextlib.nullcontext():
            res = run()
        out[path] = (res, {k: v for k, v in nb_kernel.LAUNCHES.items() if v},
                     {k: v for k, v in sharding.COLLECTIVES.items() if v and k != "seconds"},
                     graphs.STATS["captures"], graphs.STATS["replays"])
        graphs.release()
    nb_kernel.reset_launches()
    sharding.reset_collectives()
    (_, launches, collectives, captures, replays), (_, e_launches, e_collectives, e_captures,
                                                     _) = out["graphs"], out["eager"]
    assert launches == e_launches and launches
    working, e_idle = sharding.split_idle(collectives)[0], sharding.split_idle(e_collectives)[1]
    assert working == e_collectives and not e_idle
    assert e_captures == 0 < captures
    return out["graphs"][0], out["eager"][0], collectives, launches, replays


def test_a_region_books_the_all_reduces_its_capture_holds(capturable):
    """A Region whose function all-reduces once: the warm-up's and the
    capture's all-reduces go to STATS["build_collectives"], COLLECTIVES is
    as before, and each replay books one all-reduce of its kind and bytes."""
    group = _mesh("genes").get_group()
    buf = torch.ones(3, dtype=torch.float64)
    sharding.reset_collectives()
    region = graphs.Region(lambda: sharding.all_reduce(buf, group, "sums"), "cpu", "test")
    one = {"all_reduce": 1, "bytes": 24, "sums": 1, "sums_bytes": 24}
    assert region.collectives == one
    assert graphs.STATS["build_collectives"] == {k: v * (graphs.WARMUP_RUNS + 1)
                                                 for k, v in one.items()}
    assert sharding.COLLECTIVES["all_reduce"] == 0
    region.replay(3)
    assert {k: sharding.COLLECTIVES[k] for k in one} == {k: 3 * v for k, v in one.items()}
    sharding.reset_collectives()


def test_gene_sharded_advi_through_graphs_is_the_eager_fit(capturable):
    """fit_advi over a genes axis through CapturedFit (its value-and-gradient
    and ELBO all-reduces inside the step and ELBO graphs) gives the eager
    sharded fit's mean, log_sd and ELBO trace bit for bit, one "logp"
    all-reduce per evaluation either way."""
    data, dims = _nb_case()
    layout = sharding.Layout.from_mesh(_mesh("genes"), dims)
    local = sharding.shard_data(data, layout.genes)
    f = functools.partial(_counting(nb_model.flat_logp(dims)), shard=layout.genes)
    kw = dict(_fit_kw(data, dims), data=local, layout=layout)
    got, eager, collectives, launches, _ = _both(
        lambda: fit_advi(f, dims.dim, torch.Generator().manual_seed(4), **kw))
    assert _same_fit(got, eager)
    assert collectives["logp"] == launches["nb_glm_delta"] == collectives["all_reduce"]


@pytest.mark.parametrize("axes,chees", [(("genes",), False), (("chains", "genes"), False),
                                        (("chains",), True)],
                         ids=["genes", "chains-genes", "chees-chains"])
def test_hmc_over_a_mesh_through_graphs_is_the_eager_run(axes, chees, capturable):
    """run_hmc over a genes axis and a 2-D mesh replays the captured
    leapfrog with its all-reduce inside, the energy sums and chain
    statistics staying eager; ChEES, which refuses a genes axis as JAX's
    runner does, over a chains axis. Draws, step size, accept
    probabilities, launches and all-reduces equal the eager run's."""
    data, dims = _nb_case(dtype=torch.float32)
    kw = dict(data=data, dims=dims, mesh=_mesh(*axes), num_chains=4, num_warmup=6, num_draws=4,
              num_leapfrog=6, init_theta=nb_model.smart_init(data, dims),
              adapt_trajectory=chees, device="cpu")
    f = _counting(nb_model.flat_logp(dims))
    got, eager, collectives, launches, _ = _both(
        lambda: hmc.run_hmc(f, dims.dim, torch.Generator().manual_seed(5), **kw))
    assert torch.equal(got.draws, eager.draws)
    assert got.step_size == eager.step_size and got.num_leapfrog == eager.num_leapfrog
    assert np.array_equal(got.accept_prob, eager.accept_prob)
    if "genes" in axes:  # one per evaluation: the leapfrogs' and the first gradient's
        assert collectives["logp"] == launches["nb_glm_delta"] == got.num_leapfrog // 4 + 1
    else:
        assert "logp" not in collectives and collectives["chains"] > 0


@pytest.mark.parametrize("axes", [("chains",), ("genes",), ("chains", "genes")],
                         ids=["chains", "genes", "chains-genes"])
def test_nuts_over_a_mesh_through_strides_is_the_eager_run(axes, capturable, monkeypatch):
    """Under a mesh whose groups a graph can hold, the transition's tree is
    the device-decided CapturedTree (its mesh step: the chain counts'
    all-reduce at each step's start, the genes all-reduces between the
    conditional parts of the leaf and the end). A short run_nuts through
    strides of 1, 3 and 16 tree steps draws its graphs.disabled() run's
    draws, step sizes and inverse masses bit for bit, with equal K1
    launches and equal all-reduces by kind (one "logp" per K1 launch under
    a genes axis), reads the host once per stride replayed (the replays
    but the search's eight), and books idle all-reduces only through
    graphs; graphs.release() frees the tree. Without the patch the gloo
    mesh keeps the host-decided tree."""
    data, dims = _nb_case()
    mesh = _mesh(*axes)
    layout = sharding.Layout.from_mesh(mesh, dims if "genes" in axes else None)
    z = torch.zeros((2, layout.genes.dim if layout.genes else dims.dim), dtype=torch.float64)
    logp = _counting(nb_model.flat_logp(dims))
    tree = nuts._transition_tree(logp, data, None, z, 3, layout, "cpu")
    assert type(tree) is nuts.CapturedTree
    # release() frees the entry, its reference cycles too: no graph that
    # holds an all-reduce may outlive the process group's destruction
    tree = weakref.ref(tree)
    graphs.release()
    assert tree() is None
    kw = dict(data=data, dims=dims, mesh=mesh, num_chains=2, num_warmup=3, num_draws=2,
              max_depth=4, init_theta=nb_model.smart_init(data, dims), device="cpu",
              dtype=torch.float64)
    for stride in (1, 3, 16):
        monkeypatch.setattr(nuts, "STRIDE", stride)
        got, eager, collectives, launches, replays = _both(
            lambda: nuts.run_nuts(logp, dims.dim, torch.Generator().manual_seed(3), **kw))
        assert torch.equal(got.draws, eager.draws), stride
        assert np.array_equal(got.step_size, eager.step_size)
        assert np.array_equal(got.inv_mass, eager.inv_mass)
        assert np.array_equal(got.accept_prob, eager.accept_prob)
        assert got.num_evals == eager.num_evals == launches["nb_glm_delta"]
        assert got.host_syncs == replays - 8
        assert stride < 16 or 2 * got.host_syncs < eager.host_syncs
        idle = set(sharding.split_idle(collectives)[1])
        assert idle == ({"chains_idle", "chains_idle_bytes"} if "chains" in axes else set()) | (
            {"logp_idle", "logp_idle_bytes", "sums_idle", "sums_idle_bytes"}
            if "genes" in axes else set())
        if "genes" in axes:
            assert collectives["logp"] == launches["nb_glm_delta"]
    for name, predicate in zip(("capturable", "all_capturable"), _CAPTURABLE):
        monkeypatch.setattr(sharding.Layout, name, predicate)
    assert not layout.all_capturable("cpu")
    assert type(nuts._transition_tree(logp, data, None, z, 3, layout, "cpu")) is nuts._Tree


def test_an_all_reduce_inside_a_conditional_body_raises(capturable):
    """sharding.all_reduce refuses to be captured inside a graphs.when
    body (NCCL refuses it there over two ranks or more), naming the body;
    at a region's top level, and in a body run eagerly, it reduces."""
    group = _mesh("genes").get_group()
    buf = torch.ones(2, dtype=torch.float64)

    def body():
        sharding.all_reduce(buf, group, "sums")

    with pytest.raises(RuntimeError, match="inside a conditional body of the test region"):
        graphs.Region(lambda: graphs.when(torch.tensor(True), body), "cpu", "test region")
    graphs.Region(body, "cpu", "top level").replay()
    sharding.reset_collectives()
    graphs.when(torch.tensor(True), body)
    assert sharding.COLLECTIVES["sums"] == 1
    sharding.reset_collectives()


def test_three_gene_vb_over_a_mesh_through_graphs(capturable):
    """The reference's 3-gene case (tests/test_pipeline.py:37-75) on the VB
    branch over a genes axis, through the graph route: (0, 1, 0)."""
    from ppcseq_tpu_torch import identify_outliers, load_counts

    counts = load_counts()
    counts = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    res = identify_outliers(counts, formula="~ Label", sample="sample", transcript="symbol",
                            abundance="value", significance="PValue", do_check="is_significant",
                            percent_false_positive_genes=1, how_many_negative_controls=50,
                            seed=42, mesh=_mesh("genes"), device="cpu")
    assert graphs.STATS["captures"] > 0
    assert dict(zip(res.symbol, res.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}


def test_a_gloo_mesh_keeps_the_eager_route(monkeypatch):
    """Layout.capturable is false on the CPU and over gloo where the layout
    has a genes group, true where it has none (the chain collectives run
    between the steps); with the stub in place but the predicate as it is,
    every sampler over a gloo genes axis runs eagerly: no capture."""
    data, dims = _nb_case()
    genes = sharding.Layout.from_mesh(_mesh("genes"), dims)
    chains = sharding.Layout.from_mesh(_mesh("chains"))
    assert not genes.capturable("cpu") and not genes.all_capturable("cpu")
    assert chains.capturable("cpu") and sharding.Layout().capturable("cpu")
    assert not chains.all_capturable("cpu") and sharding.Layout().all_capturable("cpu")
    _stub(monkeypatch)
    graphs.release()
    graphs.reset_stats()
    f = nb_model.flat_logp(dims)
    common = dict(data=data, dims=dims, mesh=_mesh("genes"), num_chains=2,
                  init_theta=nb_model.smart_init(data, dims), device="cpu",
                  dtype=torch.float64)
    fit_advi(functools.partial(f, shard=genes.genes), dims.dim, torch.Generator().manual_seed(1),
             **dict(_fit_kw(data, dims), max_iter=20, layout=genes))
    hmc.run_hmc(f, dims.dim, torch.Generator().manual_seed(1), num_warmup=2, num_draws=2,
                num_leapfrog=3, **common)
    nuts.run_nuts(f, dims.dim, torch.Generator().manual_seed(1), num_warmup=2, num_draws=2,
                  max_depth=3, **common)
    assert graphs.STATS["captures"] == 0 and graphs._CACHE == {}
