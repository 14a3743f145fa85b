"""The port's NUTS in JAX's fixed-shape form and through its CUDA graphs
(ppcseq_tpu_torch.infer.nuts: _Tree, CapturedTree) on the CPU, with
tests/test_torch_graphs.py's stub standing in for torch.cuda.CUDAGraph.

The device table of checkpoint slot ranges must be JAX's _leaf_to_ckpt;
a lockstep subtree's masked all-slot U-turn test and one-hot checkpoint
write must give JAX's _build_subtree carry for every chain (rtol 1e-10,
as tests/test_torch_nuts.py); the graph path must replay JAX's transition
at that file's tolerances and draw the eager run's numbers bit for bit,
with the same counters and kernel launches; and the cache must keep one
capture across data of equal shapes."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppcseq_tpu.infer import nuts as jnuts
from ppcseq_tpu_torch.infer import graphs, nuts
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.ops import nb_kernel
from test_torch_graphs import _nb_case, _stub
from test_torch_nuts import (_D, _check_against_jax, _jax_logp_grad, _t, _torch_logp,
                             _torch_logp_grad)

torch.set_num_threads(2)


@pytest.fixture
def stub_graphs(monkeypatch):
    """The samplers take their graph path on the CPU, through _StubCapture."""
    _stub(monkeypatch)
    graphs.release()
    graphs.reset_stats()
    yield
    graphs.release()
    graphs.reset_stats()


def test_ckpt_table_is_jax_leaf_to_ckpt():
    """The device table's (lo, hi) of every leaf i < 2^10 equal JAX's
    _leaf_to_ckpt(i); a short table keeps room for a capture's runs."""
    lo, hi = jax.jit(jax.vmap(jnuts._leaf_to_ckpt))(jnp.arange(1024, dtype=jnp.int32))
    got_lo, got_hi = nuts.ckpt_table(10, "cpu")
    assert got_lo.tolist() == np.asarray(lo).tolist()
    assert got_hi.tolist() == np.asarray(hi).tolist()
    assert len(nuts.ckpt_table(0, "cpu")[0]) == graphs.WARMUP_RUNS + 1


_JAX_SUBTREE = jax.jit(jnuts._build_subtree, static_argnums=(0, 9))


@pytest.mark.parametrize("seed", [0, 3])
def test_masked_subtree_is_jax_build_subtree(seed):
    """One lockstep subtree of depth 4 (16 leaves, max_depth 4, so 5
    checkpoint slots) for 32 chains of the 5-D Gaussian, their step sizes
    spread so that they stop at different leaves (U-turns at odd leaves,
    divergences, or all 16 leaves): each chain's carry after the leaves
    equals JAX's _build_subtree of that chain alone, with JAX's leaf
    uniforms. Its leaf count, U-turn and divergence flags exactly; its
    checkpoints (the one-hot writes of every even leaf), end point,
    proposal, weights and accept sum at rtol 1e-10."""
    rng = np.random.default_rng(seed)
    C, depth, max_depth = 32, 4, 4
    z = rng.normal(size=(C, _D))
    eps = np.exp(rng.uniform(np.log(0.05), np.log(2.0), C))
    inv_mass = rng.uniform(0.5, 2.0, (C, _D))
    r0 = rng.normal(size=(C, _D)) / np.sqrt(inv_mass)
    keys = [jax.random.PRNGKey(100 * seed + c) for c in range(C)]

    zt = _t(z)
    lp, g = _torch_logp_grad(zt)
    tree = nuts._Tree(_torch_logp_grad, zt, max_depth)
    tree.start(zt, lp, g, _t(eps), _t(inv_mass), _t(r0), {})  # uniforms: set below
    tree.u["direction"].fill_(0.0)  # go right: the subtree steps by +eps
    tree.steps["begin"]()
    leaf_keys = list(keys)
    for i in range(1 << depth):
        if i > 0 and not bool(tree.sub["live"].any()):
            break
        us = []
        for c in range(C):  # nuts.py:127, per chain
            leaf_keys[c], k_accept = jax.random.split(leaf_keys[c])
            us.append(float(jax.random.uniform(k_accept)))
        tree.u["leaf"].copy_(_t(us))
        tree.steps["odd" if i % 2 else "even"]()
    s = tree.sub

    for c in range(C):
        jlp, jg = _jax_logp_grad(jnp.asarray(z[c]))
        energy0 = jnuts._energy(jlp, jnp.asarray(r0[c]), jnp.asarray(inv_mass[c]))
        want = _JAX_SUBTREE(_jax_logp_grad, jnp.asarray(z[c]), jnp.asarray(r0[c]), jg,
                            jnp.asarray(eps[c]), jnp.asarray(inv_mass[c]), depth, energy0,
                            keys[c], max_depth)
        assert int(s["steps"][c]) == int(want.i), c
        assert bool(s["turning"][c]) == bool(want.turning), c
        assert bool(s["diverging"][c]) == bool(want.diverging), c
        for name, jname in (("r_ckpts", "r_ckpts"), ("r_sum_ckpts", "r_sum_ckpts"), ("z", "z"),
                            ("r", "r"), ("z_prop", "z_prop"), ("r_sum", "r_sum"),
                            ("logp_prop", "logp_prop"), ("log_weight", "log_weight"),
                            ("sum_accept", "sum_accept")):
            np.testing.assert_allclose(s[name][c].numpy(), np.asarray(getattr(want, jname)),
                                       rtol=1e-10, err_msg=f"{name} of chain {c}")
    stops = set(s["steps"].tolist())
    assert len(stops) >= 4 and 16 in stops, stops
    assert 0 < int(s["turning"].sum()) < C and int(s["diverging"].sum()) > 0


@pytest.mark.parametrize("seed,eps", [(0, 0.3), (1, 0.5), (2, 0.1), (3, 0.9), (4, 8.0)],
                         ids=["key0", "key1", "key2-deep", "key3", "key4-diverges"])
def test_nuts_transition_replays_jax_through_graphs(seed, eps, stub_graphs):
    """tests/test_torch_nuts.py::test_nuts_transition_replays_jax through
    the graph path: the transition replays a CapturedTree's stride (stub),
    the device's decisions taken by the host, and z, logp, num_steps,
    depth, diverging and accept_prob equal JAX's _nuts_transition at rtol
    1e-10."""
    rng = np.random.default_rng(10 + seed)
    stats = _check_against_jax(rng.normal(size=(1, _D)), np.array([eps]),
                               rng.uniform(0.5, 2.0, (1, _D)), [seed],
                               tree=lambda z: nuts.CapturedTree(_torch_logp, None, z, 6))
    assert bool(stats["diverging"][0]) == (eps > 5)
    assert graphs.STATS["captures"] == 2 and graphs.STATS["replays"] > 0  # search, stride


def test_lockstep_chains_each_replay_jax_through_graphs(stub_graphs):
    """tests/test_torch_nuts.py::test_lockstep_chains_each_replay_jax
    through a CapturedTree (stub): three chains that stop at three depths
    each equal JAX's transition of that chain alone."""
    rng = np.random.default_rng(20)
    stats = _check_against_jax(rng.normal(size=(3, _D)), np.array([0.12, 0.6, 8.0]),
                               rng.uniform(0.5, 2.0, (3, _D)), [5, 6, 7],
                               tree=lambda z: nuts.CapturedTree(_torch_logp, None, z, 6))
    assert len(set(stats["depth"].tolist())) == 3


def _counting(logp):
    """logp(theta, data) that books one K2 launch per call, as the card's
    density does (on the CPU the kernel's plain version launches nothing)."""

    def counted(theta, data):
        nb_kernel.LAUNCHES["nb_glm_plain"] += 1
        return logp(theta, data)

    return counted


def _nuts_kw(data, dims, dtype, **kw):
    return dict(dict(data=data, num_chains=3, num_warmup=20, num_draws=4, max_depth=4,
                     init_theta=nb_model.smart_init(data, dims), device="cpu", dtype=dtype), **kw)


def _run(logp, dims, kw, seed=3):
    nb_kernel.reset_launches()
    res = nuts.run_nuts(logp, dims.dim, torch.Generator().manual_seed(seed), **kw)
    return res, {k: v for k, v in nb_kernel.LAUNCHES.items() if v}


def _assert_same_run(got, want, transitions):
    """got (through graphs) draws want's (eager) numbers with its counters
    and launches, and reads the host once per transition: at max_depth 4
    a transition's at most 15 leaves fit one stride."""
    (a, a_n), (b, b_n) = got, want
    assert torch.equal(a.draws, b.draws)
    for name in ("accept_prob", "divergences", "step_size", "inv_mass"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for name in ("num_leapfrog", "lockstep_leapfrog", "num_evals", "mean_depth"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.host_syncs == transitions < b.host_syncs
    assert a_n == b_n


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_run_nuts_through_graphs_is_the_eager_run(dtype, monkeypatch):
    """run_nuts on the NB model (S=6, G=10, no baseline, as the pipeline's
    flat_logp(dims) with data=) through the graph path (stub) draws the
    eager run's numbers bit for bit, with the same step sizes, inverse
    masses, leapfrog counts, batched evaluations and kernel launches, and
    one host read per transition where the eager run reads one per leaf and
    doubling; the warmup crosses a metric window. A search replay books the
    launches its capture holds, a stride those of the leaves the device
    counted: one per leaf or search step."""
    data, dims = _nb_case(dtype=dtype)
    data = nb_model.upload(data.host, "cpu", dtype)  # no baseline: K2's route
    logp = _counting(nb_model.flat_logp(dims))
    kw = _nuts_kw(data, dims, dtype)
    eager = _run(logp, dims, kw)
    _stub(monkeypatch)
    graphs.reset_stats()
    got = _run(logp, dims, kw)
    assert graphs.STATS["captures"] == 2
    graphs.release()
    _assert_same_run(got, eager, 24)
    res, launches = got
    assert launches == {"nb_glm_plain": res.num_evals}
    # the search's warm-up and capture and the stride's warm-up of the even
    # and the odd leaf evaluate the density (the stub's capture of the
    # stride, from a state with no chain building, runs no body)
    assert graphs.STATS["build_launches"] == {"nb_glm_plain": 3 * graphs.WARMUP_RUNS + 1}


def test_one_capture_serves_equal_shapes_and_a_new_dim_replaces_it(stub_graphs):
    """Two runs of flat_logp(dims) with other data of the same shapes (a
    baseline from another like_mask) replay one capture, each drawing its
    eager run's numbers; a run at another G (another D) captures anew and
    replaces the entry. Under a layout whose collectives no graph can hold
    (Layout.all_capturable: a gloo mesh's), or inside graphs.disabled(),
    the transition's tree is the eager one."""
    entries = []
    for seed, G in ((0, 10), (1, 10), (2, 12)):
        mask = np.random.default_rng(seed).uniform(size=(6, G)) < 0.2
        data, dims = _nb_case(seed=seed, G=G, exclude=mask)
        logp = nb_model.flat_logp(dims)
        kw = _nuts_kw(data, dims, torch.float64, num_warmup=6, num_draws=3, max_depth=4)
        got = _run(logp, dims, kw)
        entries.append((graphs.STATS["captures"], graphs._CACHE["nuts"][0]))
        with graphs.disabled():
            eager = _run(logp, dims, kw)
        _assert_same_run(got, eager, 9)
    (c0, k0), (c1, k1), (c2, k2) = entries
    assert c0 == c1 == 2 and k0 == k1
    assert c2 == 4 and k2 != k1 and list(graphs._CACHE) == ["nuts"]

    def tree(layout):
        z = torch.zeros((2, _D), dtype=torch.float64)
        return type(nuts._transition_tree(_torch_logp, None, _torch_logp_grad, z, 3, layout,
                                          "cpu"))

    gloo = SimpleNamespace(all_capturable=lambda device: False, gene_collectives=False)
    assert tree(gloo) is nuts._Tree
    with graphs.disabled():
        assert tree(nuts._SINGLE) is nuts._Tree
    assert tree(nuts._SINGLE) is nuts.CapturedTree
