"""The port's device-decided NUTS transition (ppcseq_tpu_torch.infer.nuts:
CapturedTree's stride of tree steps, each step's begin, leaf and end a
conditional body, infer/graphs.when) on the CPU, with
tests/test_torch_graphs.py's stub standing in for torch.cuda.CUDAGraph:
its replay runs the stride again, and graphs.when reads each step's flag
on the host where the card's conditional nodes read it on the device.

A transition through strides must be the host-decided transition bit for
bit (draws, statistics, counters, kernel launches) at every stride, read
the host at most once per stride and transition, replay JAX's transition
at rtol 1e-10 when a stride ends inside a subtree, and change nothing
once it is done."""

import math

import numpy as np
import pytest
import torch

from ppcseq_tpu_torch.infer import graphs, nuts
from ppcseq_tpu_torch.infer.hmc import GeneratorDraws, logp_and_grad
from ppcseq_tpu_torch.ops import nb_kernel
from test_torch_graphs import _stub
from test_torch_nuts import _D, _check_against_jax, _t, _torch_logp

torch.set_num_threads(2)


@pytest.fixture
def stub_graphs(monkeypatch):
    _stub(monkeypatch)
    graphs.release()
    graphs.reset_stats()
    yield
    graphs.release()
    graphs.reset_stats()


def _counted(x):
    """_torch_logp booking one K2 launch per call, as the card's density
    does (on the CPU a kernel's plain version launches nothing)."""
    nb_kernel.LAUNCHES["nb_glm_plain"] += 1
    return _torch_logp(x)


# 4 chains of the 5-D Gaussian: three stop at three depths, one diverges
_EPS = np.array([0.05, 0.3, 0.9, 8.0])


def _chains():
    rng = np.random.default_rng(30)
    return _t(rng.normal(size=(4, _D))), _t(_EPS), _t(rng.uniform(0.5, 2.0, (4, _D)))


def _transition(tree_of, seed=4, max_depth=6):
    """One lockstep transition of _chains() from a seeded generator through
    tree_of(z) (None: the eager host-decided _Tree); (z, logp, grad, stats,
    counters, launches)."""
    z, eps, inv_mass = _chains()
    grad_fn = lambda x: logp_and_grad(_counted, x)  # noqa: E731
    lp, g = grad_fn(z)
    counters = nuts._Counters()
    tree = None if tree_of is None else tree_of(z)
    draws = GeneratorDraws(torch.Generator().manual_seed(seed), "cpu", torch.float64)
    nb_kernel.reset_launches()
    out = nuts._nuts_transition(grad_fn, z, lp, g, eps, inv_mass, max_depth, draws, counters,
                                tree)
    return (*out, counters, {k: v for k, v in nb_kernel.LAUNCHES.items() if v}, tree)


@pytest.mark.parametrize("stride", [1, 3, 16])
def test_stride_transition_is_the_host_decided_transition(stride, stub_graphs):
    """Through a CapturedTree of `stride` steps per replay, the transition's
    z, logp, gradient, accept statistics, num_steps, depth and divergences
    equal the host-decided transition's (graphs.disabled()'s path) bit for
    bit, and so do its batched evaluations, leaf steps and K2 launches (the
    device's count of leaves times a leaf's launches). The host reads once
    per stride: ceil(leaves / stride) reads, where the eager transition
    reads once per leaf and doubling."""
    want_z, want_lp, want_g, want, want_n, want_launch, _ = _transition(None)
    got_z, got_lp, got_g, got, got_n, got_launch, tree = _transition(
        lambda z: nuts.CapturedTree(_counted, None, z, 6, stride=stride))
    for a, b in ((got_z, want_z), (got_lp, want_lp), (got_g, want_g)):
        assert torch.equal(a, b)
    for name in ("accept_prob", "diverging", "num_steps", "depth"):
        assert torch.equal(got[name], want[name]), name
    assert (got_n.evals, got_n.leaf_steps) == (want_n.evals, want_n.leaf_steps)
    assert got_launch == want_launch == {"nb_glm_plain": want_n.evals}
    leaves = want_n.leaf_steps
    assert got_n.host_syncs == math.ceil(leaves / stride)
    assert want_n.host_syncs >= leaves
    # the case: three depths among the chains that do not diverge, one that does
    assert want["diverging"].tolist() == [False, False, False, True]
    assert len(set(want["depth"][:3].tolist())) == 3
    # what the device counted: every leaf once, a begin and an end per doubling
    done, begins, evens, odds, ends = tree.status.tolist()
    assert done == 1 and evens + odds == leaves and begins == ends == int(tree.d)


def test_a_step_after_done_changes_no_buffer(stub_graphs):
    """Once a transition is done, further tree steps (what the rest of its
    last stride runs) leave every buffer as it was: the trajectory, the
    subtree, the uniforms, the counters and the status word."""
    *_, tree = _transition(lambda z: nuts.CapturedTree(_counted, None, z, 6, stride=4))

    def buffers():
        out = {f"traj.{k}": v for k, v in tree.traj.items()}
        out.update({f"sub.{k}": v for k, v in tree.sub.items()})
        out.update({f"u.{k}": v for k, v in tree.u.items()})
        out.update(d=tree.d, in_subtree=tree.in_subtree, status=tree.status, eps=tree.eps)
        return {k: v.clone() for k, v in out.items()}

    before = buffers()
    assert int(tree.status[0]) == 1
    nb_kernel.reset_launches()
    for _ in range(5):
        tree._step()
    after = buffers()
    assert not any(nb_kernel.LAUNCHES.values())
    for k, v in before.items():
        assert torch.equal(after[k], v), k


@pytest.mark.parametrize("stride", [1, 3])
def test_strides_replay_jax(stride, stub_graphs):
    """tests/test_torch_nuts.py::test_lockstep_chains_each_replay_jax
    through strides of 1 and of 3 tree steps (a stride ends inside a
    subtree, and between a subtree's end and the next begin): each chain
    equals JAX's transition of that chain alone at rtol 1e-10."""
    rng = np.random.default_rng(20)
    stats = _check_against_jax(
        rng.normal(size=(3, _D)), np.array([0.12, 0.6, 8.0]), rng.uniform(0.5, 2.0, (3, _D)),
        [5, 6, 7], tree=lambda z: nuts.CapturedTree(_torch_logp, None, z, 6, stride=stride))
    assert len(set(stats["depth"].tolist())) == 3


def test_tree_uniforms_rows_and_one_draw():
    """GeneratorDraws.tree_uniforms draws a transition's uniforms in one
    torch.rand of 2 max_depth + 2^max_depth - 1 rows: directions, leaves by
    doubling, merges."""
    gen = torch.Generator().manual_seed(0)
    u = GeneratorDraws(gen, "cpu", torch.float64).tree_uniforms(3, 4)
    assert {k: tuple(v.shape) for k, v in u.items()} == {
        "direction": (4, 3), "leaf": (15, 3), "merge": (4, 3)}
    want = torch.rand((23, 3), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    assert torch.equal(torch.cat([u["direction"], u["leaf"], u["merge"]]), want)
