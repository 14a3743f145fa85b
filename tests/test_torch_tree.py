"""Structured sampler states in the port (model/params.state_spec): the
prototype that JAX's fit_advi, advi_sample, run_nuts and run_hmc_tree take
("an int D, an example array, or a pytree"), held against the JAX package's
flattening and result structures, and against the port's own flat runs of
the flattened state. Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ppcseq_tpu.infer import advi as jadvi
from ppcseq_tpu.infer import hmc as jhmc
from ppcseq_tpu_torch.infer import advi, hmc, nuts
from ppcseq_tpu_torch.model import nb_model, params
from ppcseq_tpu_torch.model.params import state_spec, tree_map
from torch_mesh_stub import MeshOf

torch.set_num_threads(2)
CPU64 = dict(device="cpu", dtype=torch.float64)

# sorted leaves: a (), b [2], c.d [1], c.e [2, 3] -> D = 10
PROTO = {"b": np.zeros(2), "a": np.zeros(()), "c": {"e": np.zeros((2, 3)), "d": np.zeros(1)}}
_rng = np.random.default_rng(5)
MU = _rng.normal(size=10)
SD = _rng.uniform(0.5, 2.0, size=10)


def _gauss(theta):
    """A diagonal Gaussian over the flat [B, 10] state, in JAX's leaf order."""
    z = (theta - torch.as_tensor(MU)) / torch.as_tensor(SD)
    return -0.5 * torch.sum(z * z, dim=-1)


def _tree_gauss(tree, *args):
    """The same density of the tree state (leaves with a leading [B]): the
    leaves are concatenated by hand, so the value is the flat one's bits."""
    c = tree["c"]
    return _gauss(torch.cat([tree["a"][..., None], tree["b"], c["d"], c["e"].flatten(-2)], -1))


def _jax_gauss(tree):
    z = (ravel_pytree(tree)[0] - MU) / SD
    return -0.5 * jnp.sum(z * z)


def _structure_and_shapes(tree):
    np_tree = tree_map(lambda x: np.asarray(x), tree)
    return jax.tree.structure(np_tree), jax.tree.map(np.shape, np_tree)


@pytest.mark.parametrize("proto", [7, np.zeros(7), np.zeros((3, 4)), np.zeros(()), PROTO],
                         ids=["int", "vector", "matrix", "scalar", "nested-dict"])
def test_state_spec_flattens_as_jax_ravel_pytree(proto):
    """flatten is JAX's ravel_pytree of the same tree, unflatten its
    inverse, and both keep leading batch axes."""
    rng = np.random.default_rng(1)
    example = np.zeros(proto) if isinstance(proto, int) else proto
    tree = jax.tree.map(lambda x: rng.normal(size=np.shape(x)), example)
    spec = state_spec(proto)
    want, unravel = ravel_pytree(tree)
    flat = spec.flatten(tree_map(torch.as_tensor, tree))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    assert spec.dim == want.shape[0] and spec.structured == (np.ndim(example) != 1)
    back = spec.unflatten(flat)
    assert _structure_and_shapes(back) == _structure_and_shapes(unravel(want))
    # leading batch axes
    batch = torch.as_tensor(rng.normal(size=(4, 3, spec.dim)))
    tb = spec.unflatten(batch)
    assert jax.tree.map(np.shape, tree_map(np.asarray, tb)) == jax.tree.map(
        lambda x: (4, 3) + np.shape(x), example)
    np.testing.assert_array_equal(spec.flatten(tb).numpy(), batch.numpy())
    # a NumPy state unflattens to NumPy leaves
    np_back = spec.unflatten(batch.numpy())
    assert _structure_and_shapes(np_back) == _structure_and_shapes(tb)
    assert all(isinstance(x, np.ndarray) for x in jax.tree.leaves(np_back))


def test_fit_advi_and_advi_sample_over_a_tree():
    """A dict state fits as its flat vector: the same numbers as the flat
    fit, returned in the prototype's structure, which is JAX's."""
    kw = dict(max_iter=60, eval_every=20, learning_rate=0.1, **CPU64)
    flat = advi.fit_advi(_gauss, 10, torch.Generator().manual_seed(0), **kw)
    tree = advi.fit_advi(_tree_gauss, PROTO, torch.Generator().manual_seed(0), **kw)
    spec = state_spec(PROTO)
    assert torch.equal(spec.flatten(tree.mean), flat.mean)
    assert torch.equal(spec.flatten(tree.log_sd), flat.log_sd)
    assert tree.elbo == flat.elbo and tree.iterations == flat.iterations

    jres = jadvi.fit_advi(_jax_gauss, PROTO, jax.random.PRNGKey(0), max_iter=20,
                          eval_every=10, dtype=jnp.float64)
    assert _structure_and_shapes(tree.mean) == _structure_and_shapes(jres.mean)
    assert _structure_and_shapes(tree.log_sd) == _structure_and_shapes(jres.log_sd)

    draws = advi.advi_sample(tree, torch.Generator().manual_seed(1), 5)
    want = advi.advi_sample(flat, torch.Generator().manual_seed(1), 5)
    assert torch.equal(spec.flatten(draws), want)
    jdraws = jadvi.advi_sample(jres, jax.random.PRNGKey(1), 5, dtype=jnp.float64)
    assert _structure_and_shapes(draws) == _structure_and_shapes(jdraws)
    assert advi.advi_sample(tree, torch.Generator(), 2, dtype=torch.float32)["a"].dtype == \
        torch.float32
    # a tree init_mean is the flat one in the tree's structure
    init = spec.unflatten(torch.as_tensor(MU))
    a = advi.fit_advi(_tree_gauss, PROTO, torch.Generator().manual_seed(2), init_mean=init, **kw)
    b = advi.fit_advi(_gauss, 10, torch.Generator().manual_seed(2), init_mean=MU, **kw)
    assert torch.equal(spec.flatten(a.mean), b.mean)


def test_fit_advi_data_operand_and_vb_iterative_over_a_tree():
    """data= calls log_density(theta, data), as JAX's bind (advi.py:75-78)."""
    seen = []

    def density(tree, data):
        seen.append(data)
        return _tree_gauss(tree)

    kw = dict(max_iter=40, eval_every=20, **CPU64)
    res = advi.vb_iterative(density, PROTO, torch.Generator().manual_seed(0), data="D", **kw)
    want = advi.fit_advi(_gauss, 10, torch.Generator().manual_seed(0), **kw)
    assert set(seen) == {"D"}
    assert torch.equal(res.flat()[0], want.mean)


def test_run_nuts_over_a_tree_is_the_flat_run():
    kw = dict(num_chains=2, num_warmup=30, num_draws=6, max_depth=5, **CPU64)
    init = state_spec(PROTO).unflatten(torch.as_tensor(MU + 0.3))
    flat = nuts.run_nuts(_gauss, 10, torch.Generator().manual_seed(3), init_theta=MU + 0.3, **kw)
    tree = nuts.run_nuts(_tree_gauss, PROTO, torch.Generator().manual_seed(3), init_theta=init,
                         **kw)
    spec = state_spec(PROTO)
    assert torch.equal(spec.flatten(tree.draws), flat.draws)
    np.testing.assert_array_equal(spec.flatten(tree.inv_mass).numpy(), flat.inv_mass)
    np.testing.assert_array_equal(tree.step_size, flat.step_size)
    # JAX's result structure (nuts.py:364-369): leaves [chains, num_draws, ...]
    # and an inverse mass of [chains, ...] leaves
    stacked = jax.tree.map(lambda x: np.zeros((2, 6) + np.shape(x)), PROTO)
    per_chain = jax.tree.map(lambda x: np.zeros((2,) + np.shape(x)), PROTO)
    assert _structure_and_shapes(tree.draws) == _structure_and_shapes(stacked)
    assert _structure_and_shapes(tree.inv_mass) == _structure_and_shapes(per_chain)


def test_run_hmc_tree_over_a_tree_is_the_flat_run_and_jaxs_structure():
    """The chains start at the prototype's values jittered (JAX's
    hmc.py:708-716): a flat run from the same point draws the same numbers."""
    start = state_spec(PROTO).unflatten(torch.as_tensor(MU))
    mass = state_spec(PROTO).unflatten(torch.as_tensor(SD**2))
    kw = dict(num_chains=3, num_warmup=8, num_draws=4, num_leapfrog=4, **CPU64)
    tree = hmc.run_hmc_tree(_tree_gauss, start, torch.Generator().manual_seed(4), inv_mass=mass,
                            **kw)
    flat = hmc.run_hmc(_gauss, 10, torch.Generator().manual_seed(4), init_theta=MU,
                       inv_mass=SD**2, **kw)
    assert torch.equal(state_spec(PROTO).flatten(tree.draws), flat.draws)
    assert tree.step_size == flat.step_size
    jres = jhmc.run_hmc_tree(_jax_gauss, PROTO, jax.random.PRNGKey(0), num_chains=3,
                             num_warmup=2, num_draws=4, num_leapfrog=2, dtype=jnp.float64)
    assert _structure_and_shapes(tree.draws) == _structure_and_shapes(jres.draws)
    # an int prototype starts at zeros, as JAX's
    zero = hmc.run_hmc_tree(_gauss, 10, torch.Generator().manual_seed(4), **kw)
    flat0 = hmc.run_hmc(_gauss, 10, torch.Generator().manual_seed(4), init_theta=np.zeros(10),
                        **kw)
    assert torch.equal(zero.draws, flat0.draws)


def _model(non_centered=False):
    rng = np.random.default_rng(9)
    S, G = 6, 8
    counts = rng.poisson(np.exp(rng.normal(3.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, S).astype(float), rng.normal(size=S)])
    data, dims = nb_model.prepare_data(counts, X, rng.normal(0, .2, S), 3,
                                       non_centered=non_centered, **CPU64)
    return nb_model.with_baseline(data, dims), dims


def test_the_model_tree_enters_through_tree_to_theta():
    """With dims, smart_init(as_tree=True) is the model's tree in the
    model's flat layout: run_nuts and run_hmc_tree over it draw the flat
    runs' numbers bit for bit, and hand back the model's tree."""
    data, dims = _model()
    tree0 = nb_model.smart_init(data, dims, as_tree=True)
    flat0 = nb_model.smart_init(data, dims)
    assert set(tree0) == params.model_tree_names(dims)
    tl, fl = nb_model.tree_logp(dims, "plain"), nb_model.flat_logp(dims, "plain")
    kw = dict(data=data, dims=dims, num_chains=2, num_warmup=20, num_draws=4, max_depth=4,
              **CPU64)
    a = nuts.run_nuts(tl, tree0, torch.Generator().manual_seed(7), init_theta=tree0, **kw)
    b = nuts.run_nuts(fl, dims.dim, torch.Generator().manual_seed(7), init_theta=flat0, **kw)
    assert torch.equal(params.tree_to_theta(a.draws, dims), b.draws)
    assert a.draws["alpha_2"].shape == (2, 4, 1, 3) and a.draws["lambda_mu"].shape == (2, 4)
    kw = dict(data=data, dims=dims, num_chains=2, num_warmup=6, num_draws=3, num_leapfrog=3,
              **CPU64)
    a = hmc.run_hmc_tree(tl, tree0, torch.Generator().manual_seed(8), **kw)
    b = hmc.run_hmc_tree(fl, dims.dim, torch.Generator().manual_seed(8), init_theta=flat0, **kw)
    assert torch.equal(params.tree_to_theta(a.draws, dims), b.draws)


def test_a_genes_mesh_takes_a_flat_state_or_the_models_tree():
    """Under a `genes` axis a rank's state is its local flat vector in the
    global layout: any other tree is a ValueError, raised before any
    collective; the model's tree (with dims) passes that check and a
    chains-only mesh takes any tree."""
    data, dims = _model()
    gen = torch.Generator()
    for axes in (dict(genes=2), dict(chains=2, genes=2)):
        mesh = _Mesh(**axes)
        with pytest.raises(ValueError, match="local flat vector"):
            nuts.run_nuts(_tree_gauss, PROTO, gen, mesh=mesh, dims=dims, **CPU64)
        with pytest.raises(ValueError, match="local flat vector"):
            hmc.run_hmc_tree(_tree_gauss, PROTO, gen, mesh=mesh, dims=dims, **CPU64)
        tree0 = nb_model.smart_init(data, dims, as_tree=True)
        with pytest.raises(_PastTheCheck):
            nuts.run_nuts(nb_model.tree_logp(dims), tree0, gen, data=data, mesh=mesh, dims=dims,
                          **CPU64)
    with pytest.raises(_PastTheCheck):
        nuts.run_nuts(_tree_gauss, PROTO, gen, mesh=_Mesh(chains=2), **CPU64)
    with pytest.raises(ValueError, match="flat state"):
        advi.fit_advi(_tree_gauss, PROTO, gen, layout=_GeneLayout(), **CPU64)


class _PastTheCheck(Exception):
    pass


class _Mesh(MeshOf):
    """A mesh stub whose first step into the process group says that the
    state check let the call through."""

    def __getitem__(self, name):
        return self

    def get_local_rank(self):
        raise _PastTheCheck


class _GeneLayout:
    genes = object()
