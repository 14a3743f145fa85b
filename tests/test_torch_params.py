"""The port's parameter layout (ppcseq_tpu_torch/model/params.py) and its
non-centered parametrization (model/nb_model.py) against the JAX package's
(ppcseq_tpu/model/params.py, nb_model.py:140-180, 301-307, 878-956), in
float64 at the sizes of tests/test_sharding.py:21-28: values at rtol 1e-12,
gradients at rtol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu.model import params as jparams
from ppcseq_tpu_torch.model import nb_model, params
from ppcseq_tpu_torch.utils import convert

S, G, K = 6, 48, 4


def _jax_model(C, non_centered):
    rng = np.random.default_rng(0)
    counts = rng.poisson(40.0, size=(S, G))
    cols = [np.ones(S), rng.integers(0, 2, size=S).astype(float), rng.normal(size=S)]
    X = np.column_stack(cols[:C])
    exposure = rng.normal(0, 0.2, size=S)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, K, non_centered=non_centered,
                                    dtype=jnp.float64)
    return jnb.with_baseline(jdata, jdims), jdims


def _thetas(dims, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.5, size=(n, dims.dim))


def test_names_layout_and_zeros_equal_jax():
    jdata, jdims = _jax_model(3, False)
    _, dims = convert.model_from_arrays(jdata, jdims)
    assert params.SCALAR_NAMES == jparams.SCALAR_NAMES
    assert params.GENE_NAMES == jparams.GENE_NAMES
    assert params.offsets(dims) == jnb._offsets(jdims)
    want = jparams.zeros_tree(jdims, jnp.float64)
    got = params.zeros_tree(dims, torch.float64)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert float(got[k].abs().sum()) == 0.0


@pytest.mark.parametrize("C", [2, 3])
def test_flat_tree_bridge_equals_jax(C):
    """theta_to_tree gives JAX's leaves; tree_to_theta inverts it, also
    over a batch axis; convert.theta_from_tree carries a JAX tree across."""
    jdata, jdims = _jax_model(C, False)
    _, dims = convert.model_from_arrays(jdata, jdims)
    thetas = _thetas(dims, 3, C)
    for th in thetas:
        want = jnb.theta_to_tree(jnp.asarray(th), jdims)
        got = params.theta_to_tree(torch.as_tensor(th), dims)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        back = convert.theta_from_tree({k: np.asarray(v) for k, v in want.items()}, dims)
        np.testing.assert_array_equal(back.numpy(), th)
    batch = torch.as_tensor(thetas)
    np.testing.assert_array_equal(
        params.tree_to_theta(params.theta_to_tree(batch, dims), dims).numpy(), thetas)


@pytest.mark.parametrize("C", [2, 3])
def test_non_centered_unpack_equals_jax(C):
    """The standardized gene leaves rebuild JAX's centered values."""
    jdata, jdims = _jax_model(C, True)
    _, dims = convert.model_from_arrays(jdata, jdims)
    assert dims.non_centered
    thetas = _thetas(dims, 3, 10 + C)
    got, got_jac = nb_model.unpack(torch.as_tensor(thetas), dims)
    for b, th in enumerate(thetas):
        want, want_jac = jnb.unpack(jnp.asarray(th), jdims)
        for k in want:
            np.testing.assert_allclose(got[k][b].numpy(), np.asarray(want[k]), rtol=1e-12,
                                       atol=1e-300, err_msg=k)
        np.testing.assert_allclose(float(got_jac[b]), float(want_jac), rtol=1e-12)


@pytest.mark.parametrize("non_centered", [True, False], ids=["non_centered", "centered"])
@pytest.mark.parametrize("C", [2, 3])
def test_log_joint_value_and_gradient_equal_jax(C, non_centered):
    """The log joint (delta-form likelihood, plain route) and its gradient
    at a batch of points, against JAX's log_joint and jax.grad."""
    jdata, jdims = _jax_model(C, non_centered)
    data, dims = convert.model_from_arrays(jdata, jdims)
    thetas = jnp.asarray(nb_model.smart_init(data, dims))[None] + 0.1 * _thetas(dims, 3, 20 + C)
    f = jax.value_and_grad(lambda th: jnb.log_joint(th, jdata, jdims))
    t = torch.as_tensor(np.array(thetas)).requires_grad_(True)
    lp = nb_model.log_joint(t, data, dims, likelihood_fn=nb_model.masked_likelihood)
    (g,) = torch.autograd.grad(lp.sum(), t)
    lp = lp.detach()
    for b in range(len(thetas)):
        want_lp, want_g = f(thetas[b])
        np.testing.assert_allclose(float(lp[b]), float(want_lp), rtol=1e-12)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(want_g), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("non_centered", [True, False], ids=["non_centered", "centered"])
def test_smart_init_equals_jax(non_centered):
    """smart_init (flat, and as JAX's as_tree=True through theta_to_tree)
    and the baseline it anchors."""
    jdata, jdims = _jax_model(3, non_centered)
    data, dims = convert.model_from_arrays(jdata, jdims)
    np.testing.assert_allclose(nb_model.smart_init(data, dims),
                               np.asarray(jnb.smart_init(jdata, jdims)), rtol=1e-12, atol=1e-14)
    want = jnb.smart_init(jdata, jdims, as_tree=True)
    got = params.theta_to_tree(torch.as_tensor(nb_model.smart_init(data, dims)), dims)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12, atol=1e-14,
                                   err_msg=k)
    bare, _ = nb_model.prepare_data(np.asarray(jdata.counts), np.asarray(jdata.X),
                                    np.asarray(jdata.exposure_rate), K,
                                    non_centered=non_centered, device="cpu",
                                    dtype=torch.float64)
    ours = nb_model.with_baseline(bare, dims)
    for k in ("alpha0", "sigma_raw0", "d0", "y_sp0"):
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(getattr(jdata, k)),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


def test_tree_logp_and_make_log_density_tree_equal_flat():
    """The counterparts of JAX's tree_logp and make_log_density(tree=True)
    without a shard: flat_logp(dims) with shard=None is log_joint, and
    log_joint_tree on the tree of the same point gives the same bits."""
    jdata, jdims = _jax_model(3, True)
    data, dims = convert.model_from_arrays(jdata, jdims)
    th = torch.as_tensor(nb_model.smart_init(data, dims))[None]
    flat = nb_model.log_joint(th, data, dims)
    np.testing.assert_array_equal(nb_model.flat_logp(dims)(th, data, shard=None).numpy(),
                                  flat.numpy())
    tree = nb_model.log_joint_tree(params.theta_to_tree(th, dims), data, dims)
    np.testing.assert_array_equal(tree.numpy(), flat.numpy())
