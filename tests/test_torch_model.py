"""The port's model (ppcseq_tpu_torch.model.nb_model) against the JAX
package's, in float64 on the CPU, plus ports of the model goldens of
tests/test_model.py."""

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.utils.constants import LAMBDA_MU_MU
from ppcseq_tpu_torch.utils.convert import model_from_arrays

torch.set_num_threads(2)

_BASELINE = ("alpha0", "sigma_raw0", "d0", "sp_d0", "sig_neg_d0", "y_sp0")


def _arrays(S=6, G=10, C=2, seed=0, exclude_frac=0.1):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 300, size=(S, G))
    X = np.column_stack(
        [np.ones(S)] + [rng.integers(0, 2, size=S).astype(float) for _ in range(C - 1)]
    )
    exposure = rng.normal(0, 0.2, size=S)
    exclude = rng.uniform(size=(S, G)) < exclude_frac
    return counts, X, exposure, exclude


@pytest.mark.parametrize("C", [1, 2, 3])
def test_log_joint_and_gradient_match_jax_fast_f64(C):
    counts, X, exposure, exclude = _arrays(C=C, seed=C)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 3, exclude_mask=exclude,
                                    dtype=jnp.float64)
    jdata = jnb.with_baseline(jdata, jdims)
    tdata, tdims = model_from_arrays(jdata, jdims, dtype=torch.float64)
    rng = np.random.default_rng(10 + C)
    theta0 = jnb.smart_init(jdata, jdims)
    thetas = theta0[None] + 0.2 * rng.normal(size=(3, jdims.dim))

    t = torch.as_tensor(thetas).requires_grad_(True)
    lp = nb_model.log_joint(t, tdata, tdims)
    lp.sum().backward()
    lp = lp.detach()
    f = jnb.flat_logp(jdims, "fast")
    for b in range(thetas.shape[0]):
        want = float(f(jnp.asarray(thetas[b]), jdata))
        np.testing.assert_allclose(float(lp[b]), want, rtol=1e-10)
        g = np.asarray(jax.grad(f)(jnp.asarray(thetas[b]), jdata))
        np.testing.assert_allclose(t.grad[b].numpy(), g, rtol=1e-10, atol=1e-10 * np.abs(g).max())


def test_smart_init_and_baseline_equal_jax():
    counts, X, exposure, exclude = _arrays(S=8, G=12, seed=4)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 3, exclude_mask=exclude,
                                    dtype=jnp.float64)
    tdata, tdims = nb_model.prepare_data(counts, X, exposure, 3, exclude_mask=exclude,
                                         device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(nb_model.smart_init(tdata, tdims), jnb.smart_init(jdata, jdims))
    jb = jnb.with_baseline(jdata, jdims)
    tb = nb_model.with_baseline(tdata, tdims)
    for k in _BASELINE:
        np.testing.assert_allclose(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)),
                                   rtol=1e-13, atol=1e-13, err_msg=k)


def test_prepare_data_pads_like_jax():
    counts, X, exposure, exclude = _arrays(S=5, G=7, seed=5)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 2, exclude_mask=exclude,
                                    pad_genes_to=9, dtype=jnp.float64)
    tdata, tdims = nb_model.prepare_data(counts, X, exposure, 2, exclude_mask=exclude,
                                         pad_genes_to=9, device="cpu", dtype=torch.float64)
    assert (tdims.G, tdims.G_unpadded, tdims.dim) == (jdims.G, jdims.G_unpadded, jdims.dim)
    for k in ("counts", "X", "exposure_rate", "like_mask", "gene_mask"):
        np.testing.assert_array_equal(getattr(tdata, k).numpy(), np.asarray(getattr(jdata, k)))


def _toy(S=4, G=6, C=2, n_check=2, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 200, size=(S, G))
    X = np.column_stack(
        [np.ones(S)] + [rng.integers(0, 2, size=S).astype(float) for _ in range(C - 1)]
    )
    exposure = rng.normal(0, 0.2, size=S)
    return nb_model.prepare_data(counts, X, exposure, n_check, device="cpu", dtype=torch.float64)


def test_unpack_roundtrip_transforms():
    _, dims = _toy()
    theta = np.random.default_rng(1).normal(size=dims.dim)
    params, log_jac = nb_model.unpack(torch.as_tensor(theta), dims)
    assert float(params["lambda_sigma"]) > 0
    assert float(params["sigma_sigma"]) > 0
    assert float(params["sigma_slope"]) < 0
    assert float(params["lambda_mu"]) == pytest.approx(theta[0] + LAMBDA_MU_MU)
    # Jacobian = sum of the three log-scale coords
    assert float(log_jac) == pytest.approx(theta[1] + theta[3] + theta[5])


def test_make_alpha_zero_padding():
    _, dims = _toy(C=3)
    theta = torch.as_tensor(np.random.default_rng(2).normal(size=(2, dims.dim)))
    params, _ = nb_model.unpack(theta, dims)
    alpha = nb_model.make_alpha(params, dims)
    assert alpha.shape == (2, 3, dims.G)
    # Control genes get zero slope/extra coefficients (stan:122-139)
    assert torch.all(alpha[:, 1, dims.n_check:] == 0)
    assert torch.all(alpha[:, 2, dims.n_check:] == 0)
    assert torch.equal(alpha[:, 0], params["intercept"])


def test_log_joint_exclusion_mask_subtracts_lpmf():
    """Masking a point == Stan's subtract-the-lpmf truncation (stan:105-115).

    Both data sets share one baseline, so the difference is exactly the
    excluded point's delta-form lpmf; that agrees with scipy's NB2 lpmf to
    the accuracy of the delta form's float32-targeted series (~1e-8
    absolute per term), hence rtol 1e-6 on a lpmf of magnitude ~5-10.
    """
    S, G = 4, 6
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 100, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    exposure = rng.normal(0, 0.2, size=S)
    excl = np.zeros((S, G), dtype=bool)
    excl[1, 0] = True
    data0, dims = nb_model.prepare_data(counts, X, exposure, 2, device="cpu", dtype=torch.float64)
    data0 = nb_model.with_baseline(data0, dims)
    data1, _ = nb_model.prepare_data(counts, X, exposure, 2, exclude_mask=excl,
                                     device="cpu", dtype=torch.float64)
    data1 = nb_model.ModelData(**{**data0.__dict__, "like_mask": data1.like_mask})
    theta = torch.as_tensor(nb_model.smart_init(data0, dims)[None]
                            + rng.normal(size=(1, dims.dim)) * 0.1)

    lp0 = float(nb_model.log_joint(theta, data0, dims)[0])
    lp1 = float(nb_model.log_joint(theta, data1, dims)[0])

    params, _ = nb_model.unpack(theta[0], dims)
    eta = exposure + (X @ nb_model.make_alpha(params, dims).numpy())[:, 0]
    mu, phi = np.exp(eta[1]), np.exp(-float(params["sigma_raw"][0]))
    lpmf_point = st.nbinom.logpmf(counts[1, 0], phi, phi / (phi + mu))
    np.testing.assert_allclose(lp0 - lp1, lpmf_point, rtol=1e-6)


def test_extract_lambda_sigma_draws_match_jax():
    counts, X, exposure, _ = _arrays(S=5, G=8, C=3, seed=7)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 3, dtype=jnp.float64)
    tdata, tdims = model_from_arrays(jdata, jdims, dtype=torch.float64)
    thetas = np.random.default_rng(8).normal(size=(4, jdims.dim))
    lam, sig = nb_model.extract_lambda_sigma_draws(torch.as_tensor(thetas), tdata, tdims)
    jlam, jsig = jnb.extract_lambda_sigma_draws(jnp.asarray(thetas), jdata, jdims)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))
    np.testing.assert_array_equal(
        nb_model.extract_alpha_sub_1_draws(torch.as_tensor(thetas), tdims).numpy(),
        np.asarray(jnb.extract_alpha_sub_1_draws(jnp.asarray(thetas), jdims)),
    )


def _jax_tree_case(non_centered, seed=3):
    counts, X, exposure, exclude = _arrays(S=6, G=9, C=3, seed=seed)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 3, exclude_mask=exclude,
                                    non_centered=non_centered, dtype=jnp.float64)
    jdata = jnb.with_baseline(jdata, jdims)
    tdata, tdims = model_from_arrays(jdata, jdims, dtype=torch.float64)
    return jdata, jdims, tdata, tdims


@pytest.mark.parametrize("non_centered", [False, True], ids=["centered", "non_centered"])
def test_tree_logp_smart_init_and_make_log_density_tree_match_jax(non_centered):
    """smart_init(as_tree=True), tree_logp(dims) and make_log_density(tree=
    True) against JAX's, leaf by leaf in float64 (value rtol 1e-12, each
    leaf's gradient rtol 1e-9). JAX's density is unbatched and vmapped; the
    port's takes the leaves with a leading batch axis. make_log_density's
    default likelihood is the port's default route, "fast" (JAX's is
    "plain"), so JAX's side is given fast_likelihood."""
    jdata, jdims, tdata, tdims = _jax_tree_case(non_centered)
    jtree = jnb.smart_init(jdata, jdims, as_tree=True)
    ttree = nb_model.smart_init(tdata, tdims, as_tree=True)
    assert set(ttree) == set(jtree)
    for k in jtree:
        assert ttree[k].dtype == torch.float64 and ttree[k].shape == jtree[k].shape, k
        np.testing.assert_allclose(ttree[k].numpy(), np.asarray(jtree[k]), rtol=1e-12,
                                   atol=1e-14, err_msg=k)
    rng = np.random.default_rng(4)
    batch = {k: np.asarray(v)[None] + 0.1 * rng.normal(size=(3,) + np.shape(v))
             for k, v in jtree.items()}
    for jf, tf in ((jnb.tree_logp(jdims, "plain"), nb_model.tree_logp(tdims, "plain")),
                   (lambda t, d: jnb.make_log_density(jdata, jdims, jnb.fast_likelihood,
                                                      tree=True)(t),
                    lambda t, d: nb_model.make_log_density(tdata, tdims, tree=True)(t))):
        jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jf), in_axes=(0, None)))(
            {k: jnp.asarray(v) for k, v in batch.items()}, jdata)
        leaves = {k: torch.as_tensor(v).requires_grad_(True) for k, v in batch.items()}
        lp = tf(leaves, tdata)
        lp.sum().backward()
        np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jv), rtol=1e-12)
        for k in batch:
            want = np.asarray(jg[k])
            np.testing.assert_allclose(leaves[k].grad.numpy(), want, rtol=1e-9,
                                       atol=1e-9 * max(np.abs(want).max(), 1.0), err_msg=k)


def test_lambda_log_matches_jax():
    """lambda_log = X @ alpha as C multiply-adds, batched, at rtol 1e-12."""
    jdata, jdims, tdata, tdims = _jax_tree_case(False, seed=6)
    thetas = np.random.default_rng(7).normal(size=(4, jdims.dim))
    params, _ = nb_model.unpack(torch.as_tensor(thetas), tdims)
    got = nb_model.lambda_log(params, tdata, tdims)
    assert got.shape == (4, tdims.S, tdims.G)
    for b in range(4):
        jp, _ = jnb.unpack(jnp.asarray(thetas[b]), jdims)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(jnb.lambda_log(jp, jdata, jdims)),
                                   rtol=1e-12, atol=1e-12)


def test_nb2_rng_moments():
    """tests/test_model.py:92-100 on the port: nb2_log_rng at eta = 3,
    phi = 2, 200,000 draws: mean within 2%, variance within 5%."""
    from ppcseq_tpu_torch.ops.nb import nb2_log_rng

    eta, phi = 3.0, 2.0
    draws = nb2_log_rng(torch.Generator().manual_seed(0), torch.full((200000,), eta),
                        torch.full((200000,), phi))
    assert draws.dtype == torch.int64
    mu = np.exp(eta)
    var = mu + mu**2 / phi
    m, v = float(draws.double().mean()), float(draws.double().var(correction=0))
    assert abs(m - mu) / mu < 0.02
    assert abs(v - var) / var < 0.05
