"""The port's likelihood (plain version and kernel wrapper) against the JAX
package: nb_fast.glm_delta in float64 and the Pallas K1 kernel in
interpret mode in float32. Inputs are made with numpy from a seed and go
through both packages via ppcseq_tpu_torch.utils.convert."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu.ops import nb_fast as jfast
from ppcseq_tpu.ops.nb_kernel import nb_glm_likelihood_fast
from ppcseq_tpu_torch.ops import nb_fast, nb_kernel
from ppcseq_tpu_torch.utils.convert import model_from_arrays

torch.set_num_threads(2)

_BASELINE = ("alpha0", "sigma_raw0", "d0", "sp_d0", "sig_neg_d0", "y_sp0")


def _case(S=21, G=300, C=2, n_check=4, B=3, seed=0, exclude_frac=0.05, masked_gene=None):
    """JAX float64 model data with baseline, and B parameter rows."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(S)] + [rng.integers(0, 2, S).astype(float) for _ in range(C - 1)])
    alpha_true = rng.normal(4.0, 1.0, size=(C, G))
    alpha_true[1:] = rng.normal(0, 0.5, size=(C - 1, G))
    exposure = rng.normal(0.0, 0.3, size=S)
    counts = rng.poisson(np.minimum(np.exp(exposure[:, None] + X @ alpha_true), 1e6))
    exclude = rng.uniform(size=(S, G)) < exclude_frac
    if masked_gene is not None:
        exclude[:, masked_gene] = True
    data, dims = jnb.prepare_data(counts, X, exposure, n_check, exclude_mask=exclude,
                                  dtype=jnp.float64)
    data = jnb.with_baseline(data, dims)
    # parameter rows: near the generating coefficients (some points reach
    # the far branches of the delta form), log_phi ~ N(0, 1) as in
    # tests/test_nb_kernel.py
    alpha = alpha_true[None] + rng.normal(0, 0.1, size=(B, C, G))
    log_phi = rng.normal(0.0, 1.0, size=(B, G))
    return data, dims, alpha, log_phi


def _plain(data, alpha, log_phi, want_grads=True):
    return nb_fast.glm_delta(
        data.X, data.counts, data.like_mask, data.alpha0, data.sigma_raw0, data.d0,
        data.sp_d0, data.sig_neg_d0, data.y_sp0, alpha, log_phi, want_grads,
    )


def test_glm_delta_matches_jax_rows_f64():
    jdata, jdims, alpha, log_phi = _case(seed=1, B=4)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    v, da, dl = _plain(tdata, torch.as_tensor(alpha), torch.as_tensor(log_phi))
    for b in range(alpha.shape[0]):
        jv, jda, jdl = jfast.glm_delta(
            jdata.X, jdata.exposure_rate, jdata.counts, jdata.like_mask,
            *(getattr(jdata, k) for k in _BASELINE),
            jnp.asarray(alpha[b]), jnp.asarray(log_phi[b]), want_grads=True,
        )
        # same polynomials and branches; only the summation order differs
        np.testing.assert_allclose(float(v[b]), float(jv), rtol=1e-10)
        for got, want in ((da[b], jda), (dl[b], jdl)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max())


def test_glm_delta_value_only_equals_value_with_grads():
    jdata, jdims, alpha, log_phi = _case(seed=2, B=3)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    a, p = torch.as_tensor(alpha), torch.as_tensor(log_phi)
    v_only = _plain(tdata, a, p, want_grads=False)
    v, _, _ = _plain(tdata, a, p, want_grads=True)
    assert torch.equal(v_only, v)


def _to_f32(d):
    return dataclasses.replace(
        d,
        X=d.X.astype(jnp.float32),
        exposure_rate=d.exposure_rate.astype(jnp.float32),
        like_mask=d.like_mask.astype(jnp.float32),
        gene_mask=d.gene_mask.astype(jnp.float32),
        **{f: getattr(d, f).astype(jnp.float32) for f in _BASELINE},
    )


def test_glm_delta_matches_pallas_k1_interpret_f32():
    """The plain version == the Pallas K1 kernel (interpret mode) in
    float32, at a gene count (300) that is not a multiple of the tile
    (128): value rtol 2e-5, gradient |d|/(1+|g|) < 1e-4
    (tests/test_nb_kernel.py:212-253 tolerances)."""
    jdata, jdims, alpha, log_phi = _case(seed=5, B=2)
    j32 = _to_f32(jdata)
    tdata, _ = model_from_arrays(j32, jdims, dtype=torch.float32)
    a32 = alpha.astype(np.float32)
    l32 = log_phi.astype(np.float32)
    v, da, dl = _plain(tdata, torch.as_tensor(a32), torch.as_tensor(l32))

    def k1(a, p):
        return nb_glm_likelihood_fast(j32, a, p, gene_tile=128, interpret=True)

    for b in range(a32.shape[0]):
        vk = k1(jnp.asarray(a32[b]), jnp.asarray(l32[b]))
        np.testing.assert_allclose(float(v[b]), float(vk), rtol=2e-5)
        gk = jax.grad(k1, (0, 1))(jnp.asarray(a32[b]), jnp.asarray(l32[b]))
        for got, want in ((da[b], gk[0]), (dl[b], gk[1])):
            want = np.asarray(want, np.float64)
            err = np.abs(got.numpy().astype(np.float64) - want) / (1.0 + np.abs(want))
            assert err.max() < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_gene_gets_exactly_zero_gradient(dtype):
    jdata, jdims, alpha, log_phi = _case(S=6, G=20, seed=3, B=2, masked_gene=7)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=dtype)
    _, da, dl = _plain(tdata, torch.as_tensor(alpha, dtype=dtype),
                       torch.as_tensor(log_phi, dtype=dtype))
    assert torch.all(da[:, :, 7] == 0) and torch.all(dl[:, 7] == 0)
    assert torch.any(da[:, :, 6] != 0)


def test_autograd_function_gradients_equal_plain_version():
    jdata, jdims, alpha, log_phi = _case(S=8, G=40, seed=4, B=3)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    a = torch.as_tensor(alpha).requires_grad_(True)
    p = torch.as_tensor(log_phi).requires_grad_(True)
    w = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    value = nb_kernel.nb_glm_likelihood_fast(tdata, a, p)
    (w * value).sum().backward()
    v, da, dl = _plain(tdata, a.detach(), p.detach())
    assert torch.equal(value.detach(), v)
    assert torch.equal(a.grad, w[:, None, None] * da)
    assert torch.equal(p.grad, w[:, None] * dl)
    with torch.no_grad():
        assert torch.equal(nb_kernel.nb_glm_likelihood_fast(tdata, a, p), v)


def test_wrapper_refuses_cpu_tensors_for_the_kernel_and_missing_baseline():
    jdata, jdims, alpha, log_phi = _case(S=4, G=8, seed=6, B=1)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float32)
    a = torch.as_tensor(alpha, dtype=torch.float32)
    p = torch.as_tensor(log_phi, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        nb_kernel.launch_delta(tdata.X, tdata.counts, tdata.like_mask, tdata.d0, a,
                               tdata.alpha0, p, tdata.sigma_raw0, want_grads=True)
    # the one-pass delta-form entry (K3) needs the baseline; the hoisted
    # entry (K1/K2) and the stable entry (K4/K5) do not
    bare = dataclasses.replace(tdata, d0=None)
    with pytest.raises(ValueError, match="baseline"):
        nb_kernel.nb_glm_likelihood_fused(bare, a, p)

