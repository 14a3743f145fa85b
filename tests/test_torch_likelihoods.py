"""The port's likelihood forms and entries against the JAX package: the
plain versions of K2-K5 in float64 (rtol 1e-10), the same plain versions in
float32 against the Pallas kernels in interpret mode (at
tests/test_nb_kernel.py's tolerances), and `flat_logp(dims, name)` for
every name. Inputs are made with numpy from a seed and carried across with
ppcseq_tpu_torch.utils.convert."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu.ops import nb as jnbops
from ppcseq_tpu.ops import nb_fast as jfast
from ppcseq_tpu.ops import nb_grad as jgrad
from ppcseq_tpu.ops import nb_kernel as jkernel
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.ops import nb, nb_fast, nb_grad, nb_kernel
from ppcseq_tpu_torch.utils.convert import model_from_arrays

torch.set_num_threads(2)

_BASELINE = ("alpha0", "sigma_raw0", "d0", "sp_d0", "sig_neg_d0", "y_sp0")


def _case(S=21, G=300, C=2, n_check=4, B=2, seed=0, exclude_frac=0.05, masked_gene=None,
          baseline=False):
    """JAX float64 model data (as tests/test_nb_kernel.py:_case builds it)
    and B parameter rows alpha[B, C, G], log_phi[B, G]."""
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
    if baseline:
        data = jnb.with_baseline(data, dims)
    alpha = alpha_true[None] + rng.normal(0, 0.1, size=(B, C, G))
    log_phi = rng.normal(0.0, 1.0, size=(B, G))
    return data, dims, alpha, log_phi


def _to_f32(d):
    return dataclasses.replace(
        d,
        X=d.X.astype(jnp.float32),
        exposure_rate=d.exposure_rate.astype(jnp.float32),
        like_mask=d.like_mask.astype(jnp.float32),
        gene_mask=d.gene_mask.astype(jnp.float32),
        **{f: getattr(d, f).astype(jnp.float32) for f in _BASELINE if getattr(d, f) is not None},
    )


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / (1.0 + np.abs(want)))


# --- the naming fault: the stable-form entry works without a baseline -----


def test_stable_entry_works_without_baseline_and_matches_jax_pallas():
    """`nb_kernel.nb_glm_likelihood` is the stable-form K4/K5 entry, as in
    the JAX package (nb_kernel.py:201-210): on data without a baseline it
    returns the Pallas kernel's value (interpret mode, rtol 2e-4), at a gene
    count (37) that is not a multiple of the tile."""
    jdata, jdims, alpha, log_phi = _case(G=37, seed=1)
    tdata, _ = model_from_arrays(_to_f32(jdata), jdims, dtype=torch.float32)
    assert tdata.d0 is None
    a32, l32 = alpha.astype(np.float32), log_phi.astype(np.float32)
    got = nb_kernel.nb_glm_likelihood(tdata, torch.as_tensor(a32), torch.as_tensor(l32))
    for b in range(alpha.shape[0]):
        want = jkernel.nb_glm_likelihood(jdata, jnp.asarray(a32[b]), jnp.asarray(l32[b]),
                                         128, True)
        np.testing.assert_allclose(float(got[b]), float(want), rtol=2e-4)


# --- plain versions against JAX in float64 ---------------------------------


def test_stable_lpmf_family_matches_jax_f64():
    rng = np.random.default_rng(2)
    n = 4000
    y = rng.integers(0, 30, n)
    y[::3] = rng.integers(8, 200_000, y[::3].shape)
    eta = rng.normal(3.0, 4.0, n)
    log_phi = rng.normal(0.0, 4.0, n)
    log_phi[::7] = rng.uniform(60.0, 90.0, log_phi[::7].shape)  # around the cap
    u = rng.uniform(-0.9, 3.0, n)
    t = {k: torch.as_tensor(v) for k, v in dict(y=y, eta=eta, log_phi=log_phi, u=u).items()}
    j = {k: jnp.asarray(v) for k, v in dict(y=y, eta=eta, log_phi=log_phi, u=u).items()}
    phi_t, phi_j = torch.exp(torch.clamp(t["log_phi"], max=80.0)), jnp.exp(
        jnp.minimum(j["log_phi"], 80.0))
    yf_t = t["y"].double()
    pairs = [
        (nb.nb2_log_lpmf_stable(t["y"], t["eta"], t["log_phi"]),
         jnbops.nb2_log_lpmf_stable(j["y"], j["eta"], j["log_phi"])),
        # the lgamma form cancels catastrophically at large phi: keep phi <= e^5
        (nb.nb2_log_lpmf(t["y"], t["eta"], t["log_phi"].clamp(max=5.0)),
         jnbops.nb2_log_lpmf(j["y"], j["eta"], jnp.minimum(j["log_phi"], 5.0))),
        (nb.nb2_part1(yf_t, phi_t, t["log_phi"]),
         jnbops.nb2_part1(j["y"].astype(jnp.float64), phi_j, j["log_phi"])),
        (nb.log1p_precise(t["u"]), jnbops.log1p_precise(j["u"])),
        (nb.expm1_precise(t["u"] - 1.0), jnbops.expm1_precise(j["u"] - 1.0)),
        (nb._softplus(t["eta"]), jnbops._softplus(j["eta"])),
        (nb._lgamma_pos_small(t["u"] + 1.0), jnbops._lgamma_pos_small(j["u"] + 1.0)),
    ]
    pairs += [(g_t, g_j) for g_t, g_j in zip(nb_grad.nb2_grads(t["y"], t["eta"], t["log_phi"]),
                                             jgrad.nb2_grads(j["y"], j["eta"], j["log_phi"]))]
    for i, (got, want) in enumerate(pairs):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max(), err_msg=str(i))


@pytest.mark.parametrize("baseline", [False, True], ids=["stable", "delta"])
def test_masked_likelihood_and_grads_match_jax_f64(baseline):
    """masked_likelihood (stable or delta form), stable_likelihood,
    delta_likelihood, likelihood_grads and the lgamma reference, per row."""
    jdata, jdims, alpha, log_phi = _case(seed=3, B=3, baseline=baseline)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    a, p = torch.as_tensor(alpha), torch.as_tensor(log_phi)
    masked = nb_model.masked_likelihood(tdata, a, p)
    stable = nb_model.stable_likelihood(tdata, a, p)
    ref = nb_model.nb_glm_loglik_reference(tdata.X, a, p, tdata.exposure_rate, tdata.counts,
                                           tdata.like_mask)
    dalpha, dlog_phi = nb_grad.likelihood_grads(tdata.X, tdata.exposure_rate, tdata.counts,
                                                tdata.like_mask, a, p)
    jplain = dataclasses.replace(jdata, **{k: None for k in _BASELINE})
    for b in range(alpha.shape[0]):
        ja, jp = jnp.asarray(alpha[b]), jnp.asarray(log_phi[b])
        np.testing.assert_allclose(float(masked[b]), float(jnb.masked_likelihood(jdata, ja, jp)),
                                   rtol=1e-10)
        np.testing.assert_allclose(float(stable[b]), float(jnb.masked_likelihood(jplain, ja, jp)),
                                   rtol=1e-10)
        np.testing.assert_allclose(float(ref[b]), float(jkernel.nb_glm_loglik_reference(
            jdata.X, ja, jp, jdata.exposure_rate, jdata.counts, jdata.like_mask)), rtol=1e-10)
        jda, jdl = jgrad.likelihood_grads(jdata.X, jdata.exposure_rate, jdata.counts,
                                          jdata.like_mask, ja, jp)
        for got, want in ((dalpha[b], jda), (dlog_phi[b], jdl)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max())
    if baseline:
        delta = nb_model.delta_likelihood(tdata, a, p)
        assert torch.equal(delta, masked)


def test_glm_plain_matches_jax_f64():
    jdata, jdims, alpha, log_phi = _case(seed=4, B=3)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    v, da, dl = nb_fast.glm_plain(tdata.X, tdata.exposure_rate, tdata.counts, tdata.like_mask,
                                  torch.as_tensor(alpha), torch.as_tensor(log_phi), True)
    v_only = nb_fast.glm_plain(tdata.X, tdata.exposure_rate, tdata.counts, tdata.like_mask,
                               torch.as_tensor(alpha), torch.as_tensor(log_phi), False)
    assert torch.equal(v_only, v)
    jv, jda, jdl = jax.jit(jax.vmap(
        lambda a, p: jfast.glm_plain(jdata.X, jdata.exposure_rate, jdata.counts,
                                     jdata.like_mask, a, p, want_grads=True)
    ))(jnp.asarray(alpha), jnp.asarray(log_phi))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-10)
    for b in range(alpha.shape[0]):
        for got, want in ((da[b], jda[b]), (dl[b], jdl[b])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max())


# --- plain versions against the Pallas kernels (interpret mode, float32) ---


def _f32_case(**kw):
    jdata, jdims, alpha, log_phi = _case(**kw)
    j32 = _to_f32(jdata)
    tdata, _ = model_from_arrays(j32, jdims, dtype=torch.float32)
    return j32, tdata, alpha.astype(np.float32), log_phi.astype(np.float32)


def test_k2_plain_version_matches_pallas_fastk_plain():
    """glm_plain == _fastk_plain (interpret): value rtol 2e-5, gradient
    |d|/(1+|g|) < 1e-4 (test_nb_kernel.py:212-253)."""
    j32, tdata, a32, l32 = _f32_case(seed=5, B=1)
    v, da, dl = nb_fast.glm_plain(tdata.X, tdata.exposure_rate, tdata.counts, tdata.like_mask,
                                  torch.as_tensor(a32), torch.as_tensor(l32), True)

    def k2(a, p):
        return jkernel.nb_glm_likelihood_fast(j32, a, p, gene_tile=128, interpret=True)

    for b in range(a32.shape[0]):
        args = (jnp.asarray(a32[b]), jnp.asarray(l32[b]))
        np.testing.assert_allclose(float(v[b]), float(k2(*args)), rtol=2e-5)
        gk = jax.grad(k2, (0, 1))(*args)
        assert _scaled_err(da[b].numpy(), gk[0]) < 1e-4
        assert _scaled_err(dl[b].numpy(), gk[1]) < 1e-4


def test_k3_plain_version_matches_pallas_fused():
    """delta_likelihood + likelihood_grads (the K3 entry on CPU tensors) ==
    _fused_dkernel (interpret): value rtol 3e-4, gradient atol
    2e-3*(1+max|g|), rtol 2e-3 (test_nb_kernel.py:168-183)."""
    j32, tdata, a32, l32 = _f32_case(S=10, G=64, seed=5, B=1, baseline=True)
    a = torch.as_tensor(a32).requires_grad_(True)
    p = torch.as_tensor(l32).requires_grad_(True)
    v = nb_kernel.nb_glm_likelihood_fused(tdata, a, p)
    v.sum().backward()

    def k3(a_, p_):
        return jkernel.nb_glm_likelihood_fused(j32, a_, p_, 32, True)

    for b in range(a32.shape[0]):
        args = (jnp.asarray(a32[b]), jnp.asarray(l32[b]))
        np.testing.assert_allclose(float(v[b].detach()), float(k3(*args)), rtol=3e-4)
        for got, want in zip((a.grad[b], p.grad[b]), jax.grad(k3, (0, 1))(*args)):
            want = np.asarray(want, np.float64)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                                       atol=2e-3 * (1 + np.abs(want).max()))


def test_k4_plain_version_matches_pallas_forward_unaligned():
    """stable_likelihood == _fwd_kernel (interpret), G=37: rtol 2e-4
    (test_nb_kernel.py:66-77); a baseline on the data is ignored."""
    j32, tdata, a32, l32 = _f32_case(G=37, seed=6, baseline=True)
    with torch.no_grad():
        v = nb_kernel.nb_glm_likelihood(tdata, torch.as_tensor(a32), torch.as_tensor(l32))
    assert torch.equal(v, nb_model.stable_likelihood(tdata, torch.as_tensor(a32),
                                                     torch.as_tensor(l32)))
    for b in range(a32.shape[0]):
        want = jkernel.nb_glm_likelihood(j32, jnp.asarray(a32[b]), jnp.asarray(l32[b]), 128, True)
        np.testing.assert_allclose(float(v[b]), float(want), rtol=2e-4)


@pytest.mark.parametrize("baseline", [False, True], ids=["plain", "baseline-ignored"])
def test_stable_entry_under_grad_is_k5s_plain_version(baseline):
    """Under grad `nb_glm_likelihood` returns, in one pass (K5's route on CPU
    tensors), exactly stable_likelihood's value and likelihood_grads'
    gradients (float64), scaled by the cotangent; under no_grad the same
    value (K4's route)."""
    jdata, jdims, alpha, log_phi = _case(seed=9, B=3, masked_gene=5, baseline=baseline)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    a = torch.as_tensor(alpha).requires_grad_(True)
    p = torch.as_tensor(log_phi).requires_grad_(True)
    w = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)
    value = nb_kernel.nb_glm_likelihood(tdata, a, p)
    (w * value).sum().backward()
    a0, p0 = a.detach(), p.detach()
    with torch.no_grad():
        v_only = nb_kernel.nb_glm_likelihood(tdata, a0, p0)
    want = nb_model.stable_likelihood(tdata, a0, p0)
    da, dl = nb_grad.likelihood_grads(tdata.X, tdata.exposure_rate, tdata.counts,
                                      tdata.like_mask, a0, p0)
    assert torch.equal(value.detach(), want) and torch.equal(v_only, want)
    assert torch.equal(a.grad, w[:, None, None] * da) and torch.equal(p.grad, w[:, None] * dl)
    assert torch.all(a.grad[:, :, 5] == 0) and torch.all(p.grad[:, 5] == 0)


def test_k5_plain_version_matches_pallas_backward_and_masks():
    """likelihood_grads (the gradients of the K4/K5 entry's K5 route on CPU
    tensors) == _bwd_kernel (interpret): rtol 3e-3, atol 3e-2
    (test_nb_kernel.py:80-94); a fully masked gene gets exactly zero
    gradients (:97-110)."""
    j32, tdata, a32, l32 = _f32_case(S=8, G=64, C=3, seed=1, masked_gene=3)
    a = torch.as_tensor(a32).requires_grad_(True)
    p = torch.as_tensor(l32).requires_grad_(True)
    w = torch.tensor([0.5, 2.0])
    (w * nb_kernel.nb_glm_likelihood(tdata, a, p)).sum().backward()
    assert torch.all(a.grad[:, :, 3] == 0) and torch.all(p.grad[:, 3] == 0)

    def k45(a_, p_):
        return jkernel.nb_glm_likelihood(j32, a_, p_, 64, True)

    for b in range(a32.shape[0]):
        ga, gp = jax.grad(k45, (0, 1))(jnp.asarray(a32[b]), jnp.asarray(l32[b]))
        np.testing.assert_allclose(a.grad[b].numpy() / float(w[b]), np.asarray(ga),
                                   rtol=3e-3, atol=3e-2)
        np.testing.assert_allclose(p.grad[b].numpy() / float(w[b]), np.asarray(gp),
                                   rtol=3e-3, atol=3e-2)


# --- flat_logp(dims, name) --------------------------------------------------

# port name -> (needs a baseline, JAX likelihood with the same math in f64)
_ROUTES = {
    "plain": (True, "plain"),
    "fast": (True, "fast"),
    "fast-nobaseline": (False, "fast"),
    "auto": (True, "fast"),
    "pallas": (False, "analytic"),  # stable forward, likelihood_grads backward
    "pallas_fused": (True, "analytic"),  # delta forward, likelihood_grads backward
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_flat_logp_value_and_grad_match_jax_f64(route):
    baseline, jname = _ROUTES[route]
    name = route.split("-")[0]
    rng = np.random.default_rng(11)
    S, G = 8, 24
    counts = rng.poisson(np.exp(rng.normal(4.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), (np.arange(S) >= S // 2).astype(float)])
    exposure = rng.normal(0.0, 0.1, size=S)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 4,
                                    exclude_mask=rng.uniform(size=(S, G)) < 0.05,
                                    dtype=jnp.float64)
    if baseline:
        jdata = jnb.with_baseline(jdata, jdims)
    tdata, tdims = model_from_arrays(jdata, jdims, dtype=torch.float64)
    thetas = jnb.smart_init(jdata, jdims)[None] + 0.1 * rng.normal(size=(3, jdims.dim))

    f = nb_model.flat_logp(tdims, name)
    t = torch.as_tensor(thetas).requires_grad_(True)
    lp = f(t, tdata)
    lp.sum().backward()
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jnb.flat_logp(jdims, jname)),
                              in_axes=(0, None)))(jnp.asarray(thetas), jdata)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jv), rtol=1e-10)
    for b in range(thetas.shape[0]):
        want = np.asarray(jg[b])
        np.testing.assert_allclose(t.grad[b].numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("name", ["pallas", "pallas_fused"])
def test_flat_logp_kernel_routes_match_jax_pallas_interpret(name):
    """The kernel routes against the JAX log joint with the Pallas kernels
    in interpret mode (f32 inside): rtol 3e-4 (test_nb_kernel.py:113-125)."""
    rng = np.random.default_rng(12)
    S, G = 6, 32
    counts = rng.poisson(np.exp(rng.normal(4.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, S).astype(float)])
    exposure = rng.normal(0.0, 0.2, size=S)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 3, dtype=jnp.float64)
    jdata = jnb.with_baseline(jdata, jdims)
    tdata, tdims = model_from_arrays(jdata, jdims, dtype=torch.float64)
    theta = jnb.smart_init(jdata, jdims)
    make = (jkernel.make_pallas_likelihood if name == "pallas"
            else jkernel.make_pallas_fused_likelihood)
    want = float(jnb.log_joint(jnp.asarray(theta), jdata, jdims,
                               likelihood_fn=make(32, True)))
    got = float(nb_model.flat_logp(tdims, name)(torch.as_tensor(theta)[None], tdata)[0])
    np.testing.assert_allclose(got, want, rtol=3e-4)


def test_flat_logp_names_that_are_not_ported_or_unknown():
    dims = nb_model.ModelDims(S=2, G=3, C=1, n_check=1, G_unpadded=3)
    for name in ("analytic", "fused"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            nb_model.flat_logp(dims, name)
    with pytest.raises(ValueError, match="unknown likelihood"):
        nb_model.flat_logp(dims, "nope")


def test_fused_entry_raises_without_baseline():
    jdata, jdims, alpha, log_phi = _case(S=4, G=16, seed=7)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    with pytest.raises(ValueError, match="baseline"):
        nb_kernel.nb_glm_likelihood_fused(tdata, torch.as_tensor(alpha),
                                          torch.as_tensor(log_phi))


def test_launch_counts_are_per_kernel_and_untouched_on_cpu():
    jdata, jdims, alpha, log_phi = _case(S=4, G=16, seed=8, baseline=True)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    nb_kernel.reset_launches()
    a, p = torch.as_tensor(alpha), torch.as_tensor(log_phi)
    for entry in (nb_kernel.nb_glm_likelihood_fast, nb_kernel.nb_glm_likelihood,
                  nb_kernel.nb_glm_likelihood_fused):
        entry(tdata, a, p)
    assert set(nb_kernel.LAUNCHES) == {"nb_glm_delta", "nb_glm_plain", "nb_glm_fused",
                                       "nb_glm_stable_fwd", "nb_glm_stable_bwd"}
    assert all(v == 0 for v in nb_kernel.LAUNCHES.values())


@pytest.mark.parametrize("likelihood", ["fast", "plain"])
def test_log_joint_sums_energy_differences_in_float64(likelihood):
    """At S = 100, G = 5,000 the log joint is about -3.1e6, where float32
    spaces its values 0.25 apart. Two thetas that differ in five genes'
    intercepts: with float32 theta and data, log_joint returns float64 and
    its difference agrees with the all-float64 evaluation to 1e-3 nats,
    while the same values rounded to float32 are off by more than 1e-2
    (0.045 here)."""
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    counts, X, exposure, _ = synthetic_cohort(5000, 100, n_check=100, seed=0)
    data, dims = nb_model.prepare_data(counts, X, exposure, 100, device="cpu",
                                       dtype=torch.float32)
    data = nb_model.with_baseline(data, dims)
    data64 = nb_model.with_baseline(nb_model.upload(data.host, "cpu", torch.float64), dims)
    theta0 = nb_model.smart_init(data, dims).astype(np.float32)
    theta1 = theta0.copy()
    lo, _ = nb_model._offsets(dims)["intercept"]
    theta1[lo + 200:lo + 205] += np.float32(2e-3)
    theta = torch.as_tensor(np.stack([theta0, theta1]))
    logp = nb_model.flat_logp(dims, likelihood)
    with torch.no_grad():
        lp = logp(theta, data)
        want = logp(theta.double(), data64)
    assert lp.dtype == torch.float64 and abs(float(lp[0])) > 3e6
    delta_want = float(want[1] - want[0])
    assert abs(float(lp[1] - lp[0]) - delta_want) < 1e-3
    lp32 = lp.float()
    assert abs(float(lp32[1] - lp32[0]) - delta_want) > 1e-2
