"""The port's ADVI (ppcseq_tpu_torch.infer.advi) against an optax Adam
step rebuilt from the JAX package, fed the same numpy noise, plus analogs
of tests/test_infer.py's ADVI tests."""

import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu_torch.infer.advi import adam_init, advi_sample, advi_step, fit_advi, vb_iterative
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.utils.convert import advi_state_from_arrays, model_from_arrays

torch.set_num_threads(2)

LR = 0.1


def _jax_advi(jdata, jdims, m0, noise):
    """Adam on the one-sample -ELBO exactly as advi.py:60-96 builds it:
    optax.adam(lr / sqrt(1 + step / 100)) over {m, log_s}. Returns the
    (params, opt_state) after every step."""
    f = jnb.flat_logp(jdims, "fast")
    D = jdims.dim

    def loss(p, eps):
        theta = p["m"] + jnp.exp(p["log_s"]) * eps
        logps = jax.vmap(lambda th: f(th, jdata))(theta)
        entropy = jnp.sum(p["log_s"]) + 0.5 * D * (1.0 + jnp.log(2.0 * jnp.pi))
        return -(jnp.mean(logps) + entropy)

    opt = optax.adam(lambda step: LR / jnp.sqrt(1.0 + step / 100.0))

    @jax.jit
    def step(p, s, eps):
        g = jax.grad(loss)(p, eps)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    p = {"m": jnp.asarray(m0), "log_s": jnp.full(D, -1.0)}
    s = opt.init(p)
    out = []
    for eps in noise:
        p, s = step(p, s, jnp.asarray(eps))
        out.append((p, s))
    return out


def test_adam_steps_match_optax_with_the_same_noise_f64():
    rng = np.random.default_rng(0)
    S, G = 6, 10
    counts = rng.integers(0, 300, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    exposure = rng.normal(0, 0.2, size=S)
    jdata, jdims = jnb.prepare_data(counts, X, exposure, 3, dtype=jnp.float64)
    jdata = jnb.with_baseline(jdata, jdims)
    tdata, tdims = model_from_arrays(jdata, jdims, dtype=torch.float64)
    m0 = jnb.smart_init(jdata, jdims)
    noise = rng.normal(size=(50, 1, jdims.dim))

    ref = _jax_advi(jdata, jdims, m0, noise)

    def logp(theta):
        return nb_model.log_joint(theta, tdata, tdims)

    params = {"m": torch.as_tensor(m0), "log_s": torch.full((tdims.dim,), -1.0, dtype=torch.float64)}
    state = adam_init(params)
    for k in range(25):
        params, state, _ = advi_step(params, state, torch.as_tensor(noise[k]), logp, LR)
    p25, s25 = ref[24]
    np.testing.assert_allclose(params["m"].numpy(), np.asarray(p25["m"]), rtol=1e-9)
    np.testing.assert_allclose(params["log_s"].numpy(), np.asarray(p25["log_s"]), rtol=1e-9)

    # continue from the JAX state carried across at step 25
    adam = s25[0]
    params, state = advi_state_from_arrays(
        p25["m"], p25["log_s"], adam.mu["m"], adam.mu["log_s"], adam.nu["m"], adam.nu["log_s"],
        adam.count,
    )
    assert state.count == 25
    for k in range(25, 50):
        params, state, _ = advi_step(params, state, torch.as_tensor(noise[k]), logp, LR)
    p50, _ = ref[49]
    np.testing.assert_allclose(params["m"].numpy(), np.asarray(p50["m"]), rtol=1e-9)
    np.testing.assert_allclose(params["log_s"].numpy(), np.asarray(p50["log_s"]), rtol=1e-9)


def _gaussian_logp(mu, sd):
    mu = torch.as_tensor(mu)
    sd = torch.as_tensor(sd)

    def logp(theta):  # theta[B, D] -> [B]
        z = (theta - mu) / sd
        return -0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(sd))

    return logp


def test_advi_recovers_gaussian():
    mu = np.array([1.5, -2.0, 0.5])
    sd = np.array([0.3, 2.0, 1.0])
    gen = torch.Generator().manual_seed(0)
    res = fit_advi(_gaussian_logp(mu, sd), 3, gen, learning_rate=0.05, device="cpu",
                   dtype=torch.float64)
    np.testing.assert_allclose(res.mean.numpy(), mu, atol=0.15)
    np.testing.assert_allclose(np.exp(res.log_sd.numpy()), sd, rtol=0.3)
    draws = advi_sample(res, torch.Generator().manual_seed(1), 4000).numpy()
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=0.2)


def test_vb_iterative_retries_then_raises(capsys):
    def bad_logp(theta):
        return torch.nan * torch.sum(theta, dim=-1)

    with pytest.raises(RuntimeError, match="failed"):
        vb_iterative(bad_logp, 2, torch.Generator().manual_seed(0), max_attempts=2, max_iter=200,
                     device="cpu")
    assert capsys.readouterr().out.count("failed\n") == 2


def test_fit_advi_stops_on_the_relative_elbo_rule():
    """Converges at the first check with two relative changes below tol,
    i.e. after 3 ELBO evaluations (300 steps) on an easy target."""
    gen = torch.Generator().manual_seed(3)
    res = fit_advi(_gaussian_logp([0.0, 1.0], [1.0, 1.0]), 2, gen, init_mean=[0.0, 1.0],
                   init_log_sd=0.0, tol_rel_obj=0.5, device="cpu", dtype=torch.float64)
    assert res.converged and res.iterations == 300 and len(res.elbo_trace) == 3
    assert math.isfinite(res.elbo)


def test_fit_advi_data_operand_is_the_bound_density():
    """fit_advi(data=) calls log_density(theta, data), as JAX's `bind`
    (advi.py:75-78): flat_logp's f(theta, data) with data= gives the bits of
    the same density bound by hand."""
    rng = np.random.default_rng(2)
    S, G = 5, 6
    counts = rng.integers(0, 200, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    data, dims = nb_model.prepare_data(counts, X, rng.normal(0, .2, S), 2, device="cpu",
                                       dtype=torch.float64)
    data = nb_model.with_baseline(data, dims)
    logp = nb_model.flat_logp(dims, "plain")
    init = nb_model.smart_init(data, dims)
    kw = dict(init_mean=init, max_iter=40, eval_every=20, device="cpu", dtype=torch.float64)
    a = fit_advi(logp, dims.dim, torch.Generator().manual_seed(0), data=data, **kw)
    b = fit_advi(lambda th: logp(th, data), dims.dim, torch.Generator().manual_seed(0), **kw)
    assert torch.equal(a.mean, b.mean) and torch.equal(a.log_sd, b.log_sd)
    assert a.elbo == b.elbo
    c = vb_iterative(logp, dims.dim, torch.Generator().manual_seed(0), data=data, **kw)
    assert torch.equal(c.mean, a.mean)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("approx", [True, False], ids=["vb", "mcmc-warm-start"])
def test_do_inference_takes_tol_rel_obj_as_jax(approx, monkeypatch):
    """do_inference(tol_rel_obj=0.02), through identify_outliers as JAX
    passes it (identify.py:779 of the JAX package), reaches both VB fits -
    the VB fit and the MCMC branch's ADVI warm start - with the tolerances
    JAX's fits use there (identify.py:209, 226): the reference's hard-coded
    ones, whatever the argument. Each fit is stopped once it is called."""
    from ppcseq_tpu import identify_outliers as j_identify
    from ppcseq_tpu import load_counts as j_load
    from ppcseq_tpu.pipeline import identify as jid
    from ppcseq_tpu_torch import identify_outliers, load_counts
    from ppcseq_tpu_torch.pipeline import identify as tid

    seen = {}

    def recorder(pkg, fit):
        def fn(*args, tol_rel_obj=None, **kwargs):
            seen.setdefault(pkg, []).append((fit, tol_rel_obj))
            raise _Stop

        return fn

    for pkg, mod in (("jax", jid), ("torch", tid)):
        for fit in ("vb_iterative", "fit_advi"):
            monkeypatch.setattr(mod, fit, recorder(pkg, fit))
    kw = dict(formula="~ Label", sample="sample", transcript="symbol", abundance="value",
              significance="PValue", do_check="is_significant", percent_false_positive_genes=5,
              how_many_negative_controls=50, approximate_posterior_inference=approx,
              tol_rel_obj=0.02, seed=42)
    for pkg, run, load, extra in (("jax", j_identify, j_load, {}),
                                  ("torch", identify_outliers, load_counts,
                                   dict(device="cpu", dtype=torch.float64))):
        counts = load()
        counts = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
        with pytest.warns(UserWarning, match="tol_rel_obj"), pytest.raises(_Stop):
            run(counts, **kw, **extra)
    fit = "vb_iterative" if approx else "fit_advi"
    assert seen["torch"] == seen["jax"] == [(fit, 0.005 if approx else 0.01)]
