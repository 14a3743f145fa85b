"""The port's jittered HMC (ppcseq_tpu_torch.infer.hmc): its update rules
against a NumPy transcription of ppcseq_tpu/infer/hmc.py:108-146 at fixed
inputs (float64, rtol 1e-12), the ChEES/SNAPER warmup replayed from JAX's
random keys against ppcseq_tpu.infer.hmc._build_chees_warmup (float64,
rtol 1e-9), and its statistics as tests/test_hmc.py checks them
(correlated-Gaussian moments, ChEES on a correlated Gaussian and on slow
directions; the NB model's HMC means against ADVI)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppcseq_tpu.infer import hmc as jhmc
from ppcseq_tpu_torch.infer import hmc
from ppcseq_tpu_torch.infer.advi import fit_advi
from ppcseq_tpu_torch.infer.diagnostics import summarize
from ppcseq_tpu_torch.infer.hmc import dual_average, leapfrog, logp_and_grad, run_hmc
from ppcseq_tpu_torch.model import nb_model

torch.set_num_threads(2)


def _np_leapfrog(z, r, g, eps, inv_mass, grad):
    """hmc.py:108-114 in NumPy."""
    r_half = r + 0.5 * eps * g
    z1 = z + eps * (r_half * inv_mass[None, :])
    lp1, g1 = grad(z1)
    return z1, r_half + 0.5 * eps * g1, g1, lp1


def _np_dual_average(log_eps_avg, h_sum, a_mean, i, mu, target):
    """hmc.py:134-146 in NumPy (gamma 0.05, t0 10, kappa 0.75)."""
    count = i + 1.0
    w = 1.0 / (count + 10.0)
    h_sum = (1 - w) * h_sum + w * (target - a_mean)
    log_eps = mu - np.sqrt(count) / 0.05 * h_sum
    eta = count ** (-0.75)
    return log_eps, eta * log_eps + (1 - eta) * log_eps_avg, h_sum


def test_leapfrog_and_dual_averaging_match_numpy_transcription():
    rng = np.random.default_rng(0)
    D, chains = 5, 3
    A = rng.normal(size=(D, D))
    prec = A @ A.T + np.eye(D)
    z, r = rng.normal(size=(chains, D)), rng.normal(size=(chains, D))
    inv_mass = rng.uniform(0.5, 2.0, D)

    def np_grad(x):
        return -0.5 * np.einsum("bi,ij,bj->b", x, prec, x), -x @ prec

    prec_t = torch.as_tensor(prec)

    def t_grad(x):
        return logp_and_grad(lambda y: -0.5 * torch.einsum("bi,ij,bj->b", y, prec_t, y), x)

    lp, g = np_grad(z)
    tz, tr, tg = (torch.as_tensor(a) for a in (z, r, g))
    for _ in range(7):
        z, r, g, lp = _np_leapfrog(z, r, g, 0.13, inv_mass, np_grad)
        tz, tr, tg, tlp = leapfrog(tz, tr, tg, 0.13, torch.as_tensor(inv_mass), t_grad)
    for got, want in ((tz, z), (tr, r), (tg, g), (tlp, lp)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)

    mu = math.log(10 * 0.05)
    state_np = (mu - math.log(10.0), 0.0)
    state_t = (torch.tensor(mu - math.log(10.0), dtype=torch.float64),
               torch.zeros((), dtype=torch.float64))
    for i, a in enumerate(rng.uniform(0, 1, 30)):
        le, lea, h = _np_dual_average(*state_np, a, i, mu, 0.8)
        tle, tlea, th = dual_average(*state_t, torch.tensor(a, dtype=torch.float64), i, mu, 0.8)
        state_np, state_t = (lea, h), (tlea, th)
        np.testing.assert_allclose([float(tle), float(tlea), float(th)], [le, lea, h], rtol=1e-12)


def test_non_finite_density_and_gradient_are_cleaned():
    def logp(x):
        return torch.where(x[:, 0] > 0, -torch.sqrt(x[:, 0]) * x[:, 1], torch.full_like(x[:, 0],
                                                                                       math.nan))

    lp, g = logp_and_grad(logp, torch.tensor([[4.0, 1.0], [-1.0, 2.0], [0.0, 1.0]],
                                             dtype=torch.float64))
    assert float(lp[0]) == -2.0 and lp[1] == -math.inf
    assert torch.all(torch.isfinite(g)) and torch.all(g[1] == 0)


def test_hmc_correlated_gaussian_moments():
    """tests/test_hmc.py:10-34 on the port."""
    D = 8
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, D))
    cov = A @ A.T / D + np.eye(D) * 0.5
    prec = torch.as_tensor(np.linalg.inv(cov))
    mu = rng.normal(size=D)
    mu_t = torch.as_tensor(mu)

    def logp(x):
        d = x - mu_t
        return -0.5 * torch.einsum("bi,ij,bj->b", d, prec, d)

    gen = torch.Generator().manual_seed(0)
    res = run_hmc(logp, D, gen, num_chains=64, num_warmup=200, num_draws=300, num_leapfrog=16,
                  inv_mass=np.diag(cov).copy(), device="cpu", dtype=torch.float64)
    assert res.draws.shape == (64, 300, D)
    assert res.divergences.sum() == 0
    assert 0.6 < res.accept_prob.mean() < 0.99
    draws = res.draws.reshape(-1, D).numpy()
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=0.08)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.1 * np.abs(cov).max())
    assert summarize(res.draws.numpy())["rhat_max"] < 1.05


def test_hmc_nb_model_agrees_with_advi():
    """tests/test_hmc.py:95-125 on the port: data without a baseline, so
    flat_logp(dims) runs K2's plain version (nb_fast.glm_plain)."""
    rng = np.random.default_rng(1)
    S, G, n_check = 8, 24, 4
    counts = rng.poisson(np.exp(rng.normal(4.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), (np.arange(S) >= S // 2).astype(float)])
    exposure = rng.normal(0.0, 0.1, size=S)
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, device="cpu",
                                       dtype=torch.float32)
    assert data.d0 is None
    logp = nb_model.flat_logp(dims)
    init = nb_model.smart_init(data, dims)

    warm = fit_advi(lambda th: logp(th, data), dims.dim, torch.Generator().manual_seed(2),
                    init_mean=init, tol_rel_obj=0.01, learning_rate=0.2, eval_every=50,
                    device="cpu")
    res = run_hmc(logp, dims.dim, torch.Generator().manual_seed(3), data=data,
                  num_chains=32, num_warmup=60, num_draws=60, num_leapfrog=16,
                  init_theta=warm.mean, inv_mass=torch.exp(2.0 * warm.log_sd),
                  target_accept=0.95, device="cpu")
    assert res.divergences.sum() <= 0.01 * res.draws.shape[0] * res.draws.shape[1]
    assert res.num_leapfrog >= 32 * 120 * math.ceil(0.4 * 16)
    hmc_mean = res.draws.reshape(-1, dims.dim).mean(dim=0).numpy()
    lo, hi = nb_model._offsets(dims)["intercept"]
    np.testing.assert_allclose(hmc_mean[lo:hi], warm.mean.numpy()[lo:hi], atol=0.25)


def test_hmc_refuses_what_is_not_ported():
    """A mesh that is not a DeviceMesh is refused, with or without ChEES
    (a DeviceMesh runs: tests/test_torch_sharding.py); ChEES alone runs."""
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(mesh=object()), dict(mesh=object(), adapt_trajectory=True)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            run_hmc(lambda x: -x.pow(2).sum(1), 2, gen, device="cpu", **kw)
    res = run_hmc(lambda x: -x.pow(2).sum(1), 2, gen, num_chains=4, num_warmup=5, num_draws=3,
                  num_leapfrog=8, adapt_trajectory=True, device="cpu", dtype=torch.float64)
    assert res.trajectory_length > 0 and res.draws.shape == (4, 3, 2)


def test_halton_seq_equals_jax():
    for base in (2, 3):
        np.testing.assert_array_equal(hmc._halton_seq(300, base), jhmc._halton_seq(300, base))
    assert hmc._L_BUCKETS == jhmc._L_BUCKETS


class _JaxKeys:
    """The port's `draws` interface replaying the keys of JAX's ChEES
    warmup: split(key, num_warmup) per draw (hmc.py:329), and per draw the
    momentum and accept keys from split(key) (hmc.py:198)."""

    def __init__(self, key, n):
        self.keys = list(jax.random.split(key, n))

    def momentum(self, shape):
        k_mom, self.k_acc = jax.random.split(self.keys.pop(0))
        return torch.as_tensor(np.array(jax.random.normal(k_mom, shape, jnp.float64)))

    def uniform(self, n, what):
        assert what == "accept"
        return torch.as_tensor(np.array(jax.random.uniform(self.k_acc, (n,), jnp.float64)))


@pytest.mark.parametrize("L_cap", [16, 4], ids=["cap16", "cap4"])
def test_chees_warmup_replays_jax(L_cap):
    """8 chains, D = 8, 6 warmup draws, float64, from JAX's keys: the final
    state, step size, trajectory length and leapfrog count equal
    ppcseq_tpu.infer.hmc._build_chees_warmup's at rtol 1e-9 (at cap 4 the
    log-T clip binds)."""
    rng = np.random.default_rng(0)
    D, C, W = 8, 8, 6
    A = rng.normal(size=(D, D))
    cov = A @ A.T / D + 0.5 * np.eye(D)
    prec, mu = np.linalg.inv(cov), rng.normal(size=D)
    pj, pt, mt = jnp.asarray(prec), torch.as_tensor(prec), torch.as_tensor(mu)
    z0 = mu[None] + rng.normal(size=(C, D))
    inv_mass = np.diag(cov).copy()
    mu_da = math.log(10 * 0.05)
    u = hmc._halton_seq(W)
    key = jax.random.PRNGKey(4)

    warm = jhmc._build_chees_warmup(lambda x: -0.5 * (x - mu) @ pj @ (x - mu), False, D, C, W,
                                    L_cap, 0.8, jnp.float64)
    jz, _, _, jeps, jT, jL = warm(None, jnp.asarray(z0), jnp.asarray(inv_mass),
                                  jnp.asarray(mu_da), key, jnp.asarray(u))

    def grad_fn(x):
        return logp_and_grad(lambda y: -0.5 * torch.einsum("bi,ij,bj->b", y - mt, pt, y - mt), x)

    z, _, _, eps, T, L = hmc._chees_warmup(grad_fn, torch.as_tensor(z0), torch.as_tensor(inv_mass),
                                           mu_da, W, L_cap, 0.8, _JaxKeys(key, W),
                                           torch.as_tensor(u))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-9)
    np.testing.assert_allclose([float(eps), float(T)], [float(jeps), float(jT)], rtol=1e-9)
    assert L == int(jL)


def _correlated_gaussian(seed):
    D = 8
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    cov = A @ A.T / D + np.eye(D) * 0.5
    prec = torch.as_tensor(np.linalg.inv(cov))
    mu = rng.normal(size=D)
    mu_t = torch.as_tensor(mu)

    def logp(x):
        d = x - mu_t
        return -0.5 * torch.einsum("bi,ij,bj->b", d, prec, d)

    return logp, mu, cov


def test_chees_adaptive_trajectory_gaussian():
    """tests/test_hmc.py:37-63 on the port: adapt_trajectory=True finds a
    good T on a correlated Gaussian."""
    logp, mu, cov = _correlated_gaussian(5)
    res = run_hmc(logp, 8, torch.Generator().manual_seed(1), num_chains=64, num_warmup=300,
                  num_draws=400, num_leapfrog=64, adapt_trajectory=True,
                  inv_mass=np.diag(cov).copy(), device="cpu", dtype=torch.float64)
    assert res.trajectory_length is not None and res.trajectory_length > 0
    assert res.divergences.sum() == 0
    np.testing.assert_allclose(res.draws.reshape(-1, 8).numpy().mean(axis=0), mu, atol=0.1)
    assert summarize(res.draws.numpy())["rhat_max"] < 1.05


def test_snaper_targets_slow_directions():
    """tests/test_hmc.py:66-92 on the port: 195 fast coordinates and 5 slow
    ones (sd 10) under a unit mass; the SNAPER criterion must adapt T past
    the fast scale, and the slow block must mix."""
    D_fast, D_slow, slow_sd = 195, 5, 10.0
    var = np.ones(D_fast + D_slow)
    var[D_fast:] = slow_sd**2
    prec = torch.as_tensor(1.0 / var)

    def logp(x):
        return -0.5 * torch.sum(x * x * prec, dim=1)

    res = run_hmc(logp, D_fast + D_slow, torch.Generator().manual_seed(3), num_chains=64,
                  num_warmup=300, num_draws=300, num_leapfrog=64, adapt_trajectory=True,
                  device="cpu", dtype=torch.float64)
    assert res.trajectory_length > 5.0, res.trajectory_length
    assert summarize(res.draws[:, :, D_fast:].numpy())["rhat_max"] < 1.1
    slow = res.draws.reshape(-1, D_fast + D_slow)[:, D_fast:].numpy()
    np.testing.assert_allclose(slow.std(axis=0), slow_sd, rtol=0.25)
