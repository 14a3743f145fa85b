"""The port's NUTS (ppcseq_tpu_torch.infer.nuts) and chain heuristic
(infer/chains.py) against the JAX package: the warmup schedule and the
checkpoint slots exactly, the adaptation and energy helpers at rtol 1e-12,
one NUTS transition replayed from JAX's random keys at rtol 1e-10 (a single
chain, and three chains in lockstep), and the statistics that
tests/test_infer.py checks of JAX's sampler (a correlated Gaussian, a
banana)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppcseq_tpu.infer import chains as jchains
from ppcseq_tpu.infer import nuts as jnuts
from ppcseq_tpu.model.params import tree_normal_like
from ppcseq_tpu_torch.infer import nuts
from ppcseq_tpu_torch.infer.chains import (
    chains_for_run,
    find_optimal_number_of_chains,
    mcmc_iterations,
)
from ppcseq_tpu_torch.infer.hmc import logp_and_grad
from ppcseq_tpu_torch.model import nb_model

torch.set_num_threads(2)


def test_build_warmup_schedule_equals_jax():
    for n in range(1001):
        assert nuts.build_warmup_schedule(n) == jnuts.build_warmup_schedule(n), n


def test_leaf_to_ckpt_equals_jax():
    lo, hi = jax.jit(jax.vmap(jnuts._leaf_to_ckpt))(jnp.arange(1024, dtype=jnp.int32))
    assert [nuts._leaf_to_ckpt(i) for i in range(1024)] == list(
        zip(np.asarray(lo).tolist(), np.asarray(hi).tolist()))


def _t(a):
    return torch.as_tensor(np.array(a))


def test_adaptation_and_energy_helpers_match_jax():
    """_welford_update/_welford_variance, _da_update, _is_turning and
    _energy per chain against JAX's, on seeded inputs (rtol 1e-12)."""
    rng = np.random.default_rng(0)
    C, D = 3, 6
    xs = rng.normal(size=(7, C, D))
    wf = nuts._welford_init(_t(xs[0]))
    jwf = [jnuts._welford_init(jnp.asarray(xs[0, c])) for c in range(C)]
    for k, x in enumerate(xs):
        wf = nuts._welford_update(wf, _t(x))
        jwf = [jnuts._welford_update(s, jnp.asarray(x[c])) for c, s in enumerate(jwf)]
        want_var = np.stack([np.asarray(jnuts._welford_variance(s)) for s in jwf])
        np.testing.assert_allclose(wf.mean.numpy(), np.stack([s.mean for s in jwf]), rtol=1e-12)
        np.testing.assert_allclose(wf.m2.numpy(), np.stack([s.m2 for s in jwf]), rtol=1e-12)
        np.testing.assert_allclose(nuts._welford_variance(wf).numpy(), want_var, rtol=1e-12)
        assert wf.count == k + 1

    eps0 = rng.uniform(0.01, 1.0, C)
    da = nuts._da_init(_t(eps0))
    jda = [jnuts._da_init(jnp.asarray(e)) for e in eps0]
    for a in rng.uniform(0, 1, (30, C)):
        da = nuts._da_update(da, _t(a), 0.8)
        jda = [jnuts._da_update(s, jnp.asarray(a[c]), 0.8) for c, s in enumerate(jda)]
        for name in ("log_eps", "log_eps_avg", "h_sum", "mu"):
            np.testing.assert_allclose(getattr(da, name).numpy(),
                                       [float(getattr(s, name)) for s in jda], rtol=1e-12)

    n = 400
    r_sum, r_first, r_last = (rng.normal(size=(n, D)) for _ in range(3))
    inv_mass = rng.uniform(0.2, 3.0, (n, D))
    got = nuts._is_turning(_t(r_sum), _t(r_first), _t(r_last), _t(inv_mass)).numpy()
    want = jax.vmap(jnuts._is_turning)(*map(jnp.asarray, (r_sum, r_first, r_last, inv_mass)))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 < got.sum() < n
    logp = rng.normal(-50.0, 10.0, n)
    np.testing.assert_allclose(
        nuts._energy(_t(logp), _t(r_first), _t(inv_mass)).numpy(),
        np.asarray(jax.vmap(jnuts._energy)(*map(jnp.asarray, (logp, r_first, inv_mass)))),
        rtol=1e-12)


def test_chain_heuristic_matches_reference_formula():
    """tests/test_infer.py:29-35 on the port's chains.py."""
    assert find_optimal_number_of_chains(1000) == 3
    assert find_optimal_number_of_chains(100) == 2
    assert chains_for_run(1000, cores=2) == 3
    assert chains_for_run(100000, cores=8) == 8
    assert mcmc_iterations(1000, 3) == 334
    for draws, cores in ((1000, 1), (5000, 4), (20000, 64), (1e6, 128)):
        assert chains_for_run(draws, cores) == jchains.chains_for_run(draws, cores)
        assert mcmc_iterations(draws, 5) == jchains.mcmc_iterations(draws, 5)


# ---- one transition replayed from JAX's keys -----------------------------

_D = 5
_RNG = np.random.default_rng(0)
_A = _RNG.normal(size=(_D, _D))
_PREC = np.linalg.inv(_A @ _A.T / _D + 0.5 * np.eye(_D))
_MU = _RNG.normal(size=_D)


def _jax_logp_grad(z):
    lp, g = jax.value_and_grad(lambda x: -0.5 * (x - _MU) @ jnp.asarray(_PREC) @ (x - _MU))(z)
    return jnp.where(jnp.isfinite(lp), lp, -jnp.inf), jnp.where(jnp.isfinite(g), g, 0.0)


def _torch_logp(x):
    prec, mu = torch.as_tensor(_PREC), torch.as_tensor(_MU)
    return -0.5 * torch.einsum("bi,ij,bj->b", x - mu, prec, x - mu)


def _torch_logp_grad(z):
    return logp_and_grad(_torch_logp, z)


_JAX_TRANSITION = jax.jit(jnuts._nuts_transition, static_argnums=(0, 7))


class _JaxKeys:
    """The port's `draws` interface replaying JAX's key splits per chain:
    the momentum from split(key, 3) (nuts.py:203), per doubling the
    direction, subtree and merge keys from split(t.key, 4) (:225), per
    leaf the accept key from split(c.key) (:127). `tree_uniforms` makes
    every doubling's and leaf's key in that order, up front: those of the
    doublings and leaves that JAX runs are JAX's keys, the others go
    unused."""

    def __init__(self, keys):
        self.keys = list(keys)

    def momentum(self, shape):
        out, n = [], len(self.keys)
        self.t_keys, self.sub_keys, self.merge_keys = [], [None] * n, [None] * n
        for key in self.keys:
            _, k_mom, k_build = jax.random.split(key, 3)
            self.t_keys.append(k_build)
            out.append(np.asarray(tree_normal_like(k_mom, jnp.zeros(shape[1:]))))
        return _t(np.stack(out))

    def uniform(self, n, what):
        ks = []
        for c in range(n):
            if what == "direction":
                self.t_keys[c], k_dir, self.sub_keys[c], self.merge_keys[c] = jax.random.split(
                    self.t_keys[c], 4)
                ks.append(k_dir)
            elif what == "leaf":
                self.sub_keys[c], k_acc = jax.random.split(self.sub_keys[c])
                ks.append(k_acc)
            else:
                assert what == "merge"
                ks.append(self.merge_keys[c])
        return _t([float(jax.random.uniform(k)) for k in ks])

    def tree_uniforms(self, n, max_depth):
        rows = {"direction": [], "leaf": [], "merge": []}
        for d in range(max_depth):
            rows["direction"].append(self.uniform(n, "direction"))
            rows["leaf"] += [self.uniform(n, "leaf") for _ in range(1 << d)]
            rows["merge"].append(self.uniform(n, "merge"))
        return {k: torch.stack(v) if v else torch.zeros((0, n), dtype=torch.float64)
                for k, v in rows.items()}


def _jax_transition(z, eps, inv_mass, key):
    lp, g = _jax_logp_grad(jnp.asarray(z))
    return _JAX_TRANSITION(_jax_logp_grad, jnp.asarray(z), lp, g, jnp.asarray(eps),
                           jnp.asarray(inv_mass), key, 6)


def _check_against_jax(z, eps, inv_mass, seeds, tree=None):
    """The port's lockstep transition of len(seeds) chains against JAX's
    transition of each chain alone, max_depth 6, float64; `tree(z)` gives
    the transition's nuts._Tree (a new eager one by default)."""
    keys = [jax.random.PRNGKey(s) for s in seeds]
    zt = _t(z)
    lp, g = _torch_logp_grad(zt)
    got_z, got_lp, _, stats = nuts._nuts_transition(
        _torch_logp_grad, zt, lp, g, _t(eps), _t(inv_mass), 6, _JaxKeys(keys),
        tree=None if tree is None else tree(zt))
    for c, key in enumerate(keys):
        jz, jlp, _, jst = _jax_transition(z[c], eps[c], inv_mass[c], key)
        np.testing.assert_allclose(got_z[c].numpy(), np.asarray(jz), rtol=1e-10)
        np.testing.assert_allclose(float(got_lp[c]), float(jlp), rtol=1e-10)
        for name in ("num_steps", "depth", "diverging"):
            assert int(stats[name][c]) == int(jst[name]), name
        np.testing.assert_allclose(float(stats["accept_prob"][c]), float(jst["accept_prob"]),
                                   rtol=1e-10)
    return stats


@pytest.mark.parametrize("seed,eps", [(0, 0.3), (1, 0.5), (2, 0.1), (3, 0.9), (4, 8.0)],
                         ids=["key0", "key1", "key2-deep", "key3", "key4-diverges"])
def test_nuts_transition_replays_jax(seed, eps):
    """One chain, float64, 5-D correlated Gaussian, max_depth 6: z, logp,
    num_steps, depth, diverging and accept_prob equal to JAX's _nuts_transition
    at rtol 1e-10 when the port draws JAX's random numbers; eps 8 diverges
    at the first leaf."""
    rng = np.random.default_rng(10 + seed)
    stats = _check_against_jax(rng.normal(size=(1, _D)), np.array([eps]),
                               rng.uniform(0.5, 2.0, (1, _D)), [seed])
    assert bool(stats["diverging"][0]) == (eps > 5)


def test_lockstep_chains_each_replay_jax():
    """Three chains in one lockstep transition (different step sizes,
    masses and keys; one diverges, the others stop at different depths)
    each equal JAX's transition of that chain alone: a chain that is done
    never moves."""
    rng = np.random.default_rng(20)
    stats = _check_against_jax(rng.normal(size=(3, _D)), np.array([0.12, 0.6, 8.0]),
                               rng.uniform(0.5, 2.0, (3, _D)), [5, 6, 7])
    assert len(set(stats["depth"].tolist())) == 3


# ---- statistics, as tests/test_infer.py checks JAX's sampler ---------------


def _gaussian_logp(mu, sd):
    mu, sd = torch.as_tensor(mu), torch.as_tensor(sd)

    def logp(theta):
        z = (theta - mu) / sd
        return -0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(sd))

    return logp


def test_nuts_recovers_correlated_gaussian():
    """tests/test_infer.py:68-84 on the port."""
    rng = np.random.default_rng(0)
    mu = rng.normal(size=5)
    sd = np.array([0.5, 1.0, 2.0, 0.2, 3.0])
    res = nuts.run_nuts(_gaussian_logp(mu, sd), 5, torch.Generator().manual_seed(2),
                        num_chains=4, num_warmup=300, num_draws=500, device="cpu",
                        dtype=torch.float64)
    draws = res.draws.reshape(-1, 5).numpy()
    assert res.divergences.sum() == 0
    np.testing.assert_allclose(draws.mean(axis=0), mu,
                               atol=float(4 * sd.max() / np.sqrt(2000) + 0.05))
    np.testing.assert_allclose(draws.std(axis=0), sd, rtol=0.15)
    ratio = res.inv_mass.mean(axis=0) / sd**2
    assert (ratio > 0.2).all() and (ratio < 5.0).all()
    # the lockstep evaluates at least every chain's own leapfrogs
    assert res.lockstep_leapfrog >= res.num_leapfrog > 0
    assert res.num_evals * 4 >= res.lockstep_leapfrog and res.host_syncs > 0


def test_nuts_on_banana_no_nans():
    """tests/test_infer.py:87-100 on the port."""
    def logp(theta):
        x, y = theta[:, 0], theta[:, 1]
        return -0.5 * (x**2) - 0.5 * ((y - x**2) ** 2) / 0.25

    res = nuts.run_nuts(logp, 2, torch.Generator().manual_seed(3), num_chains=2,
                        num_warmup=300, num_draws=300, device="cpu", dtype=torch.float64)
    assert torch.isfinite(res.draws).all()
    assert abs(float(res.draws[:, :, 0].mean())) < 0.3


def test_run_nuts_refuses_what_is_not_ported():
    """A mesh must be a DeviceMesh; a pytree prototype is ported, but under
    a `genes` mesh axis only a flat state or the model's tree is, and any
    other tree is a ValueError that names the reason, before any
    collective."""
    from torch_mesh_stub import MeshOf

    gen = torch.Generator()
    for kw in (dict(mesh=object()), dict(mesh=object(), dims=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            nuts.run_nuts(lambda x: -x.pow(2).sum(1), 2, gen, device="cpu", **kw)
    dims = nb_model.ModelDims(S=2, G=4, C=2, n_check=1, G_unpadded=4)
    with pytest.raises(ValueError, match="local flat vector in the global layout"):
        nuts.run_nuts(lambda x: -x["a"].pow(2).sum(1), {"a": np.zeros(2)}, gen,
                      mesh=MeshOf(genes=2), dims=dims, device="cpu")
