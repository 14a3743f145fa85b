"""The samplers' CUDA-graph runners (ppcseq_tpu_torch.infer.graphs, the
captured ADVI fit and HMC trajectory) on the CPU, with a stub standing in
for torch.cuda.CUDAGraph: its capture records the region's function and
its replay runs it again, uncaptured, over the runners' static buffers.
The runners must give the eager loops' bits, the device-scalar Adam step
must match optax (float64, rtol 1e-9 as tests/test_torch_advi.py), the
cache must reuse one capture across fits of equal shapes and replace it
when a shape changes, and a replay must add the launches its capture
holds."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu_torch.infer import advi, graphs, hmc
from ppcseq_tpu_torch.infer.advi import adam_init, advi_step, fit_advi, vb_iterative
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.model.params import state_spec
from ppcseq_tpu_torch.ops import nb_kernel
from ppcseq_tpu_torch.parallel import sharding
from ppcseq_tpu_torch.utils.convert import model_from_arrays

torch.set_num_threads(2)

LR = 0.1


class _StubCapture:
    """graphs.CudaCapture's stand-in on the CPU: warm-up runs fn, capture
    records it and returns one run's outputs (the region's static ones), and
    a replay runs it again, copies its outputs into the static ones and
    takes back the launches and all-reduces it counted (a graph's kernels
    and all-reduces count nothing themselves)."""

    def __init__(self, device, name):
        self.name = name
        self.fn = self.outputs = None

    def warmup(self, fn, runs):
        for _ in range(runs):
            fn()

    def capture(self, fn):
        self.fn = fn
        self.outputs = fn()
        return self.outputs

    def replay(self):
        before, collectives = dict(nb_kernel.LAUNCHES), dict(sharding.COLLECTIVES)
        out = self.fn()
        nb_kernel.LAUNCHES.update(before)
        sharding.COLLECTIVES.update(collectives)
        if isinstance(out, torch.Tensor):
            self.outputs.copy_(out)


def _stub(monkeypatch):
    """The samplers take their graph path on the CPU too (outside
    graphs.disabled()), through _StubCapture."""
    monkeypatch.setattr(graphs, "Capture", _StubCapture)
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._eager)


@pytest.fixture
def stub_graphs(monkeypatch):
    """The samplers take their graph path on the CPU, through _StubCapture."""
    _stub(monkeypatch)
    graphs.release()
    graphs.reset_stats()
    yield
    graphs.release()
    graphs.reset_stats()


def _nb_case(seed=0, S=6, G=10, dtype=torch.float64, exclude=None):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 300, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    data, dims = nb_model.prepare_data(counts, X, rng.normal(0, 0.2, size=S), 3,
                                       exclude_mask=exclude, device="cpu", dtype=dtype)
    return nb_model.with_baseline(data, dims), dims


def _optax_steps(jdata, jdims, m0, noise):
    """optax.adam(LR / sqrt(1 + step / 100)) on the one-sample -ELBO, as
    ppcseq_tpu/infer/advi.py:60-96 builds it; the params after every step."""
    f = jnb.flat_logp(jdims, "fast")
    D = jdims.dim

    def loss(p, eps):
        theta = p["m"] + jnp.exp(p["log_s"]) * eps
        logps = jax.vmap(lambda th: f(th, jdata))(theta)
        return -(jnp.mean(logps) + jnp.sum(p["log_s"]) + 0.5 * D * (1.0 + jnp.log(2.0 * jnp.pi)))

    opt = optax.adam(lambda step: LR / jnp.sqrt(1.0 + step / 100.0))

    @jax.jit
    def step(p, s, eps):
        u, s = opt.update(jax.grad(loss)(p, eps), s, p)
        return optax.apply_updates(p, u), s

    p = {"m": jnp.asarray(m0), "log_s": jnp.full(D, -1.0)}
    s = opt.init(p)
    out = []
    for eps in noise:
        p, s = step(p, s, jnp.asarray(eps))
        out.append(p)
    return out


def test_captured_adam_chunks_match_optax_and_the_eager_steps(stub_graphs):
    """Three chunks of 10 Adam steps through CapturedFit (one step per
    replay) equal the eager advi_step loop bit for bit, and optax's 30 steps
    at rtol 1e-9 (float64); the captured ELBO equals the eager one."""
    rng = np.random.default_rng(0)
    jdata, jdims = jnb.prepare_data(rng.integers(0, 300, size=(6, 10)),
                                    np.column_stack([np.ones(6),
                                                     rng.integers(0, 2, size=6).astype(float)]),
                                    rng.normal(0, 0.2, size=6), 3, dtype=jnp.float64)
    jdata = jnb.with_baseline(jdata, jdims)
    data, dims = model_from_arrays(jdata, jdims, dtype=torch.float64)
    m0 = torch.as_tensor(np.asarray(jnb.smart_init(jdata, jdims)))
    log_s0 = torch.full((dims.dim,), -1.0, dtype=torch.float64)
    noise = torch.as_tensor(rng.normal(size=(30, 1, dims.dim)))
    logp = nb_model.flat_logp(dims, "fast")

    fit = advi.CapturedFit(logp, state_spec(dims.dim), data, m0, log_s0, eval_every=10,
                           grad_samples=1, elbo_samples=5, learning_rate=LR)
    fit.load(m0, log_s0, data)
    for c in range(3):
        fit.chunk(noise[10 * c:10 * c + 10])
    m, log_s = fit.result()

    params, state = {"m": m0, "log_s": log_s0}, adam_init({"m": m0, "log_s": log_s0})
    for k in range(30):
        params, state, _ = advi_step(params, state, noise[k], lambda th: logp(th, data), LR)
    assert torch.equal(m, params["m"]) and torch.equal(log_s, params["log_s"])
    assert int(state.count) == int(fit.count) == 30

    ref = _optax_steps(jdata, jdims, m0.numpy(), noise.numpy())[-1]
    np.testing.assert_allclose(m.numpy(), np.asarray(ref["m"]), rtol=1e-9)
    np.testing.assert_allclose(log_s.numpy(), np.asarray(ref["log_s"]), rtol=1e-9)

    eps = torch.as_tensor(rng.normal(size=(5, dims.dim)))
    want = advi.elbo_estimate(lambda th: logp(th, data), m, log_s, eps)
    assert torch.equal(fit.elbo(eps), want)
    assert graphs.STATS["replays"] == 3 * 10 + 1


def _fit_kw(data, dims):
    return dict(data=data, init_mean=nb_model.smart_init(data, dims), max_iter=60,
                eval_every=20, elbo_samples=7, device="cpu", dtype=torch.float64)


def _same_fit(a, b):
    return (torch.equal(a.mean, b.mean) and torch.equal(a.log_sd, b.log_sd)
            and np.array_equal(a.elbo_trace, b.elbo_trace) and a.iterations == b.iterations)


def test_fit_advi_and_vb_iterative_through_graphs_are_the_eager_fits(monkeypatch):
    """fit_advi and vb_iterative on the graph path (stub) give the eager
    fits' mean, log_sd and ELBO trace bit for bit, on the NB model (data as
    an operand, float64 and float32, "fast" and "plain") and on a
    structured state; the eager fits are those tests/test_torch_advi.py
    holds against the JAX package."""
    data, dims = _nb_case()
    data32, _ = _nb_case(dtype=torch.float32)
    gauss_mu = torch.tensor([1.5, -2.0, 0.5], dtype=torch.float64)

    def gauss(tree):
        return -0.5 * torch.sum((tree["x"] - gauss_mu) ** 2, dim=-1) - 0.5 * tree["y"][..., 0] ** 2

    proto = {"x": torch.zeros(3, dtype=torch.float64), "y": torch.zeros(1, dtype=torch.float64)}
    cases = [
        (fit_advi, nb_model.flat_logp(dims, "fast"), dims.dim, _fit_kw(data, dims)),
        (fit_advi, nb_model.flat_logp(dims, "plain"), dims.dim, _fit_kw(data, dims)),
        (fit_advi, nb_model.flat_logp(dims, "fast"), dims.dim,
         dict(_fit_kw(data32, dims), dtype=torch.float32)),
        (vb_iterative, nb_model.flat_logp(dims, "fast"), dims.dim, _fit_kw(data, dims)),
        (fit_advi, gauss, proto, dict(max_iter=300, eval_every=100, learning_rate=0.05,
                                      device="cpu", dtype=torch.float64)),
    ]
    for fn, logp, proto_, kw in cases:
        eager = fn(logp, proto_, torch.Generator().manual_seed(4), **kw)
        with monkeypatch.context() as mp:
            _stub(mp)
            graphs.reset_stats()
            got = fn(logp, proto_, torch.Generator().manual_seed(4), **kw)
            assert graphs.STATS["captures"] == 2 and graphs.STATS["replays"] > 0
            graphs.release()
        if isinstance(proto_, dict):
            assert all(torch.equal(got.mean[k], eager.mean[k]) for k in proto_)
            assert all(torch.equal(got.log_sd[k], eager.log_sd[k]) for k in proto_)
            np.testing.assert_allclose(got.mean["x"].numpy(), gauss_mu.numpy(), atol=0.15)
        else:
            assert _same_fit(got, eager), fn.__name__


def test_captured_leapfrogs_are_the_eager_leapfrogs(stub_graphs):
    """CapturedTrajectory: L leapfrogs as replays of one captured leapfrog
    over static buffers equal the eager leapfrog loop bit for bit (NB model
    through "fast", float32, 5 chains), twice from other states."""
    data, dims = _nb_case(dtype=torch.float32)
    logp = nb_model.flat_logp(dims, "fast")
    gen = torch.Generator().manual_seed(2)
    z = torch.as_tensor(nb_model.smart_init(data, dims), dtype=torch.float32)[None].repeat(5, 1)
    z = z + 0.05 * torch.randn(z.shape, generator=gen)
    inv_mass = 0.5 + torch.rand(dims.dim, generator=gen)
    traj = hmc.CapturedTrajectory(logp, data, z, inv_mass)
    traj.load(data, inv_mass)
    grad_fn = lambda x: hmc.logp_and_grad(logp, x, data)  # noqa: E731
    eager = hmc.eager_trajectory(grad_fn, inv_mass)
    for L in (7, 3):
        lp, g = grad_fn(z)
        r = torch.randn(z.shape, generator=gen)
        eps = torch.tensor(0.01, dtype=torch.float32)
        got, want = traj.run(z, r, g, lp, eps, L), eager(z, r, g, lp, eps, L)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        z = got[0]


@pytest.mark.parametrize("chees", [False, True], ids=["jittered", "chees"])
def test_run_hmc_through_graphs_draws_the_eager_draws(chees, monkeypatch):
    """run_hmc (jittered HMC and ChEES) on the graph path draws the eager
    run's draws bit for bit, with the same step size and leapfrog count."""
    data, dims = _nb_case(dtype=torch.float32)
    kw = dict(data=data, num_chains=4, num_warmup=6, num_draws=4, num_leapfrog=6,
              init_theta=nb_model.smart_init(data, dims), adapt_trajectory=chees,
              device="cpu")
    logp = nb_model.flat_logp(dims)
    eager = hmc.run_hmc(logp, dims.dim, torch.Generator().manual_seed(5), **kw)
    _stub(monkeypatch)
    graphs.reset_stats()
    got = hmc.run_hmc(logp, dims.dim, torch.Generator().manual_seed(5), **kw)
    graphs.release()
    assert torch.equal(got.draws, eager.draws)
    assert got.step_size == eager.step_size and got.num_leapfrog == eager.num_leapfrog
    assert np.array_equal(got.accept_prob, eager.accept_prob)
    assert graphs.STATS["captures"] == 1
    assert graphs.STATS["replays"] == got.num_leapfrog // 4


@pytest.mark.parametrize("chees", [False, True], ids=["jittered", "chees"])
def test_run_hmc_under_a_chains_mesh_replays_the_leapfrog(chees, stub_graphs, tmp_path):
    """Under a chains-only mesh (a `chains` axis over a one-rank gloo group)
    run_hmc takes the captured leapfrog, its chain collectives (the accept
    means, ChEES's statistics, the gathers) staying eager, and draws the
    run of graphs.disabled() bit for bit; a genes axis over gloo (whose
    all-reduce no graph can hold) keeps the eager leapfrogs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ppcseq_tpu_torch.parallel import sharding

    data, dims = _nb_case(dtype=torch.float32)
    kw = dict(data=data, num_chains=4, num_warmup=6, num_draws=4, num_leapfrog=6,
              init_theta=nb_model.smart_init(data, dims), adapt_trajectory=chees,
              device="cpu")
    logp = nb_model.flat_logp(dims)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("chains",))
        got = hmc.run_hmc(logp, dims.dim, torch.Generator().manual_seed(5), mesh=mesh, **kw)
        assert graphs.STATS["captures"] == 1
        assert graphs.STATS["replays"] == got.num_leapfrog // 4
        with graphs.disabled():
            eager = hmc.run_hmc(logp, dims.dim, torch.Generator().manual_seed(5), mesh=mesh,
                                **kw)
        genes = sharding.Layout.from_mesh(
            init_device_mesh("cpu", (1,), mesh_dim_names=("genes",)), dims)
        sharded = hmc._trajectory(logp, data, None, torch.zeros((2, dims.dim)),
                                  torch.ones(dims.dim), genes, "cpu")
    finally:
        dist.destroy_process_group()
    assert got.chains == eager.chains == (0, 4)
    assert torch.equal(got.draws, eager.draws)
    assert got.step_size == eager.step_size and got.num_leapfrog == eager.num_leapfrog
    assert np.array_equal(got.accept_prob, eager.accept_prob)
    assert sharded.__name__ == "trajectory"  # eager_trajectory's


def test_fit_advi_without_a_gene_shard_replays_graphs(stub_graphs):
    """A layout with no gene shard (the MCMC warm start under a chains-only
    mesh) runs no collective in ADVI: fit_advi takes the single-device fit,
    captured, and gives the eager fit's bits."""
    from types import SimpleNamespace

    data, dims = _nb_case()
    logp = nb_model.flat_logp(dims)
    kw = dict(_fit_kw(data, dims), layout=SimpleNamespace(genes=None))
    got = fit_advi(logp, dims.dim, torch.Generator().manual_seed(3), **kw)
    assert graphs.STATS["captures"] == 2 and graphs.STATS["replays"] > 0
    with graphs.disabled():
        eager = fit_advi(logp, dims.dim, torch.Generator().manual_seed(3), **kw)
    assert _same_fit(got, eager)


def test_run_hmc_tree_replays_one_capture_across_calls(stub_graphs):
    """run_hmc_tree binds its structured density anew at every call; equal
    bindings (StateSpec.bind) keep one cache key, so a second run of the
    same shapes replays the first run's leapfrog capture, and both draw the
    eager runs' numbers."""
    mu = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)

    def tree_gauss(tree):
        return (-0.5 * torch.sum((tree["x"] - mu[:2]) ** 2, dim=-1)
                - 0.5 * (tree["y"][..., 0] - mu[2]) ** 2)

    proto = {"x": torch.zeros(2, dtype=torch.float64), "y": torch.zeros(1, dtype=torch.float64)}
    spec = state_spec(proto)
    assert spec.bind(tree_gauss) == spec.bind(tree_gauss) != spec.bind(lambda t: tree_gauss(t))
    kw = dict(num_chains=3, num_warmup=4, num_draws=3, num_leapfrog=3, device="cpu",
              dtype=torch.float64)
    for seed, captures in ((1, 1), (2, 1)):
        got = hmc.run_hmc_tree(tree_gauss, proto, torch.Generator().manual_seed(seed), **kw)
        assert graphs.STATS["captures"] == captures
        with graphs.disabled():
            eager = hmc.run_hmc_tree(tree_gauss, proto, torch.Generator().manual_seed(seed),
                                     **kw)
        assert all(torch.equal(got.draws[k], eager.draws[k]) for k in proto)


def test_cache_reuses_one_capture_across_data_and_replaces_it_on_a_new_shape(stub_graphs):
    """Two fits of flat_logp(dims) with other data of the same shapes (another
    like_mask, so another baseline) replay the first fit's capture, each
    giving the eager fit of its own data; a fit at another G captures anew
    and replaces the entry."""
    fits = []
    for seed, G, exclude in ((0, 10, None), (1, 10, "some"), (2, 12, None)):
        mask = None if exclude is None else np.random.default_rng(9).uniform(size=(6, G)) < 0.2
        data, dims = _nb_case(seed=seed, G=G, exclude=mask)
        logp = nb_model.flat_logp(dims)
        assert logp is nb_model.flat_logp(dims)  # a stable identity: the cache key
        got = fit_advi(logp, dims.dim, torch.Generator().manual_seed(1), **_fit_kw(data, dims))
        fits.append((dict(graphs.STATS), graphs._CACHE["advi"][0]))
        with graphs.disabled():
            eager = fit_advi(logp, dims.dim, torch.Generator().manual_seed(1),
                             **_fit_kw(data, dims))
        assert _same_fit(got, eager), seed
    (s0, k0), (s1, k1), (s2, k2) = fits
    assert s0["captures"] == s1["captures"] == 2 and k0 == k1
    assert s2["captures"] == 4 and k2 != k1 and list(graphs._CACHE) == ["advi"]


def test_replays_add_the_launches_their_capture_holds(stub_graphs, monkeypatch):
    """A region counts one launch per call of a density that launches once:
    the warm-up's and the capture's go to STATS["build_launches"], every
    replay adds the capture's to LAUNCHES, and a fit through graphs counts
    what the eager fit counts."""
    calls = []

    def launching(theta):  # stands in for a density that launches K1 once
        calls.append(1)
        nb_kernel.LAUNCHES["nb_glm_delta"] += 1
        return -0.5 * torch.sum(theta * theta, dim=-1)

    nb_kernel.reset_launches()
    theta = torch.zeros((1, 3))
    region = graphs.Region(lambda: launching(theta), "cpu", "test region")
    assert nb_kernel.LAUNCHES["nb_glm_delta"] == 0 and len(calls) == graphs.WARMUP_RUNS + 1
    assert region.launches == {"nb_glm_delta": 1}
    assert graphs.STATS["build_launches"] == {"nb_glm_delta": graphs.WARMUP_RUNS + 1}
    region.replay(5)
    assert nb_kernel.LAUNCHES["nb_glm_delta"] == 5 and graphs.STATS["replays"] == 5

    kw = dict(max_iter=200, eval_every=50, elbo_samples=4, tol_rel_obj=0.0, device="cpu")
    nb_kernel.reset_launches()
    fit_advi(launching, 3, torch.Generator().manual_seed(0), **kw)
    through_graphs = nb_kernel.LAUNCHES["nb_glm_delta"]
    nb_kernel.reset_launches()
    with graphs.disabled():
        fit_advi(launching, 3, torch.Generator().manual_seed(0), **kw)
    assert through_graphs == nb_kernel.LAUNCHES["nb_glm_delta"] == 200 + 4
    nb_kernel.reset_launches()


def test_data_operand_buffers():
    """static_operand clones a ModelData's tensors (keeping its host
    mirrors), load_operand copies another's in, and operand_key tells
    shapes apart but not values."""
    a, _ = _nb_case(seed=0)
    b, _ = _nb_case(seed=1)
    c, _ = _nb_case(seed=0, G=12)
    static = graphs.static_operand(a)
    assert static.counts is not a.counts and torch.equal(static.counts, a.counts)
    assert static.host["like_mask"] is a.host["like_mask"] and static.alpha0 is not a.alpha0
    graphs.load_operand(static, b)
    assert torch.equal(static.d0, b.d0) and not torch.equal(static.d0, a.d0)
    assert graphs.operand_key(a) == graphs.operand_key(b) != graphs.operand_key(c)
    nested = {"w": torch.ones(2), "pair": (torch.zeros(3), None), "n": 4}
    assert graphs.operand_key(nested) != graphs.operand_key(dict(nested, n=5))
    copy = graphs.static_operand(nested)
    assert copy["pair"][1] is None and copy["n"] == 4 and copy["w"] is not nested["w"]


def test_identify_outliers_replays_one_capture_for_both_passes(monkeypatch):
    """The reference's 3-gene case on the VB branch through graphs (stub):
    both passes replay one capture of the step and one of the ELBO, the
    table and the VB iterations are the eager run's, and the graphs are
    released at the end."""
    from ppcseq_tpu_torch import identify_outliers, load_counts

    counts = load_counts()
    counts = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    kw = dict(formula="~ Label", sample="sample", transcript="symbol", abundance="value",
              significance="PValue", do_check="is_significant", percent_false_positive_genes=1,
              how_many_negative_controls=50, seed=42, device="cpu")
    eager = identify_outliers(counts, **kw)
    _stub(monkeypatch)
    graphs.reset_stats()
    got = identify_outliers(counts, **kw)
    assert graphs.STATS["captures"] == 2 and graphs._CACHE == {}
    assert got.attrs["vb_iterations"] == eager.attrs["vb_iterations"]
    assert dict(zip(got.symbol, got.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    for a, b in zip(got.sample_wise_data, eager.sample_wise_data):
        assert a.equals(b)
    graphs.reset_stats()


def test_kernel_launches_reads_each_kernels_device_symbols():
    """profile_advi.kernel_launches (phase graphs' device-side launch count)
    maps each kernel's CUDA functions, tile_kernel and row_kernel over its
    form of csrc/nb_tile.cuh, to its nb_kernel.LAUNCHES name, in the
    profiler's and cu++filt's spellings, and counts no other kernel."""
    from types import SimpleNamespace

    from ppcseq_tpu_torch.utils.profile_advi import KERNEL_SYMBOLS, kernel_launches

    forms = {"nb_glm_delta": ("Fast", True), "nb_glm_plain": ("Fast", False),
             "nb_glm_fused": ("Fused", None), "nb_glm_stable_fwd": ("Stable", False),
             "nb_glm_stable_bwd": ("Stable", True), "nb_glm_delta_f64": ("Fast64", True),
             "nb_glm_plain_f64": ("Fast64", False)}
    assert set(KERNEL_SYMBOLS) == set(forms) == set(nb_kernel.KERNELS)

    def event(key, count, device="CUDA"):
        return SimpleNamespace(key=key, count=count, device_type=SimpleNamespace(name=device))

    events, want = [], {}
    for i, (name, (form, flag)) in enumerate(sorted(forms.items())):
        for j, (ns, spell) in enumerate((("(anonymous namespace)::", str), ("<unnamed>::",
                                         lambda f: f"(bool){int(f)}"))):
            arg = "" if flag is None else f"<{spell(flag).lower()}>"
            grads = "true" if j == 0 else "(bool)1"
            kernel = ("tile_kernel", "row_kernel")[(i + j) % 2]
            events.append(event(f"void {ns}{kernel}<{ns}{form}{arg}, 2, {grads}>"
                                f"(nbk::InputsT<float, double>, int, int, int)", 3 + i + j))
            want[name] = want.get(name, 0) + 3 + i + j
    events += [event("void at::native::vectorized_elementwise_kernel<4, Fast<true>>", 7),
               event("cudaLaunchKernel", 9, device="CPU"),
               event("void (anonymous namespace)::tile_kernel<Fast<true>, 2, true>(...)", 5,
                     device="CPU")]
    assert kernel_launches(events) == want
