"""The CUDA likelihood kernels against their plain torch versions, a short
HMC run through each likelihood route, short NUTS and ChEES runs
through "fast", the command-line entry point, and the samplers' CUDA
graphs against their eager loops (bit for bit), on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. They import
no JAX, so the card can run them without the JAX package's test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ppcseq_tpu_torch.infer import graphs
from ppcseq_tpu_torch.infer.advi import fit_advi
from ppcseq_tpu_torch.infer.hmc import run_hmc
from ppcseq_tpu_torch.infer import nuts
from ppcseq_tpu_torch.infer.hmc import logp_and_grad
from ppcseq_tpu_torch.infer.nuts import run_nuts
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.ops import nb, nb_fast, nb_grad, nb_kernel

pytestmark = pytest.mark.cuda


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.fixture(params=[1, 2, 3], ids=lambda c: f"C{c}")
def cuda_case(request):
    """Float32 model data on the card (one fully masked gene, ~5% excluded
    points) with C design columns, and B=5 parameter rows, from a numpy
    seed."""
    _needs_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    S, G, C, B = 21, 300, request.param, 5
    X = np.column_stack([np.ones(S)] + [rng.integers(0, 2, S).astype(float) for _ in range(C - 1)])
    alpha_true = np.concatenate([rng.normal(4.0, 1.0, (1, G)), rng.normal(0.0, 0.5, (C - 1, G))])
    exposure = rng.normal(0.0, 0.3, S)
    counts = rng.poisson(np.minimum(np.exp(exposure[:, None] + X @ alpha_true), 1e6))
    exclude = rng.uniform(size=(S, G)) < 0.05
    exclude[:, 11] = True
    data, dims = nb_model.prepare_data(counts, X, exposure, 4, exclude_mask=exclude,
                                       device=dev, dtype=torch.float32)
    data = nb_model.with_baseline(data, dims)
    alpha = torch.as_tensor(alpha_true[None] + rng.normal(0, 0.1, (B, C, G)),
                            dtype=torch.float32, device=dev)
    log_phi = torch.as_tensor(rng.normal(0.0, 1.0, (B, G)), dtype=torch.float32, device=dev)
    return data, alpha, log_phi


def _scaled(got, want):
    """max |got - want| / (1 + |want|), elementwise."""
    want = want.double()
    return float(((got.double() - want).abs() / (1 + want.abs())).max())


def _within(got, want, rtol, atol):
    """assert_allclose's |got - want| <= atol + rtol |want|."""
    return bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all())


def _f64(data):
    return dataclasses.replace(data, **{
        f.name: getattr(data, f.name).double() for f in dataclasses.fields(data)
        if f.name != "host" and getattr(data, f.name) is not None
        and getattr(data, f.name).is_floating_point()})


def _launch(data, alpha, log_phi, kernel):
    """The kernel's (value, dalpha, dlog_phi); "nb_glm_stable" is K5."""
    d = data
    if kernel == "nb_glm_delta":
        return nb_kernel.launch_delta(d.X, d.counts, d.like_mask, d.d0, alpha, d.alpha0, log_phi,
                                      d.sigma_raw0, want_grads=True)
    if kernel == "nb_glm_plain":
        return nb_kernel.launch_plain(d.X, d.exposure_rate, d.counts, d.like_mask, alpha,
                                      log_phi, want_grads=True)
    if kernel == "nb_glm_fused":
        return nb_kernel.launch_fused(d.X, d.counts, d.like_mask, d.d0, alpha, d.alpha0, log_phi,
                                      d.sigma_raw0, want_grads=True)
    return nb_kernel.launch_stable_bwd(d.X, d.exposure_rate, d.counts, d.like_mask, alpha,
                                       log_phi)  # nb_glm_stable(_bwd)


def _plain(data, alpha, log_phi, kernel):
    """The plain version's (value, dalpha, dlog_phi) of `kernel`."""
    d = data
    if kernel == "nb_glm_delta":
        return nb_fast.glm_delta(d.X, d.counts, d.like_mask, d.alpha0, d.sigma_raw0, d.d0,
                                 d.sp_d0, d.sig_neg_d0, d.y_sp0, alpha, log_phi, True)
    if kernel == "nb_glm_plain":
        return nb_fast.glm_plain(d.X, d.exposure_rate, d.counts, d.like_mask, alpha, log_phi,
                                 True)
    grads = nb_grad.likelihood_grads(d.X, d.exposure_rate, d.counts, d.like_mask, alpha, log_phi)
    value = (nb_model.delta_likelihood if kernel == "nb_glm_fused"
             else nb_model.stable_likelihood)(d, alpha, log_phi)
    return (value, *grads)


# Values are held at rtol 2e-5 and gradients at |d|/(1+|g|) < 1e-4 against
# the plain version. K3 computes the gradient at another d than its plain
# version; where the plain float32 gradient is itself 1e-4 or more from
# float64, it is held instead at tests/test_nb_kernel.py's tolerances (rtol,
# atol(want)) AND at most a stated multiple of the plain version's own
# |d|/(1+|g|) from float64 (1.2x measured on the H100 at the chip_smoke.py
# shapes). K5 computes the plain version's terms at its d: no fallback.
_GRAD_FALLBACK = {
    "nb_glm_fused": (2e-3, lambda w: 2e-3 * (1 + float(w.abs().max())), 2.0),
}


def _grads_ok(kernel, kern, plain, plain64):
    if all(_scaled(k, p) < 1e-4 for k, p in zip(kern, plain)):
        return True
    if kernel not in _GRAD_FALLBACK:
        return False
    rtol, atol, multiple = _GRAD_FALLBACK[kernel]
    p64 = max(_scaled(p, w) for p, w in zip(plain, plain64))
    return p64 >= 1e-4 and all(
        _within(k, p, rtol, atol(p)) and _scaled(k, w) <= multiple * p64
        for k, p, w in zip(kern, plain, plain64))


@pytest.mark.parametrize("kernel", ["nb_glm_delta", "nb_glm_plain", "nb_glm_fused",
                                    "nb_glm_stable"])
def test_kernel_matches_plain_version(cuda_case, kernel):
    """Each kernel against its plain version (value rtol 2e-5; gradients as
    _grads_ok); exactly zero gradients for the masked gene; one launch
    counted per kernel call."""
    data, alpha, log_phi = cuda_case
    nb_kernel.reset_launches()
    kern = _launch(data, alpha, log_phi, kernel)
    torch.cuda.synchronize()
    assert nb_kernel.LAUNCHES[{"nb_glm_stable": "nb_glm_stable_bwd"}.get(kernel, kernel)] == 1
    assert sum(nb_kernel.LAUNCHES.values()) == 1
    plain = _plain(data, alpha, log_phi, kernel)
    plain64 = _plain(_f64(data), alpha.double(), log_phi.double(), kernel)
    assert kern[0].dtype == plain[0].dtype == torch.float64  # both sum into float64
    assert kern[1].dtype == kern[2].dtype == torch.float32
    np.testing.assert_allclose(kern[0].cpu().numpy(), plain[0].cpu().numpy(), rtol=2e-5)
    assert _grads_ok(kernel, kern[1:], plain[1:], plain64[1:])
    assert torch.all(kern[1][:, :, 11] == 0) and torch.all(kern[2][:, 11] == 0)


# entry -> (kernel whose gradients autograd must return, launches of one
# autograd call plus one no_grad call)
_ENTRIES = {
    "nb_glm_likelihood_fast": ("nb_glm_delta", {"nb_glm_delta": 2}),
    "nb_glm_likelihood_fast-nobaseline": ("nb_glm_plain", {"nb_glm_plain": 2}),
    "nb_glm_likelihood": ("nb_glm_stable_bwd", {"nb_glm_stable_bwd": 1, "nb_glm_stable_fwd": 1}),
    "nb_glm_likelihood_fused": ("nb_glm_fused", {"nb_glm_fused": 2}),
}


@pytest.mark.parametrize("entry", list(_ENTRIES))
def test_entries_launch_their_kernels(cuda_case, entry):
    """Autograd and no_grad calls of each entry launch the kernels of its
    route and nothing else, and autograd returns exactly the gradients the
    route's kernel gives when launched directly."""
    data, alpha, log_phi = cuda_case
    if entry.endswith("-nobaseline"):
        data = dataclasses.replace(data, d0=None, alpha0=None, sigma_raw0=None, sp_d0=None,
                                   sig_neg_d0=None, y_sp0=None)
    fn = getattr(nb_kernel, entry.split("-")[0])
    kernel, want = _ENTRIES[entry]
    a = alpha.clone().requires_grad_(True)
    p = log_phi.clone().requires_grad_(True)
    nb_kernel.reset_launches()
    value = fn(data, a, p)
    value.sum().backward()
    with torch.no_grad():
        v_only = fn(data, alpha, log_phi)
    torch.cuda.synchronize()
    assert {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == want
    np.testing.assert_allclose(v_only.cpu().numpy(), value.detach().cpu().numpy(), rtol=1e-6)
    _, dak, dlk = _launch(data, alpha, log_phi, kernel)
    torch.cuda.synchronize()
    assert torch.equal(a.grad, dak) and torch.equal(p.grad, dlk)


def _ragged_case(B, S, G, seed=3, dev="cuda"):
    """Float32 model data on the card at any (S, G), two design columns,
    gene 0 fully masked (when G > 1), ~3% excluded points, B parameter
    rows."""
    dev = torch.device(dev)
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(S), (np.arange(S) % 2).astype(float)])
    alpha_true = np.stack([rng.normal(3.0, 1.5, G), rng.normal(0.0, 0.5, G)])
    exposure = rng.normal(0.0, 0.3, S)
    counts = rng.poisson(np.minimum(np.exp(exposure[:, None] + X @ alpha_true), 1e6))
    exclude = rng.uniform(size=(S, G)) < 0.03
    exclude[:, 0] = G > 1
    data, dims = nb_model.prepare_data(counts, X, exposure, min(4, G), exclude_mask=exclude,
                                       device=dev, dtype=torch.float32)
    data = nb_model.with_baseline(data, dims)
    alpha = torch.as_tensor(alpha_true[None] + rng.normal(0, 0.1, (B, 2, G)),
                            dtype=torch.float32, device=dev)
    log_phi = torch.as_tensor(rng.normal(1.0, 1.5, (B, G)), dtype=torch.float32, device=dev)
    return data, alpha, log_phi


def _k3_grads_at_its_d(data, alpha, log_phi):
    """K3's gradients by the plain version's formulas (nb_grad.nb2_grads),
    in float32, at K3's own d = d0 + X (alpha - alpha0) - (min(log_phi, 80)
    + sigma_raw0) in its order of operations: the plain version of K3's
    arithmetic point by point, so that only the order of the sums over S
    differs. (Against likelihood_grads, which takes d = eta - log_phi, K3's
    float32 gradient differs by the rounding of d times the O(phi)
    sensitivity of near-Poisson genes: ~3e-4 scaled at this data.)"""
    lpc = torch.clamp(log_phi, max=nb_grad.LOG_PHI_CAP)[:, None, :]
    d = data.d0[None] + (nb_fast._eta_small(data.X, torch.zeros_like(data.X[:, 0]),
                                            alpha - data.alpha0)
                         - (lpc + data.sigma_raw0[None, None, :]))
    yf = data.counts.to(torch.float32)
    em = torch.exp(-torch.abs(d))
    q = torch.where(d > 0, em / (1.0 + em), 1.0 / (1.0 + em))
    deta = yf * q - torch.exp(lpc - nb._softplus(-d))
    dlogphi = torch.where(
        log_phi[:, None, :] < nb_grad.LOG_PHI_CAP,
        nb_grad.phi_digamma_diff(yf, torch.exp(lpc))
        - nb_grad.phi_softplus_minus_sigmoid(d, lpc) - yf * q, 0.0)
    return (nb_fast._dalpha_small(data.X, data.like_mask * deta),
            torch.sum(data.like_mask * dlogphi, dim=1))


# (B, S, G): one row and many S-chunks with a ragged last tile; B above the
# b-chunk (8) with S-chunks and G not a multiple of the tile; the bundled
# width with B above the b-chunk; the row layout (B >= 32, S <= 32) with a
# ragged last block; a single gene and a single sample
_RAGGED = [(1, 601, 9001), (9, 601, 4201), (17, 21, 515), (33, 21, 300), (3, 1, 1), (2, 21, 1)]


def _value_only(data, alpha, log_phi, kernel):
    d = data
    if kernel == "nb_glm_delta":
        return nb_kernel.launch_delta(d.X, d.counts, d.like_mask, d.d0, alpha, d.alpha0,
                                      log_phi, d.sigma_raw0, want_grads=False)
    if kernel == "nb_glm_plain":
        return nb_kernel.launch_plain(d.X, d.exposure_rate, d.counts, d.like_mask, alpha,
                                      log_phi, want_grads=False)
    if kernel == "nb_glm_fused":
        return nb_kernel.launch_fused(d.X, d.counts, d.like_mask, d.d0, alpha, d.alpha0,
                                      log_phi, d.sigma_raw0, want_grads=False)
    return nb_kernel.launch_stable_fwd(d.X, d.exposure_rate, d.counts, d.like_mask, alpha,
                                       log_phi)


# layout()'s rule: the stable form (K4, K5) is tiled at every shape
_ALWAYS_TILED = ("nb_glm_stable_fwd", "nb_glm_stable_bwd")


def _check_ragged(kernel, B, S, G):
    """The kernel against its plain version at value rtol 2e-5 and gradient
    |d|/(1+|g|) < 1e-4 where the layout has several S-chunks, a partial
    gene tile, a partial b-chunk, or is the row layout; the masked gene's
    gradients are 0; the value-only launch gives the same value.

    K3's gradient, the decision: its strict limit (< 1e-4) is taken
    against the plain formulas at K3's own d = d0 + dlo
    (_k3_grads_at_its_d), because the plain version likelihood_grads takes
    d = eta - log_phi and the two d differ by float32 rounding times the
    O(phi) sensitivity of near-Poisson genes: 1.2e-4 to 1.6e-3 (scaled) on
    these inputs, where _grads_ok fails at four of the shapes (PERF.md
    section 7 has the readings). Against likelihood_grads, in float32 and
    in float64, K3 is held at tests/test_nb_kernel.py's tolerance for the
    fused kernel (_GRAD_FALLBACK's rtol, atol). Every value, K3's too,
    is float64 and meets rtol 2e-5 against its plain version."""
    data, alpha, log_phi = _ragged_case(B, S, G)
    lay = nb_kernel.layout(kernel, B, S, 2, G)
    if S == 601:
        assert lay["n_chunks"] > 1 and G % lay["T"] != 0
    assert (lay["SY"] == 0) == (B == 33 and kernel not in _ALWAYS_TILED)
    value_only = _value_only(data, alpha, log_phi, kernel)
    assert value_only.dtype == torch.float64
    if kernel == "nb_glm_stable_fwd":
        want = nb_model.stable_likelihood(data, alpha, log_phi)
        np.testing.assert_allclose(value_only.cpu().numpy(), want.cpu().numpy(), rtol=2e-5)
        return
    kern = _launch(data, alpha, log_phi, kernel)
    plain = _plain(data, alpha, log_phi, kernel)
    np.testing.assert_allclose(kern[0].cpu().numpy(), plain[0].cpu().numpy(), rtol=2e-5)
    want = _k3_grads_at_its_d(data, alpha, log_phi) if kernel == "nb_glm_fused" else plain[1:]
    assert _scaled(kern[1], want[0]) < 1e-4 and _scaled(kern[2], want[1]) < 1e-4
    if kernel == "nb_glm_fused":
        plain64 = _plain(_f64(data), alpha.double(), log_phi.double(), kernel)
        rtol, atol, _ = _GRAD_FALLBACK[kernel]
        assert all(_within(k, p, rtol, atol(p))
                   for ref in (plain, plain64) for k, p in zip(kern[1:], ref[1:]))
    if G > 1:
        assert torch.all(kern[1][:, :, 0] == 0) and torch.all(kern[2][:, 0] == 0)
    np.testing.assert_allclose(value_only.cpu().numpy(), plain[0].cpu().numpy(), rtol=2e-5)


@pytest.mark.parametrize("kernel", ["nb_glm_delta", "nb_glm_plain"])
@pytest.mark.parametrize("B,S,G", _RAGGED, ids=[f"B{b}-S{s}-G{g}" for b, s, g in _RAGGED])
def test_k12_ragged_edges_match_plain(kernel, B, S, G):
    """K1/K2 at value rtol 2e-5 and gradient |d|/(1+|g|) < 1e-4 (_check_ragged)."""
    _needs_card()
    _check_ragged(kernel, B, S, G)


@pytest.mark.parametrize("kernel", ["nb_glm_fused", "nb_glm_stable_fwd"])
@pytest.mark.parametrize("B,S,G", _RAGGED, ids=[f"B{b}-S{s}-G{g}" for b, s, g in _RAGGED])
def test_k3_k4_ragged_edges_match_plain(kernel, B, S, G):
    """K3/K4 at value rtol 2e-5; K3's gradient as _check_ragged says."""
    _needs_card()
    _check_ragged(kernel, B, S, G)


@pytest.mark.parametrize("B,S,G", _RAGGED, ids=[f"B{b}-S{s}-G{g}" for b, s, g in _RAGGED])
def test_k5_ragged_edges_match_plain(B, S, G):
    """K5's value at rtol 2e-5 against stable_likelihood and its gradients
    at |d|/(1+|g|) < 1e-4 against likelihood_grads (no fallback), exactly
    zero for the masked gene (_check_ragged)."""
    _needs_card()
    _check_ragged("nb_glm_stable_bwd", B, S, G)


def _launch_any(data, alpha, log_phi, kernel):
    if kernel == "nb_glm_stable_fwd":
        return (_value_only(data, alpha, log_phi, kernel),)
    return _launch(data, alpha, log_phi, kernel)


@pytest.mark.parametrize("kernel", ["nb_glm_delta", "nb_glm_plain"])
def test_k12_bitwise_repeatable(kernel):
    """50 launches give the same value and gradients bit for bit (fixed
    reduction orders, no atomics on the sums)."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(9, 601, 4201)
    first = _launch(data, alpha, log_phi, kernel)
    for _ in range(49):
        again = _launch(data, alpha, log_phi, kernel)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("kernel", ["nb_glm_fused", "nb_glm_stable_fwd"])
@pytest.mark.parametrize("B,S,G", [(9, 601, 4201), (40, 21, 515)], ids=["B9-S601", "B40-S21"])
def test_k3_k4_bitwise_repeatable(kernel, B, S, G):
    """As test_k12_bitwise_repeatable for K3 and K4 (K3 in both layouts)."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(B, S, G)
    first = _launch_any(data, alpha, log_phi, kernel)
    for _ in range(49):
        again = _launch_any(data, alpha, log_phi, kernel)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("B,S,G", [(9, 601, 4201), (40, 21, 515)], ids=["B9-S601", "B40-S21"])
def test_k5_bitwise_repeatable(B, S, G):
    """As test_k12_bitwise_repeatable for K5's value and gradients."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(B, S, G)
    first = _launch(data, alpha, log_phi, "nb_glm_stable_bwd")
    for _ in range(49):
        again = _launch(data, alpha, log_phi, "nb_glm_stable_bwd")
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_k12_ticket_survives_many_launches():
    """1,000 back-to-back launches on one stream, K1 in the row layout and
    K2 in the tiled one alternating: every value right and the shared
    ticket back at 0."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(40, 21, 515)
    want = _launch(data, alpha, log_phi, "nb_glm_delta")[0]
    want_plain = _launch(data, alpha[:1], log_phi[:1], "nb_glm_plain")[0]
    got = []
    for i in range(500):
        got.append(_launch(data, alpha, log_phi, "nb_glm_delta")[0])
        got.append(_launch(data, alpha[:1], log_phi[:1], "nb_glm_plain")[0])
    torch.cuda.synchronize()
    assert all(torch.equal(v, want) for v in got[0::2])
    assert all(torch.equal(v, want_plain) for v in got[1::2])
    stream = torch.cuda.current_stream().cuda_stream
    assert int(nb_kernel._TICKETS[(alpha.device.index, stream)].item()) == 0


def test_k3_k4_ticket_survives_many_launches():
    """1,000 back-to-back launches on the stream's one ticket, K3 in the row
    layout and K4 in the tiled one alternating: every value right and the
    ticket back at 0."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(40, 21, 515)
    want = _launch(data, alpha, log_phi, "nb_glm_fused")[0]
    want4 = _value_only(data, alpha[:1], log_phi[:1], "nb_glm_stable_fwd")
    got = []
    for i in range(500):
        got.append(_launch(data, alpha, log_phi, "nb_glm_fused")[0])
        got.append(_value_only(data, alpha[:1], log_phi[:1], "nb_glm_stable_fwd"))
    torch.cuda.synchronize()
    assert all(torch.equal(v, want) for v in got[0::2])
    assert all(torch.equal(v, want4) for v in got[1::2])
    stream = torch.cuda.current_stream().cuda_stream
    assert int(nb_kernel._TICKETS[(alpha.device.index, stream)].item()) == 0


def test_k5_ticket_survives_many_launches():
    """1,000 back-to-back launches on the stream's one ticket, K5 at B = 40
    (five b-chunks) and at B = 1 alternating: every output right and the
    ticket back at 0."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(40, 21, 515)
    want = _launch(data, alpha, log_phi, "nb_glm_stable_bwd")
    want1 = _launch(data, alpha[:1], log_phi[:1], "nb_glm_stable_bwd")
    got = []
    for i in range(500):
        got.append(_launch(data, alpha, log_phi, "nb_glm_stable_bwd"))
        got.append(_launch(data, alpha[:1], log_phi[:1], "nb_glm_stable_bwd"))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for out in got[0::2] for a, b in zip(out, want))
    assert all(torch.equal(a, b) for out in got[1::2] for a, b in zip(out, want1))
    stream = torch.cuda.current_stream().cuda_stream
    assert int(nb_kernel._TICKETS[(alpha.device.index, stream)].item()) == 0


def _kernels_run(fn):
    """The CUDA kernels that 20 calls of fn() ran, by name without spaces
    (a record or two may be dropped by the profiler, hence several calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace(" ", "") for e in prof.key_averages() if e.device_type.name == "CUDA"}


def _assert_one_kernel(fn, layout_kind, form_args):
    """fn() runs one CUDA kernel, csrc/nb_tile.cuh's {tile,row}_kernel
    instantiated at <form_args>."""
    names = _kernels_run(fn)
    assert len(names) == 1, names
    assert f"{layout_kind}_kernel<(anonymousnamespace)::{form_args}>" in next(iter(names)), names


@pytest.mark.parametrize("B,kind", [(4, "tile"), (40, "row")])
def test_k1_one_kernel_per_call_and_value_only_under_no_grad(B, kind):
    """An autograd call of the K1/K2 entry runs one CUDA kernel, the GRADS
    instantiation; a no_grad call runs one, the value-only instantiation
    (csrc/nb_tile.cuh: {tile,row}_kernel<Fast<DELTA>, C, GRADS>)."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(B, 21, 515)
    a = alpha.clone().requires_grad_(True)
    nb_kernel.nb_glm_likelihood_fast(data, a, log_phi)  # warm: build, ticket
    _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood_fast(data, a, log_phi), kind,
                       "Fast<true>,2,true")
    with torch.no_grad():
        _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood_fast(data, alpha, log_phi), kind,
                           "Fast<true>,2,false")


@pytest.mark.parametrize("B,kind", [(4, "tile"), (40, "row")])
def test_k3_k4_one_kernel_per_call_and_value_only_under_no_grad(B, kind):
    """An autograd call of K3's entry runs one CUDA kernel, the GRADS
    instantiation, and a no_grad call one, the value-only one; K4's
    forward runs one kernel, value-only and tiled at every shape
    (csrc/nb_tile.cuh: {tile,row}_kernel<Form, C, GRADS>)."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(B, 21, 515)
    a = alpha.clone().requires_grad_(True)
    nb_kernel.nb_glm_likelihood_fused(data, a, log_phi)  # warm: build, ticket
    _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood_fused(data, a, log_phi), kind,
                       "Fused,2,true")
    with torch.no_grad():
        _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood_fused(data, alpha, log_phi), kind,
                           "Fused,2,false")
        _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood(data, alpha, log_phi), "tile",
                           "Stable<false>,2,false")


@pytest.mark.parametrize("B", [4, 40])
def test_k5_one_kernel_per_gradient_call(B):
    """An autograd call of the stable-form entry launches K5 once and K4
    never, one CUDA kernel (csrc/nb_tile.cuh's tile_kernel or row_kernel at
    <Stable<true>, C, true>); a no_grad call launches K4 once and K5 never."""
    _needs_card()
    data, alpha, log_phi = _ragged_case(B, 21, 515)
    a = alpha.clone().requires_grad_(True)
    nb_kernel.nb_glm_likelihood(data, a, log_phi)  # warm: build, ticket
    kind = "row" if nb_kernel.layout("nb_glm_stable_bwd", B, 21, 2, 515)["SY"] == 0 else "tile"
    nb_kernel.reset_launches()
    nb_kernel.nb_glm_likelihood(data, a, log_phi).sum().backward()
    torch.cuda.synchronize()
    assert nb_kernel.LAUNCHES["nb_glm_stable_bwd"] == 1 and nb_kernel.LAUNCHES["nb_glm_stable_fwd"] == 0
    _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood(data, a, log_phi), kind,
                       "Stable<true>,2,true")
    nb_kernel.reset_launches()
    with torch.no_grad():
        nb_kernel.nb_glm_likelihood(data, alpha, log_phi)
        torch.cuda.synchronize()
        assert nb_kernel.LAUNCHES["nb_glm_stable_fwd"] == 1
        assert nb_kernel.LAUNCHES["nb_glm_stable_bwd"] == 0


def _launch64(d, alpha, log_phi, kernel, want_grads=True):
    """The float64 form's output (d, alpha, log_phi in float64)."""
    if kernel == "nb_glm_delta_f64":
        return nb_kernel.launch_delta(d.X, d.counts, d.like_mask, d.d0, alpha, d.alpha0, log_phi,
                                      d.sigma_raw0, want_grads, sp_d0=d.sp_d0,
                                      sig_neg_d0=d.sig_neg_d0, y_sp0=d.y_sp0)
    return nb_kernel.launch_plain(d.X, d.exposure_rate, d.counts, d.like_mask, alpha, log_phi,
                                  want_grads)


@pytest.mark.parametrize("kernel", ["nb_glm_delta_f64", "nb_glm_plain_f64"])
def test_float64_form_matches_plain_version(cuda_case, kernel):
    """The float64 forms of K1/K2 against their plain versions in float64
    (nb_fast.glm_delta / glm_plain), at chip_smoke.py phase dtype's limits:
    value rtol 1e-10, gradients |d|/(1+|g|) < 1e-10 (the same operations in
    double; only the summation order differs). One launch each, of that
    form only; float64 gradients; exactly zero gradients for the masked
    gene; the value-only launch gives the same value."""
    data, alpha, log_phi = cuda_case
    d, a, p = _f64(data), alpha.double(), log_phi.double()
    nb_kernel.reset_launches()
    kern = _launch64(d, a, p, kernel)
    value_only = _launch64(d, a, p, kernel, want_grads=False)
    torch.cuda.synchronize()
    assert {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == {kernel: 2}
    plain = _plain(d, a, p, kernel[:-4])
    assert all(t.dtype == torch.float64 for t in kern)
    np.testing.assert_allclose(kern[0].cpu().numpy(), plain[0].cpu().numpy(), rtol=1e-10)
    assert all(_scaled(k, w) < 1e-10 for k, w in zip(kern[1:], plain[1:]))
    assert torch.all(kern[1][:, :, 11] == 0) and torch.all(kern[2][:, 11] == 0)
    assert torch.equal(value_only, kern[0])


# Forced layouts of the float64 forms' card tests beside the rule's: the
# row layout and two tiled ones (T, BY, SY), eight b-lanes of two sample
# lanes (b-chunks, several S-chunks at S = 601) and one b-lane of 64 sample
# lanes (idle lanes past S at S = 21)
_F64_FORCED = {"row": None, "tiled 16x8x2": (16, 8, 2), "tiled 4x1x64": (4, 1, 64)}


def _f64_case(B, S, G):
    data, alpha, log_phi = _ragged_case(B, S, G)
    return _f64(data), alpha.double(), log_phi.double()


def _check_float64(kernel, d, a, p, G, masked):
    """The float64 form under the current nb_kernel.layout against its plain
    version: value rtol 1e-10, gradients |d|/(1+|g|) < 1e-10, the masked
    gene's gradients exactly 0, a second launch equal bit for bit and the
    value-only launch's value equal to the gradient launch's."""
    kern = _launch64(d, a, p, kernel)
    again = _launch64(d, a, p, kernel)
    value_only = _launch64(d, a, p, kernel, want_grads=False)
    plain = _plain(d, a, p, kernel[:-4])
    assert all(t.dtype == torch.float64 for t in kern)
    np.testing.assert_allclose(kern[0].cpu().numpy(), plain[0].cpu().numpy(), rtol=1e-10)
    assert all(_scaled(k, w) < 1e-10 for k, w in zip(kern[1:], plain[1:]))
    if masked:
        assert torch.all(kern[1][:, :, 0] == 0) and torch.all(kern[2][:, 0] == 0)
    assert all(torch.equal(x, y) for x, y in zip(kern, again))
    assert torch.equal(value_only, kern[0])


_F64_RAGGED = _RAGGED + [(5, 2001, 300)]


@pytest.mark.parametrize("kernel", ["nb_glm_delta_f64", "nb_glm_plain_f64"])
@pytest.mark.parametrize("B,S,G", _F64_RAGGED, ids=[f"B{b}-S{s}-G{g}" for b, s, g in _F64_RAGGED])
def test_float64_ragged_edges_match_plain(kernel, B, S, G, monkeypatch):
    """The float64 forms at the ragged shapes (several S-chunks at S = 601
    and S = 2001, partial gene tiles and b-chunks, one gene, one sample),
    under layout()'s rule and forced to the row layout and to two tiled ones
    (_check_float64's limits)."""
    _needs_card()
    d, a, p = _f64_case(B, S, G)
    rule = nb_kernel.layout(kernel, B, S, 2, G)
    if S > 600:
        assert rule["n_chunks"] > 1
    _check_float64(kernel, d, a, p, G, G > 1)
    for forced in _F64_FORCED.values():
        if forced is None:
            fixed = lambda n, B_, S_, C_, G_, want=True: nb_kernel._row(B_, S_, G_)
        else:
            fixed = (lambda n, B_, S_, C_, G_, want=True, f=forced:
                     nb_kernel._tiled(n, B_, S_, C_, G_, want, *f))
        monkeypatch.setattr(nb_kernel, "layout", fixed)
        _check_float64(kernel, d, a, p, G, G > 1)


@pytest.mark.parametrize("kernel", ["nb_glm_delta_f64", "nb_glm_plain_f64"])
def test_float64_bitwise_repeatable(kernel):
    """As test_k12_bitwise_repeatable for the float64 forms (20 launches at
    several S-chunks and b-chunks)."""
    _needs_card()
    d, a, p = _f64_case(9, 601, 4201)
    first = _launch64(d, a, p, kernel)
    for _ in range(19):
        again = _launch64(d, a, p, kernel)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("B", [1, 40])
def test_float64_one_kernel_per_call(B):
    """A float64 autograd call of the fast entry runs one CUDA kernel, the
    float64 form's GRADS instantiation in the layout layout() chose
    (csrc/nb_tile.cuh's tile_kernel or row_kernel at <Fast64<DELTA>, C,
    GRADS>); a no_grad call runs one, the value-only instantiation."""
    _needs_card()
    d, a, p = _f64_case(B, 21, 515)
    kind = "row" if nb_kernel.layout("nb_glm_delta_f64", B, 21, 2, 515)["SY"] == 0 else "tile"
    ag = a.clone().requires_grad_(True)
    nb_kernel.nb_glm_likelihood_fast(d, ag, p)  # warm: build, ticket
    _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood_fast(d, ag, p), kind,
                       "Fast64<true>,2,true")
    with torch.no_grad():
        _assert_one_kernel(lambda: nb_kernel.nb_glm_likelihood_fast(d, a, p), kind,
                           "Fast64<true>,2,false")


def test_float64_density_and_three_gene_case_on_the_card():
    """A float64 flat_logp(dims) runs on the card (the float64 form of K1
    with a baseline, of K2 without; one launch per value and gradient) and
    matches the same density on the CPU, where the route runs the plain
    versions: value rtol 1e-10, gradient |d|/(1+|g|) < 1e-10.
    identify_outliers(dtype=torch.float64) on the reference's 3-gene case
    gives (0, 1, 0) on both CI paths, launching the float64 form of K1 and
    no other kernel."""
    _needs_card()
    from ppcseq_tpu_torch import identify_outliers, load_counts

    rng = np.random.default_rng(1)
    S, G = 8, 24
    counts = rng.poisson(np.exp(rng.normal(4.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), (np.arange(S) >= S // 2).astype(float)])
    exposure = rng.normal(0.0, 0.1, S)
    noise = rng.normal(size=(3, 6 + 2 * G + 4))
    for baseline, kernel in ((True, "nb_glm_delta_f64"), (False, "nb_glm_plain_f64")):
        out = {}
        for dev in ("cuda", "cpu"):
            data, dims = nb_model.prepare_data(counts, X, exposure, 4, device=dev,
                                               dtype=torch.float64)
            if baseline:
                data = nb_model.with_baseline(data, dims)
            f = nb_model.flat_logp(dims)
            theta = torch.as_tensor(nb_model.smart_init(data, dims)[None] + 0.05 * noise,
                                    device=dev).requires_grad_(True)
            nb_kernel.reset_launches()
            lp = f(theta, data)
            (g,) = torch.autograd.grad(lp.sum(), theta)
            if dev == "cuda":
                torch.cuda.synchronize()
                assert {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == {kernel: 1}
            out[dev] = (lp.detach().cpu(), g.cpu())
        np.testing.assert_allclose(out["cuda"][0].numpy(), out["cpu"][0].numpy(), rtol=1e-10)
        assert out["cuda"][1].dtype == torch.float64
        assert _scaled(out["cuda"][1], out["cpu"][1]) < 1e-10
    table = load_counts()
    three = table.assign(is_significant=table.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    for approx in (True, False):
        nb_kernel.reset_launches()
        res = identify_outliers(three, formula="~ Label", sample="sample", transcript="symbol",
                                abundance="value", significance="PValue",
                                do_check="is_significant", percent_false_positive_genes=1,
                                how_many_negative_controls=50, seed=42,
                                approximate_posterior_analysis=approx, device="cuda",
                                dtype=torch.float64)
        torch.cuda.synchronize()
        assert dict(zip(res.symbol, res.tot_deleterious_outliers)) == {
            "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
        assert {k for k, v in nb_kernel.LAUNCHES.items() if v} == {"nb_glm_delta_f64"}


def test_kernel_refuses_wrong_dtype(cuda_case):
    data, alpha, log_phi = cuda_case
    with pytest.raises(TypeError, match="dtype"):
        nb_kernel.launch_delta(data.X.double(), data.counts, data.like_mask, data.d0, alpha,
                               data.alpha0, log_phi, data.sigma_raw0, want_grads=False)


@pytest.mark.parametrize("name", ["plain", "fast", "pallas", "pallas_fused"])
def test_short_hmc_run_on_the_card(name):
    """A short HMC run through each flat_logp route: finite draws, the
    route's kernels launched."""
    _needs_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    S, G = 8, 24
    counts = rng.poisson(np.exp(rng.normal(4.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), (np.arange(S) >= S // 2).astype(float)])
    data, dims = nb_model.prepare_data(counts, X, rng.normal(0.0, 0.1, S), 4, device=dev)
    data = nb_model.with_baseline(data, dims)
    nb_kernel.reset_launches()
    res = run_hmc(nb_model.flat_logp(dims, name), dims.dim,
                  torch.Generator(device=dev).manual_seed(0), data=data, num_chains=16,
                  num_warmup=20, num_draws=10, num_leapfrog=8,
                  init_theta=nb_model.smart_init(data, dims), device=dev)
    assert torch.isfinite(res.draws).all()
    assert res.draws.shape == (16, 10, dims.dim)
    launched = {k for k, v in nb_kernel.LAUNCHES.items() if v}
    assert launched == {"plain": set(), "fast": {"nb_glm_delta"},
                        "pallas": {"nb_glm_stable_bwd"},
                        "pallas_fused": {"nb_glm_fused"}}[name]


def _fast_case(dev):
    """The small NB model of test_short_hmc_run_on_the_card with a baseline
    (so "fast" is K1), and a log density through "fast" that records the
    batch of every likelihood call."""
    rng = np.random.default_rng(1)
    S, G = 8, 24
    counts = rng.poisson(np.exp(rng.normal(4.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), (np.arange(S) >= S // 2).astype(float)])
    data, dims = nb_model.prepare_data(counts, X, rng.normal(0.0, 0.1, S), 4, device=dev)
    data = nb_model.with_baseline(data, dims)
    batches = []

    def likelihood(d, alpha, log_phi):
        batches.append(alpha.shape[0])
        return nb_kernel.nb_glm_likelihood_fast(d, alpha, log_phi)

    def logp(theta, d):
        return nb_model.log_joint(theta, d, dims, likelihood_fn=likelihood)

    return data, dims, logp, batches


def test_short_nuts_run_launches_k1_at_every_gradient():
    """NUTS through "fast" on the card, through graphs and eagerly: one K1
    launch per batched gradient evaluation (num_evals), each over all the
    chains (B = chains), a frozen chain included; the value is float64 and
    the draws finite."""
    _needs_card()
    dev = torch.device("cuda")
    data, dims, logp, batches = _fast_case(dev)
    nb_kernel.reset_launches()
    res = run_nuts(logp, dims.dim, torch.Generator(device=dev).manual_seed(0), data=data,
                   num_chains=3, num_warmup=20, num_draws=10, max_depth=6,
                   init_theta=nb_model.smart_init(data, dims), device=dev)
    torch.cuda.synchronize()
    assert torch.isfinite(res.draws).all() and res.draws.shape == (3, 10, dims.dim)
    assert {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == {"nb_glm_delta": res.num_evals}
    # the leaves and the step-size search replay captured steps: the
    # density's Python ran at the first gradient, at the search step's
    # warm-up and capture, at the stride's warm-up of each leaf parity and
    # at its capture of STRIDE steps, each with both leaf parities' bodies;
    # eagerly, at every gradient
    assert batches == [3] * (1 + graphs.WARMUP_RUNS + 1 + 2 * graphs.WARMUP_RUNS
                             + 2 * nuts.STRIDE)
    assert res.lockstep_leapfrog >= res.num_leapfrog > 0
    batches.clear()
    nb_kernel.reset_launches()
    with graphs.disabled():
        res = run_nuts(logp, dims.dim, torch.Generator(device=dev).manual_seed(0), data=data,
                       num_chains=3, num_warmup=20, num_draws=10, max_depth=6,
                       init_theta=nb_model.smart_init(data, dims), device=dev)
    torch.cuda.synchronize()
    assert {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == {"nb_glm_delta": res.num_evals}
    assert batches == [3] * res.num_evals


def test_short_chees_run_launches_k1_at_every_gradient():
    """ChEES through "fast" on the card: one K1 launch per gradient of the
    chain batch (the start, then every leapfrog), B = chains."""
    _needs_card()
    dev = torch.device("cuda")
    data, dims, logp, batches = _fast_case(dev)
    nb_kernel.reset_launches()
    res = run_hmc(logp, dims.dim, torch.Generator(device=dev).manual_seed(0), data=data,
                  num_chains=16, num_warmup=10, num_draws=5, num_leapfrog=8,
                  adapt_trajectory=True, init_theta=nb_model.smart_init(data, dims),
                  device=dev)
    torch.cuda.synchronize()
    assert torch.isfinite(res.draws).all() and res.trajectory_length > 0
    evals = 1 + res.num_leapfrog // 16
    assert {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == {"nb_glm_delta": evals}
    # the leapfrogs replay a captured one: the density's Python ran at the
    # first gradient, the warm-up and the capture; eagerly, at every gradient
    assert batches == [16] * (1 + graphs.WARMUP_RUNS + 1)
    batches.clear()
    nb_kernel.reset_launches()
    with graphs.disabled():
        res = run_hmc(logp, dims.dim, torch.Generator(device=dev).manual_seed(0), data=data,
                      num_chains=16, num_warmup=10, num_draws=5, num_leapfrog=8,
                      adapt_trajectory=True, init_theta=nb_model.smart_init(data, dims),
                      device=dev)
    torch.cuda.synchronize()
    evals = 1 + res.num_leapfrog // 16
    assert {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == {"nb_glm_delta": evals}
    assert batches == [16] * evals


def test_cli_on_the_card(tmp_path):
    """The command-line entry point on its default device, the card: the
    reference's 3-gene calls (0, 1, 0) in result.csv, with K1 launched by
    every fit."""
    _needs_card()
    import pandas as pd

    from ppcseq_tpu_torch import load_counts
    from ppcseq_tpu_torch.cli import main

    counts = load_counts()
    counts["is_significant"] = counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"])
    inp = tmp_path / "input.csv"
    counts.to_csv(inp, index=False)
    nb_kernel.reset_launches()
    assert main([str(inp), "-o", str(tmp_path / "out"), "--formula", "~ Label",
                 "--sample", "sample", "--transcript", "symbol", "--abundance", "value",
                 "--significance", "PValue", "--do-check", "is_significant",
                 "--negative-controls", "50", "--seed", "42"]) == 0
    torch.cuda.synchronize()
    summary = pd.read_csv(tmp_path / "out" / "result.csv")
    assert dict(zip(summary.symbol, summary.tot_deleterious_outliers)) == {
        "SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    assert nb_kernel.LAUNCHES["nb_glm_delta"] > 0


def test_sharded_density_through_k1_in_a_one_rank_nccl_group(tmp_path, monkeypatch):
    """A world of one under NCCL with a `genes` axis of 1: the sharded log
    density launches K1 once and all-reduces once on the card per
    value+gradient, and equals the unsharded K1 route's bits (a one-rank
    all-reduce of float64 is exact). Against the same log joint with K1's
    plain version (nb_fast.glm_delta) on the card in its place, at phase
    kernel's limits: value rtol 2e-5, gradient |d|/(1+|g|) < 1e-4 (the
    priors' float32 rounding is then the same on both sides). Against the
    float64 log joint (masked_likelihood) the float32 K1 route is held to
    limits set from its readings: value rtol 2e-5; the sigma_raw
    coordinates (dlog_phi, whose float32 cancellation is worst at large
    dispersion phi) |d|/(1+|g|) < 2.5e-2, read 1.66e-2 on the card and
    1.61e-2 from the plain version on the CPU; every other coordinate
    < 1e-3, read 2.7e-4 on the CPU."""
    _needs_card()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ppcseq_tpu_torch.model.params import offsets
    from ppcseq_tpu_torch.parallel import sharding

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("genes",))
        rng = np.random.default_rng(4)
        S, G = 21, 515
        X = np.column_stack([np.ones(S), rng.integers(0, 2, S).astype(float)])
        exposure = rng.normal(0.0, 0.3, S)
        counts = rng.poisson(np.exp(exposure[:, None] + rng.normal(4.0, 1.0, (1, G))))
        host, dims = nb_model.prepare_data(counts, X, exposure, 15, device="cpu",
                                           dtype=torch.float32)
        host = nb_model.with_baseline(host, dims)
        layout = sharding.Layout.from_mesh(mesh, dims)
        card = sharding.shard_data(host, layout.genes, dev)  # every gene: the axis is 1
        theta = (torch.as_tensor(nb_model.smart_init(host, dims))[None]
                 + 0.05 * torch.as_tensor(rng.normal(size=(3, dims.dim)))).float()
        f = nb_model.flat_logp(dims)

        def value_and_grad(fn, th):
            t = th.clone().requires_grad_(True)
            lp = fn(t)
            (g,) = torch.autograd.grad(lp.sum(), t)
            return lp.detach(), g

        nb_kernel.reset_launches()
        sharding.reset_collectives()
        lp, g = value_and_grad(layout.density(lambda t: f(t, card, layout.genes)), theta.to(dev))
        assert nb_kernel.LAUNCHES["nb_glm_delta"] == 1
        assert sharding.COLLECTIVES["logp"] == 1
        k1_lp, k1_g = value_and_grad(lambda t: nb_model.log_joint(t, card, dims), theta.to(dev))
        assert torch.equal(lp, k1_lp) and torch.equal(g, k1_g)
        card64, _ = nb_model.prepare_data(counts, X, exposure, 15, device=dev,
                                          dtype=torch.float64)
        card64 = nb_model.with_baseline(card64, dims)
        want64, want64_g = value_and_grad(
            lambda t: nb_model.log_joint(t, card64, dims, likelihood_fn=nb_model.masked_likelihood),
            theta.to(dev, torch.float64))
        assert float(((lp - want64).abs() / want64.abs()).max()) < 2e-5
        lo, hi = offsets(dims)["sigma_raw"]
        assert _scaled(g[:, lo:hi], want64_g[:, lo:hi]) < 2.5e-2
        assert _scaled(torch.cat([g[:, :lo], g[:, hi:]], 1),
                       torch.cat([want64_g[:, :lo], want64_g[:, hi:]], 1)) < 1e-3
        monkeypatch.setattr(nb_kernel, "_on", lambda device: False)  # the plain version
        want, want_g = value_and_grad(lambda t: nb_model.log_joint(t, card, dims), theta.to(dev))
        assert nb_kernel.LAUNCHES["nb_glm_delta"] == 2
        assert float(((lp - want).abs() / want.abs()).max()) < 2e-5
        assert _scaled(g, want_g) < 1e-4
    finally:
        dist.destroy_process_group()


def test_sharded_samplers_through_graphs_in_a_one_rank_nccl_group(tmp_path):
    """The test above's world of one under NCCL, driven through the
    samplers: gene-sharded fit_advi and run_hmc_tree over the `genes` axis
    take the graph route (Layout.capturable), their all-reduces inside the
    graphs, and run_nuts over a ("chains", "genes") mesh the device-decided
    one (Layout.all_capturable: nuts.CapturedTree's strides, the chain
    counts' and the genes all-reduces at the graph's top level, between
    the conditional parts of each tree step). Each is bitwise its
    graphs.disabled() run, with equal K1 launches and equal all-reduces by
    kind (the host seconds and NUTS's idle all-reduces apart), one "logp"
    all-reduce per K1 launch, and captures only through graphs."""
    _needs_card()
    import functools

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ppcseq_tpu_torch.infer.hmc import run_hmc_tree
    from ppcseq_tpu_torch.parallel import sharding

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        genes = init_device_mesh("cuda", (1,), mesh_dim_names=("genes",))
        both = init_device_mesh("cuda", (1, 1), mesh_dim_names=("chains", "genes"))
        data, dims, _, _ = _fast_case(dev)
        layout = sharding.Layout.from_mesh(genes, dims)
        assert layout.capturable(dev) and sharding.Layout.from_mesh(both, dims).all_capturable(dev)
        local = sharding.shard_data(data, layout.genes, dev)
        init, f = nb_model.smart_init(data, dims), nb_model.flat_logp(dims)

        def gen():
            return torch.Generator(device=dev).manual_seed(0)

        runs = {
            "advi": (lambda: fit_advi(functools.partial(f, shard=layout.genes), dims.dim, gen(),
                                      data=local, init_mean=init, layout=layout, device=dev),
                     lambda r: (r.mean, r.log_sd, torch.as_tensor(r.elbo_trace))),
            "hmc": (lambda: run_hmc_tree(f, dims.dim, gen(), data=data, dims=dims, mesh=genes,
                                         num_chains=16, num_warmup=10, num_draws=6,
                                         num_leapfrog=8, init_theta=init, device=dev),
                    lambda r: (r.draws, torch.as_tensor(r.accept_prob))),
            "nuts": (lambda: run_nuts(f, dims.dim, gen(), data=data, dims=dims, mesh=both,
                                      num_chains=4, num_warmup=24, num_draws=8, max_depth=8,
                                      init_theta=init, device=dev),
                     lambda r: (r.draws, *(torch.as_tensor(getattr(r, k)) for k in (
                         "accept_prob", "step_size", "inv_mass")))),
        }
        for name, (run, parts) in runs.items():
            out = {}
            for path in ("eager", "graphs"):
                nb_kernel.reset_launches()
                sharding.reset_collectives()
                graphs.reset_stats()
                if path == "eager":
                    with graphs.disabled():
                        res = run()
                else:
                    res = run()
                torch.cuda.synchronize()
                working, idle = sharding.split_idle(
                    {k: v for k, v in sharding.COLLECTIVES.items() if v and k != "seconds"})
                out[path] = (parts(res), {k: v for k, v in nb_kernel.LAUNCHES.items() if v},
                             working, graphs.STATS["captures"], idle)
            graphs.release()
            want, want_n, want_c, eager_captures, eager_idle = out["eager"]
            got, got_n, got_c, captures, idle = out["graphs"]
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            assert got_n == want_n and set(got_n) == {"nb_glm_delta"}, name
            assert got_c == want_c and got_c["logp"] == got_n["nb_glm_delta"], name
            assert not eager_idle and bool(idle) == (name == "nuts"), name
            assert eager_captures == 0 < captures, name
    finally:
        dist.destroy_process_group()


def _eager_and_graphs(run):
    """run() eagerly (graphs.disabled()) and through graphs: both results
    and the kernel launches each counted."""
    out = {}
    for name in ("eager", "graphs"):
        nb_kernel.reset_launches()
        if name == "eager":
            with graphs.disabled():
                res = run()
        else:
            res = run()
        torch.cuda.synchronize()
        out[name] = (res, {k: v for k, v in nb_kernel.LAUNCHES.items() if v})
    graphs.release()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fit_advi_through_graphs_is_the_eager_fit_at_15_genes(dtype):
    """fit_advi at the 15-gene README configuration (the VB fit's settings):
    the graphs' mean, log_sd and ELBO trace equal the eager fit's bit for
    bit, with the same launches of K1 (or its float64 form); the side
    stream's ticket is back at 0."""
    _needs_card()
    from ppcseq_tpu_torch.utils.profile_advi import _model

    dev = torch.device("cuda")
    _, data, dims = _model(dev, dtype)
    init = nb_model.smart_init(data, dims)
    out = _eager_and_graphs(lambda: fit_advi(
        nb_model.flat_logp(dims), dims.dim, torch.Generator(device=dev).manual_seed(0),
        data=data, init_mean=init, device=dev, dtype=dtype))
    (eager, eager_n), (got, got_n) = out["eager"], out["graphs"]
    assert torch.equal(got.mean, eager.mean) and torch.equal(got.log_sd, eager.log_sd)
    assert np.array_equal(got.elbo_trace, eager.elbo_trace) and got.converged == eager.converged
    kernel = "nb_glm_delta" if dtype == torch.float32 else "nb_glm_delta_f64"
    assert got_n == eager_n == {kernel: got.iterations + len(got.elbo_trace)}
    stream = graphs._side_stream(dev).cuda_stream
    assert int(nb_kernel._TICKETS[(dev.index or 0, stream)].item()) == 0


@pytest.mark.parametrize("chees", [False, True], ids=["jittered", "chees"])
def test_run_hmc_through_graphs_draws_the_eager_draws(chees):
    """A short jittered-HMC run and a short ChEES run through "fast" (K1):
    the graphs' draws equal the eager run's bit for bit, with the same step
    size and the same K1 launches (one per gradient of the chain batch)."""
    _needs_card()
    dev = torch.device("cuda")
    data, dims, _, _ = _fast_case(dev)
    out = _eager_and_graphs(lambda: run_hmc(
        nb_model.flat_logp(dims), dims.dim, torch.Generator(device=dev).manual_seed(0),
        data=data, num_chains=16, num_warmup=10, num_draws=6, num_leapfrog=8,
        adapt_trajectory=chees, init_theta=nb_model.smart_init(data, dims), device=dev))
    (eager, eager_n), (got, got_n) = out["eager"], out["graphs"]
    assert torch.equal(got.draws, eager.draws) and got.step_size == eager.step_size
    assert np.array_equal(got.accept_prob, eager.accept_prob)
    assert got_n == eager_n == {"nb_glm_delta": 1 + got.num_leapfrog // 16}


@pytest.mark.parametrize("baseline", [False, True], ids=["K2", "K1"])
def test_run_nuts_through_graphs_draws_the_eager_draws(baseline):
    """A short NUTS run through "fast" without a baseline (K2) and with one
    (K1): the graphs' draws equal the eager run's bit for bit, with the same
    step sizes, inverse masses, counters and kernel launches (one per
    batched evaluation); the device decides the leaves, so the host reads
    once per stride of leaves (at most ceil(leaves / STRIDE) per
    transition) where the eager run reads once per leaf and doubling."""
    _needs_card()
    dev = torch.device("cuda")
    data, dims, _, _ = _fast_case(dev)
    if not baseline:
        data = nb_model.upload(data.host, dev, torch.float32)
    out = _eager_and_graphs(lambda: run_nuts(
        nb_model.flat_logp(dims), dims.dim, torch.Generator(device=dev).manual_seed(0),
        data=data, num_chains=4, num_warmup=24, num_draws=8, max_depth=8,
        init_theta=nb_model.smart_init(data, dims), device=dev))
    (eager, eager_n), (got, got_n) = out["eager"], out["graphs"]
    assert torch.equal(got.draws, eager.draws)
    for name in ("accept_prob", "step_size", "inv_mass"):
        assert np.array_equal(getattr(got, name), getattr(eager, name)), name
    for name in ("num_leapfrog", "lockstep_leapfrog", "num_evals", "mean_depth"):
        assert getattr(got, name) == getattr(eager, name), name
    transitions, leaves = 24 + 8, got.lockstep_leapfrog // 4
    assert transitions <= got.host_syncs <= leaves / nuts.STRIDE + transitions
    assert eager.host_syncs >= leaves
    kernel = "nb_glm_delta" if baseline else "nb_glm_plain"
    assert got_n == eager_n == {kernel: got.num_evals}


@pytest.mark.parametrize("baseline", [False, True], ids=["K2", "K1"])
def test_if_node_region_runs_its_body_only_where_the_flag_holds(baseline):
    """graphs.when under a capture: a region whose body (a batched log
    density and gradient through K2, or K1) is an IF node replays it where
    the device flag holds and skips it where it does not. The body counts
    its runs on the device; booked, they give nb_kernel.LAUNCHES, and the
    outputs equal the eager call's bit for bit. The capturing stream's
    ticket is back at 0 (the body's kernels share it)."""
    _needs_card()
    dev = torch.device("cuda")
    data, dims, _, _ = _fast_case(dev)
    if not baseline:
        data = nb_model.upload(data.host, dev, torch.float32)
    logp = nb_model.flat_logp(dims)
    theta = torch.as_tensor(nb_model.smart_init(data, dims), dtype=torch.float32,
                            device=dev)[None].repeat(3, 1)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    ran = torch.zeros(1, dtype=torch.int64, device=dev)
    lp, g = torch.zeros(3, dtype=torch.float64, device=dev), torch.zeros_like(theta)

    def body():
        for buf, new in zip((lp, g), logp_and_grad(logp, theta, data)):
            buf.copy_(new)
        ran.add_(1)

    launches = {}
    region = graphs.Region(lambda: graphs.when(flag, body), dev, "IF-node test",
                           warmup=lambda: launches.update(graphs.launches_of(body)), books=False)
    kernel = "nb_glm_delta" if baseline else "nb_glm_plain"
    assert region.launches == {} and launches == {kernel: 1}
    ran.zero_()
    lp.zero_()
    nb_kernel.reset_launches()
    for on in (False, False):
        flag.fill_(on)
        region.replay()
    assert int(ran.item()) == 0 and not lp.any()
    for on in (True, False, True, True):
        flag.fill_(on)
        region.replay()
    times = int(ran.item())
    graphs.book(launches, times)
    assert times == 3 and {k: v for k, v in nb_kernel.LAUNCHES.items() if v} == {kernel: 3}
    want_lp, want_g = logp_and_grad(logp, theta, data)
    assert torch.equal(lp, want_lp) and torch.equal(g, want_g)
    stream = graphs._side_stream(dev).cuda_stream
    assert int(nb_kernel._TICKETS[(dev.index or 0, stream)].item()) == 0


def test_a_failed_capture_raises_and_runs_nothing_eagerly():
    """A density that reads a value back to the host cannot be captured:
    fit_advi raises, after the warm-up's and the capture's calls only (no
    eager loop takes over), caches nothing, and the card keeps working."""
    _needs_card()
    dev = torch.device("cuda")
    calls = []

    def host_reading(theta):
        calls.append(1)
        return -0.5 * torch.sum(theta * theta, dim=-1) * float(theta.abs().max() > -1.0)

    with pytest.raises(RuntimeError, match="capture of the ADVI step failed"):
        fit_advi(host_reading, 3, torch.Generator(device=dev).manual_seed(0), max_iter=200,
                 device=dev)
    assert len(calls) == graphs.WARMUP_RUNS + 1 and "advi" not in graphs._CACHE
    assert float(torch.ones(4, device=dev).sum()) == 4.0


@pytest.mark.parametrize("approx", [True, False], ids=["vb", "hmc"])
def test_the_root_span_counts_what_the_call_ran(approx, monkeypatch):
    """identify_outliers on the reference's 3-gene case with its spans
    recorded (utils/log.py): the root span's captures are the Regions the
    call built, its launches the growth of nb_kernel.LAUNCHES by kernel
    (replays' booked launches included), and on the HMC branch these
    exceed the calls the returned fits account for, by the ADVI warm
    starts' launches at least."""
    _needs_card()
    from ppcseq_tpu_torch import identify_outliers, load_counts
    from ppcseq_tpu_torch.utils import log

    built = []

    class Region(graphs.Region):
        def __init__(self, fn, device, name, *args, **kwargs):
            built.append(name)
            super().__init__(fn, device, name, *args, **kwargs)

    monkeypatch.setattr(graphs, "Region", Region)
    table = load_counts()
    three = table.assign(is_significant=table.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    before = dict(nb_kernel.LAUNCHES)
    log.clear_spans()
    log.set_verbose(True)
    try:
        res = identify_outliers(three, formula="~ Label", sample="sample", transcript="symbol",
                                abundance="value", significance="PValue",
                                do_check="is_significant", percent_false_positive_genes=1,
                                how_many_negative_controls=50, seed=42, pass_fit=True,
                                approximate_posterior_inference=approx, device="cuda")
    finally:
        log.set_verbose(False)
    torch.cuda.synchronize()
    root = log.spans()[-1]
    log.clear_spans()
    grown = {k: v - before[k] for k, v in nb_kernel.LAUNCHES.items() if v != before[k]}
    assert root.name == "identify_outliers" and root.attrs["captures"] == len(built) > 0
    assert root.attrs["launches"] == grown and sum(grown.values()) > 0
    if not approx:
        fits = [res.attrs[f"fit {p}"] for p in (1, 2)]
        accounted = sum(f.num_leapfrog // f.draws.shape[0] + 1 for f in fits)
        assert sum(grown.values()) > accounted
