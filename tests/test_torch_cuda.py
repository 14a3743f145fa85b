"""The CUDA likelihood kernels against their plain torch versions, a short
HMC run through each likelihood route, and short NUTS and ChEES runs
through "fast", on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. They import
no JAX, so the card can run them without the JAX package's test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ppcseq_tpu_torch.infer.hmc import run_hmc
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
    """NUTS through "fast" on the card: one K1 launch per batched gradient
    evaluation (num_evals), each over all the chains (B = chains), a frozen
    chain included; the value is float64 and the draws finite."""
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
    assert batches == [3] * res.num_evals
    assert res.lockstep_leapfrog >= res.num_leapfrog > 0


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
    assert batches == [16] * evals
