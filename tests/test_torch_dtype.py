"""The port's dtype policy against the JAX package: `nb_model.fast_likelihood`
in float64 and float32, `nb_fast.glm_plain` in float64, `identify_outliers`
keeping float64 on a CUDA device, the float64 kernel form's wrapper checks
and work count, the vanishing-dispersion behaviour of both packages, and the
ingest check on missing keys. Inputs are made with numpy from a seed and
carried across with ppcseq_tpu_torch.utils.convert. The float64 kernels
themselves run on the card only (tests/test_torch_cuda.py)."""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ppcseq_tpu.model import nb_model as jnb
from ppcseq_tpu.ops import nb as jnbops
from ppcseq_tpu.ops import nb_fast as jfast
from ppcseq_tpu_torch.data import ingest
from ppcseq_tpu_torch.model import nb_model
from ppcseq_tpu_torch.ops import nb, nb_fast, nb_kernel
from ppcseq_tpu_torch.pipeline import identify
from ppcseq_tpu_torch.utils.convert import model_from_arrays

torch.set_num_threads(2)

_BASELINE = ("alpha0", "sigma_raw0", "d0", "sp_d0", "sig_neg_d0", "y_sp0")
_CSRC = Path(__file__).resolve().parents[1] / "ppcseq_tpu_torch" / "csrc"


def _case(S=21, G=200, C=2, B=3, seed=0, baseline=True, jdtype=jnp.float64):
    """JAX model data in `jdtype` (as tests/test_nb_kernel.py:_case builds
    it, with a baseline if asked) and B parameter rows alpha[B, C, G],
    log_phi[B, G] (float64 numpy)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(S)] + [rng.integers(0, 2, S).astype(float) for _ in range(C - 1)])
    alpha_true = np.concatenate([rng.normal(4.0, 1.0, (1, G)), rng.normal(0.0, 0.5, (C - 1, G))])
    exposure = rng.normal(0.0, 0.3, size=S)
    counts = rng.poisson(np.minimum(np.exp(exposure[:, None] + X @ alpha_true), 1e6))
    exclude = rng.uniform(size=(S, G)) < 0.05
    data, dims = jnb.prepare_data(counts, X, exposure, 4, exclude_mask=exclude, dtype=jnp.float64)
    if baseline:
        data = jnb.with_baseline(data, dims)
    if jdtype == jnp.float32:
        data = dataclasses.replace(data, **{
            f: getattr(data, f).astype(jnp.float32)
            for f in ("X", "exposure_rate", "like_mask", "gene_mask") + _BASELINE
            if getattr(data, f) is not None})
    alpha = alpha_true[None] + rng.normal(0, 0.1, size=(B, C, G))
    log_phi = rng.normal(0.0, 1.0, size=(B, G))
    return data, dims, alpha, log_phi


# float64: the same polynomials and branches, only the summation order
# differs; float32: tests/test_nb_kernel.py's tolerances (value rtol 2e-5,
# gradient |d|/(1+|g|) < 1e-4)
_TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (2e-5, 1e-4)}


@pytest.mark.parametrize("baseline", [True, False], ids=["delta", "plain"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_fast_likelihood_matches_jax(dtype, baseline):
    """nb_model.fast_likelihood (the plain versions of K1/K2 on the CPU)
    against JAX's nb_model.fast_likelihood: the value, and autograd against
    jax.grad, row by row."""
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jdata, jdims, alpha, log_phi = _case(seed=3, baseline=baseline, jdtype=jdtype)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=dtype)
    a = torch.as_tensor(alpha, dtype=dtype).requires_grad_(True)
    p = torch.as_tensor(log_phi, dtype=dtype).requires_grad_(True)
    value = nb_model.fast_likelihood(tdata, a, p)
    da, dp = torch.autograd.grad(value.sum(), (a, p))
    assert value.dtype == torch.float64 and da.dtype == dp.dtype == dtype
    v_tol, g_tol = _TOL[dtype]
    for b in range(alpha.shape[0]):
        ja, jp = jnp.asarray(alpha[b], jdtype), jnp.asarray(log_phi[b], jdtype)
        jv = jnb.fast_likelihood(jdata, ja, jp)
        jda, jdp = jax.grad(lambda x, y: jnb.fast_likelihood(jdata, x, y), (0, 1))(ja, jp)
        np.testing.assert_allclose(float(value[b].detach()), float(jv), rtol=v_tol)
        for got, want in ((da[b], jda), (dp[b], jdp)):
            want = np.asarray(want, np.float64)
            err = np.abs(got.double().numpy() - want) / (1.0 + np.abs(want))
            assert err.max() < g_tol


def test_fast_is_the_likelihood_of_flat_logp():
    assert nb_model._resolve_likelihood_fn("fast") is nb_model.fast_likelihood


def test_glm_plain_matches_jax_f64():
    """nb_fast.glm_plain (the plain version of K2 and of its float64 form)
    against JAX's nb_fast.glm_plain in float64, rtol 1e-10."""
    jdata, jdims, alpha, log_phi = _case(seed=4, B=3, baseline=False)
    tdata, _ = model_from_arrays(jdata, jdims, dtype=torch.float64)
    v, da, dl = nb_fast.glm_plain(tdata.X, tdata.exposure_rate, tdata.counts, tdata.like_mask,
                                  torch.as_tensor(alpha), torch.as_tensor(log_phi), True)
    for b in range(alpha.shape[0]):
        jv, jda, jdl = jfast.glm_plain(jdata.X, jdata.exposure_rate, jdata.counts,
                                       jdata.like_mask, jnp.asarray(alpha[b]),
                                       jnp.asarray(log_phi[b]), want_grads=True)
        np.testing.assert_allclose(float(v[b]), float(jv), rtol=1e-10)
        for got, want in ((da[b], jda), (dl[b], jdl)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max())


class _Stop(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_identify_outliers_keeps_the_dtype_on_a_cuda_device(dtype, counts_df, monkeypatch):
    """On a CUDA device identify_outliers hands the caller's dtype to the
    fit unchanged (it used to replace float64 by float32 there). A fake
    device: resolve_device answers cuda:0, and the first fit records what it
    was given and stops."""
    seen = {}

    def fit(*args, **kwargs):
        seen.update(device=kwargs["device"], dtype=kwargs["dtype"])
        raise _Stop

    monkeypatch.setattr(identify, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(identify, "do_inference", fit)
    three = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    with pytest.raises(_Stop):
        identify.identify_outliers(
            three, formula="~ Label", sample="sample", transcript="symbol", abundance="value",
            significance="PValue", do_check="is_significant", percent_false_positive_genes=1,
            how_many_negative_controls=50, seed=42, dtype=dtype)
    assert seen == {"device": torch.device("cuda", 0), "dtype": dtype}


def _launch_args(dtype=torch.float64, S=5, G=7, C=2, B=2):
    """launch_delta's inputs on the CPU, every float in `dtype`."""
    z = lambda *shape: torch.zeros(shape, dtype=dtype)  # noqa: E731
    return dict(X=z(S, C), counts=torch.zeros((S, G), dtype=torch.int32), mask=z(S, G),
                d0=z(S, G), alpha=z(B, C, G), alpha0=z(C, G), log_phi=z(B, G),
                sigma_raw0=z(G), want_grads=True, sp_d0=z(S, G), sig_neg_d0=z(S, G),
                y_sp0=z(S, G))


@pytest.mark.parametrize("mixed", ["X", "mask", "log_phi", "d0", "sigma_raw0", "y_sp0"])
def test_float64_form_refuses_mixed_dtypes(mixed):
    """Every float input of the float64 form is float64: one float32 input
    among them (or one float64 among float32 ones, for K1) is a TypeError,
    raised before the kernel is reached."""
    args = _launch_args()
    args[mixed] = args[mixed].float()
    with pytest.raises(TypeError, match=f"{mixed} has dtype torch.float32, expected torch.float64"):
        nb_kernel.launch_delta(**args)
    args = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in _launch_args().items()}
    # alpha decides the form, log_phi then follows; K1 does not read y_sp0
    if mixed not in ("log_phi", "y_sp0"):
        args[mixed] = args[mixed].double()
        with pytest.raises(TypeError, match=f"{mixed} has dtype torch.float64"):
            nb_kernel.launch_delta(**args)


def test_float64_form_checks_and_the_routes_that_refuse_it():
    """The float64 delta form reads sp_d0, sig_neg_d0 and y_sp0 (a missing
    one is a ValueError); K3, K4 and K5 take float32 only, as JAX's Pallas
    routes; consistent float64 inputs on the CPU reach the device check."""
    args = _launch_args()
    with pytest.raises(ValueError, match="CUDA"):
        nb_kernel.launch_delta(**args)
    with pytest.raises(ValueError, match="CUDA"):
        nb_kernel.launch_plain(args["X"], args["X"][:, 0].contiguous(), args["counts"],
                               args["mask"], args["alpha"], args["log_phi"], want_grads=False)
    with pytest.raises(ValueError, match="y_sp0 is missing"):
        nb_kernel.launch_delta(**dict(args, y_sp0=None))
    a = args
    with pytest.raises(TypeError, match="alpha has dtype torch.float64, expected torch.float32"):
        nb_kernel.launch_fused(a["X"].float(), a["counts"], a["mask"].float(), a["d0"].float(),
                               a["alpha"], a["alpha0"].float(), a["log_phi"].float(),
                               a["sigma_raw0"].float(), want_grads=True)
    for launch in (nb_kernel.launch_stable_fwd, nb_kernel.launch_stable_bwd):
        with pytest.raises(TypeError, match="X has dtype torch.float64, expected torch.float32"):
            launch(a["X"], a["X"][:, 0].contiguous(), a["counts"], a["mask"], a["alpha"],
                   a["log_phi"])


def test_float64_launch_signature_matches_source():
    """_SIGNATURES["nb_glm_fast64_launch"] has the C function's pointers,
    ints and stream, in order, the layout's five among them, and the forms
    take layout()'s tiled layout at the scale HMC's shape (the source
    cannot be compiled here)."""
    src = (_CSRC / "nb_glm_fast64.cu").read_text()
    params = re.search(r'extern "C" int nb_glm_fast64_launch\(([^)]*)\)', src).group(1)
    kinds = [nb_kernel._P if "void*" in p else nb_kernel._I for p in params.split(",")]
    assert kinds == nb_kernel._SIGNATURES["nb_glm_fast64_launch"]
    assert nb_kernel._MAX_C_FN["nb_glm_fast64.cu"] in src
    for name in nb_kernel.F64_FORMS:
        assert nb_kernel.KERNELS[name][0] == "nb_glm_fast64.cu"
        assert nb_kernel.layout(name, 8, 100, 2, 50000) == nb_kernel._tiled(
            name, 8, 100, 2, 50000, True, 32, 8, 1)
    assert [q.split()[-1] for q in params.split(",")[-6:-1]] == ["T", "BY", "SY", "SC", "smem"]


@pytest.mark.parametrize("name,grads,expected", [
    # 4 SG counts + 8 (SG mask + SC X + BCG alpha + BG log_phi); the delta
    # form's 8 (4 SG d0, sp_d0, sig_neg_d0, y_sp0 + CG alpha0 + G sigma_raw0),
    # the plain form's 8 S exposure; 8 B value; 8 (BCG + BG) gradients
    ("nb_glm_delta_f64", True, 43_260 + 99_216 + 8 * (4 * 10_815 + 1_030 + 515) + 8 + 12_360),
    ("nb_glm_delta_f64", False, 43_260 + 99_216 + 8 * (4 * 10_815 + 1_030 + 515) + 8),
    ("nb_glm_plain_f64", True, 43_260 + 99_216 + 8 * 21 + 8 + 12_360),
    ("nb_glm_plain_f64", False, 43_260 + 99_216 + 8 * 21 + 8),
])
def test_float64_work_by_hand(name, grads, expected):
    """work() of the float64 forms at (1, 21, 2, 515): 8-byte operands, and
    FP64 operations over 34 TFLOP/s; more operations per point than the
    float32 form's count, whose exp, log and divide cost less."""
    w = nb_kernel.work(name, 1, 21, 2, 515, want_grads=grads)
    assert w["bytes"] == expected
    f32 = nb_kernel.work(name[:-4], 8, 100, 2, 50000, want_grads=grads)
    w = nb_kernel.work(name, 8, 100, 2, 50000, want_grads=grads)
    assert w["ops"] > f32["ops"]
    assert w["bound_us"] == pytest.approx(max(w["bytes"] / 3.35e12, w["ops"] / 34e12) * 1e6)


# ---- vanishing dispersion -----------------------------------------------------
# One observation at eta = 2 with log phi far below 0: float64 log phi -700
# (phi = e^-700 is a normal double) and -740 (subnormal), float32 -88 and
# -100 (both subnormal: the least normal float32 is e^-87.34). XLA flushes a
# subnormal phi to 0 on the CPU; torch keeps it. The behaviour of both
# packages is pinned here as it is; neither is made finite.
_POINTS = [("float64", -700.0, "normal"), ("float64", -740.0, "deep"),
           ("float32", -88.0, "shallow"), ("float32", -100.0, "deep")]
_ETA = 2.0


def _lpmf_both(fname, y, lp, dtype):
    """(JAX, port) of (value, d/deta, d/dlog_phi) of ops/nb.<fname> by
    autograd."""
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    jf = getattr(jnbops, fname)

    def jfn(e, p):
        return jf(jnp.asarray(y), e, p)

    je, jp = jnp.asarray(_ETA, jdt), jnp.asarray(lp, jdt)
    jout = (float(jfn(je, jp)), *map(float, jax.grad(jfn, (0, 1))(je, jp)))
    tdt = getattr(torch, dtype)
    e = torch.tensor(_ETA, dtype=tdt, requires_grad=True)
    p = torch.tensor(lp, dtype=tdt, requires_grad=True)
    v = getattr(nb, fname)(torch.tensor(y), e, p)
    tout = (float(v.detach()), *map(float, torch.autograd.grad(v, (e, p))))
    return jout, tout


def _glm_delta_both(y, lp, dtype):
    """(JAX, port) of nb_fast.glm_delta's (value, dalpha, dlog_phi) at one
    observation, the baseline at the same point (dlo = 0)."""
    d0 = np.array([[_ETA - lp]])
    with np.errstate(over="ignore"):
        tabs = [d0, np.logaddexp(0.0, d0), 1.0 / (1.0 + np.exp(d0)), y * np.logaddexp(0.0, -d0)]
    X, mask, a0 = np.ones((1, 1)), np.ones((1, 1)), np.full((1, 1), _ETA)
    cnt, sr0 = np.array([[y]]), np.array([-lp])
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    jv, jda, jdl = jfast.glm_delta(J(X), J(np.zeros(1)), jnp.asarray(cnt, jnp.int32), J(mask),
                                   J(a0), J(sr0), *map(J, tabs), J(a0), J([lp]),
                                   want_grads=True)
    tdt = getattr(torch, dtype)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)  # noqa: E731
    tv, tda, tdl = nb_fast.glm_delta(T(X), torch.as_tensor(cnt, dtype=torch.int32), T(mask),
                                     T(a0), T(sr0), *map(T, tabs), T(a0[None]), T([[lp]]), True)
    return ((float(jv), float(jda[0, 0]), float(jdl[0])),
            (float(tv[0]), float(tda[0, 0, 0]), float(tdl[0, 0])))


@pytest.mark.parametrize("y", [0, 3, 50])
@pytest.mark.parametrize("dtype,lp,kind", _POINTS, ids=[f"{d}{lp:.0f}" for d, lp, _ in _POINTS])
def test_vanishing_dispersion_pin(dtype, lp, kind, y):
    """Where phi is a normal number the two packages agree: value, d/deta
    and d/dlog_phi of nb2_log_lpmf and nb2_log_lpmf_stable (autograd) and of
    nb_fast.glm_delta (analytic). Where phi is subnormal, XLA flushes it to
    0 and torch does not: JAX's value is -inf at y > 0 and its autograd
    dlog_phi NaN at every y, while the port's value stays finite; the
    port's autograd dlog_phi is +inf at y > 0 deep in the subnormals
    (float64 -740, float32 -100: non-finite in both packages) and finite
    (1.0) at float32 -88; glm_delta's analytic dlog_phi is finite in both."""
    rows = {f: _lpmf_both(f, y, lp, dtype) for f in ("nb2_log_lpmf", "nb2_log_lpmf_stable")}
    rows["glm_delta"] = _glm_delta_both(y, lp, dtype)
    if kind == "normal":
        for fname, (j, t) in rows.items():
            np.testing.assert_allclose(t, j, rtol=1e-12, atol=0, err_msg=fname)
        return
    for fname, (j, t) in rows.items():
        assert math.isfinite(t[0]), (fname, t)
        if y > 0:
            assert j[0] == -math.inf, (fname, j)
    for fname in ("nb2_log_lpmf", "nb2_log_lpmf_stable"):
        j, t = rows[fname]
        assert math.isnan(j[2]), (fname, j)
        if y > 0:
            assert (t[2] == math.inf) if kind == "deep" else (t[2] == 1.0), (fname, t)
    j, t = rows["glm_delta"]
    assert math.isfinite(j[2]) and math.isfinite(t[2])


# ---- ingest ---------------------------------------------------------------------

@pytest.mark.parametrize("column", ["sample", "symbol"])
def test_check_rectangular_names_a_column_with_missing_keys(counts_df, column):
    """A NaN sample or transcript key is a ValueError naming its column
    (pd.factorize codes it -1, which the pair arithmetic took for another
    key or refused with an unrelated error)."""
    df = counts_df[["sample", "symbol", "value"]].copy()
    df[column] = df[column].astype(object)
    df.loc[df.index[[3, 7]], column] = np.nan
    role = "sample" if column == "sample" else "transcript"
    with pytest.raises(ValueError, match=f"The {role} column '{column}' has 2 missing keys"):
        ingest.check_rectangular(df, "sample", "symbol")
    ingest.check_rectangular(counts_df, "sample", "symbol")  # the intact table passes
