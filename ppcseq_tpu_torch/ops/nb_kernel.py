"""The NB2-log GLM likelihood kernels: wrappers, launch counts and autograd.

Five CUDA kernels replace the five Pallas TPU kernels of
ppcseq_tpu/ops/nb_kernel.py, and K1 and K2 have a float64 form beside them
(built at first use by ops/_build.py):

| name                | TPU kernel      | source           | plain version                  |
|---------------------|-----------------|------------------|--------------------------------|
| K1 nb_glm_delta     | _fastk_delta    | nb_glm_delta.cu  | nb_fast.glm_delta              |
| K2 nb_glm_plain     | _fastk_plain    | nb_glm_delta.cu  | nb_fast.glm_plain              |
| K3 nb_glm_fused     | _fused_dkernel  | nb_glm_fused.cu  | delta_likelihood + likelihood_grads |
| K4 nb_glm_stable_fwd| _fwd_kernel     | nb_glm_stable.cu | nb_model.stable_likelihood     |
| K5 nb_glm_stable_bwd| _bwd_kernel     | nb_glm_stable.cu | stable_likelihood + likelihood_grads |
| K1 nb_glm_delta_f64 | _fastk_delta    | nb_glm_fast64.cu | nb_fast.glm_delta (float64)    |
| K2 nb_glm_plain_f64 | _fastk_plain    | nb_glm_fast64.cu | nb_fast.glm_plain (float64)    |

The entries, each `(data, alpha[B,C,G], log_phi[B,G]) -> value[B]` (float64) and
differentiable in alpha and log_phi, are the JAX package's:
- `nb_glm_likelihood_fast`: K1 when the data carry a baseline, K2 when not;
  in float64 (data, alpha and log_phi all float64) their float64 forms, as
  JAX computes its float64 "fast" likelihood with XLA from ops/nb_fast.
  Value and gradients in one pass; under no_grad the value-only
  instantiation.
- `nb_glm_likelihood`: the stable form, baseline ignored. K5 (value and
  gradients in one pass); under no_grad K4 (value only). float32 only, as
  JAX's Pallas routes.
- `nb_glm_likelihood_fused`: K3, delta form; raises without a baseline.
  float32 only.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs the kernel's plain version. There is no fallback. `LAUNCHES` counts
the launches of each kernel (CUDA only; a replayed CUDA graph adds the
launches its capture holds, infer/graphs.Region); `reset_launches()`
zeroes them.
`layout()` chooses the launch layout of each kernel per shape;
`work()` counts a call's bytes and operations (FP32, or FP64 for the
float64 forms) for its bound (chip_smoke.py), on the branch shares of
`branch_shares()`.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ppcseq_tpu_torch.ops import nb_fast, nb_grad

MAX_C = 8  # the kernels' template instantiations: C in 1..MAX_C

# kernel name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "nb_glm_delta": ("nb_glm_delta.cu", "ppcseq_tpu/ops/nb_kernel.py:487"),
    "nb_glm_plain": ("nb_glm_delta.cu", "ppcseq_tpu/ops/nb_kernel.py:476"),
    "nb_glm_fused": ("nb_glm_fused.cu", "ppcseq_tpu/ops/nb_kernel.py:236"),
    "nb_glm_stable_fwd": ("nb_glm_stable.cu", "ppcseq_tpu/ops/nb_kernel.py:64"),
    "nb_glm_stable_bwd": ("nb_glm_stable.cu", "ppcseq_tpu/ops/nb_kernel.py:80"),
    "nb_glm_delta_f64": ("nb_glm_fast64.cu", "ppcseq_tpu/ops/nb_kernel.py:487"),
    "nb_glm_plain_f64": ("nb_glm_fast64.cu", "ppcseq_tpu/ops/nb_kernel.py:476"),
}
F64_FORMS = ("nb_glm_delta_f64", "nb_glm_plain_f64")
SOURCES = tuple(dict.fromkeys(src for src, _ in KERNELS.values()))

LAUNCHES = {name: 0 for name in KERNELS}  # kernel launches (CUDA tensors only)

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C function -> argument types (pointers, then ints, then the stream)
_SIGNATURES = {
    "nb_glm_fast_launch": [_P] * 14 + [_I] * 11 + [_P],
    "nb_glm_fused_launch": [_P] * 13 + [_I] * 10 + [_P],
    "nb_glm_stable_launch": [_P] * 11 + [_I] * 10 + [_P],
    "nb_glm_fast64_launch": [_P] * 17 + [_I] * 11 + [_P],
}
_MAX_C_FN = {"nb_glm_delta.cu": "nb_glm_fast_max_c", "nb_glm_fused.cu": "nb_glm_fused_max_c",
             "nb_glm_stable.cu": "nb_glm_stable_max_c",
             "nb_glm_fast64.cu": "nb_glm_fast64_max_c"}
_FNS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- work of one call, for the kernels' bounds ------------------------------
# The card's peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s, and
# FP32 and FP64 operations/s outside the tensor cores (67 and 34 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

# FP32 operations per point and per (b, g), counted from csrc/ along the
# branch each point takes. A stated approximation, for ranking only: expf,
# logf and an IEEE divide (no fast math) cost about their instruction counts;
# every other add, multiply, min/max and compare-select costs 1; fabs and
# negation are free. log1p_wide and l1p_b are counted on their series
# branch, expm1/e1 on its expf branch, the far branch as phi * softplus(d).
EXP, LOG, DIV = 8, 20, 10
_LOG1P = 2 * DIV + 15  # log1p01 and log1p_wide's series (nb_common.cuh)
# The float64 forms (nb_glm_fast64.cu), in FP64 instructions: the card has
# no special-function unit for double, so exp and log are software
# sequences (range reduction, a polynomial, scaling) of about 20 and 25
# instructions, and an IEEE divide about 10 (a reciprocal seed and Newton
# steps). A stated approximation, as above.
EXP64, LOG64, DIV64 = 20, 25, 10

# Data-dependent branch shares (fractions of the B*S*G points) assumed when
# work() is not given the run's own (branch_shares).
DEFAULT_SHARES = {"y_le7": 0.5, "mean_y_le7": 3.0, "y_gt7_phi_ge8": 0.25, "mid": 1.0,
                  "series": 0.5}


def _ops_per_point(name, C, grads, sh):
    """FP32 operations of one kernel per point (b, s, g), per (b, g), and per
    data point (s, g): the terms that do not depend on b (K1/K2:
    lgamma(y+1) or log(y+1) and 1/(y+1), K1's softplus(d0) and sigmoid(-d0);
    K3-K5: 1/(y+1) and 1/(y+1)^3, K3's softplus(d0) and sigmoid(-d0)). The
    function needs these once per (s, g), whichever layout runs it."""
    small, big_phi = sh["y_le7"], sh["y_gt7_phi_ge8"]
    small_phi = 1.0 - small - big_phi  # y > 7, phi < 8
    series, mid = sh["series"], sh["mid"]
    if name in ("nb_glm_delta", "nb_glm_plain") + F64_FORMS:  # nb_glm_delta.cu, nb_glm_fast64.cu
        delta = name.startswith("nb_glm_delta")
        f64 = name in F64_FORMS
        exp_, log_, div_ = (EXP64, LOG64, DIV64) if f64 else (EXP, LOG, DIV)
        log1p = 2 * div_ + 15
        pt = 1 + 2 * C + exp_ + log1p + 4 + (2 if delta else 1) + 5
        datum = small * 12 + (1 - small) * (log_ + div_ + 2)
        if delta:  # hybrid increments; K1 rebuilds the baseline from d0, the
            # float64 form reads it
            datum += 0 if f64 else exp_ + log1p + div_ + 4
            pt += 2 + mid * (exp_ + div_ + 2 * log1p + 11) + (1 - mid) * 6
        else:
            pt += 1
        big_y = div_ + log1p + 17
        pt += small * 15 + big_phi * (big_y + log1p + 7) + small_phi * (big_y + 4)
        if grads:
            pt += exp_ + div_ + 14 + 2 * C + series * (exp_ + 16) + (1 - series) * 3
            pt += small * 14 + big_phi * 14 + small_phi * (div_ + 12)
        return pt, exp_ + 9 * log_ + 10 * div_ + 40 + C, datum
    # nb_tile.cuh forms K3-K5: nb2_part1's rest per point (nb_common.cuh
    # part1_point), its phi terms per (b, g) (build_part1), 1/(y+1) and
    # 1/(y+1)^3 per (s, g)
    part1 = (1 + small * 7 + (1 - small) * (13 + 3 * DIV + _LOG1P)
             + big_phi * (DIV + _LOG1P + 8) + small_phi * (LOG + 4))
    gene = EXP + 10 * LOG + 4 * DIV + 58
    datum = 1 + (1 - small) * (3 + 2 * DIV)
    pt = 2 * C + 12 + EXP + _LOG1P + part1  # nb_glm_stable.cu Stable: the value
    if name == "nb_glm_fused":  # nb_glm_fused.cu Fused: the delta form's value
        datum += EXP + _LOG1P + DIV + 4  # softplus(d0), sigmoid(-d0)
        gene += C + 1
        pt += 4 + mid * (2 * EXP + 2 * _LOG1P + 9) + (1 - mid) * 3
    if grads:  # nb_common.cuh build_grad_row per (b, g), grad_point per point
        gene += 10 * DIV + 19
        pt += EXP + DIV + 15 + 2 * C
        pt += small * 7 + big_phi * (3 * DIV + 11) + small_phi * (DIV + 11)
        pt += series * (EXP + 16) + (1 - series) * (DIV + 3)
    return pt, gene, datum


def work(name, B, S, C, G, want_grads=True, shares=None):
    """Bytes and operations of one call of kernel `name` at (B, S, C, G),
    and the least time the card could take for them.

    Bytes: each input read once and each output written once (counts int32,
    mask, d0 or exposure, X, alpha, alpha0, log_phi, sigma_raw0, and the
    float64 delta form's sp_d0, sig_neg_d0 and y_sp0; value, dalpha,
    dlog_phi), scratch not counted; the float64 forms' operands are 8 bytes.
    Operations: _ops_per_point along the branches in `shares`
    (DEFAULT_SHARES where not given), each term as often as the function
    needs it (per point, per (b, g) or per (s, g)), not as often as a launch
    layout happens to compute it; FP32, or FP64 for the float64 forms, over
    the card's peak for that type. Returns a dict with bytes, ops, bound_us
    and bound_by ("bytes" or "operations")."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}")
    sh = dict(DEFAULT_SHARES, **(shares or {}))
    baseline = name in ("nb_glm_delta", "nb_glm_fused", "nb_glm_delta_f64")
    grads = want_grads and name != "nb_glm_stable_fwd"
    e = 8 if name in F64_FORMS else 4  # bytes of a floating-point operand
    n = 4 * S * G + e * (S * G + S * C + B * C * G + B * G)  # counts, mask, X, alpha, log_phi
    if name == "nb_glm_delta_f64":
        n += e * 3 * S * G  # sp_d0, sig_neg_d0, y_sp0
    n += e * (S * G + C * G + G) if baseline else e * S  # d0, alpha0, sigma_raw0 | exposure
    n += 8 * B + e * (B * C * G + B * G) * grads  # value (f64), dalpha, dlog_phi
    per_point, per_gene, per_datum = _ops_per_point(name, C, grads, sh)
    ops = B * S * G * per_point + B * G * per_gene + S * G * per_datum
    peak = FP64_OPS_PER_S if name in F64_FORMS else FP32_OPS_PER_S
    t_bytes, t_ops = n / HBM_BYTES_PER_S * 1e6, ops / peak * 1e6
    return {"bytes": n, "ops": ops, "bound_us": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def branch_shares(data, alpha, log_phi):
    """The data-dependent branch shares of work() for these inputs (plain
    torch, on the inputs' device): y <= 7; y > 7 with phi >= 8; the delta
    form's mid range -2 < dlo < 8 (1.0 without a baseline); the gradient's
    series branch d <= -1.386; and the mean count of the y <= 7 points."""
    y = data.counts.to(alpha.dtype)
    lpc = torch.clamp(log_phi, max=nb_fast.LOG_PHI_CAP)
    phi = torch.exp(lpc)[:, None, :]
    d = nb_fast._eta_small(data.X, data.exposure_rate, alpha) - lpc[:, None, :]
    small = y <= 7.0
    out = {
        "y_le7": float(small.to(alpha.dtype).mean()),
        "mean_y_le7": float(y[small].mean()) if bool(small.any()) else 0.0,
        "y_gt7_phi_ge8": float((~small & (phi >= 8.0)).to(alpha.dtype).mean()),
        "series": float((d <= -1.386).to(alpha.dtype).mean()),
        "mid": 1.0,
    }
    if data.d0 is not None:
        dlo = (nb_fast._eta_small(data.X, torch.zeros_like(data.X[:, 0]), alpha - data.alpha0)
               - (lpc + data.sigma_raw0)[:, None, :])
        out["mid"] = float(((dlo > -2.0) & (dlo < 8.0)).to(alpha.dtype).mean())
    return out


def build_all() -> None:
    """Build (in parallel) and bind every kernel source."""
    from ppcseq_tpu_torch.ops import _build

    for source, lib in zip(SOURCES, _build.load_all(SOURCES)):
        max_c = getattr(lib, _MAX_C_FN[source])
        max_c.restype = ctypes.c_int
        if max_c() != MAX_C:
            raise RuntimeError(f"{source} and ops/nb_kernel.py disagree on MAX_C")
        for fn_name, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FNS[fn_name] = fn


def _fn(name):
    if name not in _FNS:
        build_all()
    return _FNS[name]


def _check(name, t, dev, dtype, shape):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(X, counts, mask, alpha, log_phi, float64_ok=False, **extra):
    """Check the shared inputs (and `extra` per-sample/per-gene ones): all
    float32, or with `float64_ok` all float64 when alpha is; returns
    (device, B, S, C, G). The dtypes and shapes are checked before the
    device, so a CPU tensor shows them too."""
    dev = alpha.device
    B, C, G = alpha.shape
    S = X.shape[0]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"design has {C} columns; the kernels take 1..{MAX_C}")
    ft = torch.float64 if float64_ok and alpha.dtype == torch.float64 else torch.float32
    _check("X", X, dev, ft, (S, C))
    _check("counts", counts, dev, torch.int32, (S, G))
    _check("mask", mask, dev, ft, (S, G))
    _check("alpha", alpha, dev, ft, (B, C, G))
    _check("log_phi", log_phi, dev, ft, (B, G))
    shapes = {"exposure": (S,), "d0": (S, G), "alpha0": (C, G), "sigma_raw0": (G,),
              "sp_d0": (S, G), "sig_neg_d0": (S, G), "y_sp0": (S, G)}
    for name, t in extra.items():
        if t is None:
            raise ValueError(f"{name} is missing")
        _check(name, t, dev, ft, shapes[name])
    if dev.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {dev}")
    return dev, B, S, C, G


def _run(fn_name, kernel, dev, args):
    with torch.cuda.device(dev):
        rc = _fn(fn_name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---- launch layouts (csrc/nb_tile.cuh) ------------------------------------------
SM_COUNT = 132  # the H100 SXM's SMs
_SMEM_BUDGET = 100 * 1024  # per block, so that at least two blocks share an SM
_MAX_THREADS = 256  # as MAX_THREADS in csrc/nb_common.cuh
_ROW_THREADS = 128  # as ROW_THREADS in csrc/nb_common.cuh
_TILES = (16, 8, 4)  # genes per block, widest first
_F64_TILES = (32, 16, 8, 4)  # the float64 forms'

# kernel -> the (BASE, NH, TAB) of its form (csrc/nb_glm_*.cu), which size
# its shared memory by csrc/nb_tile.cuh's stage_words/fixed_words: base =
# reads d0, alpha0 and sigma_raw0 (else exposure), nh = staged planes of
# per-(s, g) terms (the float64 delta form's last 3 are its input tables
# sp_d0, sig_neg_d0, y_sp0), tab = per-(b, g) table slots
_CARVING = {"nb_glm_delta": (1, 4, 16), "nb_glm_plain": (0, 2, 16),
            "nb_glm_fused": (1, 4, 16), "nb_glm_stable_fwd": (0, 2, 8),
            "nb_glm_stable_bwd": (0, 2, 16),
            "nb_glm_delta_f64": (1, 6, 16), "nb_glm_plain_f64": (0, 2, 16)}
# bytes of a shared-memory word (the form's Real): 4, the float64 forms' 8
_WORD = {"nb_glm_delta_f64": 8, "nb_glm_plain_f64": 8}


def _pow2_at_least(n):
    return 1 << max(0, int(n) - 1).bit_length()


def layout(name, B, S, C, G, want_grads=True):
    """Launch layout of kernel `name` at (B, S, C, G). The rules
    follow H100 sweeps of every layout (bench_kernels.py --sweep, PERF.md).

    K1-K3 at many b and small S (B >= 32, S <= 32): the row layout (_row).
    Otherwise the tiled one (_tiled) with BY the largest power of two up to
    min(B, 8) and T the widest of 16, 8, 4 that gives six blocks per SM
    (the stable form's K4 and K5: four, at every shape; their points are
    the cheapest, so the tile's staging and hoisting pay even at (128, 21,
    515)), the sample lanes SY filling a block of 256 threads; where no T
    does (a small call), as many sample lanes as S uses, up to 64, and the
    tile that fills the block.

    The float64 forms: tiled at every shape, T the widest of 32, 16, 8, 4
    that gives three blocks per SM (their ~128 registers a thread hold two
    blocks of 256 per SM), the small call as above. The row layout tied at
    the 50k cohort's ADVI step, won only at the value-only (100, 21, 515)
    and lost everywhere else; the rule does not depend on want_grads (a
    value-only launch takes the gradient launch's lanes), and at (128, 21,
    515) with gradients the tile wins by 1.2-1.6x."""
    if name not in _CARVING:
        raise ValueError(f"no launch layout for kernel {name!r}")
    stable = name in ("nb_glm_stable_fwd", "nb_glm_stable_bwd")
    f64 = name in F64_FORMS
    if B >= 32 and S <= 32 and not (stable or f64):
        return _row(B, S, G)
    BY = 1 << (min(B, 8).bit_length() - 1)
    gy = -(-B // BY)
    per_sm = 4 if stable else 3 if f64 else 6
    T = next((t for t in (_F64_TILES if f64 else _TILES)
              if -(-G // t) * gy >= per_sm * SM_COUNT), None)
    if T is None:
        SY = max(8 // BY, min(_pow2_at_least(S), _MAX_THREADS // (4 * BY)))
        T = max(4, _MAX_THREADS // (BY * SY))
    else:
        SY = max(8 // BY, min(_MAX_THREADS // (T * BY), _pow2_at_least(S)))
    return _tiled(name, B, S, C, G, want_grads, T, BY, SY)


def _row(B, S, G):
    """One thread per (b, g): blocks of T = 128 genes of one b, SY = 0, no
    shared memory."""
    return {"T": _ROW_THREADS, "BY": 1, "SY": 0, "SC": S, "grid": (-(-G // _ROW_THREADS), B),
            "threads": _ROW_THREADS, "smem": 0, "n_chunks": 1}


def _tiled(name, B, S, C, G, want_grads, T, BY, SY):
    """Blocks of T genes x BY b-lanes x SY sample lanes (warps of 4 genes x 8
    lanes), each owning BY rows b; the samples staged in chunks of SC, all S
    at once where the block's shared memory stays within _SMEM_BUDGET. smem
    is the dynamic shared memory of the source's stage_words/fixed_words,
    in words of the form's Real (_WORD). For the float64 forms a chunk is a
    whole number of sample-lane rounds (SC a multiple of SY, or all of S), so
    that every sample stays on lane s mod SY whatever SC the shared memory
    allows: the gradient launch and the value-only one (which differ in SC)
    then sum each value in one order."""
    base, nh, tab = _CARVING[name]
    word = _WORD.get(name, 4)
    Tp = T if (T // 4) % 2 else T + 4  # the source's padded(T)
    nq = C + 2 if want_grads and name != "nb_glm_stable_fwd" else 1
    fixed = word * ((C * T + T if base else 0) + tab * BY * T + nq * BY * SY * T + BY * T)
    per_row = word * (Tp * (2 + base + nh) + C + (0 if base else 1))
    SC = min(S, max(1, (_SMEM_BUDGET - fixed) // per_row))
    if name in F64_FORMS and SC < S:
        SC = min(S, max(SY, SC - SC % SY))
    return {"T": T, "BY": BY, "SY": SY, "SC": SC, "grid": (-(-G // T), -(-B // BY)),
            "threads": T * BY * SY, "smem": fixed + SC * per_row, "n_chunks": -(-S // SC)}


_TICKETS: dict = {}  # (device index, stream) -> the zeroed ticket its launches share
_TICKET_STREAM: dict = {}  # device index -> the stream whose ticket launches take (ticket_of)


@contextlib.contextmanager
def ticket_of(stream):
    """Inside the block, launches on `stream`'s device take `stream`'s
    ticket, whatever stream they run on. A CUDA graph's conditional body is
    captured on a stream of its own (infer/graphs.CudaCapture.if_node), and
    its kernels run inside the graph, in the order of the stream that
    captures the graph: they share that stream's ticket, as the graph's
    other kernels do."""
    index = stream.device.index
    before = _TICKET_STREAM.get(index)
    _TICKET_STREAM[index] = stream.cuda_stream
    try:
        yield
    finally:
        if before is None:
            del _TICKET_STREAM[index]
        else:
            _TICKET_STREAM[index] = before


def _ticket(dev, stream):
    """The stream's ticket, allocated (zeroed) at its first launch. A CUDA
    graph's kernels keep the ticket of the stream they were captured on, so
    infer/graphs.py warms a region up on that stream first: a ticket made
    inside a capture would be memory of the graph's pool, zeroed only when
    the graph replays."""
    key = (dev.index, _TICKET_STREAM.get(dev.index, stream))
    if key not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a kernel's first launch on a stream is under CUDA graph "
                               "capture: warm the stream up before capturing")
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def _one_launch_outputs(name, dev, B, S, C, G, want_grads, grad_dtype=torch.float32):
    """(layout, value, dalpha, dlog_phi, partial, ticket) of one call:
    the outputs (gradients in `grad_dtype`), the [B, n_tiles] double scratch
    and the stream's ticket."""
    lay = layout(name, B, S, C, G, want_grads)
    value = torch.empty((B,), dtype=torch.float64, device=dev)
    dalpha = dlog_phi = None
    if want_grads:
        dalpha = torch.empty((B, C, G), dtype=grad_dtype, device=dev)
        dlog_phi = torch.empty((B, G), dtype=grad_dtype, device=dev)
    partial = torch.empty((B, lay["grid"][0]), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        ticket = _ticket(dev, torch.cuda.current_stream(dev).cuda_stream)
    return lay, value, dalpha, dlog_phi, partial, ticket


def _layout_args(lay):
    return lay["T"], lay["BY"], lay["SY"], lay["SC"], lay["smem"]


def _launch_fast(X, exposure, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0,
                 want_grads, delta, tables=(None, None, None)):
    """K1 or K2, or in float64 their float64 form; `tables` = (sp_d0,
    sig_neg_d0, y_sp0), which the float64 delta form reads."""
    f64 = alpha.dtype == torch.float64
    if delta:
        extra = dict(d0=d0, alpha0=alpha0, sigma_raw0=sigma_raw0)
        if f64:
            extra.update(zip(("sp_d0", "sig_neg_d0", "y_sp0"), tables))
    else:
        extra = dict(exposure=exposure)
    dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi, float64_ok=True, **extra)
    name = ("nb_glm_delta" if delta else "nb_glm_plain") + ("_f64" if f64 else "")
    lay, value, dalpha, dlog_phi, partial, ticket = _one_launch_outputs(
        name, dev, B, S, C, G, want_grads, alpha.dtype)
    if f64:
        sp_d0, sig_neg_d0, y_sp0 = tables
        _run("nb_glm_fast64_launch", name, dev, (
            X.data_ptr(), _ptr(exposure), counts.data_ptr(), mask.data_ptr(), _ptr(d0),
            _ptr(sp_d0), _ptr(sig_neg_d0), _ptr(y_sp0), alpha.data_ptr(), _ptr(alpha0),
            log_phi.data_ptr(), _ptr(sigma_raw0), partial.data_ptr(), value.data_ptr(),
            _ptr(dalpha), _ptr(dlog_phi), ticket.data_ptr(), B, S, C, G,
            int(bool(want_grads)), int(bool(delta)), *_layout_args(lay),
        ))
        return (value, dalpha, dlog_phi) if want_grads else value
    _run("nb_glm_fast_launch", name, dev, (
        X.data_ptr(), _ptr(exposure), counts.data_ptr(), mask.data_ptr(), _ptr(d0),
        alpha.data_ptr(), _ptr(alpha0), log_phi.data_ptr(), _ptr(sigma_raw0),
        partial.data_ptr(), value.data_ptr(), _ptr(dalpha), _ptr(dlog_phi), ticket.data_ptr(),
        B, S, C, G, int(bool(want_grads)), int(bool(delta)), *_layout_args(lay),
    ))
    return (value, dalpha, dlog_phi) if want_grads else value


def launch_delta(X, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, want_grads, *,
                 sp_d0=None, sig_neg_d0=None, y_sp0=None):
    """K1: value[B] (float64), or (value, dalpha[B,C,G], dlog_phi[B,G]).

    All inputs contiguous on one CUDA device, counts int32: X[S,C],
    counts/mask/d0 [S,G], alpha[B,C,G], alpha0[C,G], log_phi[B,G],
    sigma_raw0[G]. float32 inputs launch K1 (which rebuilds softplus(d0) and
    sigmoid(-d0) from d0; sp_d0, sig_neg_d0 and y_sp0 are not read);
    float64 inputs launch its float64 form, which reads the [S,G] tables
    sp_d0, sig_neg_d0 and y_sp0 too, and returns float64 gradients. Mixed
    dtypes raise TypeError.
    """
    return _launch_fast(X, None, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0,
                        want_grads, delta=True, tables=(sp_d0, sig_neg_d0, y_sp0))


def launch_plain(X, exposure, counts, mask, alpha, log_phi, want_grads):
    """K2: as launch_delta, with exposure[S] in place of the baseline
    (float64 inputs: its float64 form)."""
    return _launch_fast(X, exposure, counts, mask, None, alpha, None, log_phi, None,
                        want_grads, delta=False)


def launch_fused(X, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, want_grads):
    """K3: as launch_delta (same inputs and outputs), on the unhoisted math."""
    dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi,
                                    d0=d0, alpha0=alpha0, sigma_raw0=sigma_raw0)
    lay, value, dalpha, dlog_phi, partial, ticket = _one_launch_outputs(
        "nb_glm_fused", dev, B, S, C, G, want_grads)
    _run("nb_glm_fused_launch", "nb_glm_fused", dev, (
        X.data_ptr(), counts.data_ptr(), mask.data_ptr(), d0.data_ptr(), alpha.data_ptr(),
        alpha0.data_ptr(), log_phi.data_ptr(), sigma_raw0.data_ptr(), partial.data_ptr(),
        value.data_ptr(), _ptr(dalpha), _ptr(dlog_phi), ticket.data_ptr(), B, S, C, G,
        int(bool(want_grads)), *_layout_args(lay),
    ))
    return (value, dalpha, dlog_phi) if want_grads else value


def _launch_stable(X, exposure, counts, mask, alpha, log_phi, want_grads):
    dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi, exposure=exposure)
    name = "nb_glm_stable_bwd" if want_grads else "nb_glm_stable_fwd"
    lay, value, dalpha, dlog_phi, partial, ticket = _one_launch_outputs(
        name, dev, B, S, C, G, want_grads)
    _run("nb_glm_stable_launch", name, dev, (
        X.data_ptr(), exposure.data_ptr(), counts.data_ptr(), mask.data_ptr(),
        alpha.data_ptr(), log_phi.data_ptr(), partial.data_ptr(), value.data_ptr(),
        _ptr(dalpha), _ptr(dlog_phi), ticket.data_ptr(), B, S, C, G, int(bool(want_grads)),
        *_layout_args(lay),
    ))
    return (value, dalpha, dlog_phi) if want_grads else value


def launch_stable_fwd(X, exposure, counts, mask, alpha, log_phi):
    """K4: value[B] of the stable form (inputs as launch_plain)."""
    return _launch_stable(X, exposure, counts, mask, alpha, log_phi, want_grads=False)


def launch_stable_bwd(X, exposure, counts, mask, alpha, log_phi):
    """K5: (value[B], dalpha[B,C,G], dlog_phi[B,G]) of the stable form, in
    one launch (inputs as launch_plain)."""
    return _launch_stable(X, exposure, counts, mask, alpha, log_phi, want_grads=True)


def _on(dev):
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no likelihood for device {dev}")
    return dev.type == "cuda"


def _fast(data, alpha, log_phi, want_grads):
    if data.d0 is not None:
        if _on(alpha.device):
            return launch_delta(data.X, data.counts, data.like_mask, data.d0, alpha.contiguous(),
                                data.alpha0, log_phi.contiguous(), data.sigma_raw0, want_grads,
                                sp_d0=data.sp_d0, sig_neg_d0=data.sig_neg_d0, y_sp0=data.y_sp0)
        return nb_fast.glm_delta(
            data.X, data.counts, data.like_mask, data.alpha0, data.sigma_raw0, data.d0,
            data.sp_d0, data.sig_neg_d0, data.y_sp0, alpha, log_phi, want_grads,
        )
    if _on(alpha.device):
        return launch_plain(data.X, data.exposure_rate, data.counts, data.like_mask,
                            alpha.contiguous(), log_phi.contiguous(), want_grads)
    return nb_fast.glm_plain(data.X, data.exposure_rate, data.counts, data.like_mask,
                             alpha, log_phi, want_grads)


def _with_plain_grads(value, data, alpha, log_phi, want_grads):
    """value, or (value, *likelihood_grads): the gradient half of K3's and
    K5's plain versions."""
    if not want_grads:
        return value
    return (value, *nb_grad.likelihood_grads(data.X, data.exposure_rate, data.counts,
                                             data.like_mask, alpha, log_phi))


def _fused(data, alpha, log_phi, want_grads):
    if _on(alpha.device):
        return launch_fused(data.X, data.counts, data.like_mask, data.d0, alpha.contiguous(),
                            data.alpha0, log_phi.contiguous(), data.sigma_raw0, want_grads)
    from ppcseq_tpu_torch.model.nb_model import delta_likelihood

    return _with_plain_grads(delta_likelihood(data, alpha, log_phi), data, alpha, log_phi,
                             want_grads)


def _stable(data, alpha, log_phi, want_grads):
    if _on(alpha.device):
        return _launch_stable(data.X, data.exposure_rate, data.counts, data.like_mask,
                              alpha.contiguous(), log_phi.contiguous(), want_grads)
    from ppcseq_tpu_torch.model.nb_model import stable_likelihood

    return _with_plain_grads(stable_likelihood(data, alpha, log_phi), data, alpha, log_phi,
                             want_grads)


class _GradsInForward(torch.autograd.Function):
    """Value (float64) and gradients (the inputs' dtype) from one pass (K1,
    K2, K3 or K5); backward scales the stored gradients by grad_out[b], cast
    to their dtype."""

    @staticmethod
    def forward(ctx, alpha, log_phi, data, compute):
        value, dalpha, dlog_phi = compute(data, alpha, log_phi, True)
        ctx.save_for_backward(dalpha, dlog_phi)
        return value

    @staticmethod
    def backward(ctx, grad_out):
        dalpha, dlog_phi = ctx.saved_tensors
        grad_out = grad_out.to(dalpha.dtype)
        return grad_out[:, None, None] * dalpha, grad_out[:, None] * dlog_phi, None, None


def _wants_grad(alpha, log_phi):
    return torch.is_grad_enabled() and (alpha.requires_grad or log_phi.requires_grad)


def nb_glm_likelihood_fast(data, alpha, log_phi):
    """Masked likelihood on the hoisted math, value[B]: K1 (delta form) when
    `data` carries baseline constants (nb_model.with_baseline), K2 (stable
    plain form) when it does not; in float64, their float64 forms.
    alpha[B, C, G] and log_phi[B, G] lie on the data's device, in its
    dtype."""
    if _wants_grad(alpha, log_phi):
        return _GradsInForward.apply(alpha, log_phi, data, _fast)
    return _fast(data, alpha, log_phi, want_grads=False)


def nb_glm_likelihood(data, alpha, log_phi):
    """Masked likelihood in the stable form, value[B]; a baseline on `data`
    is ignored (nb_kernel.py:201-210 of the JAX package). Under grad K5
    (value and gradients in one launch), under no_grad K4."""
    if _wants_grad(alpha, log_phi):
        return _GradsInForward.apply(alpha, log_phi, data, _stable)
    return _stable(data, alpha, log_phi, want_grads=False)


def nb_glm_likelihood_fused(data, alpha, log_phi):
    """One-pass delta-form likelihood on the unhoisted math (K3), value[B].
    Needs baseline constants (nb_model.with_baseline)."""
    if data.d0 is None:
        raise ValueError(
            "nb_glm_likelihood_fused requires baseline constants (nb_model.with_baseline)"
        )
    if _wants_grad(alpha, log_phi):
        return _GradsInForward.apply(alpha, log_phi, data, _fused)
    return _fused(data, alpha, log_phi, want_grads=False)
