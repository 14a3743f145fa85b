"""The NB2-log GLM likelihood kernels: wrappers, launch counts and autograd.

Five CUDA kernels replace the five Pallas TPU kernels of
ppcseq_tpu/ops/nb_kernel.py (built at first use by ops/_build.py):

| name                | TPU kernel      | source           | plain version                  |
|---------------------|-----------------|------------------|--------------------------------|
| K1 nb_glm_delta     | _fastk_delta    | nb_glm_delta.cu  | nb_fast.glm_delta              |
| K2 nb_glm_plain     | _fastk_plain    | nb_glm_delta.cu  | nb_fast.glm_plain              |
| K3 nb_glm_fused     | _fused_dkernel  | nb_glm_fused.cu  | delta_likelihood + likelihood_grads |
| K4 nb_glm_stable_fwd| _fwd_kernel     | nb_glm_stable.cu | nb_model.stable_likelihood     |
| K5 nb_glm_stable_bwd| _bwd_kernel     | nb_glm_stable.cu | nb_grad.likelihood_grads       |

The entries, each `(data, alpha[B,C,G], log_phi[B,G]) -> value[B]` and
differentiable in alpha and log_phi, are the JAX package's:
- `nb_glm_likelihood_fast`: K1 when the data carry a baseline, K2 when not.
  Value and gradients in one pass; under no_grad the value-only
  instantiation.
- `nb_glm_likelihood`: the stable form, baseline ignored. Forward K4,
  backward K5; under no_grad only K4 runs.
- `nb_glm_likelihood_fused`: K3, delta form; raises without a baseline.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs the kernel's plain version. There is no fallback. `LAUNCHES` counts
the launches of each kernel (CUDA only); `reset_launches()` zeroes them.
"""

from __future__ import annotations

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
}
SOURCES = tuple(dict.fromkeys(src for src, _ in KERNELS.values()))

LAUNCHES = {name: 0 for name in KERNELS}  # kernel launches (CUDA tensors only)

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C function -> argument types (pointers, then ints, then the stream)
_SIGNATURES = {
    "nb_glm_fast_launch": [_P] * 13 + [_I] * 6 + [_P],
    "nb_glm_fused_launch": [_P] * 12 + [_I] * 5 + [_P],
    "nb_glm_stable_fwd_launch": [_P] * 8 + [_I] * 4 + [_P],
    "nb_glm_stable_bwd_launch": [_P] * 8 + [_I] * 4 + [_P],
}
_MAX_C_FN = {"nb_glm_delta.cu": "nb_glm_fast_max_c", "nb_glm_fused.cu": "nb_glm_fused_max_c",
             "nb_glm_stable.cu": "nb_glm_stable_max_c"}
_FNS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _check_common(X, counts, mask, alpha, log_phi, **extra):
    """Check the shared inputs (and `extra` per-sample/per-gene ones);
    returns (device, B, S, C, G)."""
    dev = alpha.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {dev}")
    B, C, G = alpha.shape
    S = X.shape[0]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"design has {C} columns; the kernels take 1..{MAX_C}")
    f32 = torch.float32
    _check("X", X, dev, f32, (S, C))
    _check("counts", counts, dev, torch.int32, (S, G))
    _check("mask", mask, dev, f32, (S, G))
    _check("alpha", alpha, dev, f32, (B, C, G))
    _check("log_phi", log_phi, dev, f32, (B, G))
    shapes = {"exposure": (S,), "d0": (S, G), "alpha0": (C, G), "sigma_raw0": (G,)}
    for name, t in extra.items():
        _check(name, t, dev, f32, shapes[name])
    return dev, B, S, C, G


def _run(fn_name, kernel, dev, args):
    with torch.cuda.device(dev):
        rc = _fn(fn_name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1


def _outputs(dev, B, C, G, want_grads):
    f32 = torch.float32
    partial = torch.empty((B, G), dtype=f32, device=dev)
    value = torch.empty((B,), dtype=f32, device=dev)
    if not want_grads:
        return partial, value, None, None
    return (partial, value, torch.empty((B, C, G), dtype=f32, device=dev),
            torch.empty((B, G), dtype=f32, device=dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fast(X, exposure, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0,
                 want_grads, delta):
    if delta:
        dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi,
                                        d0=d0, alpha0=alpha0, sigma_raw0=sigma_raw0)
    else:
        dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi, exposure=exposure)
    partial, value, dalpha, dlog_phi = _outputs(dev, B, C, G, want_grads)
    _run("nb_glm_fast_launch", "nb_glm_delta" if delta else "nb_glm_plain", dev, (
        X.data_ptr(), _ptr(exposure), counts.data_ptr(), mask.data_ptr(), _ptr(d0),
        alpha.data_ptr(), _ptr(alpha0), log_phi.data_ptr(), _ptr(sigma_raw0),
        partial.data_ptr(), value.data_ptr(), _ptr(dalpha), _ptr(dlog_phi),
        B, S, C, G, int(bool(want_grads)), int(bool(delta)),
    ))
    return (value, dalpha, dlog_phi) if want_grads else value


def launch_delta(X, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, want_grads):
    """K1: value[B], or (value, dalpha[B,C,G], dlog_phi[B,G]).

    All inputs float32 and contiguous on one CUDA device, counts int32:
    X[S,C], counts/mask/d0 [S,G], alpha[B,C,G], alpha0[C,G], log_phi[B,G],
    sigma_raw0[G].
    """
    return _launch_fast(X, None, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0,
                        want_grads, delta=True)


def launch_plain(X, exposure, counts, mask, alpha, log_phi, want_grads):
    """K2: as launch_delta, with exposure[S] in place of the baseline."""
    return _launch_fast(X, exposure, counts, mask, None, alpha, None, log_phi, None,
                        want_grads, delta=False)


def launch_fused(X, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, want_grads):
    """K3: as launch_delta (same inputs and outputs), on the unhoisted math."""
    dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi,
                                    d0=d0, alpha0=alpha0, sigma_raw0=sigma_raw0)
    partial, value, dalpha, dlog_phi = _outputs(dev, B, C, G, want_grads)
    _run("nb_glm_fused_launch", "nb_glm_fused", dev, (
        X.data_ptr(), counts.data_ptr(), mask.data_ptr(), d0.data_ptr(), alpha.data_ptr(),
        alpha0.data_ptr(), log_phi.data_ptr(), sigma_raw0.data_ptr(), partial.data_ptr(),
        value.data_ptr(), _ptr(dalpha), _ptr(dlog_phi), B, S, C, G, int(bool(want_grads)),
    ))
    return (value, dalpha, dlog_phi) if want_grads else value


def launch_stable_fwd(X, exposure, counts, mask, alpha, log_phi):
    """K4: value[B] of the stable form (inputs as launch_plain)."""
    dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi, exposure=exposure)
    partial, value, _, _ = _outputs(dev, B, C, G, False)
    _run("nb_glm_stable_fwd_launch", "nb_glm_stable_fwd", dev, (
        X.data_ptr(), exposure.data_ptr(), counts.data_ptr(), mask.data_ptr(),
        alpha.data_ptr(), log_phi.data_ptr(), partial.data_ptr(), value.data_ptr(), B, S, C, G,
    ))
    return value


def launch_stable_bwd(X, exposure, counts, mask, alpha, log_phi):
    """K5: (dalpha[B,C,G], dlog_phi[B,G]) of the stable form."""
    dev, B, S, C, G = _check_common(X, counts, mask, alpha, log_phi, exposure=exposure)
    _, _, dalpha, dlog_phi = _outputs(dev, B, C, G, True)
    _run("nb_glm_stable_bwd_launch", "nb_glm_stable_bwd", dev, (
        X.data_ptr(), exposure.data_ptr(), counts.data_ptr(), mask.data_ptr(),
        alpha.data_ptr(), log_phi.data_ptr(), dalpha.data_ptr(), dlog_phi.data_ptr(), B, S, C, G,
    ))
    return dalpha, dlog_phi


def _on(dev):
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no likelihood for device {dev}")
    return dev.type == "cuda"


def _fast(data, alpha, log_phi, want_grads):
    if data.d0 is not None:
        if _on(alpha.device):
            return launch_delta(data.X, data.counts, data.like_mask, data.d0, alpha.contiguous(),
                                data.alpha0, log_phi.contiguous(), data.sigma_raw0, want_grads)
        return nb_fast.glm_delta(
            data.X, data.counts, data.like_mask, data.alpha0, data.sigma_raw0, data.d0,
            data.sp_d0, data.sig_neg_d0, data.y_sp0, alpha, log_phi, want_grads,
        )
    if _on(alpha.device):
        return launch_plain(data.X, data.exposure_rate, data.counts, data.like_mask,
                            alpha.contiguous(), log_phi.contiguous(), want_grads)
    return nb_fast.glm_plain(data.X, data.exposure_rate, data.counts, data.like_mask,
                             alpha, log_phi, want_grads)


def _fused(data, alpha, log_phi, want_grads):
    if _on(alpha.device):
        return launch_fused(data.X, data.counts, data.like_mask, data.d0, alpha.contiguous(),
                            data.alpha0, log_phi.contiguous(), data.sigma_raw0, want_grads)
    from ppcseq_tpu_torch.model.nb_model import delta_likelihood

    value = delta_likelihood(data, alpha, log_phi)
    if not want_grads:
        return value
    return (value, *nb_grad.likelihood_grads(data.X, data.exposure_rate, data.counts,
                                             data.like_mask, alpha, log_phi))


def _stable_value(data, alpha, log_phi):
    if _on(alpha.device):
        return launch_stable_fwd(data.X, data.exposure_rate, data.counts, data.like_mask,
                                 alpha.contiguous(), log_phi.contiguous())
    from ppcseq_tpu_torch.model.nb_model import stable_likelihood

    return stable_likelihood(data, alpha, log_phi)


def _stable_grads(data, alpha, log_phi):
    if _on(alpha.device):
        return launch_stable_bwd(data.X, data.exposure_rate, data.counts, data.like_mask,
                                 alpha.contiguous(), log_phi.contiguous())
    return nb_grad.likelihood_grads(data.X, data.exposure_rate, data.counts, data.like_mask,
                                    alpha, log_phi)


class _GradsInForward(torch.autograd.Function):
    """Value and gradients from one pass (K1/K2/K3); backward scales the
    stored gradients by grad_out[b]."""

    @staticmethod
    def forward(ctx, alpha, log_phi, data, compute):
        value, dalpha, dlog_phi = compute(data, alpha, log_phi, True)
        ctx.save_for_backward(dalpha, dlog_phi)
        return value

    @staticmethod
    def backward(ctx, grad_out):
        dalpha, dlog_phi = ctx.saved_tensors
        return grad_out[:, None, None] * dalpha, grad_out[:, None] * dlog_phi, None, None


class _StableForwardBackward(torch.autograd.Function):
    """Forward K4, backward K5 (scaled by grad_out[b])."""

    @staticmethod
    def forward(ctx, alpha, log_phi, data):
        ctx.data = data
        ctx.save_for_backward(alpha, log_phi)
        return _stable_value(data, alpha, log_phi)

    @staticmethod
    def backward(ctx, grad_out):
        alpha, log_phi = ctx.saved_tensors
        dalpha, dlog_phi = _stable_grads(ctx.data, alpha, log_phi)
        return grad_out[:, None, None] * dalpha, grad_out[:, None] * dlog_phi, None


def _wants_grad(alpha, log_phi):
    return torch.is_grad_enabled() and (alpha.requires_grad or log_phi.requires_grad)


def nb_glm_likelihood_fast(data, alpha, log_phi):
    """Masked likelihood on the hoisted math, value[B]: K1 (delta form) when
    `data` carries baseline constants (nb_model.with_baseline), K2 (stable
    plain form) when it does not. alpha[B, C, G] and log_phi[B, G] lie on
    the data's device."""
    if _wants_grad(alpha, log_phi):
        return _GradsInForward.apply(alpha, log_phi, data, _fast)
    return _fast(data, alpha, log_phi, want_grads=False)


def nb_glm_likelihood(data, alpha, log_phi):
    """Masked likelihood in the stable form, value[B]; a baseline on `data`
    is ignored (nb_kernel.py:201-210 of the JAX package). Forward K4,
    backward K5."""
    if _wants_grad(alpha, log_phi):
        return _StableForwardBackward.apply(alpha, log_phi, data)
    return _stable_value(data, alpha, log_phi)


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
