"""The delta-form NB2-log GLM likelihood kernel: wrapper, launch count and
autograd.

`nb_glm_likelihood(data, alpha[B,C,G], log_phi[B,G]) -> value[B]` is the
model's likelihood. On CUDA tensors it launches the hand-written kernel
csrc/nb_glm_delta.cu (built at first use by ops/_build.py), which replaces
the Pallas TPU kernel ppcseq_tpu/ops/nb_kernel.py:_fastk_delta; on CPU
tensors it runs the kernel's plain torch version, ops/nb_fast.glm_delta.
Any other placement or dtype raises: there is no fallback.

What bounds the kernel on the card: per point ~3 exp + 1 log and 12 bytes
of [S, G] inputs (counts, mask, d0), so the special-function units at
large S*G*B and launch latency at the bundled 21 x 515 shape. See the
source for the thread layout.

Gradients: a torch.autograd.Function whose forward computes the value and
the analytic dalpha/dlog_phi in the same pass and whose backward scales
them by grad_out[b]. Called under no_grad (or on inputs that need no
gradient) it launches the value-only instantiation instead.
"""

from __future__ import annotations

import ctypes

import torch

from ppcseq_tpu_torch.ops import nb_fast

SOURCE = "nb_glm_delta.cu"
MAX_C = 8  # the kernel's template instantiations: C in 1..MAX_C

LAUNCHES = 0  # kernel launches (CUDA tensors only), for run reports

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from ppcseq_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        fn = lib.nb_glm_delta_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.nb_glm_delta_max_c.restype = ctypes.c_int
        if lib.nb_glm_delta_max_c() != MAX_C:
            raise RuntimeError("nb_glm_delta.cu and ops/nb_kernel.py disagree on MAX_C")
        _FN = fn
    return _FN


def _check(name, t, dev, dtype, shape):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(X, counts, mask, d0, alpha, alpha0, log_phi, sigma_raw0, want_grads):
    """Run the CUDA kernel: value[B], or (value, dalpha[B,C,G], dlog_phi[B,G]).

    All inputs float32 and contiguous on one CUDA device, counts int32:
    X[S,C], counts/mask/d0 [S,G], alpha[B,C,G], alpha0[C,G], log_phi[B,G],
    sigma_raw0[G].
    """
    global LAUNCHES
    dev = alpha.device
    if dev.type != "cuda":
        raise ValueError(f"launch needs CUDA tensors, got {dev}")
    B, C, G = alpha.shape
    S = X.shape[0]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"design has {C} columns; the kernel takes 1..{MAX_C}")
    f32 = torch.float32
    _check("X", X, dev, f32, (S, C))
    _check("counts", counts, dev, torch.int32, (S, G))
    _check("mask", mask, dev, f32, (S, G))
    _check("d0", d0, dev, f32, (S, G))
    _check("alpha", alpha, dev, f32, (B, C, G))
    _check("alpha0", alpha0, dev, f32, (C, G))
    _check("log_phi", log_phi, dev, f32, (B, G))
    _check("sigma_raw0", sigma_raw0, dev, f32, (G,))
    fn = _launcher()
    partial = torch.empty((B, G), dtype=f32, device=dev)
    value = torch.empty((B,), dtype=f32, device=dev)
    if want_grads:
        dalpha = torch.empty((B, C, G), dtype=f32, device=dev)
        dlog_phi = torch.empty((B, G), dtype=f32, device=dev)
    else:
        dalpha = dlog_phi = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            X.data_ptr(), counts.data_ptr(), mask.data_ptr(), d0.data_ptr(),
            alpha.data_ptr(), alpha0.data_ptr(), log_phi.data_ptr(),
            sigma_raw0.data_ptr(), partial.data_ptr(), value.data_ptr(),
            dalpha.data_ptr() if want_grads else None,
            dlog_phi.data_ptr() if want_grads else None,
            B, S, C, G, int(bool(want_grads)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"nb_glm_delta launch failed: cudaError {rc}")
    LAUNCHES += 1
    return (value, dalpha, dlog_phi) if want_grads else value


def _compute(data, alpha, log_phi, want_grads):
    dev = alpha.device
    if dev.type == "cpu":
        return nb_fast.glm_delta(
            data.X, data.counts, data.like_mask,
            data.alpha0, data.sigma_raw0, data.d0, data.sp_d0, data.sig_neg_d0,
            data.y_sp0, alpha, log_phi, want_grads,
        )
    if dev.type == "cuda":
        return launch(
            data.X, data.counts, data.like_mask, data.d0, alpha.contiguous(),
            data.alpha0, log_phi.contiguous(), data.sigma_raw0, want_grads,
        )
    raise ValueError(f"no likelihood for device {dev}")


class _NbGlmDelta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, log_phi, data):
        value, dalpha, dlog_phi = _compute(data, alpha, log_phi, want_grads=True)
        ctx.save_for_backward(dalpha, dlog_phi)
        return value

    @staticmethod
    def backward(ctx, grad_out):
        dalpha, dlog_phi = ctx.saved_tensors
        return grad_out[:, None, None] * dalpha, grad_out[:, None] * dlog_phi, None


def nb_glm_likelihood(data, alpha, log_phi):
    """Masked delta-form NB2-log likelihood, value[B] (see module doc).

    `data` is a model.nb_model.ModelData with baseline constants attached
    (with_baseline); alpha[B, C, G] and log_phi[B, G] lie on its device.
    """
    if data.d0 is None:
        raise ValueError("nb_glm_likelihood needs baseline constants (nb_model.with_baseline)")
    if torch.is_grad_enabled() and (alpha.requires_grad or log_phi.requires_grad):
        return _NbGlmDelta.apply(alpha, log_phi, data)
    return _compute(data, alpha, log_phi, want_grads=False)
