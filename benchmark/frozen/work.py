"""Bytes and operations of one call of the float32 delta-form likelihood.

A frozen copy of the "nb_glm_delta" branch of `work()` and its constants
in ppcseq_tpu_torch/ops/nb_kernel.py at commit dc3b358, so that the
benchmark's yardstick reads the same work whatever kernel a later version
of the program computes it with. The data-dependent branch shares are the
copy's DEFAULT_SHARES: the work counted is a function of the shapes alone.

Bytes: each input read once and each output written once (counts int32,
mask, d0, X, alpha, alpha0, log_phi, sigma_raw0; value (float64), dalpha,
dlog_phi). Operations: FP32 instructions along the branches in the shares,
each term as often as the function needs it, an FMA counted as one, so a
share of the card's peak (which counts an FMA as two) read from it is
conservative.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, 700 W: HBM bytes/s and FP32 operations/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

EXP, LOG, DIV = 8, 20, 10
DEFAULT_SHARES = {"y_le7": 0.5, "mean_y_le7": 3.0, "y_gt7_phi_ge8": 0.25, "mid": 1.0,
                  "series": 0.5}


def _ops_per_point(C: int, grads: bool, sh: dict) -> tuple[float, float, float]:
    """FP32 operations per point (b, s, g), per (b, g) and per (s, g)."""
    small, big_phi = sh["y_le7"], sh["y_gt7_phi_ge8"]
    small_phi = 1.0 - small - big_phi
    series, mid = sh["series"], sh["mid"]
    log1p = 2 * DIV + 15
    pt = 1 + 2 * C + EXP + log1p + 4 + 2 + 5
    datum = small * 12 + (1 - small) * (LOG + DIV + 2)
    datum += EXP + log1p + DIV + 4
    pt += 2 + mid * (EXP + DIV + 2 * log1p + 11) + (1 - mid) * 6
    big_y = DIV + log1p + 17
    pt += small * 15 + big_phi * (big_y + log1p + 7) + small_phi * (big_y + 4)
    if grads:
        pt += EXP + DIV + 14 + 2 * C + series * (EXP + 16) + (1 - series) * 3
        pt += small * 14 + big_phi * 14 + small_phi * (DIV + 12)
    return pt, EXP + 9 * LOG + 10 * DIV + 40 + C, datum


def delta_work(B: int, S: int, C: int, G: int, want_grads: bool = True) -> dict:
    """{"bytes", "ops", "bound_us", "bound_by"} of one delta-form call at
    (B, S, C, G): the least time the card could take for it is the larger
    of bytes over HBM bandwidth and operations over the FP32 peak."""
    e = 4
    n = 4 * S * G + e * (S * G + S * C + B * C * G + B * G)
    n += e * (S * G + C * G + G)
    n += 8 * B + e * (B * C * G + B * G) * want_grads
    per_point, per_gene, per_datum = _ops_per_point(C, want_grads, DEFAULT_SHARES)
    ops = B * S * G * per_point + B * G * per_gene + S * G * per_datum
    t_bytes, t_ops = n / HBM_BYTES_PER_S * 1e6, ops / FP32_OPS_PER_S * 1e6
    return {"bytes": n, "ops": ops, "bound_us": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
