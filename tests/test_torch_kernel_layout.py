"""The K1/K2 launch layout (ops/nb_kernel.layout) and the work count behind
the kernels' bounds (ops/nb_kernel.work), on the CPU: plain arithmetic on
shapes, no card needed. The layout's index arithmetic is the kernel's
(csrc/nb_glm_delta.cu): block (x, y) owns genes [x*T, x*T + T) and rows
b in [y*BY, y*BY + BY); chunk k of the samples is [k*SC, k*SC + SC)."""

import re
from pathlib import Path

import numpy as np
import pytest

from ppcseq_tpu_torch.ops import nb_kernel

SHAPES = [(S, G) for S in (1, 21, 100, 301, 2000) for G in (1, 515, 600, 50000)]
_SRC = (Path(nb_kernel.__file__).resolve().parent.parent / "csrc" / "nb_glm_delta.cu").read_text()


def _source_fn(name, params, **names):
    """The one-line C++ function `name` of csrc/nb_glm_delta.cu as a Python
    function of `params`: its return expression with C's `c ? a : b` and
    integer `/` translated (the source cannot be compiled here)."""
    expr = re.search(rf"\b{name}\(int [^)]*\)\s*\{{\s*return ([^;]*);", _SRC).group(1)
    expr = " ".join(expr.split()).replace("/", "//")
    ternary = re.compile(r"\(([^()?:]+)\?([^()?:]+):([^()?:]+)\)")
    while ternary.search(expr):  # parenthesised ones, innermost first
        expr = ternary.sub(r"((\2) if (\1) else (\3))", expr)
    if "?" in expr:  # one at the top level
        cond, rest = expr.split("?", 1)
        expr = "(({1}) if ({0}) else ({2}))".format(cond, *rest.split(":", 1))
    return eval(f"lambda {params}: {expr}", dict(names))


_padded = _source_fn("padded", "T")
_stage_words = _source_fn("stage_words", "rows, T, C, DELTA", padded=_padded)
_fixed_words = _source_fn("fixed_words", "T, BY, SY, C, GRADS, DELTA")


def _smem_bytes(lay, C, delta, grads):
    """Dynamic shared memory of one staged chunk and the fixed part, by the
    source's own stage_words/fixed_words (launch_one refuses any other
    size on the card)."""
    return 4 * (_stage_words(lay["SC"], lay["T"], C, delta)
                + _fixed_words(lay["T"], lay["BY"], lay["SY"], C, grads, delta))


def test_source_carving_is_read():
    """The translated source functions give the carving written out by hand
    at (T, BY, SY) = (16, 8, 2), C = 2, one sample row."""
    assert _padded(16) == 20 and _padded(8) == 12 and _padded(4) == 4
    assert _stage_words(1, 16, 2, True) == 20 * 7 + 2
    assert _stage_words(1, 16, 2, False) == 20 * 4 + 2 + 1
    assert _fixed_words(16, 8, 2, 2, True, True) == 2 * 16 + 16 + 16 * 8 * 16 + 4 * 16 * 16 + 8 * 16
    assert _fixed_words(16, 8, 2, 2, False, False) == 16 * 8 * 16 + 16 * 16 + 8 * 16


def _cover(n, width, n_blocks):
    """How often each of n indices is covered by n_blocks blocks of
    `width`, and whether every block holds at least one index."""
    lo = np.arange(n_blocks) * width
    hi = np.minimum(lo + width, n)
    edges = np.zeros(n + 1, dtype=np.int64)
    np.add.at(edges, lo[lo < n], 1)
    np.add.at(edges, hi[lo < n], -1)
    return np.cumsum(edges)[:n], bool((hi > lo).all())


@pytest.mark.parametrize("S,G", SHAPES, ids=[f"S{S}-G{G}" for S, G in SHAPES])
def test_layout_covers_every_point_once(S, G):
    """Every (b, g) in exactly one block, the S-chunks tile [0, S) and S is
    chunked only where all of it would pass the budget, warps of 4 genes x 8
    lanes and at most 256 threads, shared memory within the budget and equal
    to the source's carving (or the row layout's 128 threads and none), for
    B in {1, 8, 100, 128}, C in 1..8, K1 and K2, with and without
    gradients."""
    for B in (1, 8, 100, 128):
        for C in range(1, 9):
            for delta in (True, False):
                for grads in (True, False):
                    lay = nb_kernel.layout(B, S, C, G, delta, grads)
                    gx, gy = lay["grid"]
                    cov_g, full_g = _cover(G, lay["T"], gx)
                    cov_b, full_b = _cover(B, lay["BY"], gy)
                    assert full_g and full_b and (cov_g == 1).all() and (cov_b == 1).all()
                    cov_s, full_s = _cover(S, lay["SC"], lay["n_chunks"])
                    assert full_s and (cov_s == 1).all()
                    if lay["SY"] == 0:  # the row layout: one thread per (b, g)
                        assert lay["threads"] == lay["T"] == 128 and lay["BY"] == 1
                        assert lay["smem"] == 0 and B >= 32 and S <= 32
                        continue
                    assert lay["threads"] == lay["T"] * lay["BY"] * lay["SY"] <= 256
                    assert lay["T"] % 4 == 0 and (lay["BY"] * lay["SY"]) % 8 == 0
                    assert lay["smem"] == _smem_bytes(lay, C, delta, grads)
                    assert lay["smem"] <= nb_kernel._SMEM_BUDGET <= 232_448
                    one_more = dict(lay, SC=lay["SC"] + 1)
                    assert lay["n_chunks"] == 1 or (
                        _smem_bytes(one_more, C, delta, grads) > nb_kernel._SMEM_BUDGET)


@pytest.mark.parametrize("B,S,G,min_blocks", [(1, 21, 515, 64), (1, 100, 600, 64),
                                              (128, 21, 515, 2 * 132), (8, 100, 50000, 2 * 132)])
def test_layout_fills_the_card(B, S, G, min_blocks):
    """At the main path's (1, 21, 515) the grid reaches most of the 132 SMs
    (the one-thread-per-(b, g) kernel ran 5 blocks there); at the HMC and
    scale shapes there are at least two blocks per SM."""
    gx, gy = nb_kernel.layout(B, S, 2, G)["grid"]
    assert gx * gy >= min_blocks


@pytest.mark.parametrize("S", [301, 2000])
def test_large_s_walks_chunks_through_the_ring(S):
    """Past the budget the samples are walked in chunks through the kernel's
    one staging slot, each chunk still several rows per sample lane."""
    lay = nb_kernel.layout(8, S, 2, 50000)
    assert lay["n_chunks"] > 1 and lay["SC"] >= 8 * lay["SY"]


def test_layout_constants_match_source():
    """layout()'s thread limits are the kernels' (MAX_THREADS, ROW_THREADS)."""
    consts = dict(re.findall(r"constexpr int (MAX_THREADS|ROW_THREADS) = (\d+);", _SRC))
    assert int(consts["MAX_THREADS"]) == nb_kernel._MAX_THREADS
    assert int(consts["ROW_THREADS"]) == nb_kernel._ROW_THREADS


# Bytes of one call at the bundled ADVI step (B, S, C, G) = (1, 21, 2, 515),
# written out by hand: each input read once, each output written once.
_SG, _CG, _BCG, _BG = 21 * 515, 2 * 515, 2 * 515, 515
_K1 = 4 * (3 * _SG + 21 * 2 + _BCG + _CG + _BG + 515)  # counts, mask, d0, X, alpha, alpha0, log_phi, sigma_raw0
_K2 = 4 * (2 * _SG + 21 + 21 * 2 + _BCG + _BG)  # counts, mask, exposure, X, alpha, log_phi
_OUT = 4 * (1 + _BCG + _BG)  # value, dalpha, dlog_phi


@pytest.mark.parametrize("name,grads,expected", [
    ("nb_glm_delta", True, _K1 + _OUT), ("nb_glm_delta", False, _K1 + 4),
    ("nb_glm_plain", True, _K2 + _OUT), ("nb_glm_plain", False, _K2 + 4),
])
def test_work_bytes_by_hand(name, grads, expected):
    w = nb_kernel.work(name, 1, 21, 2, 515, want_grads=grads)
    assert w["bytes"] == expected
    assert w["bytes"] == {("nb_glm_delta", True): 148_492, ("nb_glm_delta", False): 142_312,
                          ("nb_glm_plain", True): 99_136, ("nb_glm_plain", False): 92_956}[
        (name, grads)]


@pytest.mark.parametrize("name", list(nb_kernel.KERNELS))
def test_work_bound_is_the_larger_side(name):
    """bound_us is the larger of bytes / 3.35 TB/s and ops / 67 TFLOP/s;
    a branch that costs more (the gradient's series, small phi) never lowers
    the count."""
    w = nb_kernel.work(name, 8, 100, 2, 50000)
    t_bytes, t_ops = w["bytes"] / 3.35e12 * 1e6, w["ops"] / 67e12 * 1e6
    assert w["bound_us"] == pytest.approx(max(t_bytes, t_ops))
    assert w["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    cheap = nb_kernel.work(name, 8, 100, 2, 50000, shares={"series": 0.0, "y_gt7_phi_ge8": 0.5})
    dear = nb_kernel.work(name, 8, 100, 2, 50000, shares={"series": 1.0, "y_gt7_phi_ge8": 0.0})
    assert dear["ops"] >= cheap["ops"] > 0


def test_launch_signature_matches_source():
    """_SIGNATURES["nb_glm_fast_launch"] has the C function's pointers, ints
    and stream, in order (the source cannot be compiled here)."""
    params = re.search(r'extern "C" int nb_glm_fast_launch\(([^)]*)\)', _SRC).group(1)
    kinds = [nb_kernel._P if "void*" in p else nb_kernel._I for p in params.split(",")]
    assert kinds == nb_kernel._SIGNATURES["nb_glm_fast_launch"]
