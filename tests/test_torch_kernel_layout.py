"""The K1-K5 launch layouts (ops/nb_kernel.layout) and the work count behind
the kernels' bounds (ops/nb_kernel.work), on the CPU: plain arithmetic on
shapes, no card needed. The layout's index arithmetic is the kernels'
(csrc/nb_tile.cuh): block (x, y) owns genes [x*T, x*T + T) and rows b in
[y*BY, y*BY + BY); chunk k of the samples is [k*SC, k*SC + SC)."""

import re
from pathlib import Path

import numpy as np
import pytest

from ppcseq_tpu_torch.ops import nb_kernel

SHAPES = [(S, G) for S in (1, 21, 100, 301, 2000) for G in (1, 515, 600, 50000)]
_CSRC = Path(nb_kernel.__file__).resolve().parent.parent / "csrc"
_SRC = (_CSRC / "nb_glm_delta.cu").read_text()
_COMMON = (_CSRC / "nb_common.cuh").read_text()
_TILE = (_CSRC / "nb_tile.cuh").read_text()
# kernel -> (source, its form of csrc/nb_tile.cuh, the form's template argument)
_FORMS = {"nb_glm_delta": ("nb_glm_delta.cu", "Fast", {"DELTA": True}),
          "nb_glm_plain": ("nb_glm_delta.cu", "Fast", {"DELTA": False}),
          "nb_glm_fused": ("nb_glm_fused.cu", "Fused", {}),
          "nb_glm_stable_fwd": ("nb_glm_stable.cu", "Stable", {"K5": False}),
          "nb_glm_stable_bwd": ("nb_glm_stable.cu", "Stable", {"K5": True})}
K34 = ["nb_glm_fused", "nb_glm_stable_fwd"]
K345 = K34 + ["nb_glm_stable_bwd"]


def _py(expr):
    """A C++ integer expression as Python: `c ? a : b` and integer `/`."""
    expr = " ".join(expr.split()).replace("/", "//")
    ternary = re.compile(r"\(([^()?:]+)\?([^()?:]+):([^()?:]+)\)")
    while ternary.search(expr):  # parenthesised ones, innermost first
        expr = ternary.sub(r"((\2) if (\1) else (\3))", expr)
    if "?" in expr:  # one at the top level
        cond, rest = expr.split("?", 1)
        expr = "(({1}) if ({0}) else ({2}))".format(cond, *rest.split(":", 1))
    return expr


def _source_fn(name, params, src=_SRC, **names):
    """The one-line C++ function `name` of a csrc/ source (default
    nb_glm_delta.cu) as a Python function of `params` (the source cannot be
    compiled here)."""
    expr = re.search(rf"\b{name}\(int [^)]*\)\s*\{{\s*return ([^;]*);", src).group(1)
    return eval(f"lambda {params}: {_py(expr)}", dict(names))


_padded = _source_fn("padded", "T", _COMMON)
_stage_words = _source_fn("stage_words", "rows, T, C, base, nh", _TILE, padded=_padded)
_fixed_words = _source_fn("fixed_words", "T, BY, SY, C, grads, base, tab", _TILE)


def _form_constants(name):
    """(BASE, NH, TAB) of kernel `name`'s form, read out of its source."""
    source, form, args = _FORMS[name]
    body = (_CSRC / source).read_text().split(f"struct {form} {{", 1)[1]
    const = dict(re.findall(r"static constexpr (?:bool|int) (\w+) = ([^;]+);", body)[:3])
    names = dict(args, true=True, false=False)
    return tuple(int(eval(_py(const[k]), names)) for k in ("BASE", "NH", "TAB"))


def _smem_bytes(name, lay, C, grads):
    """Dynamic shared memory of one staged chunk and the fixed part, by
    csrc/nb_tile.cuh's stage_words/fixed_words and the form's constants
    (launch_layout refuses any other size on the card)."""
    base, nh, tab = _form_constants(name)
    k_grads = int(grads and name != "nb_glm_stable_fwd")  # K4 is value-only
    return 4 * (_stage_words(lay["SC"], lay["T"], C, base, nh)
                + _fixed_words(lay["T"], lay["BY"], lay["SY"], C, k_grads, base, tab))


def test_source_carving_is_read():
    """The translated source functions give the carving written out by hand
    at (T, BY, SY) = (16, 8, 2), C = 2, one sample row, for the forms of
    K1-K5 (csrc/nb_tile.cuh); K5's table holds the 8 ratios beside K4's 8
    logs."""
    assert _padded(16) == 20 and _padded(8) == 12 and _padded(4) == 4
    assert [_form_constants(n) for n in _FORMS] == [(1, 4, 16), (0, 2, 16), (1, 4, 16), (0, 2, 8),
                                                    (0, 2, 16)]
    assert all(nb_kernel._CARVING[n] == _form_constants(n) for n in _FORMS)
    assert _stage_words(1, 16, 2, 1, 4) == 20 * 7 + 2
    assert _stage_words(1, 16, 2, 0, 2) == 20 * 4 + 2 + 1
    assert _fixed_words(16, 8, 2, 2, 1, 1, 16) == 2 * 16 + 16 + 16 * 8 * 16 + 4 * 16 * 16 + 8 * 16
    assert _fixed_words(16, 8, 2, 2, 0, 0, 16) == 16 * 8 * 16 + 16 * 16 + 8 * 16
    assert _fixed_words(16, 8, 2, 2, 0, 0, 8) == 8 * 8 * 16 + 16 * 16 + 8 * 16


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
                    name = "nb_glm_delta" if delta else "nb_glm_plain"
                    lay = nb_kernel.layout(name, B, S, C, G, grads)
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
                    assert lay["smem"] == _smem_bytes(name, lay, C, grads)
                    assert lay["smem"] <= nb_kernel._SMEM_BUDGET <= 232_448
                    one_more = dict(lay, SC=lay["SC"] + 1)
                    assert lay["n_chunks"] == 1 or (
                        _smem_bytes(name, one_more, C, grads) > nb_kernel._SMEM_BUDGET)


def _check_form_cover(name, S, G):
    """Every (b, g) in one block, the S-chunks tile [0, S), warps of 4 genes
    x 8 lanes, at most 256 threads, shared memory within the budget (<=
    232,448 B) and equal to csrc/nb_tile.cuh's carving with the form's
    constants read out of its source, for B in {1, 8, 100, 128}, C in 1..8,
    with and without gradients."""
    for B in (1, 8, 100, 128):
        for C in range(1, 9):
            for grads in (True, False):
                lay = nb_kernel.layout(name, B, S, C, G, grads)
                gx, gy = lay["grid"]
                cov_g, full_g = _cover(G, lay["T"], gx)
                cov_b, full_b = _cover(B, lay["BY"], gy)
                assert full_g and full_b and (cov_g == 1).all() and (cov_b == 1).all()
                cov_s, full_s = _cover(S, lay["SC"], lay["n_chunks"])
                assert full_s and (cov_s == 1).all()
                if lay["SY"] == 0:
                    assert lay["threads"] == lay["T"] == 128 and lay["BY"] == 1
                    assert lay["smem"] == 0 and lay["n_chunks"] == 1
                    continue
                assert lay["threads"] == lay["T"] * lay["BY"] * lay["SY"] <= 256
                assert lay["T"] % 4 == 0 and (lay["BY"] * lay["SY"]) % 8 == 0
                assert lay["smem"] == _smem_bytes(name, lay, C, grads)
                assert lay["smem"] <= nb_kernel._SMEM_BUDGET <= 232_448
                one_more = dict(lay, SC=lay["SC"] + 1)
                assert lay["n_chunks"] == 1 or (
                    _smem_bytes(name, one_more, C, grads) > nb_kernel._SMEM_BUDGET)


@pytest.mark.parametrize("name", K34)
@pytest.mark.parametrize("S,G", SHAPES, ids=[f"S{S}-G{G}" for S, G in SHAPES])
def test_k3_k4_layout_covers_every_point_once(name, S, G):
    """As test_layout_covers_every_point_once for K3 and K4 (_check_form_cover)."""
    _check_form_cover(name, S, G)


@pytest.mark.parametrize("S,G", SHAPES, ids=[f"S{S}-G{G}" for S, G in SHAPES])
def test_k5_layout_covers_every_point_once(S, G):
    """As test_layout_covers_every_point_once for K5, whose form (Stable<true>)
    carries 16 table slots (_check_form_cover)."""
    _check_form_cover("nb_glm_stable_bwd", S, G)


# K4's layout at the ADVI step, the bench HMC and the scale HMC (C = 2), as
# it was before K5 became a form of the same source: K4's value-only
# instantiation keeps its carving (TAB = 8) and layout
_K4_LAYOUTS = {(1, 21, 515): (8, 1, 32, 21, 5596), (128, 21, 515): (16, 8, 2, 21, 12604),
               (8, 100, 50000): (16, 8, 2, 100, 38832)}


@pytest.mark.parametrize("B,S,G", list(_K4_LAYOUTS), ids=["A", "H", "Z"])
def test_k4_layout_and_smem_unchanged(B, S, G):
    for grads in (True, False):
        lay = nb_kernel.layout("nb_glm_stable_fwd", B, S, 2, G, grads)
        assert (lay["T"], lay["BY"], lay["SY"], lay["SC"], lay["smem"]) == _K4_LAYOUTS[(B, S, G)]


@pytest.mark.parametrize("B,S,G,min_blocks", [(1, 21, 515, 64), (1, 100, 600, 64),
                                              (128, 21, 515, 2 * 132), (8, 100, 50000, 2 * 132)])
def test_layout_fills_the_card(B, S, G, min_blocks):
    """At the main path's (1, 21, 515) the grid reaches most of the 132 SMs
    (the one-thread-per-(b, g) kernel ran 5 blocks there); at the HMC and
    scale shapes there are at least two blocks per SM."""
    gx, gy = nb_kernel.layout("nb_glm_delta", B, S, 2, G)["grid"]
    assert gx * gy >= min_blocks


@pytest.mark.parametrize("S", [301, 2000])
def test_large_s_walks_chunks_through_the_ring(S):
    """Past the budget the samples are walked in chunks through the kernel's
    one staging slot, each chunk still several rows per sample lane (K1-K4)."""
    for name in nb_kernel._CARVING:
        lay = nb_kernel.layout(name, 8, S, 2, 50000)
        assert lay["n_chunks"] > 1 and lay["SC"] >= 8 * lay["SY"]


def test_layout_constants_match_source():
    """layout()'s thread limits are the kernels' (MAX_THREADS, ROW_THREADS)."""
    consts = dict(re.findall(r"constexpr int (MAX_THREADS|ROW_THREADS) = (\d+);", _COMMON))
    assert int(consts["MAX_THREADS"]) == nb_kernel._MAX_THREADS
    assert int(consts["ROW_THREADS"]) == nb_kernel._ROW_THREADS


# Bytes of one call at the bundled ADVI step (B, S, C, G) = (1, 21, 2, 515),
# written out by hand: each input read once, each output written once.
_SG, _CG, _BCG, _BG = 21 * 515, 2 * 515, 2 * 515, 515
_K1 = 4 * (3 * _SG + 21 * 2 + _BCG + _CG + _BG + 515)  # counts, mask, d0, X, alpha, alpha0, log_phi, sigma_raw0
_K2 = 4 * (2 * _SG + 21 + 21 * 2 + _BCG + _BG)  # counts, mask, exposure, X, alpha, log_phi
_VALUE = 8  # value[B] is float64
_OUT = _VALUE + 4 * (_BCG + _BG)  # value, dalpha, dlog_phi


@pytest.mark.parametrize("name,grads,expected", [
    ("nb_glm_delta", True, _K1 + _OUT), ("nb_glm_delta", False, _K1 + _VALUE),
    ("nb_glm_plain", True, _K2 + _OUT), ("nb_glm_plain", False, _K2 + _VALUE),
    ("nb_glm_fused", True, _K1 + _OUT), ("nb_glm_fused", False, _K1 + _VALUE),
    ("nb_glm_stable_fwd", True, _K2 + _VALUE), ("nb_glm_stable_fwd", False, _K2 + _VALUE),
    ("nb_glm_stable_bwd", True, _K2 + _OUT), ("nb_glm_stable_bwd", False, _K2 + _VALUE),
])
def test_work_bytes_by_hand(name, grads, expected):
    w = nb_kernel.work(name, 1, 21, 2, 515, want_grads=grads)
    assert w["bytes"] == expected
    assert w["bytes"] == {("nb_glm_delta", True): 148_496, ("nb_glm_delta", False): 142_316,
                          ("nb_glm_plain", True): 99_140, ("nb_glm_plain", False): 92_960,
                          ("nb_glm_fused", True): 148_496, ("nb_glm_fused", False): 142_316,
                          ("nb_glm_stable_fwd", True): 92_960,
                          ("nb_glm_stable_fwd", False): 92_960,
                          ("nb_glm_stable_bwd", True): 99_140,
                          ("nb_glm_stable_bwd", False): 92_960}[(name, grads)]


@pytest.mark.parametrize("name", list(nb_kernel.KERNELS))
def test_work_bound_is_the_larger_side(name):
    """bound_us is the larger of bytes / 3.35 TB/s and ops / 67 TFLOP/s
    (FP32; the float64 forms' FP64 ops over 34 TFLOP/s); a branch that costs
    more (the gradient's series, the dearer phi branch) never lowers the
    count."""
    w = nb_kernel.work(name, 8, 100, 2, 50000)
    peak = 34e12 if name in nb_kernel.F64_FORMS else 67e12
    t_bytes, t_ops = w["bytes"] / 3.35e12 * 1e6, w["ops"] / peak * 1e6
    assert w["bound_us"] == pytest.approx(max(t_bytes, t_ops))
    assert w["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    # the dearer phi branch at y > 7: phi < 8, except in K3-K5, whose phi < 8
    # terms are built once per (b, g) while phi >= 8 keeps log1p(y/phi) per point
    dear_phi = 0.5 if name in K345 else 0.0
    cheap = nb_kernel.work(name, 8, 100, 2, 50000,
                           shares={"series": 0.0, "y_gt7_phi_ge8": 0.5 - dear_phi})
    dear = nb_kernel.work(name, 8, 100, 2, 50000,
                          shares={"series": 1.0, "y_gt7_phi_ge8": dear_phi})
    assert dear["ops"] >= cheap["ops"] > 0


@pytest.mark.parametrize("name", list(_FORMS))
def test_work_does_not_follow_the_layout(name):
    """The count is the function's: ops grow by the same step per b row on
    both sides of layout()'s switch from tiled to row at B = 32, S <= 32
    (the per-(s, g) terms once per (s, g) in either layout)."""
    assert [nb_kernel.layout(name, b, 21, 2, 515)["SY"] == 0 for b in (8, 16, 40)] == \
        [False, False, name not in ("nb_glm_stable_fwd", "nb_glm_stable_bwd")]
    ops = {b: nb_kernel.work(name, b, 21, 2, 515)["ops"] for b in (8, 16, 40)}
    assert ops[40] - ops[16] == pytest.approx(3 * (ops[16] - ops[8]), rel=1e-12)


def test_launch_signature_matches_source():
    """_SIGNATURES["nb_glm_fast_launch"] has the C function's pointers, ints
    and stream, in order (the source cannot be compiled here)."""
    params = re.search(r'extern "C" int nb_glm_fast_launch\(([^)]*)\)', _SRC).group(1)
    kinds = [nb_kernel._P if "void*" in p else nb_kernel._I for p in params.split(",")]
    assert kinds == nb_kernel._SIGNATURES["nb_glm_fast_launch"]


@pytest.mark.parametrize("fn_name,source", [("nb_glm_fused_launch", "nb_glm_fused.cu"),
                                            ("nb_glm_stable_launch", "nb_glm_stable.cu")])
def test_k3_k5_launch_signatures_match_source(fn_name, source):
    """_SIGNATURES of K3-K5's C functions (K4 and K5 share one, by
    want_grads) against their sources."""
    params = re.search(rf'extern "C" int {fn_name}\(([^)]*)\)',
                       (_CSRC / source).read_text()).group(1)
    kinds = [nb_kernel._P if "void*" in p else nb_kernel._I for p in params.split(",")]
    assert kinds == nb_kernel._SIGNATURES[fn_name]
