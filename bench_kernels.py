"""Device time of the likelihood kernels K1-K5 and the float64 forms of K1/K2
at the main path's shapes, for one checkout of the PyTorch + CUDA port, on
one NVIDIA GPU.

    python3 bench_kernels.py [--root DIR] [--tag NAME] [--only f32|f64] [--shapes A,H,...]
                             [--sweep KERNEL] [--sass] [--sass-against DIR] [--k3-grads]

Imports ppcseq_tpu_torch from DIR (default: this checkout), builds its
kernels under DIR, and prints one JSON line per (kernel, shape): the device
time per call and the CUDA kernels per call (torch.profiler, as
chip_smoke.py's device_us), and the value's relative error against the
kernel's plain version. The shapes and inputs are chip_smoke.py phase
kernel's (this checkout's chip_smoke.py, whichever package is timed): the
ADVI step (1, 21, 515), the value-only ELBO (100, 21, 515, K1/K2 only) and
the bench HMC (128, 21, 515) on the bundled cohort, the 50k pipeline
cohort's ADVI step (1, 100, 600, K1/K2 only) and the scale HMC (8, 100,
50000). K5's row is one gradient call of the stable form: value and
gradients in one launch, or, in a checkout whose launch_stable_bwd
returns the gradients alone, K4's value and K5's gradients, two launches.
The float64 forms of K1 and K2 (nb_glm_delta_f64, nb_glm_plain_f64) run on
the same cohorts in float64 (chip_smoke._kernel_case(..., dtype=float64))
at all of them and at V (1, 100, 50000) and W (100, 100, 50000, value
only), the 50k command line's ADVI step and ELBO, against nb_fast in
float64. --only f32 or f64 times one of the two groups, --shapes A,H
(labels of SHAPES) some of the shapes. To compare two checkouts on one
card, run both in one call, in turns: parent, change, change, parent.

--sweep KERNEL times that kernel (nb_glm_delta, nb_glm_fused,
nb_glm_stable_fwd, nb_glm_stable_bwd, nb_glm_delta_f64 or
nb_glm_plain_f64) instead under every launch layout (T genes, BY b-lanes,
SY sample lanes per block; ops/nb_kernel.py's _row and _tiled) it takes at
each shape, one JSON line each, to choose nb_kernel.layout()'s rules; the
float64 forms at every shape. K4's and K5's row layout is built only for this sweep: layout()
never picks it (their sweep results, slower than tiled at every shape, are
in PERF.md).

--sass counts, in the built libraries (C = 2), with `cuobjdump -sass`: for
K3-K5 the special-function instructions (MUFU.EX2, MUFU.LG2, MUFU.RCP, ...)
in all and in the innermost loop that holds the most of them (the sample
loop, i.e. per point); for the float64 forms the FP64 instructions (DFMA,
DADD, DMUL, DSETP, MUFU.RCP64H, conversions, ...) of the two innermost
loops that hold the most of them: the sample loop (one point, every branch
side counted once) and, in the tiled layout, the hoisting loop (one staged
point's log(y + 1) and 1/(y + 1)), beside ops/nb_kernel.py's guesses
(EXP64, LOG64, DIV64); one JSON line per kernel. It also prints a SHA-256
of the instruction words of every function of the float32 libraries
(K1-K5). With --sass-against DIR it compares those with the libraries
built under checkout DIR (DIR/build/kernels, by an earlier run with --root
DIR): one line per source with the instantiations whose words differ.

--k3-grads prints, for K3 at the ragged shapes of tests/test_torch_cuda.py
(_RAGGED, _ragged_case), the largest |d|/(1+|g|) of its gradients against
the plain likelihood_grads in float32 and in float64, of the plain version
against float64, and of K3 against the plain formulas at its own d
(_k3_grads_at_its_d), one JSON line per shape.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import chip_smoke  # this script's directory; imports the package only when called

HERE = Path(__file__).resolve().parent
K1_TO_K5 = ("nb_glm_delta", "nb_glm_plain", "nb_glm_fused", "nb_glm_stable_fwd",
            "nb_glm_stable_bwd")
F64 = ("nb_glm_delta_f64", "nb_glm_plain_f64")
SWEEPS = ("nb_glm_delta", "nb_glm_fused", "nb_glm_stable_fwd", "nb_glm_stable_bwd") + F64
K12 = K1_TO_K5[:2]
# (label, B, cohort, gradients, float32 kernels timed); the float64 forms at each
SHAPES = [("A", 1, "bundled", True, K1_TO_K5), ("E", 100, "bundled", False, K12),
          ("H", 128, "bundled", True, K1_TO_K5), ("P", 1, "c600", True, K12),
          ("Z", 8, "c50k", True, K1_TO_K5), ("V", 1, "c50k", True, ()),
          ("W", 100, "c50k", False, ())]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose ppcseq_tpu_torch to time")
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("f32", "f64"), help="time only K1-K5 or the float64 forms")
    ap.add_argument("--shapes", help="comma-separated labels of SHAPES to run (default: all)")
    ap.add_argument("--sweep", choices=SWEEPS, help="time this kernel under every launch layout")
    ap.add_argument("--sass", action="store_true",
                    help="count K3-K5's MUFU and the float64 forms' FP64 instructions")
    ap.add_argument("--sass-against", metavar="DIR",
                    help="with --sass: compare K1-K5's instruction words with DIR's build")
    ap.add_argument("--k3-grads", action="store_true",
                    help="K3's gradient errors at the card tests' ragged shapes")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA device")
    from ppcseq_tpu_torch import load_counts
    from ppcseq_tpu_torch.ops import nb_kernel
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    dev = torch.device("cuda", 0)
    nb_kernel.build_all()
    if args.sass:
        _sass(args.tag, args.sass_against)
        return
    if args.k3_grads:
        _k3_grads(args.tag)
        return
    df = load_counts()
    md = chip_smoke._bundled_prep(df, sorted(df.loc[df.FDR < 0.01, "symbol"].unique()), 500)
    cohorts = {"bundled": (md.counts, md.X, md.exposure_rate, md.n_check),
               "c600": synthetic_cohort(600, 100, n_check=100, seed=0)[:3] + (100,),
               "c50k": synthetic_cohort(50000, 100, n_check=100, seed=0)[:3] + (100,)}
    for label, B, cohort, grads, f32_names in SHAPES:
        if args.shapes and label not in args.shapes.split(","):
            continue
        groups = []  # (dtype, the kernels to time or sweep at this shape)
        if args.sweep:
            if args.sweep in F64:
                groups.append((torch.float64, (args.sweep,)))
            elif args.sweep in f32_names:
                groups.append((torch.float32, (args.sweep,)))
        else:
            if args.only != "f64" and f32_names:
                groups.append((torch.float32, f32_names))
            if args.only != "f32":
                groups.append((torch.float64, F64))
        for dtype, names in groups:
            d, alpha, log_phi, _ = chip_smoke._kernel_case(*cohorts[cohort], B, 7, dev,
                                                           dtype=dtype)
            S, G = d.counts.shape
            calls = chip_smoke._calls(d, alpha, log_phi, grads)[0]
            calls["nb_glm_stable_bwd"] = (_stable_gradient_call(nb_kernel, d, alpha, log_phi),
                                          calls["nb_glm_stable_bwd"][1])
            for name in F64:  # on float64 data K1's and K2's calls launch their float64 forms
                calls[name] = calls[name[:-len("_f64")]]
            if args.sweep:
                _sweep(nb_kernel, args.sweep, calls[args.sweep][0], B, S, G, grads, args.tag,
                       label)
            else:
                for name in names:
                    kern, plain = calls[name]
                    value, want = kern()[0].double(), plain()[0].double()
                    rel = float(((value - want).abs() / want.abs()).max())
                    dev_us, n_kernels, _, _ = chip_smoke._device_us(kern, 20 if G > 1000 else 200)
                    lay = nb_kernel.layout(name, B, S, d.X.shape[1], G, grads)
                    print(json.dumps({"tag": args.tag, "kernel": name, "shape": label, "B": B,
                                      "S": S, "G": G, "grads": grads, "device_us": dev_us,
                                      "cuda_kernels_per_call": n_kernels, "value_rel_err": rel,
                                      "layout": {k: lay.get(k) for k in
                                                 ("T", "BY", "SY", "SC", "n_chunks")}}),
                          flush=True)
            del d, alpha, log_phi, calls
            torch.cuda.empty_cache()


def _stable_gradient_call(nb_kernel, d, alpha, log_phi):
    """One gradient call of the stable form, (value, dalpha, dlog_phi): K5,
    or K4 then K5 where launch_stable_bwd gives the gradients alone."""
    args = (d.X, d.exposure_rate, d.counts, d.like_mask, alpha, log_phi)

    def call():
        out = nb_kernel.launch_stable_bwd(*args)
        return out if len(out) == 3 else (nb_kernel.launch_stable_fwd(*args), *out)
    return call


def _sweep(nb_kernel, name, kern, B, S, G, grads, tag, label):
    """Device time of kernel `name` under the row layout (T, BY, SY) = (128,
    1, 0) and each tiled layout with whole warps of 4 genes x 8 lanes, at
    most 256 threads, BY <= B and SY <= 2 * S."""
    C = 2
    chosen = nb_kernel.layout(name, B, S, C, G, grads)
    rule = nb_kernel.layout
    layouts = [(128, 1, 0)] + [(t, by, sy) for t in (4, 8, 16, 32) for by in (1, 2, 4, 8)
                               for sy in (1, 2, 4, 8, 16, 32, 64)
                               if (by * sy) % 8 == 0 and 32 <= t * by * sy <= 256
                               and by <= B and sy <= 2 * S]
    try:
        for T, BY, SY in layouts:
            nb_kernel.layout = (
                (lambda n, B_, S_, C_, G_, want=True: nb_kernel._row(B_, S_, G_)) if SY == 0 else
                (lambda n, B_, S_, C_, G_, want=True, T=T, BY=BY, SY=SY:
                 nb_kernel._tiled(n, B_, S_, C_, G_, want, T, BY, SY)))
            dev_us = chip_smoke._device_us(kern, 10 if G > 1000 else 50)[0]
            print(json.dumps({"tag": tag, "sweep": name, "shape": label, "B": B, "S": S,
                              "G": G, "grads": grads, "T": T, "BY": BY, "SY": SY,
                              "chosen": (T, BY, SY) == (chosen["T"], chosen["BY"], chosen["SY"]),
                              "device_us": dev_us}), flush=True)
    finally:
        nb_kernel.layout = rule


def _k3_grads(tag):
    sys.path.insert(0, str(HERE / "tests"))
    import test_torch_cuda as t  # this checkout's card tests, whichever package is timed

    for B, S, G in t._RAGGED:
        data, alpha, log_phi = t._ragged_case(B, S, G)
        kern = t._launch(data, alpha, log_phi, "nb_glm_fused")[1:]
        plain = t._plain(data, alpha, log_phi, "nb_glm_fused")[1:]
        plain64 = t._plain(t._f64(data), alpha.double(), log_phi.double(), "nb_glm_fused")[1:]
        at_its_d = t._k3_grads_at_its_d(data, alpha, log_phi)

        def err(got, want):
            return max(t._scaled(a, b) for a, b in zip(got, want))

        print(json.dumps({"tag": tag, "k3_grads": [B, S, G], "kernel_vs_plain": err(kern, plain),
                          "kernel_vs_f64": err(kern, plain64), "plain_vs_f64": err(plain, plain64),
                          "kernel_vs_its_d": err(kern, at_its_d)}), flush=True)


_FN = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _demangle(names):
    tool = next((t for t in ("/usr/local/cuda/bin/cu++filt", "cu++filt", "c++filt")
                 if shutil.which(t)), None)
    if tool is None:
        return dict(zip(names, names))
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, out.stdout.splitlines()))


def _sass_text(lib):
    cuobjdump = next((t for t in ("/usr/local/cuda/bin/cuobjdump", "cuobjdump")
                      if shutil.which(t)), None)
    if cuobjdump is None:
        raise SystemExit("cuobjdump not found")
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def _functions(text):
    """{mangled name: ([(address, opcode, operands)], [instruction words])} of a
    library's SASS (cuobjdump -sass text)."""
    fns, cur = {}, None
    for line in text.splitlines():
        m = _FN.match(line)
        if m:
            cur = fns.setdefault(m.group(1), ([], []))
            continue
        if cur is None:
            continue
        m = _INSN.search(line)
        if m:
            cur[0].append((int(m.group(1), 16), m.group(2), m.group(3)))
        cur[1].extend(_WORD.findall(line))
    return fns


_WORD = re.compile(r"/\* (0x[0-9a-f]{16}) \*/")


def _innermost_loops(insns):
    """The innermost loops, each the span from a backward branch's target to
    the branch."""
    loops = []
    for addr, op, rest in insns:
        m = re.search(r"0x([0-9a-f]+)", rest) if op in ("BRA", "BRX") else None
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any((lo, hi) != (a, b) and lo <= a and b <= hi for a, b in loops)]
    return inner, len(loops)


def _mufu_counts(insns):
    """(MUFU ops in all, MUFU ops of the innermost loop that holds the most,
    that loop's instruction count, number of loops). (CUDA's accurate logf
    is a polynomial, not MUFU.LG2; expf is one MUFU.EX2, a division one
    MUFU.RCP on its fast path.)"""
    total = Counter(op for _, op, _ in insns if op.startswith("MUFU"))
    inner, n_loops = _innermost_loops(insns)
    best, best_len = Counter(), 0
    for lo, hi in inner:
        body = [op for a, op, _ in insns if lo <= a <= hi]
        c = Counter(op for op in body if op.startswith("MUFU"))
        if sum(c.values()) > sum(best.values()):
            best, best_len = c, len(body)
    return dict(total), dict(best), best_len, n_loops


def _is_fp64(op):
    """An instruction of the FP64 pipe or a conversion to or from double."""
    base = op.split(".")[0]
    return (base in ("DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX")
            or (base == "MUFU" and "64H" in op)
            or (base in ("F2F", "I2F", "F2I") and "F64" in op))


def _fp64_loops(insns):
    """The two innermost loops with the most FP64 instructions: their FP64
    count by opcode and their instruction count, most first."""
    inner, _ = _innermost_loops(insns)
    loops = []
    for lo, hi in inner:
        body = [op for a, op, _ in insns if lo <= a <= hi]
        c = Counter(op for op in body if _is_fp64(op))
        loops.append({"fp64": sum(c.values()), "by_opcode": dict(c.most_common()),
                      "instructions": len(body)})
    return sorted(loops, key=lambda d: -d["fp64"])[:2]


def _signature_free(name):
    """A demangled function name without its parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def _word_digests(text):
    """{function without parameters: SHA-256 of its instruction words}."""
    fns = _functions(text)
    names = _demangle(list(fns))
    return {_signature_free(names[m]): hashlib.sha256(" ".join(words).encode()).hexdigest()
            for m, (_, words) in fns.items()}


def _sass(tag, against=None):
    from ppcseq_tpu_torch.ops import _build, nb_kernel

    for source in nb_kernel.SOURCES:
        lib = _build._lib_path(source)
        text = _sass_text(lib)
        fns = _functions(text)
        names = _demangle(list(fns))
        for mangled, (insns, _) in fns.items():
            if not re.search(r"[IE]Li2E", mangled):  # C = 2
                continue
            name = names[mangled]
            if source == "nb_glm_fast64.cu":
                # Fast64<DELTA> in tile_kernel/row_kernel<F, C, GRADS>, or a
                # checkout's fast64_kernel<C, GRADS, DELTA> from before them
                old = re.search(r"fast64_kernelILi2ELb([01])ELb([01])E", mangled)
                delta = old.group(2) == "1" if old else "Fast64ILb1E" in mangled
                grads = old.group(1) == "1" if old else bool(re.search(r"Li2ELb1E", mangled))
                kernel = "nb_glm_delta_f64" if delta else "nb_glm_plain_f64"
                per_point = nb_kernel._ops_per_point(kernel, 2, grads,
                                                     nb_kernel.DEFAULT_SHARES)[0]
                print(json.dumps({
                    "tag": tag, "sass": source, "function": name, "instructions": len(insns),
                    "fp64_total": sum(_is_fp64(op) for _, op, _ in insns),
                    "fp64_loops": _fp64_loops(insns),
                    "work_guess": {"EXP64": nb_kernel.EXP64, "LOG64": nb_kernel.LOG64,
                                   "DIV64": nb_kernel.DIV64,
                                   "per_point_at_default_shares": per_point}}), flush=True)
            elif re.search(r"Fused|Stable|nb_glm_\w+_kernel", mangled):  # K3-K5
                total, point, point_len, n_loops = _mufu_counts(insns)
                print(json.dumps({"tag": tag, "sass": source, "function": name,
                                  "instructions": len(insns), "mufu_total": total,
                                  "mufu_point_loop": point, "point_loop_instructions": point_len,
                                  "loops": n_loops}), flush=True)
        if source == "nb_glm_fast64.cu":
            continue
        digests = _word_digests(text)
        for fn, digest in sorted(digests.items()):
            print(json.dumps({"tag": tag, "sass_words": source, "function": fn,
                              "sha256": digest}), flush=True)
        if against:
            stem = Path(source).stem
            other = sorted(Path(against).glob(f"build/kernels/{stem}-*/lib{stem}.so"),
                           key=lambda p: p.stat().st_mtime)
            if not other:
                raise SystemExit(f"no build of {source} under {against}")
            theirs = _word_digests(_sass_text(other[-1]))
            differ = sorted(k for k in set(digests) | set(theirs)
                            if digests.get(k) != theirs.get(k))
            print(json.dumps({"tag": tag, "sass_against": str(against), "source": source,
                              "functions": len(digests), "functions_there": len(theirs),
                              "identical": len(digests) - len(differ), "differ": differ}),
                  flush=True)


if __name__ == "__main__":
    main()
