"""Device time of the likelihood kernels K1-K5 at the main path's shapes, for
one checkout of the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 bench_kernels.py [--root DIR] [--tag NAME] [--sweep KERNEL] [--sass] [--k3-grads]

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
To compare two checkouts on one card, run both in one call, in turns:
parent, change, change, parent.

--sweep KERNEL times that kernel (nb_glm_delta, nb_glm_fused,
nb_glm_stable_fwd or nb_glm_stable_bwd) instead under every launch layout
(T genes, BY b-lanes, SY sample lanes per block; ops/nb_kernel.py's _row
and _tiled) it takes at each shape, one JSON line each, to choose
nb_kernel.layout()'s rules.
K4's and K5's row layout is built only for this sweep: layout() never
picks it (their sweep results, slower than tiled at every shape, are in
PERF.md).

--sass counts, in the built K3-K5 libraries (C = 2), the special-function
instructions (MUFU.EX2, MUFU.LG2, MUFU.RCP, ...) of each kernel with
`cuobjdump -sass`: in all, and in the innermost loop that holds the most of
them (the sample loop, i.e. per point), one JSON line per kernel.

--k3-grads prints, for K3 at the ragged shapes of tests/test_torch_cuda.py
(_RAGGED, _ragged_case), the largest |d|/(1+|g|) of its gradients against
the plain likelihood_grads in float32 and in float64, of the plain version
against float64, and of K3 against the plain formulas at its own d
(_k3_grads_at_its_d), one JSON line per shape.
"""

from __future__ import annotations

import argparse
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
SWEEPS = ("nb_glm_delta", "nb_glm_fused", "nb_glm_stable_fwd", "nb_glm_stable_bwd")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose ppcseq_tpu_torch to time")
    ap.add_argument("--tag", default="")
    ap.add_argument("--sweep", choices=SWEEPS, help="time this kernel under every launch layout")
    ap.add_argument("--sass", action="store_true", help="count K3-K5's MUFU instructions")
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
        _sass(args.tag)
        return
    if args.k3_grads:
        _k3_grads(args.tag)
        return
    df = load_counts()
    md = chip_smoke._bundled_prep(df, sorted(df.loc[df.FDR < 0.01, "symbol"].unique()), 500)
    bundled = (md.counts, md.X, md.exposure_rate, md.n_check)
    c600 = synthetic_cohort(600, 100, n_check=100, seed=0)[:3] + (100,)
    c50k = synthetic_cohort(50000, 100, n_check=100, seed=0)[:3] + (100,)
    k12 = K1_TO_K5[:2]
    for B, cohort, grads, names in [(1, bundled, True, K1_TO_K5), (100, bundled, False, k12),
                                    (128, bundled, True, K1_TO_K5), (1, c600, True, k12),
                                    (8, c50k, True, K1_TO_K5)]:
        if args.sweep and args.sweep not in names:
            continue
        d, alpha, log_phi, _ = chip_smoke._kernel_case(*cohort, B, 7, dev)
        S, G = d.counts.shape
        calls = chip_smoke._calls(d, alpha, log_phi, grads)[0]
        calls["nb_glm_stable_bwd"] = (_stable_gradient_call(nb_kernel, d, alpha, log_phi),
                                      calls["nb_glm_stable_bwd"][1])
        if args.sweep:
            _sweep(nb_kernel, args.sweep, calls[args.sweep][0], B, S, G, grads, args.tag)
        else:
            for name in names:
                kern, plain = calls[name]
                value, want = kern()[0].double(), plain()[0].double()
                rel = float(((value - want).abs() / want.abs()).max())
                dev_us, n_kernels, _ = chip_smoke._device_us(kern, 20 if G > 1000 else 200)
                print(json.dumps({"tag": args.tag, "kernel": name, "B": B, "S": S, "G": G,
                                  "grads": grads, "device_us": dev_us,
                                  "cuda_kernels_per_call": n_kernels, "value_rel_err": rel}),
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


def _sweep(nb_kernel, name, kern, B, S, G, grads, tag):
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
            print(json.dumps({"tag": tag, "sweep": name, "B": B, "S": S, "G": G, "grads": grads,
                              "T": T, "BY": BY, "SY": SY,
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


def _functions(lib):
    """{mangled name: [(address, opcode, operands)]} of a library's SASS."""
    cuobjdump = next((t for t in ("/usr/local/cuda/bin/cuobjdump", "cuobjdump")
                      if shutil.which(t)), None)
    if cuobjdump is None:
        raise SystemExit("cuobjdump not found")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fns, cur = {}, None
    for line in text.splitlines():
        m = _FN.match(line)
        if m:
            cur = fns.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return fns


def _mufu_counts(insns):
    """(MUFU ops in all, MUFU ops of the innermost loop that holds the most,
    that loop's instruction count, number of loops): a loop is the span from
    a backward branch's target to the branch. (CUDA's accurate logf is a
    polynomial, not MUFU.LG2; expf is one MUFU.EX2, a division one
    MUFU.RCP on its fast path.)"""
    total = Counter(op for _, op, _ in insns if op.startswith("MUFU"))
    loops = []
    for addr, op, rest in insns:
        m = re.search(r"0x([0-9a-f]+)", rest) if op in ("BRA", "BRX") else None
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any((lo, hi) != (a, b) and lo <= a and b <= hi for a, b in loops)]
    best, best_len = Counter(), 0
    for lo, hi in inner:
        body = [op for a, op, _ in insns if lo <= a <= hi]
        c = Counter(op for op in body if op.startswith("MUFU"))
        if sum(c.values()) > sum(best.values()):
            best, best_len = c, len(body)
    return dict(total), dict(best), best_len, len(loops)


def _sass(tag):
    from ppcseq_tpu_torch.ops import _build, nb_kernel

    for source in nb_kernel.SOURCES:
        if source == "nb_glm_delta.cu":
            continue
        fns = _functions(_build._lib_path(source))
        names = _demangle(list(fns))
        for mangled, insns in fns.items():  # K3-K5 at C = 2, by the mangled name
            k345 = re.search(r"Fused|Stable|nb_glm_\w+_kernel", mangled)
            if not k345 or not re.search(r"[IE]Li2E", mangled):
                continue
            name = names[mangled]
            total, point, point_len, n_loops = _mufu_counts(insns)
            print(json.dumps({"tag": tag, "sass": source, "function": name,
                              "instructions": len(insns), "mufu_total": total,
                              "mufu_point_loop": point, "point_loop_instructions": point_len,
                              "loops": n_loops}), flush=True)


if __name__ == "__main__":
    main()
