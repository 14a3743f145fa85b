"""Device time of K1 and K2 at the main path's shapes, for one checkout of
the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 bench_k12.py [--root DIR] [--tag NAME] [--sweep]

Imports ppcseq_tpu_torch from DIR (default: this checkout), builds its
kernels under DIR, and prints one JSON line per (kernel, shape): the device
time per call and the CUDA kernels per call (torch.profiler, as
chip_smoke.py's device_us), and the value's relative error against the
kernel's plain version. The shapes and inputs are chip_smoke.py phase
kernel's (this checkout's chip_smoke.py, whichever package is timed): the
ADVI step (1, 21, 515), the value-only ELBO (100, 21, 515) and the bench
HMC (128, 21, 515) on the bundled cohort, the 50k pipeline cohort's ADVI
step (1, 100, 600) and the scale HMC (8, 100, 50000). To compare two
checkouts on one card, run both in one call, in turns: parent, change,
change, parent.

With --sweep, K1 is timed instead under every launch layout (T genes, BY
b-lanes, SY sample lanes per block; ops/nb_kernel.py's _row and _tiled)
that the kernel takes at each shape, one JSON line each, to choose
nb_kernel.layout()'s rules.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke  # this script's directory; imports the package only when called

HERE = Path(__file__).resolve().parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose ppcseq_tpu_torch to time")
    ap.add_argument("--tag", default="")
    ap.add_argument("--sweep", action="store_true", help="time K1 under every launch layout")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k12 needs a CUDA device")
    from ppcseq_tpu_torch import load_counts
    from ppcseq_tpu_torch.ops import nb_kernel
    from ppcseq_tpu_torch.utils.synthetic import synthetic_cohort

    dev = torch.device("cuda", 0)
    nb_kernel.build_all()
    df = load_counts()
    md = chip_smoke._bundled_prep(df, sorted(df.loc[df.FDR < 0.01, "symbol"].unique()), 500)
    bundled = (md.counts, md.X, md.exposure_rate, md.n_check)
    c600 = synthetic_cohort(600, 100, n_check=100, seed=0)[:3] + (100,)
    c50k = synthetic_cohort(50000, 100, n_check=100, seed=0)[:3] + (100,)
    for B, cohort, grads in [(1, bundled, True), (100, bundled, False), (128, bundled, True),
                             (1, c600, True), (8, c50k, True)]:
        d, alpha, log_phi, _ = chip_smoke._kernel_case(*cohort, B, 7, dev)
        S, G = d.counts.shape
        if args.sweep:
            _sweep(nb_kernel, d, alpha, log_phi, grads, args.tag)
        else:
            calls = chip_smoke._calls(d, alpha, log_phi, grads)[0]
            for name in ("nb_glm_delta", "nb_glm_plain"):
                kern, plain = calls[name]
                value, want = kern()[0].double(), plain()[0].double()
                rel = float(((value - want).abs() / want.abs()).max())
                dev_us, n_kernels, _ = chip_smoke._device_us(kern, 20 if G > 1000 else 200)
                print(json.dumps({"tag": args.tag, "kernel": name, "B": B, "S": S, "G": G,
                                  "grads": grads, "device_us": dev_us,
                                  "cuda_kernels_per_call": n_kernels, "value_rel_err": rel}),
                      flush=True)
        del d, alpha, log_phi
        torch.cuda.empty_cache()


def _sweep(nb_kernel, d, alpha, log_phi, grads, tag):
    """K1's device time under the row layout (T, BY, SY) = (128, 1, 0) and
    each tiled layout with whole warps of 4 genes x 8 lanes, at most 256
    threads, BY <= B and SY <= 2 * S."""
    B, C, G = alpha.shape
    S = d.counts.shape[0]
    chosen = nb_kernel.layout(B, S, C, G, True, grads)
    rule = nb_kernel.layout
    layouts = [(128, 1, 0)] + [(t, by, sy) for t in (4, 8, 16, 32) for by in (1, 2, 4, 8)
                               for sy in (1, 2, 4, 8, 16, 32, 64)
                               if (by * sy) % 8 == 0 and 32 <= t * by * sy <= 256
                               and by <= B and sy <= 2 * S]
    try:
        for T, BY, SY in layouts:
            nb_kernel.layout = (
                (lambda B_, S_, C_, G_, delta, want: nb_kernel._row(B_, S_, G_)) if SY == 0 else
                (lambda B_, S_, C_, G_, delta, want, T=T, BY=BY, SY=SY:
                 nb_kernel._tiled(B_, S_, C_, G_, delta, want, T, BY, SY)))
            dev_us = chip_smoke._device_us(
                lambda: nb_kernel.launch_delta(d.X, d.counts, d.like_mask, d.d0, alpha, d.alpha0,
                                               log_phi, d.sigma_raw0, want_grads=grads),
                10 if G > 1000 else 50)[0]
            print(json.dumps({"tag": tag, "sweep": "nb_glm_delta", "B": B, "S": S, "G": G,
                              "grads": grads, "T": T, "BY": BY, "SY": SY,
                              "chosen": (T, BY, SY) == (chosen["T"], chosen["BY"], chosen["SY"]),
                              "device_us": dev_us}), flush=True)
    finally:
        nb_kernel.layout = rule


if __name__ == "__main__":
    main()
