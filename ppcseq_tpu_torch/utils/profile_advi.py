"""Where the time goes in the port's VB fit, on one NVIDIA GPU.

    python -m ppcseq_tpu_torch.utils.profile_advi [--steps 200] [--trace DIR]

On the bundled 15-gene README configuration (15 checked genes + 500
controls, S=21): times ADVI steps and 100-sample ELBO evaluations with
CUDA-synchronized wall clocks, profiles a window of steps with
torch.profiler (device busy share = summed kernel time / wall; the top
kernels by device time), and runs identify_outliers once warm with the
stage timings of utils/log.py. Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import torch


def _model(device):
    from ppcseq_tpu_torch import load_counts
    from ppcseq_tpu_torch.data import ingest
    from ppcseq_tpu_torch.formula.design import create_design_matrix
    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.norm.tmm import sample_scaling

    counts = load_counts()
    work = counts.assign(do_check___=counts.FDR < 0.01)
    my_df = ingest.format_input(work, "~ Label", "sample", "symbol", "value", "do_check___",
                                "PValue", 500)
    X, _, rows = create_design_matrix(my_df, "~ Label", "sample")
    scal = sample_scaling(my_df, "sample", "symbol", "value")
    md = ingest.build_model_data(my_df, "sample", "symbol", "value", "do_check___", X,
                                 list(rows["sample"]),
                                 dict(zip(scal["sample"], scal["exposure_rate"])))
    data, dims = nb_model.prepare_data(md.counts, md.X, md.exposure_rate, md.n_check,
                                       device=device, dtype=torch.float32)
    return counts, nb_model.with_baseline(data, dims), dims


def _synced(fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--trace", default=None, help="directory for a chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_advi needs a CUDA device")

    from ppcseq_tpu_torch.infer.advi import adam_init, advi_step, elbo_estimate
    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.ops import nb_kernel

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    counts, data, dims = _model(dev)
    logp = functools.partial(nb_model.log_joint, data=data, dims=dims)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"m": torch.as_tensor(nb_model.smart_init(data, dims), dtype=torch.float32, device=dev),
              "log_s": torch.full((dims.dim,), -1.0, device=dev)}
    state = adam_init(params)
    eps = torch.randn((1, dims.dim), generator=gen, device=dev)
    eps100 = torch.randn((100, dims.dim), generator=gen, device=dev)
    box = {"p": params, "s": state}

    def step():
        box["p"], box["s"], _ = advi_step(box["p"], box["s"], eps, logp, 0.1)

    def elbo():
        with torch.no_grad():
            elbo_estimate(logp, box["p"]["m"], box["p"]["log_s"], eps100)

    _synced(step, 20)
    t_step = _synced(step, args.steps)
    t_elbo = _synced(elbo, 20)
    print(json.dumps({"measure": "advi", "S": dims.S, "G": dims.G, "D": dims.dim,
                      "step_ms": t_step * 1e3, "steps_per_s": 1.0 / t_step,
                      "elbo100_ms": t_elbo * 1e3}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    launches = sum(e.count for e in kernels)
    print(json.dumps({"measure": "advi_profile", "steps": 100, "wall_ms": wall * 1e3,
                      "device_busy_share": dev_us * 1e-6 / wall if wall > 0 else None,
                      "device_kernels_per_step": launches / 100,
                      "top": [{"name": e.key[:60], "count": e.count,
                               "device_us": e.self_device_time_total} for e in top]}),
          flush=True)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "advi_trace.json"))

    from ppcseq_tpu_torch import identify_outliers
    from ppcseq_tpu_torch.utils import log

    df = counts.assign(is_significant=counts.FDR < 0.01)
    kw = dict(formula="~ Label", sample="sample", transcript="symbol", abundance="value",
              significance="PValue", do_check="is_significant", percent_false_positive_genes=5,
              seed=42, device=dev)
    identify_outliers(df, **kw)  # warm-up
    log.set_verbose(True)
    nb_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    identify_outliers(df, **kw)
    torch.cuda.synchronize()
    log.set_verbose(False)
    print(json.dumps({"measure": "e2e_warm_15gene", "wall_s": time.perf_counter() - t0,
                      "kernel_launches": dict(nb_kernel.LAUNCHES)}), flush=True)


if __name__ == "__main__":
    main()
