"""Where the time goes in the port's VB fit, on one NVIDIA GPU.

    python -m ppcseq_tpu_torch.utils.profile_advi [--steps 200] [--trace DIR]

On the bundled 15-gene README configuration (15 checked genes + 500
controls, S=21): times ADVI steps and 100-sample ELBO evaluations with
CUDA-synchronized wall clocks, eagerly and as the CUDA graphs fit_advi
replays (advi.CapturedFit: one step per replay), and profiles a window of
100 steps of each with torch.profiler: the device's busy share (summed
kernel time / wall), the device kernels and the host's launch calls
(cudaLaunchKernel, cudaGraphLaunch) per step, the likelihood kernels'
launches as the device ran them, the graph replays and the top kernels by
device time. Then runs identify_outliers warm, eagerly and through graphs, with
the stage timings of utils/log.py. Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import time

import torch

# the host's launch calls: a kernel launch, or a graph's
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch")


def _form(name: str, flag: str | None = None):
    """The device symbol of a kernel: csrc/nb_tile.cuh's tile_kernel or
    row_kernel over the form `name` (with its bool template argument
    `flag`), in the demangler's spelling of the profiler ("Fast<true>") or
    of cu++filt ("Fast<(bool)1>")."""
    arg = "" if flag is None else r"<(?:\(bool\))?(?:%s)>" % flag
    return re.compile(r"(?:tile|row)_kernel<[^,]*?\b%s%s," % (name, arg))


_TRUE, _FALSE = "1|true", "0|false"
# ops/nb_kernel.KERNELS name -> its CUDA functions' symbols
KERNEL_SYMBOLS = {
    "nb_glm_delta": _form("Fast", _TRUE),
    "nb_glm_plain": _form("Fast", _FALSE),
    "nb_glm_fused": _form("Fused"),
    "nb_glm_stable_fwd": _form("Stable", _FALSE),
    "nb_glm_stable_bwd": _form("Stable", _TRUE),
    "nb_glm_delta_f64": _form("Fast64", _TRUE),
    "nb_glm_plain_f64": _form("Fast64", _FALSE),
}


def kernel_launches(events) -> dict:
    """Launches of each likelihood kernel among a profile's device events
    (key_averages()), by KERNEL_SYMBOLS: what the device ran, graph replays
    included, against which nb_kernel.LAUNCHES's Python counts are held."""
    out = {}
    for e in events:
        if e.device_type.name != "CUDA":
            continue
        for name, symbol in KERNEL_SYMBOLS.items():
            if symbol.search(e.key):
                out[name] = out.get(name, 0) + e.count
    return out


def profiled(fn, units, trace: str | None = None) -> dict:
    """fn() once under torch.profiler, after a synchronize: its wall, the
    device's busy share (CUDA kernels' summed device time over the wall;
    None where the profiler recorded no kernel), and per unit of work
    (`units` steps or leapfrogs, or a function of fn's result that counts
    them) the device kernels and the host's launch calls; and the
    likelihood kernels' launches on the device (kernel_launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    units = units(out) if callable(units) else units
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    calls = sum(e.count for e in events if e.key in HOST_LAUNCH_CALLS)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
    return {"wall_ms": wall * 1e3, "units": units,
            "device_busy_share": dev_us * 1e-6 / wall if dev_us > 0 and wall > 0 else None,
            "device_kernels_per_unit": sum(e.count for e in kernels) / units,
            "host_launches_per_unit": calls / units,
            "kernel_launches": kernel_launches(events),
            "top": [{"name": e.key[:60], "count": e.count,
                     "device_us": e.self_device_time_total} for e in top]}


def _model(device, dtype=torch.float32):
    """(counts table, 15-gene model data with its baseline, dims) in dtype."""
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
                                       device=device, dtype=dtype)
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
    ap.add_argument("--trace", default=None, help="directory for chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_advi needs a CUDA device")

    from ppcseq_tpu_torch.infer import graphs
    from ppcseq_tpu_torch.infer.advi import CapturedFit, adam_init, advi_step, elbo_estimate
    from ppcseq_tpu_torch.model import nb_model
    from ppcseq_tpu_torch.model.params import state_spec
    from ppcseq_tpu_torch.ops import nb_kernel
    from ppcseq_tpu_torch.utils.device import gpu_name_and_power_limit

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": gpu_name_and_power_limit()}), flush=True)
    counts, data, dims = _model(dev)
    logp = functools.partial(nb_model.log_joint, data=data, dims=dims)
    gen = torch.Generator(device=dev).manual_seed(0)
    m0 = torch.as_tensor(nb_model.smart_init(data, dims), dtype=torch.float32, device=dev)
    log_s0 = torch.full((dims.dim,), -1.0, device=dev)
    noise = torch.randn((100, 1, dims.dim), generator=gen, device=dev)
    eps100 = torch.randn((100, dims.dim), generator=gen, device=dev)
    box = {"p": {"m": m0, "log_s": log_s0}, "s": adam_init({"m": m0, "log_s": log_s0})}

    def step():
        box["p"], box["s"], _ = advi_step(box["p"], box["s"], noise[0], logp, 0.1)

    def elbo():
        with torch.no_grad():
            elbo_estimate(logp, box["p"]["m"], box["p"]["log_s"], eps100)

    def chunk():
        for k in range(100):
            box["p"], box["s"], _ = advi_step(box["p"], box["s"], noise[k], logp, 0.1)

    def trace(name):
        return os.path.join(args.trace, f"advi_{name}.json") if args.trace else None

    _synced(step, 20)
    t_step = _synced(step, args.steps)
    t_elbo = _synced(elbo, 20)
    print(json.dumps({"measure": "advi", "path": "eager", "S": dims.S, "G": dims.G,
                      "D": dims.dim, "step_ms": t_step * 1e3, "steps_per_s": 1.0 / t_step,
                      "elbo100_ms": t_elbo * 1e3}), flush=True)
    print(json.dumps({"measure": "advi_profile", "path": "eager", "steps": 100,
                      **profiled(chunk, 100, trace("eager"))}), flush=True)

    graphs.reset_stats()
    t0 = time.perf_counter()
    fit = CapturedFit(logp, state_spec(dims.dim), None, m0, log_s0, eval_every=100,
                      grad_samples=1, elbo_samples=100, learning_rate=0.1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fit.load(m0, log_s0, None)
    n_chunks = max(1, args.steps // 100)
    _synced(lambda: fit.chunk(noise), 1)
    t_chunk = _synced(lambda: fit.chunk(noise), n_chunks)
    t_elbo = _synced(lambda: fit.elbo(eps100), 20)
    print(json.dumps({"measure": "advi", "path": "graphs", "step_ms": t_chunk * 10,
                      "steps_per_s": 100 / t_chunk, "elbo100_ms": t_elbo * 1e3,
                      "build_s": build_s, "capture_s": graphs.STATS["capture_s"],
                      "build_launches": graphs.STATS["build_launches"],
                      "replays_per_chunk": 100}), flush=True)
    print(json.dumps({"measure": "advi_profile", "path": "graphs", "steps": 100,
                      **profiled(lambda: fit.chunk(noise), 100, trace("graphs"))}), flush=True)
    del fit

    from ppcseq_tpu_torch import identify_outliers
    from ppcseq_tpu_torch.utils import log

    df = counts.assign(is_significant=counts.FDR < 0.01)
    kw = dict(formula="~ Label", sample="sample", transcript="symbol", abundance="value",
              significance="PValue", do_check="is_significant", percent_false_positive_genes=5,
              seed=42, device=dev)
    for path in ("eager", "graphs", "eager", "graphs"):
        ctx = graphs.disabled() if path == "eager" else contextlib.nullcontext()
        with ctx:
            identify_outliers(df, **kw)  # warm-up
            log.set_verbose(True)
            nb_kernel.reset_launches()
            graphs.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = identify_outliers(df, **kw)
            torch.cuda.synchronize()
            log.set_verbose(False)
        print(json.dumps({"measure": "e2e_warm_15gene", "path": path,
                          "wall_s": time.perf_counter() - t0,
                          "vb_iterations": list(res.attrs["vb_iterations"]),
                          "kernel_launches": {k: v for k, v in nb_kernel.LAUNCHES.items() if v},
                          "graph_replays": graphs.STATS["replays"],
                          "capture_s": graphs.STATS["capture_s"]}), flush=True)


if __name__ == "__main__":
    main()
