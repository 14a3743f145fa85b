"""One run of one cell of ppcseq_tpu_torch's benchmark on NVIDIA GPUs.

    python benchmark/run.py --workload readme15.vb --seed 7 --seconds 51 --trace 0

From the root of a checkout. Set-up makes the cell's cohort from the
seed, then runs one warm analysis at the cell's settings; the window then
calls identify_outliers back to back (closed loop, one caller), each
analysis with a seed of its own, and starts none once `--seconds` have
passed. After the window a sample of the analyses, drawn from the seed,
is held to the plain reference (harness.compare). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device` and `compared`; the compared numbers with their
limits are also the last lines of standard error.

Builds and kernel caches go to benchmark/build/ inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    harness.use_checkout_caches()
    if not (ROOT / "ppcseq_tpu_torch").is_dir():
        _fail("the program (ppcseq_tpu_torch/) is not in this checkout")
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda", 0)
    out = run(cell, args.seed, args.seconds, bool(args.trace), device)
    print("analyses " + json.dumps(out.pop("analyses")), file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        _fail(f"modules that the benchmark may not load were loaded: {found}", 3)
    for name, (value, limit) in out["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    out["compared"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                       for k, (v, lim) in out["compared"].items()}
    print(json.dumps(out), flush=True)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0) -> dict:
    """Set-up, the window, the trace's reading and the comparison; the
    result line's object with `compared` as {number: (value, limit)}."""
    import torch

    from benchmark import harness
    from ppcseq_tpu_torch import identify_outliers

    cuda = torch.device(device).type == "cuda"
    df = harness.make_cohort(cell, seed)
    identify_outliers(df, seed=harness.analysis_seed(seed, 0),
                      **harness.identify_kwargs(cell, device))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    analyses, window, prof = harness.run_window(cell, df, seed, seconds, trace, device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        kernels, span_us, offset = harness.read_profile(prof, analyses) if prof else ([], (0, 0), 0)
        del prof
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell.chips,
           "memory_peak_bytes": int(peak)}

    # the program's state goes before the reference runs on the device
    judged = [a for a in analyses if a.result is not None]
    if cuda:
        torch.cuda.empty_cache()
    ctx = harness.Context(cell, df, seed, device)
    metrics, breakdown = {}, None
    if trace:
        profiled = [a for a in analyses if a.profiled]
        bound, ops = harness.likelihood_work(cell, profiled, ctx.shape)
        tr = harness.Trace(analyses, kernels, span_us, sum(a.wall for a in profiled), bound, ops,
                           peak)
        for m in cell.per_layer:
            v = harness.load_by_path(cell.bench / "metrics" / f"{m['name']}.py").read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        busy_us = harness.busy_us(kernels, span_us)
        dev.update(busy_s=busy_us * 1e-6, window_s=(span_us[1] - span_us[0]) * 1e-6,
                   profiled_analyses=len(profiled))
        breakdown = harness.breakdown(tr, offset) if kernels else None
        del tr
    else:
        values = {"analysis_s": window / len(analyses), "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    walls = [[a.wall, a.work] for a in analyses]
    n_window = len(analyses)
    del analyses
    per, compared = harness.compare(ctx, judged)
    failed = sum(any(v > compared[k][1] for k, v in p.items()) for p in per)
    out = {"correct": failed == 0, "attempted": n_window, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and breakdown:
        out["breakdown"] = breakdown
    out["compared"] = compared
    out["analyses"] = walls  # [wall, the work counter's summary] per analysis
    return out


if __name__ == "__main__":
    main()
