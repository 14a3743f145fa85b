"""The readings that the limits of harness.compare are set from, on the
chip, at the cell's own size, in one process:

    python benchmark/control.py --workload readme15.vb --seeds 101-112 --analyses 2 \
        --faults gradient_doubled,gradient_halved --fault-seeds 201-203

For each seed: the cell's cohort from that seed, `--analyses` analyses
through the timed path with the seeds a run of that seed gives them, then
each compared number of the sound program (the lower readings) and of the
control, the reference in bfloat16 put in the program's place (the upper
readings). For each fault of faults.py named in `--faults` and each seed
of `--fault-seeds`: one analysis with the fault planted, and each compared
number. One JSON line per seed; the last line sums them up: per number,
the largest sound reading, the smallest control reading and, per fault,
its smallest reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def seeds_of(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def _analyses(cell, df, seed, n, device) -> list:
    from benchmark import harness
    from ppcseq_tpu_torch import identify_outliers

    kw = harness.identify_kwargs(cell, device)
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        res = identify_outliers(df, seed=harness.analysis_seed(seed, i + 1), **kw)
        out.append(harness.Analysis(t0, time.perf_counter(), res, 0.0))
    return out


def readings(cell, seeds, n_analyses: int, device, faults=(), fault_seeds=()) -> dict:
    """Per seed, the sound and the control readings of every compared
    number, and the readings under each fault; over the seeds, the largest
    sound reading of each number, the smallest control reading and each
    fault's smallest reading."""
    import torch

    from benchmark import harness
    from benchmark.faults import planted

    cuda = torch.device(device).type == "cuda"
    rows, df, cohort_key = [], None, None
    for seed in dict.fromkeys([*seeds, *fault_seeds]):
        key = None if cell.config["cohort"]["kind"] == "parquet" else seed
        if df is None or key != cohort_key:
            df, cohort_key = harness.make_cohort(cell, seed), key
        row = {"seed": seed}
        if seed in seeds:
            analyses = _analyses(cell, df, seed, n_analyses, device)
            if cuda:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ctx = harness.Context(cell, df, seed, device)
            row["sound"], _ = harness.compare(ctx, analyses)
            row["reference_s"] = time.perf_counter() - t0
            row["control"], _ = harness.compare(ctx, analyses, control=True)
            row["walls"] = [a.wall for a in analyses]
            del analyses
        for name in faults if seed in fault_seeds else ():
            try:  # a fault that makes the program raise has failed, and reads nothing
                with planted(name):
                    analyses = _analyses(cell, df, seed, 1, device)
            except Exception as e:  # noqa: BLE001
                row.setdefault("faults", {})[name] = f"raised {type(e).__name__}: {e}"[:300]
                continue
            if cuda:
                torch.cuda.empty_cache()
            ctx = harness.Context(cell, df, seed, device)
            (row.setdefault("faults", {})[name],), _ = harness.compare(ctx, analyses)
            del analyses
        print(json.dumps(row), flush=True)
        rows.append(row)
    names = sorted({k for r in rows for p in r.get("sound", []) for k in p})
    summary = {}
    for k in names:
        s = [p[k] for r in rows for p in r.get("sound", []) if k in p]
        c = [p[k] for r in rows for p in r.get("control", []) if k in p]
        f_read = {f: [r["faults"][f][k] for r in rows
                      if isinstance(r.get("faults", {}).get(f), dict)] for f in faults}
        summary[k] = {"lower": max(s), "upper": min(c) if c else None, "sound": s, "control": c,
                      "faults": {f: min(v) if v else None for f, v in f_read.items()}}
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,11")
    ap.add_argument("--analyses", type=int, default=1)
    ap.add_argument("--faults", default="", help="faults.py names, comma-separated")
    ap.add_argument("--fault-seeds", default="", help="seeds of the faulted analyses")
    args = ap.parse_args()
    from benchmark import harness

    harness.use_checkout_caches()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("control.py reads the program on the card: no CUDA device")
    cell = harness.load_cell(args.workload)
    faults = [f for f in args.faults.split(",") if f]
    summary = readings(cell, seeds_of(args.seeds), args.analyses, torch.device("cuda", 0),
                       faults, seeds_of(args.fault_seeds) if args.fault_seeds else [])
    print(json.dumps({"workload": cell.name, "card": torch.cuda.get_device_name(0),
                      "summary": {k: {kk: vv for kk, vv in v.items()
                                      if kk in ("lower", "upper", "faults")}
                                  for k, v in summary.items()}}))


if __name__ == "__main__":
    main()
