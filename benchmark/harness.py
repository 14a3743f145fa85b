"""One run of one cell of the benchmark: set-up, the measured window, the
reading of the trace, and the comparison that decides `correct`.

Everything that belongs to one configuration, traffic mix, per-layer
metric, check or cohort kind sits in a file of its own that this module
finds by the name BENCHMARK.json gives it:

- `configs/<config>.json` (the path is the config's `file`): the cohort,
  the columns, the formula, identify_outliers's arguments, how many of a
  window's analyses are compared, and optionally `limits` of its own
  where its readings call for another limit than a check's;
- `traffic/<traffic>.json`: identify_outliers's arguments of the mix, the
  checks that decide `correct` and the counter of its likelihood work;
- `cohorts/<kind>.py`: `make(spec, seed) -> DataFrame`;
- `checks/<name>.py`: `LIMITS`, `compare(ctx, analysis) -> {number: value}`
  and `control(ctx, analysis) -> {number: value}`;
- `workcount/<name>.py`: `summary(result) -> dict`, read from each
  analysis's result while it is live, and `calls(summary, shape) ->
  [(B, want_grads, count)]`;
- `metrics/<name>.py`: `read(trace) -> float | None`.

The cell's shape (S, C, G, K, D) is the reference's own preparation of
the cohort (Context.shape), never a number kept by hand.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ppcseq_tpu")
PROFILE_ANALYSES = 1  # analyses run under torch.profiler after a traced window
REFERENCE_DRAWS = 1000  # draws of the returned fit the checks' reference averages over
PPC_CELLS = 2000  # checked (sample, transcript) cells the predictive check samples


def use_checkout_caches() -> None:
    """Point the program's builds and any kernel cache at fixed directories
    inside the checkout (benchmark/build/), and keep libraries that could
    load JAX from doing so. Call before the program or torch is imported."""
    import os

    for var, sub in (("PPCSEQ_TORCH_BUILD_DIR", "program"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(BENCH / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("PPCSEQ_VERBOSE", None)


def load_by_path(path: Path):
    """The module in `path`, imported under a name of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    name = "bench_" + re.sub(r"\W", "_", str(path.with_suffix("")))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench: Path = BENCH  # the benchmark's folder, whose files the cell's names find


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json with its configuration
    and traffic files read, and the metrics it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = dict(json.loads((root / cfg["file"]).read_text()), name=cfg["name"])
    traffic = load_traffic(root / "benchmark", w["traffic"])

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, int(w["chips"]), config, traffic, mine(spec["end_to_end"]),
                mine(spec["per_layer"]), root / "benchmark")


def load_traffic(bench: Path, name: str) -> dict:
    """The traffic mix `name`: bench/traffic/<name>.json, with its name."""
    return dict(json.loads((bench / "traffic" / f"{name}.json").read_text()), name=name)


def analysis_seed(seed: int, index: int) -> int:
    """The seed of the analysis `index` of a run (0 is set-up's warm one)."""
    return int(np.random.SeedSequence([seed % 2**64, index]).generate_state(1)[0])


def make_cohort(cell: Cell, seed: int):
    spec = cell.config["cohort"]
    return load_by_path(cell.bench / "cohorts" / f"{spec['kind']}.py").make(spec, seed)


def identify_kwargs(cell: Cell, device) -> dict:
    import torch

    cols = cell.config["columns"]
    return dict(formula=cell.config["formula"], sample=cols["sample"],
                transcript=cols["transcript"], abundance=cols["abundance"],
                significance=cols["significance"], do_check=cols["do_check"],
                pass_fit=True, device=device, dtype=getattr(torch, cell.config["dtype"]),
                **cell.config["identify"], **cell.traffic["identify"])


@dataclass
class Analysis:
    start: float
    end: float
    result: object  # None once the window's sample of analyses to compare has passed it over
    capture_s: float
    work: dict = field(default_factory=dict)  # the traffic's work counter's summary of the result
    spans: list = field(default_factory=list)  # (stage, start, end), perf_counter
    profiled: bool = False

    @property
    def wall(self) -> float:
        return self.end - self.start


class SpanTap:
    """Stands in for sys.stderr while the program's stage spans are on
    (utils/log.py prints "executing <stage>" and "done <stage> (...)"):
    records each line with the time it was written, passes nothing on."""

    LINE = re.compile(r"\] (executing|done) (.+?)(?: \([0-9.]+s\))?$")

    def __init__(self):
        self.buf, self.lines = "", []

    def write(self, s):
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)

    def flush(self):
        pass

    def spans(self) -> list:
        """(stage, start, end): a stage's span runs from its first unmatched
        "executing" line to its "done" line."""
        open_, out = {}, []
        for t, line in self.lines:
            m = self.LINE.search(line)
            if not m:
                continue
            kind, stage = m.groups()
            if kind == "executing":
                open_.setdefault(stage, []).append(t)
            elif open_.get(stage):
                out.append((stage, open_.pop(stage)[0], t))
        return out


def run_window(cell: Cell, df, seed: int, seconds: float, trace: bool, device):
    """Closed loop, one caller: analyses back to back until `seconds` have
    passed since the window opened; the window closes when the last one
    ends. With `trace`, the stage spans are on, and PROFILE_ANALYSES
    more analyses run under torch.profiler once the window has closed. Of
    the analyses' results, a uniform sample of `compare_analyses` drawn
    from the seed is kept (reservoir sampling), so that the process holds
    no more as the window goes on; of every result the traffic's work
    counter keeps its summary. Returns (analyses, window_s, profiler or None)."""
    import torch

    from ppcseq_tpu_torch import identify_outliers
    from ppcseq_tpu_torch.infer import graphs
    from ppcseq_tpu_torch.utils import log

    kw = identify_kwargs(cell, device)
    cuda = torch.device(device).type == "cuda"
    n_prof = PROFILE_ANALYSES if trace else 0
    counter = work_counter(cell)
    tap, prof, analyses = SpanTap(), None, []
    keep = int(cell.config["compare_analyses"])
    rng = np.random.default_rng(analysis_seed(seed, 2**33) % 2**32)
    kept: list[Analysis] = []
    real_stderr = sys.stderr
    if trace:
        log.set_verbose(True)
        sys.stderr = tap
    try:
        t0 = time.perf_counter()
        while True:
            i = len(analyses)
            # the profiled analyses come after the window's own, so that the
            # profiler's lasting cost on launches stays out of their spans
            profiled = i >= 1 and analyses[-1].end - t0 >= seconds
            if profiled and sum(a.profiled for a in analyses) >= n_prof:
                break
            if profiled and prof is None:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                prof = profile(activities=acts)
                prof.__enter__()
            cap0 = graphs.STATS["capture_s"]
            start = time.perf_counter()
            with (torch.profiler.record_function("bench.analysis") if profiled
                  else contextlib.nullcontext()):
                res = identify_outliers(df, seed=analysis_seed(seed, i + 1), **kw)
                if cuda:
                    torch.cuda.synchronize()
            end = time.perf_counter()
            an = Analysis(start, end, res, graphs.STATS["capture_s"] - cap0,
                          counter.summary(res), profiled=profiled)
            analyses.append(an)
            slot = i if i < keep else int(rng.integers(0, i + 1))
            if slot < keep:
                if slot < len(kept):
                    kept[slot].result = None
                    kept[slot] = an
                else:
                    kept.append(an)
            else:
                an.result = None
            del res
        window = max(a.end for a in analyses if not a.profiled) - t0
    finally:
        sys.stderr = real_stderr
        if trace:
            log.set_verbose(False)
        if prof is not None:
            prof.__exit__(None, None, None)
    for stage, a, b in tap.spans():
        for an in analyses:
            if an.start <= a and b <= an.end:
                an.spans.append((stage, a, b))
    return analyses, window, prof


@dataclass
class Trace:
    """What the per-layer metric readers read."""

    analyses: list            # Analysis, the profiled ones last
    kernels: list             # (name, start_us, end_us) of device activity, profiled window
    window_us: tuple          # (start, end) of the profiled analyses, profiler clock
    profiled_wall_s: float
    likelihood_bound_us: float  # least time of the profiled analyses' likelihood work
    likelihood_ops: float
    peak_bytes: int

    def unprofiled(self) -> list:
        rest = [a for a in self.analyses if not a.profiled]
        return rest or self.analyses

    def stage_seconds(self, match) -> float | None:
        """Mean over the analyses left unprofiled of the summed seconds of
        the stages for which match(stage) holds; None where none ran."""
        per = [sum(b - a for s, a, b in an.spans if match(s)) for an in self.unprofiled()]
        if not any(any(match(s) for s, _, _ in an.spans) for an in self.unprofiled()):
            return None
        return float(np.mean(per))


def work_counter(cell: Cell):
    """The traffic's work counter (workcount/<traffic's work>.py)."""
    return load_by_path(cell.bench / "workcount" / f"{cell.traffic['work']}.py")


def likelihood_work(cell: Cell, analyses, shape: dict) -> tuple[float, float]:
    """(least time in µs, FP32 operations) of the likelihood calls the
    analyses needed, by the traffic's work counter over each analysis's
    summary and the frozen copy of the delta form's arithmetic, at the
    cell's (S, C, G)."""
    from benchmark.frozen.work import delta_work

    counter = work_counter(cell)
    bound = ops = 0.0
    for an in analyses:
        for B, grads, n in counter.calls(an.work, shape):
            w = delta_work(B, shape["S"], shape["C"], shape["G"], want_grads=grads)
            bound += n * w["bound_us"]
            ops += n * w["ops"]
    return bound, ops


def read_profile(prof, analyses):
    """(kernels [(name, start_us, end_us)], (lo_us, hi_us), offset) from
    the profiler's raw records: the device activity inside the profiled
    analyses' markers, and the perf_counter reading of the profiler's time
    0. The raw records are read because building the profiler's event tree
    over a whole analysis (some 10^5 kernels) takes minutes."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    marks, kernels = [], []
    for e in res.events():
        start, end = (e.start_ns() - t0) * 1e-3, (e.end_ns() - t0) * 1e-3
        if e.name() == "bench.analysis":
            marks.append((start, end))
        elif e.device_type().name == "CUDA":
            kernels.append((e.name(), start, end))
    if not marks:
        return [], (0.0, 0.0), 0.0
    lo, hi = min(m[0] for m in marks), max(m[1] for m in marks)
    kernels = [k for k in kernels if k[2] > lo and k[1] < hi]
    first = next(a for a in analyses if a.profiled)
    return kernels, (lo, hi), first.start - lo * 1e-6


def breakdown(trace: Trace, marks_offset: float) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each gap named by the program's stage running on the host
    at its middle (perf_counter = profiler µs * 1e-6 + marks_offset)."""
    from benchmark.frozen.busy import gaps

    lo, hi = trace.window_us
    per: dict[str, float] = {}
    for name, s, e in trace.kernels:
        per[name] = per.get(name, 0.0) + (min(e, hi) - max(s, lo)) * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    spans = [sp for an in trace.analyses if an.profiled for sp in an.spans]
    named = []
    for a, b in sorted(gaps([(s, e) for _, s, e in trace.kernels], lo, hi),
                       key=lambda g: g[0] - g[1])[:10]:
        t = (a + b) / 2 * 1e-6 + marks_offset
        inner = [sp for sp in spans if sp[1] <= t <= sp[2]]
        stage = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "outside any stage"
        named.append([stage, (b - a) * 1e-6])
    return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": named}


class Context:
    """What a check needs besides the analysis it judges: the cell, the
    input table, the reference's own preparation of it, the thresholds and
    draw counts of both passes, and a generator of its own."""

    def __init__(self, cell: Cell, df, seed: int, device):
        import torch

        from benchmark.reference import prep

        self.cell, self.df, self.device = cell, df, device
        cols = cell.config["columns"]
        covariates = [t.strip() for t in cell.config["formula"].split("~")[1].split("+")
                      if t.strip() not in ("", "1")]
        self.prep = prep.prepare(
            df, transcript=cols["transcript"], sample=cols["sample"],
            abundance=cols["abundance"], significance=cols["significance"],
            do_check=cols["do_check"],
            n_controls=cell.config["identify"]["how_many_negative_controls"],
            covariates=covariates)
        self.exposure = prep.tmm_exposure(self.prep)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(analysis_seed(seed, 2**32) % 2**63)
        ident = dict(cell.config["identify"], **cell.traffic["identify"])
        S = len(self.prep.samples)
        pfp = ident.get("percent_false_positive_genes", 1.0)
        detrimental = len(covariates) > 0
        self.thr2 = pfp / 100 / S * (2 if detrimental else 1)
        self.thr1 = max(0.05, 2 * self.thr2)
        self.n1 = int(math.ceil(max(10 / self.thr1, 1000)))
        self.n2 = int(math.ceil(max(10 / self.thr2, 1000)))

    def model_arrays(self, an, p: int):
        """The reference's model arrays of pass p, float64 on the check's
        device: pass 2's likelihood leaves out the cells that the program
        excluded after pass 1 (its `pass1_excluded`), as the program's own
        pass 2 does."""
        import torch

        from benchmark.reference.model import ModelArrays

        pr = self.prep
        mask = np.ones(pr.counts.shape)
        if p == 2:
            cols = self.cell.config["columns"]
            ex = an.result.attrs["pass1_excluded"]
            s_of = {s: i for i, s in enumerate(pr.samples)}
            g_of = {g: i for i, g in enumerate(pr.genes)}
            mask[ex[cols["sample"]].map(s_of).to_numpy(),
                 ex[cols["transcript"]].map(g_of).to_numpy()] = 0
        f64 = dict(dtype=torch.float64, device=self.device)
        return ModelArrays(
            counts=torch.as_tensor(pr.counts, **f64), X=torch.as_tensor(pr.X, **f64),
            exposure=torch.as_tensor([self.exposure[s] for s in pr.samples], **f64),
            like_mask=torch.as_tensor(mask, **f64), n_check=pr.n_check)

    @property
    def shape(self) -> dict:
        S, C, G, K = (len(self.prep.samples), self.prep.X.shape[1], len(self.prep.genes),
                      self.prep.n_check)
        return {"S": S, "C": C, "G": G, "K": K, "D": 6 + 2 * G + K * (C - 1)}


class Fit:
    """Pass p's fit as the checks read it, float64 on the check's device:
    a VB fit's distribution N(mean, sd^2) (`draws` None), or an MCMC fit's
    draws [chains, draws per chain, D]."""

    def __init__(self, ctx: Context, an, p: int):
        import torch

        fit = an.result.attrs[f"fit {p}"]
        self.ctx = ctx
        if hasattr(fit, "draws"):
            self.draws = fit.draws.detach().to(ctx.device, torch.float64)
            flat = self.draws.reshape(-1, self.draws.shape[-1])
            self.mean, self.sd = flat.mean(0), flat.std(0)
        else:
            self.draws = None
            self.mean = fit.mean.detach().to(ctx.device, torch.float64)
            self.sd = torch.exp(fit.log_sd.detach().to(ctx.device, torch.float64))

    @property
    def dim(self) -> int:
        return self.mean.numel()

    def sample(self, cols, R: int):
        """[n, len(cols)] draws of the coordinates `cols`: R new draws of a
        VB fit from the context's generator, every draw of an MCMC fit."""
        import torch

        if self.draws is not None:
            return self.draws.reshape(-1, self.dim)[:, cols]
        eps = torch.randn((R, len(cols)), generator=self.ctx.generator, device=self.ctx.device,
                          dtype=torch.float64)
        return self.mean[cols] + self.sd[cols] * eps


def compare(ctx: Context, analyses, control: bool = False):
    """([{number: value} per analysis], {number: (worst value, limit)})
    from the traffic's checks; with `control` the checks' control readings
    instead. A value that is not a finite number reads as infinite. A
    configuration's own `limits` take the place of the checks' where its
    readings call for another limit."""
    per = [{} for _ in analyses]
    checks = [load_by_path(ctx.cell.bench / "checks" / f"{name}.py")
              for name in ctx.cell.traffic["checks"]]
    limits = {k: v for check in checks for k, v in check.LIMITS.items()}
    limits.update(ctx.cell.config.get("limits", {}))
    for check in checks:
        for i, an in enumerate(analyses):
            got = (check.control if control else check.compare)(ctx, an)
            for k, v in got.items():
                per[i][k] = float(v) if v is not None and np.isfinite(v) else math.inf
    worst = {k: (max(p[k] for p in per), limits[k]) for k in per[0]} if per else {}
    return per, worst


def busy_us(kernels, window_us) -> float:
    from benchmark.frozen.busy import busy

    return busy([(s, e) for _, s, e in kernels], *window_us)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def long_table(result, transcript: str):
    """The program's per-(sample, checked transcript) rows, one frame."""
    import pandas as pd

    return pd.concat([swd.assign(**{transcript: t})
                      for t, swd in zip(result[transcript], result["sample_wise_data"])],
                     ignore_index=True)
