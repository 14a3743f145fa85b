"""The port's span record (ppcseq_tpu_torch/utils/log.py) and the
benchmark's readers of it, on the CPU: the record's ids, passes, bound
and switch; one tiny identify_outliers traced under torch.profiler, whose
spans add no range to the profiler's trace, map onto its clock by one
offset, and match the stderr lines that benchmark.harness.SpanTap pairs, and whose root counts the call's graph
captures and kernel launches (graphs through a stand-in for the CUDA
graph, launches through a counted likelihood); and each per-layer metric
of benchmark/metrics/ that reads the record, on a hand-made trace."""

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from ppcseq_tpu_torch import identify_outliers, load_counts
from ppcseq_tpu_torch.infer import graphs
from ppcseq_tpu_torch.ops import nb_kernel
from ppcseq_tpu_torch.pipeline import identify
from ppcseq_tpu_torch.utils import log

torch.set_num_threads(2)

# the stage names the benchmark read before the record existed
STAGES = ("format input", "design matrix and scaling", "model data", "variational fit",
          "CI extraction (exact)", "CI extraction (approximated)", "pass 1 (discovery fit)",
          "pass 2 (truncated test fit)")


@pytest.fixture
def recording():
    log.clear_spans()
    log.set_verbose(True)
    yield
    log.set_verbose(False)
    log.clear_spans()


def test_spans_nest_with_parent_pass_and_analysis_ids(recording, capsys):
    with log.timed("root") as root:
        with log.timed("pass 1 (fit)") as p1:
            with log.timed("leaf", k=1) as leaf:
                leaf.set(n=2)
        with log.timed("pass 2 (fit)"):
            with log.timed("leaf"):
                pass
    with log.timed("root"):
        pass
    got = {(s.analysis, s.name, s.pass_): s for s in log.spans()}
    assert [s.name for s in log.spans()] == ["leaf", "pass 1 (fit)", "leaf", "pass 2 (fit)",
                                             "root", "root"]
    a = root.analysis
    assert root.parent is None and root.pass_ is None and leaf.attrs == {"k": 1, "n": 2}
    assert p1.parent == root.id and leaf.parent == p1.id and leaf.pass_ == 1
    assert got[a, "leaf", 2].parent == got[a, "pass 2 (fit)", 2].id
    assert got[a + 1, "root", None].parent is None
    assert len({s.id for s in log.spans()}) == 6
    assert all(s.start <= s.end for s in log.spans()) and leaf.start >= p1.start
    assert root.start <= p1.start and p1.end <= root.end
    lines = capsys.readouterr().err.splitlines()
    assert lines[0].endswith("] executing root") and lines[0].startswith("[ppcseq +")
    assert lines[-1].endswith(f"] done root ({log.spans()[-1].seconds:.2f}s)")


def test_off_records_and_prints_nothing(capsys):
    log.clear_spans()
    assert not log.verbose()
    with log.timed("stage") as span:
        span.set(n=1)
    assert log.spans() == [] and not span.recording and capsys.readouterr().err == ""


def test_the_buffer_keeps_the_newest_and_counts_the_dropped(recording, monkeypatch):
    monkeypatch.setattr(log, "MAX_SPANS", 3)
    for i in range(5):
        with log.timed(f"s{i}"):
            pass
    assert [s.name for s in log.spans()] == ["s2", "s3", "s4"] and log.dropped_spans() == 2
    log.clear_spans()
    assert log.spans() == [] and log.dropped_spans() == 0


class _StubCapture:
    """graphs.CudaCapture's stand-in on the CPU: warm-up and capture run fn,
    a replay runs it again and takes back the launches it counted (a
    graph's kernels count nothing themselves)."""

    def __init__(self, device, name):
        self.fn = None

    def warmup(self, fn, runs):
        for _ in range(runs):
            fn()

    def capture(self, fn):
        self.fn = fn
        self.outputs = fn()
        return self.outputs

    def replay(self):
        before = dict(nb_kernel.LAUNCHES)
        out = self.fn()
        nb_kernel.LAUNCHES.update(before)
        if isinstance(out, torch.Tensor):
            self.outputs.copy_(out)


CALLS = 2  # traced calls: each reading is taken from the call where it is closest


@pytest.fixture(scope="module")
def traced():
    """Two tiny VB identify_outliers calls (3 checked genes, 20 controls,
    100 ADVI steps a pass) with the spans recorded, under torch.profiler
    (CPU) and with stderr going to a SpanTap. Per call: its spans, the
    Regions it built and the launches it counted; the profiler's raw
    records and the tap over both. The cyclic garbage collector is off
    while they run: a collection that starts between a span's reading and
    the profiler's (or the tap's) would stall the host between the two."""
    from torch.profiler import ProfilerActivity, profile, record_function

    mp = pytest.MonkeyPatch()
    built = []

    class Region(graphs.Region):
        def __init__(self, fn, device, name, *args, **kwargs):
            built[-1].append(name)
            super().__init__(fn, device, name, *args, **kwargs)

    real = nb_kernel.nb_glm_likelihood_fast

    def counted(data, alpha, log_phi):
        nb_kernel.LAUNCHES["nb_glm_delta"] += 1
        return real(data, alpha, log_phi)

    mp.setattr(graphs, "Capture", _StubCapture)
    mp.setattr(graphs, "enabled", lambda device: not graphs._eager)
    mp.setattr(graphs, "Region", Region)
    mp.setattr(nb_kernel, "nb_glm_likelihood_fast", counted)
    mp.setattr(identify.K, "VB_MAX_ITER", 100)
    counts = load_counts()
    counts = counts.assign(is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    tap, stderr, grown, marks = harness.SpanTap(), sys.stderr, [], []
    log.clear_spans()
    log.set_verbose(True)
    sys.stderr = tap
    gc.disable()
    try:
        # each analysis inside a range of its own and perf_counter readings
        # around it, as the benchmark profiles one, after a range that looks
        # the profiler's ops up once
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):
                pass
            for _ in range(CALLS):
                built.append([])
                launches = dict(nb_kernel.LAUNCHES)
                start = time.perf_counter()
                with record_function("analysis"):
                    identify_outliers(counts, formula="~ Label", sample="sample",
                                      transcript="symbol", abundance="value",
                                      significance="PValue", do_check="is_significant",
                                      percent_false_positive_genes=1,
                                      how_many_negative_controls=20, seed=42, device="cpu")
                marks.append((start, time.perf_counter()))
                grown.append({k: v - launches[k] for k, v in nb_kernel.LAUNCHES.items()
                              if v != launches[k]})
    finally:
        gc.enable()
        sys.stderr = stderr
        log.set_verbose(False)
        mp.undo()
    spans = log.spans()
    calls = [[s for s in spans if s.analysis == a] for a in sorted({s.analysis for s in spans})]
    yield SimpleNamespace(calls=calls, prof=prof, tap=tap, built=built, grown=grown,
                          marks=marks)
    log.clear_spans()


def _closest(devs):
    """{key: the smallest |deviation| over the calls} from (key, deviation)
    pairs of every call."""
    best: dict = {}
    for key, d in devs:
        best[key] = min(best.get(key, np.inf), abs(d))
    return best


def test_one_call_is_one_tree(traced):
    assert len(traced.calls) == CALLS
    spans = traced.calls[0]
    (root,) = [s for s in spans if s.parent is None]
    ids = {s.id: s for s in spans}
    assert root.name == "identify_outliers"
    for s in spans:
        if s is not root:
            up = ids[s.parent]
            assert up.start <= s.start and s.end <= up.end and up.name != s.name
    top = [s.name for s in spans if s.parent == root.id]
    assert top == ["argument checks", "format input", "design matrix and scaling",
                   "pass 1 (discovery fit)", "pass 2 (truncated test fit)", "merge",
                   "release graphs"]
    for p in (1, 2):
        names = [s.name for s in spans if s.pass_ == p]
        for name in ("build model data", "prepare data", "baseline", "smart init",
                     "model data", "variational fit", "posterior draws"):
            assert names.count(name) == 1, (p, name)
    assert [s.attrs for s in spans if s.name == "variational fit"] == [{"attempts": 1}] * 2
    children = {s.name: ids[s.parent].name for s in spans if s is not root}
    assert children["design matrix"] == children["sample scaling"] == "design matrix and scaling"


def test_format_input_counts_rows_and_ranks_transcripts(traced):
    """The `format input` span carries the input's rows, the rows kept (3
    checked and 20 control transcripts in every one of the 21 samples) and
    the keys the selection sorted: one per transcript, never one per row."""
    counts = load_counts()
    for spans in traced.calls:
        (span,) = [s for s in spans if s.name == "format input"]
        assert span.attrs == {"rows": len(counts), "kept": 23 * 21,
                              "ranked": counts.symbol.nunique()}
        assert span.attrs["ranked"] < span.attrs["rows"]


def test_spans_add_no_profiler_range_and_one_offset_maps_them(traced):
    """No event of the profiler's trace bears a span's name (a range would
    also sit on the device's timeline under a CUDA profiler). Mapped onto
    the profiler's clock by the one offset that the benchmark takes from
    its first profiled analysis (perf_counter at its start less the start
    of its range), every span of every call lies inside its call's range,
    within 1 ms."""
    names = {s.name for c in traced.calls for s in c}
    ranges = []
    for e in traced.prof.profiler.kineto_results.events():
        assert e.name() not in names, e.name()
        if e.name() == "analysis":
            ranges.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9))
    ranges.sort()
    assert len(ranges) == CALLS
    offset = traced.marks[0][0] - ranges[0][0]
    for spans, (lo, hi) in zip(traced.calls, ranges):
        for s in spans:
            assert lo + offset - 1e-3 <= s.start <= s.end <= hi + offset + 1e-3, s.name


def test_the_stderr_lines_give_the_same_stages(traced):
    """benchmark.harness.SpanTap pairs the stderr lines into the same
    stages as the record, each start and end within 1 ms (in the closer
    of the two calls)."""
    tapped = sorted((sp for sp in traced.tap.spans() if sp[0] in STAGES), key=lambda sp: sp[1])
    mine = sorted((s.start, s.name, s.end) for c in traced.calls for s in c if s.name in STAGES)
    assert [sp[0] for sp in tapped] == [n for _, n, _ in mine]
    per_call = len(mine) // CALLS
    devs = [((stage, k % per_call), a - start, b - end)
            for k, ((stage, a, b), (start, _, end)) in enumerate(zip(tapped, mine))]
    for at in (1, 2):
        for key, dev in _closest((d[0], d[at]) for d in devs).items():
            assert dev < 1e-3, (key, dev)


def test_the_root_counts_the_calls_captures_and_launches(traced):
    for spans, built, grown in zip(traced.calls, traced.built, traced.grown):
        root = spans[-1]
        assert root.name == "identify_outliers"
        assert root.attrs["captures"] == len(built) == 2
        assert [s.name for s in spans if s.name.startswith("capture ")] == [
            f"capture {n}" for n in built]
        assert set(root.attrs) == {"captures", "replays", "launches"}
        assert root.attrs["replays"] > 0
        assert root.attrs["launches"] == grown and grown["nb_glm_delta"] > 0


# ---- the benchmark's readers ------------------------------------------------------

def _span(id, name, start, end, parent=None, analysis=1, **attrs):
    return SimpleNamespace(id=id, name=name, start=start, end=end, parent=parent,
                           analysis=analysis, attrs=attrs)


def _hand_made():
    """Two unprofiled analyses and a profiled one, each one call's spans."""
    analyses = [SimpleNamespace(start=0.0, end=10.0, profiled=False),
                SimpleNamespace(start=10.0, end=20.0, profiled=False),
                SimpleNamespace(start=20.0, end=30.0, profiled=True)]
    trace = SimpleNamespace(unprofiled=lambda: analyses[:2])
    spans = []
    for k, (t, retried) in enumerate(((0.0, False), (10.0, True), (20.0, False))):
        a, i = k + 1, 100 * k
        spans += [
            _span(i + 2, "argument checks", t + 0.5, t + 1.0, i + 1, a),
            _span(i + 3, "sample scaling", t + 1.5, t + 2.5, i + 4, a),
            _span(i + 4, "design matrix and scaling", t + 1.0, t + 3.0, i + 1, a),
            _span(i + 5, "variational fit", t + 3.0, t + 5.0, i + 6, a,
                  attempts=3 if retried else 1),
            _span(i + 6, "pass 1 (discovery fit)", t + 2.8, t + 6.0, i + 1, a),
            _span(i + 7, "hmc fit", t + 6.5, t + 7.0, i + 8, a, rungs=2 if retried else 1),
            _span(i + 8, "pass 2 (truncated test fit)", t + 6.0, t + 8.0, i + 1, a),
            _span(i + 9, "release graphs", t + 8.0, t + 8.25, i + 1, a),
            _span(i + 1, "identify_outliers", t + 0.25, t + 9.0, None, a,
                  captures=2 + k, replays=9,
                  launches={"nb_glm_delta": 10 * a, "nb_glm_plain": a}),
        ]
    return trace, spans


@pytest.mark.parametrize("metric, want", [
    # the root's 8.75 s less its children's union, [0.5, 8.25]
    ("unspanned_s", 8.75 - 7.75),
    ("release_s", 0.25),
    ("tmm_s", 1.0),
    ("graph_captures", 2.5),
    ("likelihood_calls", (11 + 22) / 2),
    ("fit_retries", (0 + (2 + 1)) / 2),
])
def test_each_reader_reads_the_hand_made_record(metric, want):
    mod = harness.load_by_path(harness.BENCH / "metrics" / f"{metric}.py")
    trace, spans = _hand_made()
    assert mod.read(trace, spans) == pytest.approx(want, abs=1e-12)


def test_a_program_without_the_record_reads_as_nothing(monkeypatch):
    mod = harness.load_by_path(harness.BENCH / "metrics" / "unspanned_s.py")
    trace, _ = _hand_made()
    monkeypatch.delattr(log, "spans")
    assert mod.read(trace) is None
