"""Breadcrumbs, and the program's spans.

The reference traces execution with bare `writeLines("executing <fn>")`
breadcrumbs (R/utilities.R:653, 687, 736, 788, 1350). This is the
structured equivalent: opt-in via PPCSEQ_VERBOSE=1 (or `set_verbose(True)`),
each breadcrumb carries the elapsed time, and `timed()` wraps a pipeline
stage. Silent by default — library code should not print.

While verbose, `timed()` also records the stage as a `Span`: its name, an
id, the id of the span it opened inside (the innermost one open), the
analysis it belongs to (a number each span opened outside every other
takes anew: one per `identify_outliers` call), its pass (1 or 2, from the
`pass 1 ...` / `pass 2 ...` spans around it), its start and end on
`time.perf_counter()`, and attributes the caller sets while it is open
(`span.set(...)`). Finished spans go to a buffer in memory that keeps the
newest MAX_SPANS (`spans()`, `dropped_spans()`, `clear_spans()`). A span
times the host alone: it never synchronises the device, and it opens no
torch.profiler range (under a profiler that records CUDA activity, a
range is also an event on the device's timeline, which a reader of the
device's busy time would count as work). To lay the spans over a
profiler trace, map perf_counter onto the profiler's clock by one offset
taken from a range of the caller's own around the call.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import time
from dataclasses import dataclass, field

_VERBOSE = os.environ.get("PPCSEQ_VERBOSE", "") not in ("", "0", "false")
_T0 = time.perf_counter()

MAX_SPANS = 100_000  # finished spans kept; the oldest go first

_OPEN: list = []  # the spans open now, innermost last
_FINISHED: collections.deque = collections.deque()
_DROPPED = 0
_SPAN_IDS = itertools.count(1)
_ANALYSIS_IDS = itertools.count(1)


@dataclass(eq=False)
class Span:
    """One stage of one analysis: perf_counter seconds, `end` None while open."""

    name: str
    id: int
    parent: int | None  # the id of the span it opened inside
    analysis: int
    pass_: int | None  # 1 or 2 inside a pass of identify_outliers
    start: float
    end: float | None = None
    attrs: dict = field(default_factory=dict)
    recording = True

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _Unrecorded:
    """What `timed` yields while spans are off: attributes set on it go nowhere."""

    recording = False

    def set(self, **attrs) -> None:
        pass


_UNRECORDED = _Unrecorded()


def set_verbose(on: bool) -> None:
    global _VERBOSE
    _VERBOSE = bool(on)


def verbose() -> bool:
    return _VERBOSE


def breadcrumb(msg: str) -> None:
    """`executing <stage>`-style trace line with the seconds since import."""
    if _VERBOSE:
        print(f"[ppcseq +{time.perf_counter() - _T0:8.2f}s] {msg}", file=sys.stderr, flush=True)


def spans() -> list[Span]:
    """The finished spans kept, in the order they ended."""
    return list(_FINISHED)


def dropped_spans() -> int:
    """Finished spans dropped from the buffer, the oldest first, since it was last cleared."""
    return _DROPPED


def clear_spans() -> None:
    global _DROPPED
    _FINISHED.clear()
    _DROPPED = 0


def _keep(span: Span) -> None:
    global _DROPPED
    while len(_FINISHED) >= MAX_SPANS:
        _FINISHED.popleft()
        _DROPPED += 1
    _FINISHED.append(span)


@contextlib.contextmanager
def timed(stage: str, **attrs):
    """Trace a stage's duration and record it as a Span, which it yields
    (no-op unless verbose: it then yields a span that keeps nothing)."""
    if not _VERBOSE:
        yield _UNRECORDED
        return
    parent = _OPEN[-1] if _OPEN else None
    if stage.startswith("pass 1"):
        pass_ = 1
    elif stage.startswith("pass 2"):
        pass_ = 2
    else:
        pass_ = parent.pass_ if parent else None
    span = Span(stage, next(_SPAN_IDS), parent.id if parent else None,
                parent.analysis if parent else next(_ANALYSIS_IDS), pass_, 0.0, attrs=attrs)
    _OPEN.append(span)
    span.start = time.perf_counter()
    breadcrumb(f"executing {stage}")
    try:
        yield span
    finally:
        span.end = time.perf_counter()
        breadcrumb(f"done {stage} ({span.end - span.start:.2f}s)")
        _OPEN.remove(span)
        _keep(span)
