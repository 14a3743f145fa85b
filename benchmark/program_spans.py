"""The program's own span record (ppcseq_tpu_torch/utils/log.py), which
it keeps while its stages are traced, as they are in a `--trace 1` run.

`calls(trace)` takes `log.spans()` after the window and gives each of the
window's unprofiled analyses the spans of the `identify_outliers` call it
ran: the root span that the analysis's wall holds (both on
time.perf_counter) and every span of the root's analysis id. A program
without the record (a checkout from before it) reads as nothing, as does
an analysis without a root span.
"""

from __future__ import annotations

import numpy as np

ROOT = "identify_outliers"


def program_spans() -> list | None:
    """log.spans() of the program, or None where the program keeps none."""
    from ppcseq_tpu_torch.utils import log

    read = getattr(log, "spans", None)
    return None if read is None else read()


def calls(trace, spans=None) -> list:
    """[(root span, [the spans of its call])] of the unprofiled analyses
    that hold a root span; `spans` defaults to the program's record."""
    spans = program_spans() if spans is None else spans
    if not spans:
        return []
    by_analysis: dict = {}
    for s in spans:
        by_analysis.setdefault(s.analysis, []).append(s)
    roots = [s for s in spans if s.name == ROOT and s.parent is None and s.end is not None]
    out = []
    for an in trace.unprofiled():
        inside = [r for r in roots if an.start <= r.start and r.end <= an.end]
        if inside:
            out.append((inside[0], by_analysis[inside[0].analysis]))
    return out


def mean_per_call(trace, per_call, spans=None) -> float | None:
    """Mean over the unprofiled analyses with a root span of
    per_call(root, spans of the call); None where no analysis has one."""
    got = calls(trace, spans)
    if not got:
        return None
    return float(np.mean([per_call(root, mine) for root, mine in got]))


def seconds_in(name: str):
    """per_call: the summed seconds of the call's spans named `name`."""
    return lambda root, mine: sum(s.end - s.start for s in mine if s.name == name)


def self_seconds(span, mine) -> float:
    """span's duration less the union of its children's intervals."""
    kids = sorted((max(s.start, span.start), min(s.end, span.end))
                  for s in mine if s.parent == span.id)
    covered, hi = 0.0, span.start
    for a, b in kids:
        a = max(a, hi)
        if b > a:
            covered += b - a
            hi = b
    return (span.end - span.start) - covered
