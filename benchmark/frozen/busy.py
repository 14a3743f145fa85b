"""The device's busy time over a window, from its activity intervals.

The idea is the busy share of ppcseq_tpu_torch/utils/profile_advi.py at
commit dc3b358 (device time over the wall), with the arithmetic replaced:
there the kernels' device times are summed, which counts twice what
overlaps on two streams; here the intervals are merged first, so the busy
time is the length of their union and can never exceed the window.
"""

from __future__ import annotations


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi]: the complement of the union."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out
