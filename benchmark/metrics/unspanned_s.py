"""Seconds per analysis that no stage of the program covers: the
`identify_outliers` root span's self time, its duration less the union of
its children's intervals (program_spans.py), averaged over the window's
unprofiled analyses."""

from benchmark.program_spans import mean_per_call, self_seconds


def read(trace, spans=None):
    return mean_per_call(trace, self_seconds, spans)
