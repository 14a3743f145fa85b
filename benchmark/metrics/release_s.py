"""Seconds per analysis dropping the call's CUDA graphs at its end: the
program's `release graphs` span (graphs.release(), its gc.collect() and
empty_cache()), averaged over the window's unprofiled analyses."""

from benchmark.program_spans import mean_per_call, seconds_in


def read(trace, spans=None):
    return mean_per_call(trace, seconds_in("release graphs"), spans)
