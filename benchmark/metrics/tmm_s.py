"""Seconds per analysis in the samples' scaling (TMM): the program's
`sample scaling` span, averaged over the window's unprofiled analyses."""

from benchmark.program_spans import mean_per_call, seconds_in


def read(trace, spans=None):
    return mean_per_call(trace, seconds_in("sample scaling"), spans)
