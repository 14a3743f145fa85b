"""CUDA graphs captured per analysis: the `captures` the program's
`identify_outliers` root span counts (graphs.STATS over the call),
averaged over the window's unprofiled analyses."""

from benchmark.program_spans import mean_per_call


def read(trace, spans=None):
    return mean_per_call(trace, lambda root, mine: root.attrs["captures"], spans)
