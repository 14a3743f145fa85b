"""Likelihood kernel launches per analysis: the `launches` by kernel that
the program's `identify_outliers` root span counts (nb_kernel.LAUNCHES
over the call, graph replays' booked launches included: the ADVI warm
start and every rung of the HMC ladder too), summed over the kernels and
averaged over the window's unprofiled analyses."""

from benchmark.program_spans import mean_per_call


def read(trace, spans=None):
    return mean_per_call(trace, lambda root, mine: sum(root.attrs["launches"].values()), spans)
