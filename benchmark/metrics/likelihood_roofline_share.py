"""The likelihood kernels' share of their roofline, in %: the least time
of the likelihood work the profiled analyses needed (their fits'
calls counted from what they returned, frozen/work.py's delta form at
the cell's shape) over the device time of the likelihood kernels, found
by name among the profiler's device activity (csrc/nb_tile.cuh's
tile_kernel and row_kernel, every form). Nothing where none ran."""

import re

from benchmark.frozen.busy import busy

LIKELIHOOD = re.compile(r"\b(tile|row)_kernel<")


def read(trace):
    lo, hi = trace.window_us
    spans = [(s, e) for n, s, e in trace.kernels if LIKELIHOOD.search(n)]
    device_us = busy(spans, lo, hi)
    if device_us <= 0 or trace.likelihood_bound_us <= 0:
        return None
    return 100.0 * trace.likelihood_bound_us / device_us
