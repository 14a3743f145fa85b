"""The share of the profiled analyses' wall in which no operation ran on
the device, in %: one minus the union of the device's activity intervals
over the window (frozen/busy.py). Nothing where the profiler recorded no
device activity."""

from benchmark.frozen.busy import busy


def read(trace):
    lo, hi = trace.window_us
    if hi <= lo or not trace.kernels:
        return None
    return 100.0 * (1.0 - busy([(s, e) for _, s, e in trace.kernels], lo, hi) / (hi - lo))
