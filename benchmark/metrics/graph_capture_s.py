"""Seconds per analysis capturing CUDA graphs: the growth of the program's
infer/graphs.STATS["capture_s"] over each analysis, averaged over the
window's unprofiled analyses."""

import numpy as np


def read(trace):
    return float(np.mean([a.capture_s for a in trace.unprofiled()]))
