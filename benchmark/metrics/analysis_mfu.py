"""The whole analysis's share of the card's FP32 peak, in %: the
operations of the likelihood work the profiled analyses needed (as
likelihood_roofline_share counts it) over their wall times the peak
(frozen/work.py). Nothing without device activity in the profile."""

from benchmark.frozen.work import FP32_OPS_PER_S


def read(trace):
    if not trace.kernels or trace.profiled_wall_s <= 0 or trace.likelihood_ops <= 0:
        return None
    return 100.0 * trace.likelihood_ops / (trace.profiled_wall_s * FP32_OPS_PER_S)
