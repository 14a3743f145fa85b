"""Fits retried per analysis, over both passes: each `variational fit`
span's vb_iterative `attempts` less one, plus each `hmc fit` span's
divergence-ladder `rungs` less one, averaged over the window's
unprofiled analyses."""

from benchmark.program_spans import mean_per_call

RETRIED = {"variational fit": "attempts", "hmc fit": "rungs"}


def retries(root, mine):
    return sum(s.attrs[RETRIED[s.name]] - 1 for s in mine if s.name in RETRIED)


def read(trace, spans=None):
    return mean_per_call(trace, retries, spans)
