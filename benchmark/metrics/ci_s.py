"""Seconds per analysis in the posterior-predictive CI extraction: the
program's "CI extraction (approximated|exact)" stages, averaged over the
window's unprofiled analyses."""


def read(trace):
    return trace.stage_seconds(lambda s: s.startswith("CI extraction"))
