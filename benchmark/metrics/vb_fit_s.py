"""Seconds per analysis in the two VB fits: the program's "variational
fit" stages, averaged over the window's unprofiled analyses."""


def read(trace):
    return trace.stage_seconds(lambda s: s == "variational fit")
