"""Seconds per analysis in the two MCMC fits: the program's "hmc fit"
stages (the ADVI warm start included), averaged over the window's
unprofiled analyses."""


def read(trace):
    return trace.stage_seconds(lambda s: s == "hmc fit")
