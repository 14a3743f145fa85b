"""Seconds per analysis in host preparation: the program's stages
"format input", "design matrix and scaling" and both passes' "model data"
(utils/log.py spans), averaged over the window's unprofiled analyses."""

STAGES = ("format input", "design matrix and scaling", "model data")


def read(trace):
    return trace.stage_seconds(lambda s: s in STAGES)
