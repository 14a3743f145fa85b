"""Breadcrumb + timing logger.

The reference traces execution with bare `writeLines("executing <fn>")`
breadcrumbs (R/utilities.R:653, 687, 736, 788, 1350). This is the
structured equivalent: opt-in via PPCSEQ_VERBOSE=1 (or `set_verbose(True)`),
each breadcrumb carries a wall-clock delta, and `timed()` wraps a pipeline
stage. Silent by default — library code should not print.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_VERBOSE = os.environ.get("PPCSEQ_VERBOSE", "") not in ("", "0", "false")
_T0 = time.time()


def set_verbose(on: bool) -> None:
    global _VERBOSE
    _VERBOSE = bool(on)


def verbose() -> bool:
    return _VERBOSE


def breadcrumb(msg: str) -> None:
    """`executing <stage>`-style trace line with elapsed wall clock."""
    if _VERBOSE:
        print(f"[ppcseq +{time.time() - _T0:8.2f}s] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def timed(stage: str):
    """Trace a stage's duration (no-op unless verbose)."""
    breadcrumb(f"executing {stage}")
    t0 = time.time()
    try:
        yield
    finally:
        breadcrumb(f"done {stage} ({time.time() - t0:.2f}s)")
