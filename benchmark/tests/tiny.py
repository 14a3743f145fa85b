"""A cell of the benchmark cut to a size the CPU tests can run: the
cohort50k configuration's synthetic cohort at 60 genes x 8 samples with 3
checked, every gene in the fit; and the checks' sizes cut to match."""

from __future__ import annotations

import builtins
import time

from benchmark import harness

TEST_SIZES = {"REFERENCE_DRAWS": 200, "PPC_CELLS": 100}


def use_test_sizes(setattr=builtins.setattr) -> None:
    """The checks' draw and cell counts cut to TEST_SIZES, through
    `setattr` (pytest's monkeypatch.setattr in the tests)."""
    for name, value in TEST_SIZES.items():
        setattr(harness, name, value)


def tiny_cell(workload: str = "cohort50k.vb", traffic: str | None = None) -> harness.Cell:
    cell = harness.load_cell(workload)
    if traffic is not None:
        cell.traffic = harness.load_traffic(cell.bench, traffic)
    cell.config["cohort"] = dict(cell.config["cohort"], n_genes=60, n_samples=8, n_check=3,
                                 outlier_frac=0.05)
    cell.config["identify"] = dict(cell.config["identify"], how_many_negative_controls=57)
    cell.config["compare_analyses"] = 1
    return cell


def run(cell, seed: int = 20261018, trace: bool = False) -> dict:
    """The benchmark's run on the CPU: set-up, a window of one analysis,
    the comparison."""
    from benchmark.run import run as run_cell

    return run_cell(cell, seed, 0.0, trace, "cpu", t0=time.perf_counter())
