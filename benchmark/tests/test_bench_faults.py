"""The run's comparison catches the faults that a VB cell can have
(benchmark/faults.py), each planted in the timed path underneath a run on
the CPU (the look for a chip skipped): an ADVI step that returns its state
unchanged; half of the samples left out of the likelihood with its sum
scaled up over the rest (on the README configuration itself); the
likelihood's gradients alone scaled by 2 or 1/2, or taken over half the
samples; Adam's steps a tenth as long; an answer altered where it is
produced (a credible bound, a call); and in an HMC cell half of the
samples left out, the likelihood tempered by 1/2, a sampler that never
leaves its state. The cells run on one chip: no exchange between chips
to leave out."""

from __future__ import annotations

import pytest

from benchmark import faults, harness
from benchmark.tests.tiny import run, tiny_cell


def readme_cell():
    cell = harness.load_cell("readme15.vb")
    cell.config["compare_analyses"] = 1
    return cell


def hmc_cell():
    return tiny_cell(traffic="hmc")


# (fault, the cell it is planted in, the number it fails)
CASES = [("unchanged_step", tiny_cell, "vb_fits_unimproved"),
         ("half_the_samples", readme_cell, "elbo_z"),
         ("half_the_samples_in_gradient", tiny_cell, "vb_newton_gain"),
         ("gradient_doubled", tiny_cell, "vb_scale_score"),
         ("gradient_halved", tiny_cell, "vb_scale_score"),
         ("step_tenth", tiny_cell, "vb_scale_score"),
         ("bound_altered", tiny_cell, "ppc_off"),
         ("call_altered", tiny_cell, "calls_mismatches"),
         ("half_the_samples", hmc_cell, "mcmc_grad_z"),
         ("likelihood_tempered", hmc_cell, "mcmc_scale_score"),
         ("sampler_stuck", hmc_cell, "mcmc_scale_score")]


def test_every_fault_is_tested():
    assert {fault for fault, _, _ in CASES} == set(faults.FAULTS)


@pytest.mark.parametrize("cell", [tiny_cell, hmc_cell], ids=["vb", "hmc"])
def test_a_sound_run_is_correct(cell):
    out = run(cell())
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault,cell,number", CASES,
                         ids=[f"{f}-{c.__name__}" for f, c, _ in CASES])
def test_a_planted_fault_is_not_correct(fault, cell, number, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = run(cell())
    assert not out["correct"]
    value, limit = out["compared"][number]
    assert value > limit, out["compared"]
