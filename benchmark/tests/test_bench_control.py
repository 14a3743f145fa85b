"""The control: the reference in bfloat16 put in the program's place fails
the comparison (control.py reads it on the card at the cells' sizes; here
at the tiny cell's)."""

from __future__ import annotations

from benchmark import control
from benchmark.tests.tiny import tiny_cell


def test_the_bfloat16_control_is_not_correct():
    summary = control.readings(tiny_cell(), [11, 12], 1, "cpu")
    limits = {"elbo_z": None, "exposure_gap": None}
    from benchmark import harness

    for name in ("prep", "vb_fit"):
        limits.update(harness.load_by_path(harness.BENCH / "checks" / f"{name}.py").LIMITS)
    for k in ("elbo_z", "exposure_gap"):
        assert summary[k]["lower"] <= limits[k] < summary[k]["upper"], (k, summary[k])
