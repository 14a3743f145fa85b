"""One short run of the first cell on the card (NVIDIA GPU and nvcc):

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's kernels have no CPU mode)")


def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "readme15.vb",
                           "--seed", "2147483711", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert {"analysis_s", "setup_s"} <= set(out["metrics"])
