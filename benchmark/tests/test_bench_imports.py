"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names compared whole (the program's name begins with the JAX
package's), in a process that drives a run on the CPU, and in the
benchmark's own sources."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import harness

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests.tiny import run, tiny_cell, use_test_sizes
use_test_sizes()
harness.PROFILE_ANALYSES = 0  # the CPU profiler's records of an eager fit take minutes
out = run(tiny_cell(), trace=True)
print(json.dumps({{"correct": out["correct"], "forbidden": harness.forbidden_modules(),
                   "program": "ppcseq_tpu_torch" in sys.modules}}))
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(harness.ROOT))],
                          capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "forbidden": [], "program": True}


def test_the_benchmarks_sources_import_no_jax():
    for path in harness.BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_the_check_compares_whole_names():
    sys.modules.setdefault("ppcseq_tpu_torch", sys.modules.get("ppcseq_tpu_torch"))
    before = set(sys.modules)
    try:
        sys.modules["jaxfake_probe.sub"] = sys.modules["json"]
        assert "jaxfake_probe" not in harness.forbidden_modules()
        sys.modules["ppcseq_tpu.sub_probe"] = sys.modules["json"]
        assert "ppcseq_tpu" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]
