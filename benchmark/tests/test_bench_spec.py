"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, checks, work counter, cohort kind and metric
readers by name, and a traffic file added beside the others, with a work
counter of its own, is found and counted without an edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.frozen.work import delta_work

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = harness.load_cell(workload)
    B = harness.BENCH
    assert (B / "cohorts" / f"{cell.config['cohort']['kind']}.py").is_file()
    counter = harness.work_counter(cell)
    assert callable(counter.summary) and callable(counter.calls)
    for check in cell.traffic["checks"]:
        mod = harness.load_by_path(B / "checks" / f"{check}.py")
        assert set(mod.LIMITS) and callable(mod.compare) and callable(mod.control)
    assert cell.per_layer and {"setup_s", "analysis_s"} <= {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert callable(harness.load_by_path(B / "metrics" / f"{m['name']}.py").read)


def test_an_added_traffic_file_is_found_without_an_edit(tmp_path):
    (tmp_path / "benchmark").mkdir()
    for sub in ("configs", "traffic"):
        shutil.copytree(harness.BENCH / sub, tmp_path / "benchmark" / sub)
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "readme15.vb_exact", "config": "readme15",
                              "traffic": "vb_exact", "chips": 1, "why": "exact-CI PPC path"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((harness.BENCH / "traffic" / "vb.json").read_text())
    traffic["identify"]["approximate_posterior_analysis"] = False
    (tmp_path / "benchmark" / "traffic" / "vb_exact.json").write_text(json.dumps(traffic))
    cell = harness.load_cell("readme15.vb_exact", root=tmp_path)
    assert cell.traffic["name"] == "vb_exact"
    assert cell.traffic["identify"]["approximate_posterior_analysis"] is False
    assert cell.config["name"] == "readme15"


def test_the_file_keeps_to_the_contracts_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
    assert len(json.dumps(SPEC)) < 64 * 1024


PROBE_COUNTER = """
def summary(result):
    return {"leapfrogs": result.attrs["leapfrogs"]}


def calls(summary, shape):
    return [(128, True, summary["leapfrogs"])]
"""


def test_an_added_traffic_with_its_own_work_counter_is_counted_without_an_edit(tmp_path):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "workcount"):
        shutil.copytree(harness.BENCH / sub, bench / sub)
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "readme15.probe", "config": "readme15",
                              "traffic": "probe", "chips": 1, "why": "a probe"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = {"identify": {"approximate_posterior_inference": False}, "checks": [],
               "work": "probe"}
    (bench / "traffic" / "probe.json").write_text(json.dumps(traffic))
    (bench / "workcount" / "probe.py").write_text(PROBE_COUNTER)
    cell = harness.load_cell("readme15.probe", root=tmp_path)

    class Result:
        attrs = {"leapfrogs": 7}

    an = harness.Analysis(0.0, 1.0, None, 0.0, harness.work_counter(cell).summary(Result()))
    shape = {"S": 21, "C": 2, "G": 515, "K": 15, "D": 1051}
    bound, ops = harness.likelihood_work(cell, [an, an], shape)
    w = delta_work(128, 21, 2, 515, want_grads=True)
    assert (bound, ops) == pytest.approx((14 * w["bound_us"], 14 * w["ops"]))
