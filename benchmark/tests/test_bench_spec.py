"""BENCHMARK.json keeps to its contract, and every cell's files are found by
name; a new cell, mix and metric are new files and nothing else."""

from __future__ import annotations

import json
import re
import statistics

import pytest

from benchmark.common import Bench, model_shape
from benchmark.conftest import ROOT
from benchmark.run import result_line, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32 and all(one_line(a) for a in SPEC["command"])
    assert not any(a.startswith("/") or ".." in a for a in SPEC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", WORKLOADS)
        assert set(m["workloads"]) <= set(moved)
        if "_roofline" in m["name"] or m["name"].startswith("idle_share."):
            layers.setdefault(m["name"].split(".")[0].split("_")[-1], set()).add(m["layer"])
    # the kernels' rooflines name one layer, the idle shares another
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_finds_its_files_by_name(workload):
    bench = Bench()
    cell = bench.cell(workload)
    assert cell.mode in ("train", "serve")
    assert (ROOT / "benchmark" / f"{cell.mode}.py").is_file()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(bench.reader(m["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    shape = model_shape(cell.config)
    assert len(shape["rows"]) == len(cell.config["raw_rows"])


def test_a_new_cell_mix_and_metric_are_files_only(tiny_root):
    """A configuration, a mix and a per-layer metric that live only in the
    test's directory run through the harness without an edit to it."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    conf = json.loads((tiny_root / spec["configs"][0]["file"]).read_text())
    conf["raw_rows"] = [5000, 7, 90000]
    (tiny_root / "benchmark" / "configs" / "throwaway.json").write_text(json.dumps(conf))
    mix = json.loads((tiny_root / "benchmark" / "traffic" / "train-zipf.json").read_text())
    mix["ids"] = {"law": "power", "alpha": 1.5}
    (tiny_root / "benchmark" / "traffic" / "throwaway-mix.json").write_text(json.dumps(mix))
    (tiny_root / "benchmark" / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n    return run['examples'] / run['shape']['batch']\n")
    (tiny_root / "benchmark" / "limits" / "throwaway-cell.json").write_text(
        (tiny_root / "benchmark" / "limits" / "tb25m-train-zipf.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="throwaway",
                                file="benchmark/configs/throwaway.json"))
    spec["workloads"].append({"name": "throwaway-cell", "config": "throwaway",
                              "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "tb25m-train-zipf" in m["workloads"]:
            m["workloads"].append("throwaway-cell")
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "train_examples_per_s", "workloads": ["throwaway-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench, cell, out = run_cell(tiny_root, "throwaway-cell", 7, 0.2, True, "cpu")
    line = result_line(cell, out, True, bench.reader, {"platform": "cpu"})
    assert line["metrics"]["steps_traced"]["value"] == out.attempted
    assert len(cell.config["raw_rows"]) == 3 and cell.mix["ids"]["alpha"] == 1.5


def test_result_line_keys_and_order(tiny_root):
    bench, cell, out = run_cell(tiny_root, "tb25m-serve-zipf", 5, 0.2, False, "cpu")
    line = result_line(cell, out, False, bench.reader, {"platform": "cpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] >= 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits) and line["correct"]
    assert statistics.fmean(v["limit"] for v in line["checks"].values()) > 0
