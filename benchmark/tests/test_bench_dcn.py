"""The DLRM-DCNv2 cell's comparison on the CPU at a tiny size: a sound run is
correct, the planted faults (the loss over half of each batch, a state left
unchanged) are not, the control rounds its products' operands to float8
e4m3 and still trains, the cell's readers read nothing of another mode's
run, and a run of the cell loads no JAX."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import reference_dcn
from benchmark.common import Bench
from benchmark.conftest import ROOT
from benchmark.run import forbidden_modules, run_cell

CELL = "dcn25m-train-multihot-zipf"
METRICS = ("mfu.train_dcn", "rowplan_roofline.train_dcn", "k3_roofline.train_dcn",
           "unpadded_share.train_dcn")
HOT = [3, 1, 12, 2, 100]
TINY = ("--arch-sparse-feature-size=16", "--arch-mlp-bot=13-32-16", "--arch-mlp-top=16-1",
        "--dcn-num-layers=2", "--dcn-low-rank-dim=8", "--mini-batch-size=64",
        "--max-ind-range=100000", "--compute-dtype=float32",
        "--multi-hot-sizes=" + "-".join(map(str, HOT)))


def quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


@pytest.fixture
def dcn_root(tmp_path):
    """A checkout root with the cell alone, its model cut to five tables of
    hotness [3, 1, 12, 2, 100] (two above the split threshold), D = 16, two
    cross layers of rank 8 and B = 64, in float32 compute."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    conf_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    conf = json.loads((ROOT / conf_entry["file"]).read_text())
    keep = [a for a in conf["flags"] if not a.startswith(tuple(t.split("=")[0] for t in TINY))]
    conf.update(flags=keep + list(TINY) + ["--emb-split-threshold=1000"],
                raw_rows=[200000, 50, 300, 70000, 40])
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    mix.update(hotness=HOT, pool=60, trace_dispatches=2)
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bench / sub).mkdir(parents=True)
    (tmp_path / conf_entry["file"]).write_text(json.dumps(conf))
    (bench / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
    shutil.copy(ROOT / "benchmark" / "limits" / f"{CELL}.json", bench / "limits")
    for p in (ROOT / "benchmark" / "metrics").glob("*.py"):
        shutil.copy(p, bench / "metrics")
    spec.update(configs=[conf_entry], workloads=[w])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [x for x in m["workloads"] if x == CELL]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_a_sound_run_is_correct_and_its_readers_read(dcn_root):
    bench, cell, out = quiet(run_cell, dcn_root, CELL, 21, 0.3, True, "cpu")
    assert out.correct and out.failed == 0 and out.attempted > 0, out.checks
    # float32 on both sides: round-off only
    assert max(v for v, _ in out.checks.values()) < 1e-3, out.checks
    assert out.run["counters"]["lookup.items"] == out.run["steps"] * 64 * sum(HOT)
    assert bench.reader("unpadded_share.train_dcn")(out.run) == 100.0
    # no kernel runs on the CPU: the device readers find no device time
    for m in METRICS[:3]:
        assert bench.reader(m)(out.run) is None, m


def _state_unchanged(monkeypatch):
    import dlrm_yx_tpu_torch.train.train_step as ts

    monkeypatch.setattr(ts, "apply_gradients", lambda *a, **k: None)


def _half_batch(monkeypatch):
    import dlrm_yx_tpu_torch.train.train_step as ts

    real = ts.loss_fn

    def half(logits, targets, *a, **k):
        n = logits.shape[0] // 2
        return real(logits[:n], targets[:n], *a, **k)

    monkeypatch.setattr(ts, "loss_fn", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_timed_path_is_not_correct(dcn_root, monkeypatch, fault):
    fault(monkeypatch)
    _, _, out = quiet(run_cell, dcn_root, CELL, 22, 0.3, False, "cpu")
    assert not out.correct, out.checks


def test_the_control_rounds_its_operands_to_e4m3(dcn_root, monkeypatch):
    """Every operand of every product of the control's forward is a float8
    e4m3 value, and the control reads far off the program."""
    seen = []
    real = reference_dcn._rounder

    def watched(precision):
        q = real(precision)
        if precision != "fp8":
            return q

        def rounded(t):
            out = q(t)
            seen.append(bool(torch.equal(out, out.to(torch.float8_e4m3fn).float())))
            return out
        return rounded

    monkeypatch.setattr(reference_dcn, "_rounder", watched)
    from benchmark.train_dcn import readings

    got = quiet(readings, Bench(dcn_root).cell(CELL), 23, "cpu")
    assert seen and all(seen)
    assert max(got["control"].values()) > 100 * max(got["program"].values())
    # the rounding is straight-through: every leaf gets a gradient and moves,
    # where rounded cotangents would flush to zero and read 1 on both
    assert got["control"]["grad_gap"] < 0.5 and got["control"]["change_gap"] < 0.5
    assert max(got["half_batch"].values()) > 100 * max(got["program"].values())


def test_the_readers_read_nothing_of_another_modes_run():
    bench = Bench()
    for run in ({"mode": "train", "trace": None, "shape": {}, "chips": 1},
                {"mode": "serve", "trace": None, "counters": {"lookup.items": 5}},
                {"mode": "train", "counters": {"lookup.items": 5}, "examples": 1}):
        for m in METRICS:
            assert bench.reader(m)(run) is None, m


def test_the_unpadded_share_reads_the_padding():
    read = Bench().reader("unpadded_share.train_dcn")
    assert read({"bench_mode": "train_dcn", "counters": {"lookup.items": 1,
                                                         "lookup.pad_items": 3}}) == 25.0


def test_a_run_of_the_cell_loads_no_jax(dcn_root):
    """A whole tiny run of the cell, traced, in a fresh process on the CPU:
    no module whose top-level name is jax, jaxlib, flax or dlrm_yx_tpu is
    loaded."""
    code = (
        "import contextlib, io, json\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    run_cell({str(dcn_root)!r}, {CELL!r}, 3, 0.1, True, 'cpu')\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert forbidden_modules(["jax"]) == ["jax"]  # the check itself sees JAX
