"""The HSTU cell's comparison on the CPU at a tiny size: a sound run is
correct and its readers read, the planted faults (the loss over half of each
batch's positions, a state left unchanged) are not, the control rounds its
products' operands to float8 e4m3, the cell's readers read nothing of
another mode's run, and the jagged traffic keeps its law."""

from __future__ import annotations

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import counts_hstu, reference_hstu
from benchmark.common import Bench
from benchmark.counts import HBM_BYTES_PER_S
from benchmark.conftest import ROOT
from benchmark.run import run_cell
from benchmark.trace import TraceSummary

CELL = "hstu20m-train-jagged-zipf"
METRICS = ("mfu.train_hstu", "unpadded_share.train_hstu", "coalesce_roofline.train_hstu",
           "rowplan_roofline.train_hstu")
TINY = {"--hstu-num-items": "3000", "--hstu-embedding-dim": "32", "--hstu-num-heads": "2",
        "--hstu-attention-dim": "16", "--hstu-linear-dim": "16", "--hstu-num-blocks": "2",
        "--hstu-max-seq-len": "64", "--hstu-num-negatives": "4",
        "--hstu-tokens-per-batch": "192", "--hstu-max-sequences": "64",
        "--compute-dtype": "float32"}


def quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


@pytest.fixture
def hstu_root(tmp_path):
    """A checkout root with the cell alone, its model cut to 3,000 items,
    d 32, 2 heads of 16, 2 blocks, histories of 4 to 64 events, 4
    negatives and 192 tokens a batch, in float32 compute."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    conf_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    conf = json.loads((ROOT / conf_entry["file"]).read_text())
    conf["flags"] = [f"{k}={TINY[k]}" if k in TINY else a
                     for a in conf["flags"] for k in [a.split("=")[0]]]
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    mix.update(pool=6, trace_dispatches=2, lengths=dict(mix["lengths"], min=4, max=64))
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


def test_a_sound_run_is_correct_and_its_readers_read(hstu_root):
    bench, cell, out = quiet(run_cell, hstu_root, CELL, 2**40 + 21, 0.3, True, "cpu")
    assert out.correct and out.failed == 0 and out.attempted > 0, out.checks
    # float32 on both sides: round-off only
    assert max(v for v, _ in out.checks.values()) < 1e-3, out.checks
    c = out.run["counters"]
    assert c["hstu.tokens"] == out.run["steps"] * 192
    live = sum(counts_hstu.live_scores(l) for l, _ in out.run["step_work"]) * 2 * 2
    assert c["hstu.live_scores"] == live
    share = bench.reader("unpadded_share.train_hstu")(out.run)
    assert share == pytest.approx(100 * live / (out.run["steps"] * 2 * 2 * 192 * 128))
    assert out.run["examples"] == sum(p for _, p in out.run["step_work"])
    # every token's row, then each position's positive and 4 negatives
    assert [i["items"] for i in out.run["step_items"]] == [192 * 6] * out.run["steps"]
    assert all(0 < i["rows"] <= 192 * 6 for i in out.run["step_items"])
    # the window's device time is the CPU's, and no kernel ran: nothing there to read
    for m in ("mfu.train_hstu", "coalesce_roofline.train_hstu", "rowplan_roofline.train_hstu"):
        assert bench.reader(m)(out.run) is None


def _state_unchanged(monkeypatch):
    import dlrm_yx_tpu_torch.train.train_step as ts

    monkeypatch.setattr(ts, "adamw_update", lambda *a, **k: None)
    monkeypatch.setattr(ts, "coalesced_rows_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    import dlrm_yx_tpu_torch.train.train_step as ts

    real = ts.sampled_softmax

    def half(config, items, u, b, row_grads):
        t = b.weights.shape[0]
        w = torch.where(torch.arange(t) < t // 2, b.weights, 0.0)
        return real(config, items, u, b._replace(weights=w), row_grads)

    monkeypatch.setattr(ts, "sampled_softmax", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_timed_path_is_not_correct(hstu_root, monkeypatch, fault):
    fault(monkeypatch)
    _, _, out = quiet(run_cell, hstu_root, CELL, 22, 0.3, False, "cpu")
    assert not out.correct, out.checks


def test_the_control_rounds_its_operands_to_e4m3(hstu_root, monkeypatch):
    """Every operand of every product of the control's forward is a float8
    e4m3 value, and the control reads far off the reference."""
    seen = []
    real = reference_hstu._rounder

    def watched(precision):
        q = real(precision)
        if precision != "fp8":
            return q

        def rounded(t):
            out = q(t)
            seen.append(bool(torch.equal(out, out.to(torch.float8_e4m3fn).float())))
            return out
        return rounded

    monkeypatch.setattr(reference_hstu, "_rounder", watched)
    from benchmark.train_hstu import readings

    cell = Bench(hstu_root).cell(CELL)
    got = quiet(readings, cell, 5, "cpu")
    assert seen and all(seen)
    assert max(got["control"][k] for k in ("loss_gap", "grad_gap")) > 100 * max(
        got["program"][k] for k in ("loss_gap", "grad_gap"))
    assert got["half_batch"]["grad_gap"] > 100 * got["program"]["grad_gap"]


def test_the_readers_read_nothing_of_another_modes_run():
    bench = Bench()
    for m in METRICS:
        assert bench.reader(m)({"mode": "train", "bench_mode": "train_dcn", "trace": None,
                                "counters": {"lookup.items": 5}}) is None


def test_the_traffic_fills_the_budget_with_whole_histories(hstu_root):
    from benchmark.train_hstu import make_pool

    cell = Bench(hstu_root).cell(CELL)
    shape = reference_hstu.model_shape(cell.config)
    pool = make_pool(cell.mix, shape, 3, 2**35 + 1)
    assert pool[0][0].tobytes() == make_pool(cell.mix, shape, 3, 2**35 + 1)[0][0].tobytes()
    for ids, times, offsets, positives, negatives, weights in pool:
        lengths = counts_hstu.lengths_of(offsets)
        assert lengths.sum() == 192 and (lengths[:-1][lengths[1:] > 0] >= 4).all()
        assert negatives.shape == (192, 4) and negatives.max() < 3000
        ends = np.cumsum(lengths[lengths > 0])
        assert (weights[ends - 1] == 0).all() and weights.sum() == 192 - len(ends)
        starts = ends - lengths[lengths > 0]
        assert (times[starts] == 0).all() and (np.diff(times)[weights[:-1] > 0] >= 0).all()
        sup = np.nonzero(weights)[0]
        assert (positives[sup] == ids[sup + 1]).all()


def test_flop_counts_match_hand_counts():
    shape = {"dim": 4, "heads": 2, "dqk": 3, "dv": 5, "blocks": 2, "tokens": 10,
             "negatives": 6}
    lengths = np.array([3, 7, 0])
    # projections: 2*4*2*(10+6) + 2*2*5*4 = 256 + 80 a token; attention:
    # 2*(3+5)*2 * (6 + 28) scores; loss 2*4*7 a position
    fwd = 2 * (336 * 10 + 32 * 34) + 56 * 8
    assert counts_hstu.forward_flops(shape, lengths, 8) == fwd
    assert counts_hstu.train_flops(shape, lengths, 8) == 3 * fwd


@pytest.mark.parametrize("metric, pattern, least", [
    ("coalesce_roofline.train_hstu", "void coalesce_rows_segments_kernel<4>(...)",
     lambda k, u, d: 8 * k + 4 * d * k + 8 * d * u + 8 * u),
    ("rowplan_roofline.train_hstu", "void row_plan::apply_kernel<4, 32, float, float>(...)",
     lambda k, u, d: (8 * k + 8 * d * u) + (8 * k + 12 * u))])
def test_the_row_update_rooflines_are_least_bytes_over_the_kernels_time(metric, pattern, least):
    steps = [{"items": 1_300, "rows": 900}, {"items": 1_300, "rows": 1_000}]
    op_s = {pattern: 2e-5, "cub::DeviceRadixSortOnesweepKernel": 1.0, "gemm": 1.0}
    run = {"bench_mode": "train_hstu", "shape": {"dim": 64}, "step_items": steps,
           "trace": TraceSummary(window_s=1.0, busy_s=0.9, op_s=op_s, idle_by_host_op={})}
    read = Bench().reader(metric)
    nbytes = sum(least(s["items"], s["rows"], 64) for s in steps)
    assert read(run) == pytest.approx(100 * nbytes / HBM_BYTES_PER_S / 2e-5)
    run["trace"].op_s.pop(pattern)
    assert read(run) is None  # a program whose step runs no such kernel


def test_step_items_counts_every_row_update_item():
    ids, pos = np.array([5, 6, 5, 7]), np.array([6, 5, 7, 0])
    neg = np.array([[1, 2], [2, 9], [5, 8], [3, 3]])
    assert counts_hstu.step_items((ids, None, None, pos, neg, None)) == {"items": 16, "rows": 9}
