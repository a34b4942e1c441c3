"""What decides ``correct``: the plain reference agrees with the port's CPU
path at a tiny size, and a run with the timed path broken underneath comes
out not correct, once for each fault a cell can have."""

from __future__ import annotations

import contextlib
import io

import pytest
import torch

from benchmark import calibrate, reference
from benchmark.common import Bench
from benchmark.conftest import make_tiny_root
from benchmark.run import run_cell

TRAIN_CELLS = ("tb25m-train-zipf", "tb25m-train-uniform")


def quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_reference_agrees_with_the_port_on_the_cpu_in_f32(tmp_path, workload):
    """float32 compute on both sides: the port's checked steps (one single
    step, then three dispatches of 16) equal the reference's to float32
    round-off (the tables' per-occurrence adds included)."""
    cell = Bench(make_tiny_root(tmp_path, compute_dtype="float32")).cell(workload)
    got = quiet(calibrate.train_readings, cell, 11, "cpu")
    assert got["program"]["loss_gap"] < 1e-5
    assert got["program"]["grad_gap"] < 1e-3 and got["program"]["change_gap"] < 1e-3
    # the control and the planted fault read far above the program
    for side in ("control", "half_batch"):
        assert max(got[side].values()) > 100 * max(got["program"].values())


def test_reference_predictions_agree_with_the_port_on_the_cpu_in_f32(tmp_path):
    cell = Bench(make_tiny_root(tmp_path, compute_dtype="float32")).cell("tb25m-serve-zipf")
    got = quiet(calibrate.serve_readings, cell, 12, "cpu")
    assert got["program"]["pred_gap"] < 1e-5
    assert got["control"]["pred_gap"] > 100 * max(got["program"]["pred_gap"], 1e-7)


@pytest.fixture
def f32_root(tmp_path):
    """The tiny cells in float32 compute: the bf16 gaps of a width-16 model
    are not the cells' gaps, the float32 ones are round-off."""
    return make_tiny_root(tmp_path, compute_dtype="float32")


@pytest.mark.parametrize("workload", TRAIN_CELLS + ("tb25m-serve-zipf",))
def test_a_sound_run_is_correct(f32_root, workload):
    _, _, out = quiet(run_cell, f32_root, workload, 21, 0.3, False, "cpu")
    assert out.correct and out.failed == 0 and out.attempted > 0, out.checks


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


def _dispatch_on_its_first_batch(monkeypatch):
    """Only the dispatch of several steps is broken: each of its steps trains
    on the dispatch's first batch."""
    import dlrm_yx_tpu_torch.train.trainer as tr
    from dlrm_yx_tpu_torch.data.batch import Batch

    real = tr.make_multistep_train_step

    def made(config, opt, n_steps, *a, **k):
        step = real(config, opt, n_steps, *a, **k)
        if n_steps == 1:
            return step

        def first_batch_only(params, opt_state, batches, iteration):
            same = Batch(*(f[[0] * len(f)] for f in batches))
            return step(params, opt_state, same, iteration)
        return first_batch_only

    monkeypatch.setattr(tr, "make_multistep_train_step", made)


def _lr_frozen_in_dispatch(monkeypatch):
    """Only the dispatch of several steps is broken: its steps all take the
    learning rate of its first."""
    import numpy as np
    from dlrm_yx_tpu_torch.train import capture

    real = capture.GraphStep._host_scalars

    def frozen(self, iteration):
        its, lrs = real(self, iteration)
        return its, np.full_like(lrs, lrs[0]) if len(lrs) else lrs

    monkeypatch.setattr(capture.GraphStep, "_host_scalars", frozen)


def _answer_altered(monkeypatch):
    import dlrm_yx_tpu_torch.train.train_step as ts

    real = ts.predictions_from_logits

    def altered(logits, *a, **k):
        p = real(logits, *a, **k).clone()
        p[7] = 1.0 - p[7]
        return p

    monkeypatch.setattr(ts, "predictions_from_logits", altered)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in TRAIN_CELLS for f in (_state_unchanged, _half_batch,
                                          _dispatch_on_its_first_batch, _lr_frozen_in_dispatch)
] + [("tb25m-serve-zipf", _answer_altered)])
def test_a_broken_timed_path_is_not_correct(f32_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    _, _, out = quiet(run_cell, f32_root, workload, 22, 0.3, False, "cpu")
    assert not out.correct, out.checks


def test_the_lr_policy_matches_the_configured_schedule():
    lr = {"base": 1.0, "warmup": 2750, "decay_start": 49315, "decay_steps": 27772}
    assert reference.lr_at(0, lr) == pytest.approx(1 / 2750)
    assert reference.lr_at(2748, lr) == pytest.approx(2749 / 2750)
    assert reference.lr_at(10_000, lr) == pytest.approx(2749 / 2750)
    assert reference.lr_at(49314 + 13886, lr) == pytest.approx(0.25, rel=1e-3)
    assert reference.lr_at(10**6, lr) == pytest.approx(max(1e-7, (1 / 27772) ** 2))


@pytest.mark.chip
@pytest.mark.parametrize("workload", TRAIN_CELLS + ("tb25m-serve-zipf",))
def test_control_fails_the_limits_at_the_cells_size(card, workload):
    """The control (the reference in float8 products, in the program's place)
    at the cell's own size on three seeds: each seed fails one of the
    cell's numbers, while the program passes them all."""
    cell = Bench().cell(workload)
    readings = calibrate.train_readings if cell.mode == "train" else calibrate.serve_readings
    for seed in (1_000_003, 2_000_003, 3_000_003):
        got = quiet(readings, cell, seed, card)
        assert all(v <= cell.limits[k] for k, v in got["program"].items()), got
        assert any(v > cell.limits[k] for k, v in got["control"].items()), got


@pytest.mark.chip
def test_one_run_of_each_cell_on_the_card(card):
    for w in [w["name"] for w in Bench().spec["workloads"] if w["chips"] == 1]:
        _, _, out = quiet(run_cell, Bench().root, w, 5, 1.0, False, card)
        assert out.correct and out.failed == 0, (w, out.checks)
        torch.cuda.empty_cache()
