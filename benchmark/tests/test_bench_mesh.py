"""The cell across cards, rehearsed on the CPU as four gloo ranks at a tiny
size: a sound run is correct, and a run with the timed path broken
underneath in every rank comes out not correct, once for each fault the
cell can have (a state left unchanged, half of the batch left out, the
exchange between ranks left out)."""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from benchmark.conftest import ROOT, make_tiny_root, tiny_config
from benchmark.run import run_cell

CELL = "tb40m-hybrid4-train-zipf"
CONFIG = "mlperf-dlrm-tb-40m-hybrid4"
RANK = "from benchmark.mesh import rank_main; rank_main()"
FAULTS = {
    "state_unchanged": (
        "import dlrm_yx_tpu_torch.parallel.hybrid as h\n"
        "h.update_dense_towers = lambda *a, **k: None\n"
        "h._sparse_updates = lambda *a, **k: None\n"),
    "half_batch": (
        "import dlrm_yx_tpu_torch.parallel.hybrid as h\n"
        "real = h.loss_fn\n"
        "h.loss_fn = lambda z, t, *a, **k: real(z[:z.shape[0] // 2], t[:t.shape[0] // 2], *a, **k)\n"),
    "exchange_left_out": (
        "from dlrm_yx_tpu_torch.parallel.mesh import Mesh\n"
        "def kept(self, out, inp, async_op=False):\n"
        "    out.copy_(inp)\n"
        "Mesh.all_to_all_model = kept\n"),
}


@pytest.fixture(scope="module")
def f32_root(tmp_path_factory):
    """The tiny checkout, with the cell across cards added by files where
    ``BENCHMARK.json`` does not hold it (the 40M configuration cut to the
    tiny model, the skewed cell's mix and limits)."""
    root = make_tiny_root(tmp_path_factory.mktemp("mesh"), compute_dtype="float32")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if CELL not in [w["name"] for w in spec["workloads"]]:
        conf = json.loads((ROOT / "benchmark" / "configs" / f"{CONFIG}.json").read_text())
        (root / "benchmark" / "configs" / f"{CONFIG}.json").write_text(
            json.dumps(tiny_config(conf, "float32")))
        spec["configs"].append(dict(spec["configs"][0], name=CONFIG,
                                    file=f"benchmark/configs/{CONFIG}.json"))
        spec["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "train-zipf",
                                  "chips": 4, "why": "the cell across cards"})
        for m in spec["end_to_end"]:
            if "train_examples_per_s" == m["name"]:
                m["workloads"].append(CELL)
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        (root / "benchmark" / "limits" / f"{CELL}.json").write_text(
            (root / "benchmark" / "limits" / "tb25m-train-zipf.json").read_text())
    return root


def quiet_run(root, child=None, seed=31):
    kw = {} if child is None else {"child": ("-c", child)}
    with contextlib.redirect_stdout(io.StringIO()):
        return run_cell(root, CELL, seed, 0.3, False, "cpu", **kw)[2]


def test_a_sound_run_across_four_ranks_is_correct(f32_root):
    out = quiet_run(f32_root)
    assert out.correct and out.failed == 0 and out.attempted > 0, out.checks
    assert out.e2e["train_examples_per_s"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_rank_path_is_not_correct(f32_root, fault):
    out = quiet_run(f32_root, FAULTS[fault] + RANK)
    assert not out.correct, out.checks
