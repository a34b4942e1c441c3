"""Test settings of the benchmark's own tests (``python -m pytest benchmark``).

Tests that need a CUDA card carry the ``chip`` marker and take the ``card``
fixture, which skips them where there is none; on the card:
``python -m pytest benchmark -m chip``. The ``tiny_root`` fixture lays out a
throwaway checkout root in a temporary directory: ``BENCHMARK.json`` with
the repository's cells, metrics and limits, each configuration cut to a
tiny model and each mix to a small pool, so that whole runs take seconds
on the CPU.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

TINY_FLAGS = ("--arch-sparse-feature-size=16", "--arch-mlp-bot=13-32-16",
              "--arch-mlp-top=32-16-1", "--mini-batch-size=64", "--max-ind-range=100000")
TINY_ROWS = [200000, 50, 3000, 70000]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card only")
    return "cuda"


def tiny_config(conf: dict, compute_dtype=None) -> dict:
    conf = dict(conf)
    flags = [a for a in conf["flags"]
             if not a.startswith(("--arch-", "--mini-batch-size", "--max-ind-range"))]
    if compute_dtype:
        flags = [a for a in flags if not a.startswith("--compute-dtype")]
        flags.append(f"--compute-dtype={compute_dtype}")
    conf["flags"] = flags + list(TINY_FLAGS)
    conf["raw_rows"] = list(TINY_ROWS)
    return conf


def make_tiny_root(path: Path, compute_dtype=None) -> Path:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    for c in spec["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        (path / c["file"]).write_text(json.dumps(tiny_config(conf, compute_dtype)))
    for w in spec["workloads"]:
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        mix.update(pool=60, trace_dispatches=2) if mix["mode"] == "train" else mix.update(
            pool=8, query_samples=64, checked_queries=4, trace_queries=30)
        (bench / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        shutil.copy(ROOT / "benchmark" / "limits" / f"{w['name']}.json", bench / "limits")
    for p in (ROOT / "benchmark" / "metrics").glob("*.py"):
        shutil.copy(p, bench / "metrics")
    (path / "BENCHMARK.json").write_text(json.dumps(spec))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
