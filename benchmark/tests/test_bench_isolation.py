"""The benchmark loads neither JAX nor the JAX package, and its yardstick
(traffic, draws, counts, reference, comparison) imports nothing of the
program or of the repository's other measuring scripts."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark.conftest import ROOT
from benchmark.run import FORBIDDEN, forbidden_modules

BENCH = ROOT / "benchmark"
YARDSTICK = ("draw.py", "generate.py", "counts.py", "reference.py", "check.py", "trace.py")
NOT_READ = ("chip_smoke", "compare_kernels", "bench", "bench_kernels", "bench_roofline", "tests")


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".", 1)[0] for n in names}


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["dlrm_yx_tpu_torch", "dlrm_yx_tpu_torch.cli", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                              "dlrm_yx_tpu", "dlrm_yx_tpu.ops.mlp"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "dlrm_yx_tpu",
         "dlrm_yx_tpu.ops.mlp"])
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "dlrm_yx_tpu"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_other_measuring_scripts(path):
    assert not imported(path) & (set(FORBIDDEN) | set(NOT_READ))
    text = path.read_text()
    for name in ("BENCH_" + "r0", "BASELINE" + ".json", "MULTICHIP_" + "r0"):
        assert f'"{name}' not in text and f"'{name}" not in text


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "dlrm_yx_tpu_torch" not in imported(BENCH / name)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process on the CPU: no module whose
    top-level name is jax, jaxlib, flax or dlrm_yx_tpu is loaded."""
    from benchmark.conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    code = (
        "import contextlib, io, json, sys\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    for w in {[w['name'] for w in json.loads((root / 'BENCHMARK.json').read_text())['workloads']]!r}:\n"
        f"        run_cell({str(root)!r}, w, 3, 0.1, True, 'cpu')\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_means_no_result(tmp_path):
    """Without a CUDA card a run exits non-zero and prints nothing on standard
    output (this test runs where there is none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "tb25m-train-zipf", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
