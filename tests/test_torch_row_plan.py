"""The row plan of K2 and K4 (``csrc/row_plan.cuh``) as the CPU can see it:
where its kernels live, so that the benchmark's K2 pattern names all of
them in a trace, and its tail counts, which only a card call adds to.
Imports no JAX."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dlrm_yx_tpu_torch.ops.sparse_rows_add import ROW_PLAN_COUNTS, row_plan_counts
from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
from dlrm_yx_tpu_torch.utils import profiling
from torch_row_plan_cases import BITMAP_ITEMS, STREAMS, stream, tail_counts

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "dlrm_yx_tpu_torch" / "csrc"
K2_SOURCES = ("row_plan.cuh", "sparse_rows_overwrite.cu")


def _kernels_by_namespace(text: str):
    """[(namespace, kernel name)] of every ``__global__`` function in a CUDA
    source, the namespace as the braces enclose it ("" outside any, "(anon)"
    for an unnamed one)."""
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"__launch_bounds__\([^)]*\)", "", text)
    found, stack = [], []
    token = re.compile(r"namespace\s*(\w*)\s*\{|\{|\}|__global__")
    for m in token.finditer(text):
        if m.group(0).startswith("namespace"):
            stack.append(m.group(1) or "(anon)")
        elif m.group(0) == "{":
            stack.append(None)
        elif m.group(0) == "}":
            stack.pop()
        else:
            name = re.match(r"__global__[^(]*?(\w+)\s*\(", text[m.start():])
            spaces = [s for s in stack if s is not None]
            found.append(("::".join(spaces), name.group(1)))
    assert not stack, "unbalanced braces"
    return found


def test_every_k2_kernel_lies_in_row_plan_and_matches_the_benchmarks_pattern():
    """K2's roofline share (``k2_roofline.train``) sums the device time of
    the kernels whose trace names match ``benchmark/kernels.json``'s K2
    pattern; a kernel of K2 outside ``namespace row_plan`` would be left
    out and the share would read too high."""
    pattern = json.loads((ROOT / "benchmark" / "kernels.json").read_text())["K2"]["pattern"]
    kernels = [k for f in K2_SOURCES for k in _kernels_by_namespace((CSRC / f).read_text())]
    assert {name for _, name in kernels} >= {"plan_kernel", "apply_kernel", "place_kernel",
                                             "tail_kernel"}
    for namespace, name in kernels:
        assert namespace == "row_plan", f"{name} lies in namespace {namespace!r}"
        # a trace names a templated kernel as void row_plan::name<...>(...)
        assert re.search(pattern, f"void row_plan::{name}<4, 32, float, float>(...)")


def test_the_namespace_reader_sees_a_kernel_outside_row_plan():
    src = ("namespace row_plan {\n__global__ void __launch_bounds__(256, 2)\n"
           "a(int x) { if (x) {} }\n}\n"
           "namespace {\n__global__ void b() {}\n}  // a comment { \n__global__ void c() {}\n")
    assert _kernels_by_namespace(src) == [("row_plan", "a"), ("(anon)", "b"), ("", "c")]


def test_counters_report_no_row_plan_counts_without_a_card():
    """A CPU call runs the plain version, which counts nothing: with no
    card the snapshot leaves the row plan's counts out (or reads 0)."""
    if torch.cuda.is_available():
        pytest.skip("checks the counters of a process that has no card")
    idx, act = stream("power law", 4096)
    sparse_rows_overwrite(torch.zeros(4096 + 9, 4), torch.from_numpy(idx),
                          torch.zeros(idx.size, 4), torch.ones(idx.size, 4),
                          torch.from_numpy(act))
    snap = profiling.counters()
    assert all(snap.get(name, 0) == 0 for name in ROW_PLAN_COUNTS)
    assert row_plan_counts() == {}
    assert set(ROW_PLAN_COUNTS) == {"row_plan.dup_keys", "row_plan.runs", "row_plan.long_runs"}


@pytest.mark.parametrize("name", STREAMS)
def test_the_card_cases_streams_reach_the_tail(name):
    """What each stream of the card cases gives the tail to do: the power
    law as the benchmark's zipf cell (~10,000 of 16,384 items on ~1,150
    rows, ~25 long runs), runs past a tail block's shared keys (2,048) on
    the hot-row streams, long runs past the bitmap order's K, and the same
    stream from the same seed."""
    rows = 1 << 20
    idx, act = stream(name, rows)
    again, _ = stream(name, rows)
    np.testing.assert_array_equal(idx, again)
    assert idx.min() >= 0 and idx.max() < rows
    d, runs, long_runs = tail_counts(idx, act)
    k = idx.size
    if name == "uniform":
        assert d < 0.05 * k and long_runs == 0
    elif name == "power law":
        assert 9000 < d < 11500 and 1000 < runs < 1400 and 15 < long_runs < 40
    elif name in ("hot row on half of K", "one row"):
        assert d >= k // 2 and long_runs == 1
        assert np.bincount(idx).max() > 2048
    elif name == "power law, K=65536":
        assert k == 65536 and d > 16384
    elif name == "power law, K=262144":
        assert k > BITMAP_ITEMS and long_runs > 0
    else:
        assert 0.7 * k < act.sum() < 0.9 * k and long_runs > 0
