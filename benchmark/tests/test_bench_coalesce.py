"""``coalesce_roofline.train_dcn`` on the CPU: K7's least bytes over the
device time of the ``coalesce_rows_`` kernels, from a traced window's
summary; nothing where the cell is another's, the run untraced or no K7
kernel ran (a program without K7)."""

from __future__ import annotations

import pytest

from benchmark.common import Bench
from benchmark.counts import HBM_BYTES_PER_S
from benchmark.trace import TraceSummary

METRIC = "coalesce_roofline.train_dcn"


def _run(op_s, mode="train_dcn"):
    trace = TraceSummary(window_s=1.0, busy_s=0.9, op_s=op_s, idle_by_host_op={})
    return {"bench_mode": mode, "trace": trace, "shape": {"dim": 128},
            "step_items": [{"items": 1_000, "rows": 300}, {"items": 2_000, "rows": 500}]}


def test_the_share_is_the_least_bytes_over_the_kernels_time():
    read = Bench().reader(METRIC)
    k7_s = 1e-5
    run = _run({"void (anonymous namespace)::coalesce_rows_sum<int, 4, 1>(...)": k7_s / 2,
                "void (anonymous namespace)::coalesce_rows_finish<int, 1>(...)": k7_s / 2,
                "void row_plan::apply_kernel<4, 32, float, float>(...)": 1.0,
                "cub::DeviceRadixSortOnesweepKernel": 1.0})
    nbytes = (8 * 1_000 + 8 * 128 * 300 + 8 * 300) + (8 * 2_000 + 8 * 128 * 500 + 8 * 500)
    assert read(run) == pytest.approx(100 * nbytes / HBM_BYTES_PER_S / k7_s)


@pytest.mark.parametrize("why", ["another cell", "untraced", "no K7 kernel"])
def test_nothing_to_read(why):
    read = Bench().reader(METRIC)
    run = _run({"void row_plan::apply_kernel<4, 32, float, float>(...)": 1.0},
               "train" if why == "another cell" else "train_dcn")
    if why == "untraced":
        run["trace"] = None
    if why == "another cell":
        run["trace"].op_s["coalesce_rows_sum"] = 1.0
    assert read(run) is None
