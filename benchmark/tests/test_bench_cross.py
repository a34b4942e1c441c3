"""``cross_roofline.train_dcn`` on the CPU: the cross network's least
element-wise bytes over the device time of the ``cross_layer_`` kernels,
from a traced window's summary; nothing where the cell is another's, the
run untraced or no K8 kernel ran (a program without K8)."""

from __future__ import annotations

import json

import pytest

from benchmark import reference_dcn
from benchmark.common import Bench
from benchmark.conftest import ROOT
from benchmark.counts import HBM_BYTES_PER_S
from benchmark.trace import TraceSummary

METRIC = "cross_roofline.train_dcn"
CELL_SHAPE = {"width": 3456, "cross_layers": 3}


def _run(op_s, mode="train_dcn", examples=8192):
    trace = TraceSummary(window_s=1.0, busy_s=0.9, op_s=op_s, idle_by_host_op={})
    return {"bench_mode": mode, "trace": trace, "shape": dict(CELL_SHAPE), "examples": examples}


def test_the_cells_step_needs_48_bytes_an_element_a_layer():
    """At the cell's widths one step of 8,192 examples reads and writes
    4,076,863,488 bytes of the cross network's element-wise terms (48 x
    3,456 x 3 x 8,192), read from the configuration as the harness reads
    it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == "mlperf-dlrmv2-dcn-tb-25m")
    shape = reference_dcn.model_shape(json.loads((ROOT / conf["file"]).read_text()))
    assert {k: shape[k] for k in CELL_SHAPE} == CELL_SHAPE and shape["batch"] == 8192
    run = _run({"void (anonymous namespace)::cross_layer_fwd(...)": 1.0}, examples=8192)
    run["shape"] = shape
    nbytes = Bench().reader(METRIC)(run) / 100 * HBM_BYTES_PER_S
    assert nbytes == pytest.approx(4_076_863_488, rel=1e-12)


def test_the_share_is_the_least_bytes_over_the_kernels_time():
    read = Bench().reader(METRIC)
    k8_s = 2e-3
    run = _run({"void (anonymous namespace)::cross_layer_fwd(...)": k8_s / 4,
                "void (anonymous namespace)::cross_layer_bwd(...)": k8_s / 2,
                "void (anonymous namespace)::cross_layer_bias_grad(...)": k8_s / 8,
                "void (anonymous namespace)::cross_layer_x0_grad(...)": k8_s / 8,
                "nvjet_tss_256x128_64x4_1x2_h_bz_coopA_NTT": 1.0,
                "void at::native::vectorized_elementwise_kernel<4, ...>": 1.0}, examples=16384)
    assert read(run) == pytest.approx(100 * 2 * 4_076_863_488 / HBM_BYTES_PER_S / k8_s)


@pytest.mark.parametrize("why", ["another cell", "untraced", "no K8 kernel"])
def test_nothing_to_read(why):
    read = Bench().reader(METRIC)
    run = _run({"void at::native::vectorized_elementwise_kernel<4, ...>": 1.0},
               "train" if why == "another cell" else "train_dcn")
    if why == "untraced":
        run["trace"] = None
    if why == "another cell":
        run["trace"].op_s["cross_layer_fwd"] = 1.0
    assert read(run) is None
