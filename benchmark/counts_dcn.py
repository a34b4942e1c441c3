"""The yardstick's arithmetic for DLRM-DCNv2 cells: the model's operations
and the bytes that the row plan's kernels (K2 and K4) and the small-table
finish (K3) need for a step's bag items. Plain NumPy; nothing here imports
the program. Peaks and the plain MLP count are ``benchmark.counts``'.
"""

from __future__ import annotations

import numpy as np

from benchmark.counts import HBM_BYTES_PER_S, mlp_flops
from benchmark.reference_dcn import slot_tables

# device kernel names (the profiler's) of the kernels each roofline reads:
# csrc/row_plan.cuh's, which K2 (sparse_rows_overwrite) and K4
# (sparse_rows_add) launch, and csrc/rwsadagrad_dense_finish.cu's
# dense_finish_kernel and dense_finish_one_kernel (K3)
ROW_PLAN_PATTERN = "row_plan"
K3_PATTERN = "dense_finish"


def cross_flops(shape) -> int:
    """One example through the cross layers: two products a layer, N x r and
    r x N, each multiply-add counted as 2 operations."""
    return shape["cross_layers"] * 2 * 2 * shape["width"] * shape["cross_rank"]


def forward_flops(shape) -> int:
    """Bottom MLP, cross network and over-arch of one example (the bag sums
    and the cross layers' element-wise terms add no products)."""
    return mlp_flops(shape["ln_bot"]) + cross_flops(shape) + mlp_flops(shape["ln_top"])


def train_flops(shape) -> int:
    """Forward and backward: two products in the backward for each of the
    forward's."""
    return 3 * forward_flops(shape)


def step_items(indices: np.ndarray, shape) -> dict:
    """What one step's bag ids [S, B, 1] give each store: the big tables'
    items (``items``) and distinct rows (``rows``), and the small tables'
    distinct rows (``small_rows``) and all their rows (``small_store``)."""
    slots = slot_tables(shape)
    ids = indices.reshape(indices.shape[0], -1).astype(np.int64)
    out = {}
    for name, tables in (("big", [t for t, n in enumerate(shape["rows"])
                                  if n > shape["split_threshold"]]),
                         ("small", [t for t, n in enumerate(shape["rows"])
                                    if n <= shape["split_threshold"]])):
        keys = [ids[slots == t].reshape(-1) + (t << 40) for t in tables]
        keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        out[name] = (int(keys.size), int(np.unique(keys).size))
    return {"items": out["big"][0], "rows": out["big"][1], "small_rows": out["small"][1],
            "small_store": sum(n for n in shape["rows"] if n <= shape["split_threshold"])}


def row_plan_bytes(items: dict, shape) -> int:
    """The least bytes of a step's coalesced big-store update: K2 reads each
    of the K items' id and flag and, for each distinct row, its new values,
    and writes the row; K4 reads the K ids and flags again and, for each
    distinct row, its momentum's increment, and reads and writes its
    momentum (f32)."""
    k, u = items["items"], items["rows"]
    return (8 * k + 2 * 4 * shape["dim"] * u) + (8 * k + 3 * 4 * u)


def k3_bytes(items: dict, shape) -> int:
    """The least bytes of a step's K3 finish of the small-table store: every
    row's coalesced gradient read once (the kernel's input is the dense
    gradient of the store), and each touched row's values and momentum read
    and written once (f32)."""
    d = shape["dim"]
    return 4 * d * items["small_store"] + items["small_rows"] * (2 * 4 * d + 2 * 4)


def bytes_s(nbytes: float) -> float:
    """The least time for ``nbytes`` at HBM's rate."""
    return nbytes / HBM_BYTES_PER_S
