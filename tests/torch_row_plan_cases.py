"""Id streams for the card cases of the row plan (``csrc/row_plan.cuh``: K2
and K4), shared by tests/test_torch_sparse_kernels.py and
tests/test_torch_sparse_rows_add.py. Plain NumPy and no JAX, so that the
cases also run on a machine with the card and without JAX.

The streams span what the row plan's tail sees: no duplicated row at all,
the power law of the benchmark's ``train-zipf`` mix (~10,200 of K = 16,384
items on ~1,190 duplicated rows, the longest run ~250), a hot row on half
of K and every item on one row (runs past a tail block's shared keys), four
times the cell's K, a K past the tail's bitmap order (whose long runs are
sorted in place instead), and inactive items mixed in.
"""

from __future__ import annotations

import numpy as np

ALPHA = 1.15  # benchmark/traffic/train-zipf.json
RAW_ROWS = 40_000_000  # a large Terabyte table's raw rows: the law's range
TABLES = 8  # tables above the split threshold, as in the benchmark's cells
LONG_RUN = 64  # row_plan.cuh's kLongRun

STREAMS = ("uniform", "power law", "hot row on half of K", "one row",
           "power law, K=65536", "power law, K=262144", "power law, a fifth inactive")
BITMAP_ITEMS = 131072  # row_plan.cuh's kBitmapItems


def power_ids(rng: np.random.RandomState, rows: int, k: int) -> np.ndarray:
    """k ids of the benchmark's law over TABLES tables of ``rows // TABLES``
    rows, k / TABLES a table: rank r with density ~ r^-ALPHA over RAW_ROWS
    (benchmark/generate.py's ``_power_ids``), hashed into its table."""
    per = rows // TABLES
    m = float(RAW_ROWS)
    u = rng.random_sample((TABLES, k // TABLES))
    r = (1.0 - u * (1.0 - m ** (1.0 - ALPHA))) ** (1.0 / (1.0 - ALPHA))
    ids = np.minimum(r.astype(np.int64) - 1, RAW_ROWS - 1) % per
    return (ids + np.arange(TABLES)[:, None] * per).reshape(-1)


def stream(name: str, rows: int, seed: int = 0):
    """(idx [K] int32 in [0, rows), active [K] int32) of stream ``name``."""
    rng = np.random.RandomState(seed)
    k = int(name.rsplit("K=", 1)[1]) if "K=" in name else 16384
    if name == "uniform":
        idx = rng.randint(0, rows, k)
    elif name == "hot row on half of K":
        idx = rng.randint(0, rows, k)
        idx[::2] = idx[0]
    elif name == "one row":
        idx = np.full(k, rng.randint(0, rows))
    else:
        idx = power_ids(rng, rows, k)
    live = rng.random_sample(k) > 0.2 if name.endswith("inactive") else np.ones(k, bool)
    return idx.astype(np.int32), live.astype(np.int32)


def tail_counts(idx: np.ndarray, active: np.ndarray):
    """(items on duplicated rows, duplicated rows, those with LONG_RUN
    items or more): what the tail adds to ``row_plan.dup_keys``,
    ``row_plan.runs`` and ``row_plan.long_runs`` for these items (ids
    already inside the clip)."""
    _, counts = np.unique(idx[active > 0], return_counts=True)
    dup = counts[counts > 1]
    return int(dup.sum()), int(dup.size), int((dup >= LONG_RUN).sum())
