"""The one traffic generator: host batches drawn from a mix file and a seed.

A mix (``benchmark/traffic/<name>.json``) is data: how ids, dense features
and labels are drawn, how many distinct batches a run draws (``pool``), and
for serving the query size. A training feed cycles its pool; with
``labels.fresh_each_pass`` every pass after the first draws the labels
again (``batch_at``), so that a model cannot learn the pool's labels by
heart and drive its logits out of range, as it does when the same labels
come back every few hundred steps. Plain NumPy, vectorised; nothing here imports
the program. A batch is ``(dense [B, 13] f32, indices [T, B, 1] int32,
weights [T, B, 1] f32, labels [B, 1] f32)``, the layout of the port's
``data.batch.Batch``.
"""

from __future__ import annotations

import numpy as np

from benchmark.draw import stream_seed

TRAFFIC_KEY = 2_000_003


def _power_ids(rng, raw_rows: int, cap: int, size: int, alpha: float) -> np.ndarray:
    """Ids of one table: rank r drawn with density ~ r^-alpha over the table's
    raw row count, then hashed into the cap as ``--max-ind-range`` does
    (``id % cap``). Frozen copy of chip_smoke.py:4731-4733 (the law of
    ``write_mlperf_bin``, from data/synth_kaggle.py:62-66), with the hash of
    the binary loader."""
    m = float(raw_rows)
    u = rng.random(size)
    r = (1.0 - u * (1.0 - m ** (1.0 - alpha))) ** (1.0 / (1.0 - alpha))
    ids = np.minimum(r.astype(np.int64) - 1, raw_rows - 1)
    return (ids % cap).astype(np.int32)


def _uniform_ids(rng, rows: int, size: int) -> np.ndarray:
    return rng.integers(0, rows, size, dtype=np.int64).astype(np.int32)


def make_batches(mix: dict, raw_rows, cap: int, batch: int, n: int, seed: int):
    """``n`` distinct batches of ``batch`` samples from ``mix`` for ``seed``.
    ``raw_rows``: each table's raw row count; ``cap``: the rows a table
    holds (the configuration's max_ind_range). The same seed gives the same
    batches."""
    rng = np.random.default_rng(stream_seed(seed, TRAFFIC_KEY))
    law = mix["ids"]["law"]
    t = len(raw_rows)
    size = n * batch
    indices = np.empty((t, size), np.int32)
    for j, m in enumerate(raw_rows):
        if law == "power":
            indices[j] = _power_ids(rng, m, min(m, cap), size, float(mix["ids"]["alpha"]))
        elif law == "uniform":
            indices[j] = _uniform_ids(rng, min(m, cap), size)
        else:
            raise ValueError(f"unknown id law {law!r}")
    dense_law = mix["dense"]
    if dense_law["law"] != "poisson_log1p":
        raise ValueError(f"unknown dense law {dense_law['law']!r}")
    dense = np.log1p(rng.poisson(float(dense_law["mean"]), (size, int(dense_law["features"]))))
    dense = dense.astype(np.float32)
    labels = (rng.random((size, 1)) < float(mix["labels"]["positive_share"])).astype(np.float32)
    ones = np.ones((t, batch, 1), np.float32)
    return [(dense[i * batch:(i + 1) * batch],
             np.ascontiguousarray(indices[:, i * batch:(i + 1) * batch, None]),
             ones,
             labels[i * batch:(i + 1) * batch]) for i in range(n)]


LABEL_KEY = 2_000_029


def batch_at(mix: dict, pool, k: int, seed: int):
    """The ``k``-th batch of a feed that cycles ``pool``: the pool's batch,
    with labels drawn again from (seed, pass, batch) after the first pass
    where the mix asks for it."""
    n = len(pool)
    dense, indices, weights, labels = pool[k % n]
    if k >= n and mix["labels"].get("fresh_each_pass"):
        rng = np.random.default_rng(stream_seed(seed, LABEL_KEY, k // n, k % n))
        labels = (rng.random(labels.shape) < float(mix["labels"]["positive_share"])).astype(
            np.float32)
    return dense, indices, weights, labels
