"""The yardstick's arithmetic for HSTU cells: the model's operations in a
step, from the step's own history lengths, and the bytes that the item
table's row update needs of K7 (``csrc/coalesce_rows.cu``) for the step's
items. Plain NumPy; nothing here imports the program. The peak is
``benchmark.counts``'; the row plan's bytes (K2 and K4) are
``counts_dcn.row_plan_bytes``.
"""

from __future__ import annotations

import numpy as np

# device kernel names (the profiler's) of K7: K7a's segment sums and K7b's
# new rows, both of csrc/coalesce_rows.cu
COALESCE_PATTERN = "coalesce_rows_"


def lengths_of(offsets) -> np.ndarray:
    """The histories' lengths [S] (int64) of a batch's offsets [S + 1]
    (a padded history's is 0)."""
    off = np.asarray(offsets).astype(np.int64)
    return off[1:] - off[:-1]


def live_scores(lengths) -> int:
    """A head's causal scores of one layer: L (L + 1) / 2 a history."""
    n = np.asarray(lengths, np.int64)
    return int((n * (n + 1) // 2).sum())


def projection_flops(shape) -> int:
    """One token through one block's products: LN(X) @ W_uvqk [d, H (2 dv +
    2 dqk)] and (LN(A) * U) @ W_o [H dv, d], each multiply-add 2
    operations."""
    d, h = shape["dim"], shape["heads"]
    return 2 * d * h * (2 * shape["dv"] + 2 * shape["dqk"]) + 2 * h * shape["dv"] * d


def attention_flops(shape, lengths) -> int:
    """One block's attention over a step's histories: for each live causal
    score of each head, Q K^T (dqk multiply-adds) and its share of the
    product with V (dv)."""
    return 2 * (shape["dqk"] + shape["dv"]) * shape["heads"] * live_scores(lengths)


def loss_flops(shape, positions: int) -> int:
    """The sampled softmax's logits: d multiply-adds for the positive and
    each negative of each supervised position."""
    return 2 * shape["dim"] * (shape["negatives"] + 1) * positions


def forward_flops(shape, lengths, positions: int) -> int:
    """A step's forward: every block's projections over the step's tokens
    and its attention over the live scores, then the loss."""
    per_block = projection_flops(shape) * shape["tokens"] + attention_flops(shape, lengths)
    return shape["blocks"] * per_block + loss_flops(shape, positions)


def train_flops(shape, lengths, positions: int) -> int:
    """Forward and backward: two products in the backward for each of the
    forward's."""
    return 3 * forward_flops(shape, lengths, positions)


def step_items(batch) -> dict:
    """What one step's host batch (ids, times, offsets, positives,
    negatives, weights) gives the item table's row update: its items
    (``items``: each token's row, then each position's positive and
    negatives, T (R + 2)) and their distinct rows (``rows``)."""
    ids = np.concatenate([np.asarray(batch[i]).reshape(-1) for i in (0, 3, 4)])
    return {"items": int(ids.size), "rows": int(np.unique(ids).size)}


def coalesce_bytes(items: dict, dim: int) -> int:
    """The least bytes of K7 in a step: the K sorted ids and their order
    read (8 K); each item's gradient row read, f32 (4 dim K: a [K, dim]
    tensor of gigabytes, so it comes from HBM, unlike the DLRM-DCNv2 bags'
    pooled cotangent); each of the U distinct rows' pre-update row read and
    new row written, f32 (8 dim U); its momentum read and its increment
    written (8 U)."""
    k, u = items["items"], items["rows"]
    return 8 * k + 4 * dim * k + 8 * dim * u + 8 * u
