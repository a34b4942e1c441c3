"""The yardstick's arithmetic: one H100's published peaks, the model's
operations and the bytes that K1 and K2 need. Plain NumPy; nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth (chip_smoke.py:304), the
# bf16 tensor-core rate, and the f32 rate outside the tensor cores
# (chip_smoke.py:305), which K1's bound takes as chip_smoke.py:380-388 does.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}
F32_FLOP_PER_S = PEAK_FLOP_PER_S["float32"]


def peak_flop_per_s(shape) -> float:
    """The peak of the configuration's compute type (f32 with TF32 off)."""
    return PEAK_FLOP_PER_S[shape["compute_dtype"]]


def mlp_flops(sizes) -> int:
    """Multiply-adds of one example through an MLP, counted as 2 operations."""
    return 2 * sum(int(n) * int(m) for n, m in zip(sizes[:-1], sizes[1:]))


def interaction_flops(shape) -> int:
    """The dot interaction's pairs (strict lower triangle) of one example."""
    f = len(shape["rows"]) + 1
    return 2 * (f * (f - 1) // 2) * shape["dim"]


def forward_flops(shape) -> int:
    """Model operations of one example's forward pass: towers and interaction
    (the lookups and pooling add no products at L = 1)."""
    return mlp_flops(shape["ln_bot"]) + interaction_flops(shape) + mlp_flops(shape["ln_top"])


def train_flops(shape) -> int:
    """Forward and backward of one example: the backward takes two products
    for each of the forward's (the input's gradient and the weight's)."""
    return 3 * forward_flops(shape)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time: bytes over HBM's rate or operations over the f32
    rate, whichever is larger (chip_smoke.py:380-384, ``bound_ms``)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def k1_forward(b: int, s: int, d: int):
    """(bytes, operations) of one forward K1 call on [b, s + 1, d] f32 inputs:
    the dense and the pooled features read once, the output [b, d + pairs]
    written once (chip_smoke.py:387-388, ``interaction_bound_ms``)."""
    p = (s + 1) * s // 2
    return 4 * (b * d + b * s * d + b * (d + p)), 2 * b * p * d


def k2_step(indices: np.ndarray, shape) -> tuple:
    """(bytes, operations) of one step's K2 call on the big tables' items of
    ``indices`` [T, B, L] (every item live): ids and flags read, each unique
    row's new values read and the row written, each duplicate's delta read
    and its row read and written once (chip_smoke.py:720-725)."""
    big = [t for t, n in enumerate(shape["rows"]) if n > shape["split_threshold"]]
    if not big:
        return 0, 0
    ids = indices[big].reshape(len(big), -1).astype(np.int64)
    keys = ids + np.arange(len(big), dtype=np.int64)[:, None] * (1 << 40)
    _, counts = np.unique(keys, return_counts=True)
    k = ids.size
    row = 4 * shape["dim"]
    n_once = int((counts == 1).sum())
    dup = counts[counts > 1]
    n_dup_rows, n_dup_items = int(dup.size), int(dup.sum())
    nbytes = 8 * k + 2 * row * n_once + row * n_dup_items + 2 * row * n_dup_rows
    return nbytes, shape["dim"] * n_dup_items
