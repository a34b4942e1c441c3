"""The fixed-shape batch layout every data source emits.

A numpy copy of ``dlrm_yx_tpu/data/batch.py``:

    dense   [B, m_den]  float32
    indices [T, B, L]   int32     per-table row ids, 0 where padded
    weights [T, B, L]   float32   per-sample weights; 0 marks padding
    labels  [B, 1]      float32

L is the max pooling length (num_indices_per_lookup); Criteo has L = 1.
The fields hold numpy arrays on the host and torch tensors on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Batch(NamedTuple):
    dense: "np.ndarray | object"
    indices: "np.ndarray | object"
    weights: "np.ndarray | object"
    labels: "np.ndarray | object"


def csr_to_padded(
    ls_i: Sequence[np.ndarray],
    ls_o: Sequence[np.ndarray],
    batch_size: int,
    l_max: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convert per-table CSR (indices, offsets) lists — the reference's
    EmbeddingBag input layout — to padded [T, B, L] indices + weight mask.

    ls_o[t] has B entries (start offsets); a final implicit end at
    len(ls_i[t]).
    """
    t = len(ls_i)
    indices = np.zeros((t, batch_size, l_max), dtype=np.int32)
    weights = np.zeros((t, batch_size, l_max), dtype=np.float32)
    for k in range(t):
        idx = np.asarray(ls_i[k])
        off = np.asarray(ls_o[k])
        ends = np.concatenate([off[1:], [len(idx)]])
        for b in range(batch_size):
            seg = idx[off[b] : ends[b]]
            n = len(seg)
            if n > l_max:
                raise ValueError(f"pooling length {n} exceeds L={l_max}")
            indices[k, b, :n] = seg
            weights[k, b, :n] = 1.0
    return indices, weights


def to_device(batch: Batch, device: torch.device) -> Batch:
    """The batch as tensors on ``device`` (no copy for fields already there)."""
    return Batch(*(torch.as_tensor(a, device=device) for a in batch))
