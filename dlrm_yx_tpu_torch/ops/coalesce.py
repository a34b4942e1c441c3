"""Duplicate-index coalescing for sparse gradients.

The port of ``dlrm_yx_tpu/ops/coalesce.py``: the ``grad.coalesce()`` that
the reference runs before its non-linear optimizer updates
(``optim/rwsadagrad.py:98``), as a stable sort, a neighbour compare, a
cumulative sum of segment starts and an ``index_add_`` per segment. Every
shape is static and nothing waits for the device (no ``torch.unique``, no
``nonzero``), so a step that coalesces can later be captured in a CUDA
graph.
"""

from __future__ import annotations

import torch


def coalesce_rows(flat_idx: torch.Tensor, flat_g: torch.Tensor, sentinel: int,
                  aux: torch.Tensor | None = None):
    """Sum gradient rows that share an index.

    flat_idx: [K] int row ids (may repeat); flat_g: [K, D] or [K];
    sentinel: an id above every valid row id; aux: optional [K, W]
    per-occurrence payload carried by representative, not summed
    (occurrences of one row hold the same aux, e.g. the pre-update row the
    forward lookup gathered).

    Returns (unique_idx [K], summed_g like flat_g[, aux_rep like aux]): the
    unique ids first, ascending, then the sentinel with zero gradient (and
    zero aux). Within a segment the rows are summed in occurrence order.
    """
    k = flat_idx.shape[0]
    s_idx, order = torch.sort(flat_idx, stable=True)
    new_seg = torch.cat([s_idx.new_zeros(1), s_idx[1:] != s_idx[:-1]])
    seg_id = torch.cumsum(new_seg, 0)
    summed = torch.zeros_like(flat_g).index_add_(0, seg_id, flat_g[order])
    # every member of a segment writes the same id (and the same aux)
    uniq = torch.full((k,), sentinel, dtype=s_idx.dtype, device=s_idx.device)
    uniq.index_copy_(0, seg_id, s_idx)
    if aux is None:
        return uniq, summed
    return uniq, summed, torch.zeros_like(aux).index_copy_(0, seg_id, aux[order])
