"""Quotient-Remainder compositional embeddings.

The port of ``dlrm_yx_tpu/ops/qr_embedding.py``, after the reference's
``QREmbeddingBag`` (``tricks/qr_embedding_bag.py``; Shi et al.,
arXiv:1909.02107): a table of n rows is replaced by a quotient table of
ceil(n / c) rows and a remainder table of c rows; the embedding of index i
is combine(Q[i // c], R[i % c]) with combine one of mult, add and concat,
and pooling sums the combined vectors.

Both sub-tables are plain ``[rows, dim]`` tensors with no sentinel rows
(the JAX package gives them none either). The lookup is two gathers, the
combine and a weighted sum; training takes the pooled cotangent and
``qr_row_grads`` applies the chain rule through the combine by hand, so
the sub-tables are updated row-sparsely like the group stores.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QRSpec:
    """Static metadata for one QR-compressed table."""

    table_id: int      # canonical table index
    rows: int          # original number of categories n
    dim: int           # embedding dim of each sub-table
    collisions: int    # c
    operation: str     # mult | add | concat

    @property
    def q_rows(self) -> int:
        return int(np.ceil(self.rows / self.collisions))

    @property
    def out_dim(self) -> int:
        return 2 * self.dim if self.operation == "concat" else self.dim


def init_qr(rng: np.random.RandomState, spec: QRSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Both sub-tables ~ U(-sqrt(1/n), sqrt(1/n)) over the original n,
    quotient first: the JAX package's draws."""
    bound = np.sqrt(1.0 / spec.rows)
    q = rng.uniform(-bound, bound, size=(spec.q_rows, spec.dim)).astype(np.float32)
    r = rng.uniform(-bound, bound, size=(spec.collisions, spec.dim)).astype(np.float32)
    return q, r


def _combine(q: torch.Tensor, r: torch.Tensor, op: str) -> torch.Tensor:
    if op == "mult":
        return q * r
    if op == "add":
        return q + r
    if op == "concat":
        return torch.cat([q, r], dim=-1)
    raise ValueError(f"unknown qr operation {op!r}")


def _split(spec: QRSpec, indices: torch.Tensor):
    """(quotient ids, remainder ids) of [B, L] indices, flattened."""
    flat = indices.reshape(-1)
    return (torch.div(flat, spec.collisions, rounding_mode="floor"),
            torch.remainder(flat, spec.collisions))


def qr_lookup(q_store: torch.Tensor, r_store: torch.Tensor, spec: QRSpec,
              indices: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """indices / weights: [B, L] for this table. Returns pooled [B, out_dim]
    = sum_l w * combine(Q[i // c], R[i % c])."""
    b, l = indices.shape
    qi, ri = _split(spec, indices)
    q = q_store.index_select(0, qi).reshape(b, l, spec.dim)
    r = r_store.index_select(0, ri).reshape(b, l, spec.dim)
    emb = _combine(q, r, spec.operation)  # [B, L, out_dim]
    return (weights[..., None] * emb).sum(dim=1)


def qr_row_grads(q_store: torch.Tensor, r_store: torch.Tensor, spec: QRSpec,
                 indices: torch.Tensor, weights: torch.Tensor, g_pooled: torch.Tensor):
    """The chain rule through the combine for the pooled cotangent
    g_pooled [B, out_dim]. Returns ((q_idx [K], q_g [K, dim]), (r_idx [K],
    r_g [K, dim])): flat per-occurrence grads, not coalesced. Reads the
    sub-tables as they are, so an in-place update of either comes after."""
    b, l = indices.shape
    qi, ri = _split(spec, indices)
    w = weights[..., None]        # [B, L, 1]
    g = g_pooled[:, None, :]      # [B, 1, out_dim]
    d = spec.dim
    if spec.operation == "mult":
        q = q_store.index_select(0, qi).reshape(b, l, d)
        r = r_store.index_select(0, ri).reshape(b, l, d)
        gq = (w * g * r).reshape(b * l, d)
        gr = (w * g * q).reshape(b * l, d)
    elif spec.operation == "add":
        gq = (w * g).expand(b, l, d).reshape(b * l, d)
        gr = gq
    elif spec.operation == "concat":
        gq = (w * g[..., :d]).expand(b, l, d).reshape(b * l, d)
        gr = (w * g[..., d:]).expand(b, l, d).reshape(b * l, d)
    else:
        raise ValueError(spec.operation)
    return (qi, gq), (ri, gr)
