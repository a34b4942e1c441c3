"""Hybrid-parallel placement plan.

The port of ``dlrm_yx_tpu/parallel/plan.py``: the reference's hybrid
layout (SURVEY.md §2.4), embedding tables model-parallel over the "model"
mesh axis by whole-table placement (``sharders``), dense MLPs data-parallel,
pooled vectors exchanged with an all-to-all. The static bookkeeping lives
here as host numpy, computed once, field for field as in the JAX package:
the device-major table order padded to ``t_pad`` slots a shard (``-1``
pseudo ids on the padding slots), the ``ROW_ALIGN`` row offsets of each
slot in its section's store, the big / small split at
``emb_split_threshold``, the canonical-order gather applied after the
exchange (the reference's table-order permutation after its butterfly
shuffle, ``dlrm_s_pytorch.py:948-956``), QR pseudo-tables and MD's
max-dim slots.

``build_sharded_emb`` and ``extract_tables`` take numpy arrays or torch
tensors. The port keeps logical ``[rows, dim]`` stores, so where the JAX
package returns a shard's packed physical store (``store_shape``) they
return its logical rows; ``extract_tables`` reads either.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.ops.embedding import ROW_ALIGN, SENTINEL_ROWS, _round_up, dim_pack
from dlrm_yx_tpu_torch.parallel.sharders import shard


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """All-static layout for one (config, n_model, sharder) choice.

    table_device: canonical table -> model-shard id.
    t_pad: per-shard table-slot count (max tables on any shard; short shards
      padded with dummy tables).
    device_table_order: [n_model * t_pad] (pseudo-)table ids in
      device-major order, -1 = padding slot.
    canonical_gather: [T] position of canonical (pseudo-)table t in
      device-major order (applied after the all-to-all to restore the
      canonical feature order).
    row_offsets: [n_model * t_pad] start row of each device-major slot
      inside its SECTION's store (big slots index the big store, small
      slots the small store); padding slots point past their section's live
      rows (clamped onto the dead sentinel rows on gather, dropped on
      update).
    n_big_slots: slots [0, n_big_slots) of every shard hold big tables (or
      padding) in the big store [r_big + SENTINEL_ROWS * pack, dim]; the
      slots after hold small tables in a separate small store (updated by
      the exact dense accumulate, ``size_class=0``).
    pseudo_table / pseudo_xform / pseudo_rows: the pseudo-table expansion
      of QR 'concat' (a QR table gives two slots, quotient then remainder:
      xform 1 = idx // c, 2 = idx % c; identity otherwise).
    pack: logical rows per 128-lane physical row of the JAX package's
      stores (128/dim for sub-128 dims dividing 128 on plain-table plans;
      1 with QR or MD); the port's stores are logical rows, ``pack`` keeps
      the alignment and the update routing.
    slot_coll / slot_roff / qr_r_rows: QR 'mult' / 'add': per slot the
      collisions (0 = not QR) and the row offset in the replicated
      remainder store of ``qr_r_rows`` rows.
    """

    n_model: int
    table_device: Tuple[int, ...]
    t_pad: int
    device_table_order: Tuple[int, ...]
    canonical_gather: Tuple[int, ...]
    row_offsets: Tuple[int, ...]
    dim: int
    n_big_slots: int = 0
    r_big: int = 0
    r_small: int = 0
    pseudo_table: Tuple[int, ...] = ()
    pseudo_xform: Tuple[int, ...] = ()
    pseudo_rows: Tuple[int, ...] = ()
    pack: int = 1

    @property
    def r_big_pad(self) -> int:
        """Logical rows of the big store (live + dead sentinel unit)."""
        return self.r_big + SENTINEL_ROWS * self.pack

    @property
    def r_small_pad(self) -> int:
        return self.r_small + SENTINEL_ROWS * self.pack

    def store_shape(self, section: str):
        """The JAX package's physical per-shard store shape for 'big' / 'small'."""
        rows = self.r_big_pad if section == "big" else self.r_small_pad
        return (rows // self.pack, self.dim * self.pack)

    slot_coll: Tuple[int, ...] = ()
    slot_roff: Tuple[int, ...] = ()
    qr_r_rows: int = 0

    @property
    def num_tables(self) -> int:
        return len(self.table_device)


def make_plan(
    config: DLRMConfig,
    n_model: int,
    alg: str = "greedy",
    allocation: Optional[Sequence[int]] = None,
) -> ShardingPlan:
    dims = set(config.emb_dims)
    if len(dims) == 1:
        dim = dims.pop()
    elif config.md_table_ids:
        # mixed-dimension (MD) tables: every slot uses the max dim; MD
        # tables' rows are stored with zero-padded columns and their pooled
        # outputs sliced back to d_t and up-projected after the exchange
        dim = max(dims)
        for t, d in enumerate(config.emb_dims):
            if d != dim and t not in config.md_table_ids:
                raise ValueError(
                    f"table {t} has dim {d} != {dim} but is not an MD table"
                )
    else:
        # arbitrary k*D dim mixes (dlrm_s_pytorch.py:579-585): slots carry
        # the max dim, narrower tables' rows zero-padded, their pooled
        # outputs sliced back after the exchange
        dim = max(dims)
        for t, d in enumerate(config.emb_dims):
            if d % config.base_dim:
                raise ValueError(
                    f"table {t} dim {d} is not a multiple of the base dim"
                )
    qr_ids = set(config.qr_table_ids)
    c = config.qr_collisions
    concat = bool(qr_ids) and config.qr_operation == "concat"
    if concat and len(set(config.emb_dims)) > 1:
        raise NotImplementedError(
            "hybrid QR concat with mixed k*D table dims is unsupported "
            "(slot bookkeeping assumes uniform D with concat)"
        )
    if concat:
        # QR tables become (quotient, remainder) pseudo-tables, both plain
        # tables of the sharded stores, in torch's concat order [q ; r]
        pseudo_table, pseudo_xform, pseudo_rows = [], [], []
        for tt, n in enumerate(config.emb_rows):
            if tt in qr_ids:
                pseudo_table += [tt, tt]
                pseudo_xform += [1, 2]
                pseudo_rows += [int(np.ceil(n / c)), c]
            else:
                pseudo_table.append(tt)
                pseudo_xform.append(0)
                pseudo_rows.append(n)
        rows = tuple(pseudo_rows)
    else:
        pseudo_table = list(range(len(config.emb_rows)))
        pseudo_xform = [0] * len(config.emb_rows)
        rows = tuple(
            int(np.ceil(n / c)) if tt in qr_ids else n
            for tt, n in enumerate(config.emb_rows)
        )
        pseudo_rows = list(rows)
    # the replicated remainder store of the mult / add combines
    r_offs: dict = {}
    cur_r = 0
    if not concat:
        for tt in sorted(qr_ids):
            r_offs[tt] = cur_r
            cur_r += _round_up(c, ROW_ALIGN)
    thr = config.emb_split_threshold or 0
    table_device = shard(rows, n_model, alg, allocation)
    pack = 1 if (qr_ids or config.md_table_ids) else dim_pack(dim)

    # per shard: big tables first, then small; the slot partition is
    # uniform across shards, so both sections pad to the max over shards
    per_big: List[List[int]] = [[] for _ in range(n_model)]
    per_small: List[List[int]] = [[] for _ in range(n_model)]
    for t, d in enumerate(table_device):
        # threshold disabled -> everything big (kernel-eligible)
        (per_small if thr and rows[t] <= thr else per_big)[d].append(t)
    n_big_slots = max(len(ts) for ts in per_big)
    n_small_slots = max(len(ts) for ts in per_small)
    t_pad = n_big_slots + n_small_slots

    align = ROW_ALIGN * pack  # table blocks stay physically 8-row aligned

    def layout(per_dev, base):
        """Row offsets per shard starting at base; returns (offsets, extent)."""
        extent = 0
        out = []
        for ts in per_dev:
            offs, cur = [], base
            for t in ts:
                offs.append(cur)
                cur += _round_up(rows[t], align)
            out.append(offs)
            extent = max(extent, cur - base, 0)
        return out, _round_up(extent, align)

    big_offsets, r_big = layout(per_big, 0)
    small_offsets, r_small = layout(per_small, 0)

    device_table_order: List[int] = []
    row_offsets: List[int] = []
    for d in range(n_model):
        device_table_order.extend(
            per_big[d] + [-1] * (n_big_slots - len(per_big[d]))
            + per_small[d] + [-1] * (n_small_slots - len(per_small[d]))
        )
        row_offsets.extend(
            big_offsets[d]
            + [r_big + SENTINEL_ROWS * pack] * (n_big_slots - len(per_big[d]))
            + small_offsets[d]
            + [r_small + SENTINEL_ROWS * pack]
            * (n_small_slots - len(per_small[d]))
        )

    canonical_gather = [0] * len(rows)
    for pos, t in enumerate(device_table_order):
        if t >= 0:
            canonical_gather[t] = pos

    slot_coll = tuple(
        (c if (not concat and t in qr_ids) else 0) if t >= 0 else 0
        for t in device_table_order
    )
    slot_roff = tuple(
        r_offs.get(t, 0) if t >= 0 else 0 for t in device_table_order
    )

    return ShardingPlan(
        n_model=n_model,
        table_device=tuple(table_device),
        t_pad=t_pad,
        device_table_order=tuple(device_table_order),
        canonical_gather=tuple(canonical_gather),
        row_offsets=tuple(row_offsets),
        dim=dim,
        n_big_slots=n_big_slots,
        r_big=r_big,
        r_small=r_small,
        pack=pack,
        slot_coll=slot_coll,
        slot_roff=slot_roff,
        qr_r_rows=cur_r,
        pseudo_table=tuple(pseudo_table),
        pseudo_xform=tuple(pseudo_xform),
        pseudo_rows=tuple(pseudo_rows),
    )


def _zeros(like, shape):
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    return np.zeros(shape, dtype=np.float32)


def build_sharded_emb(plan: ShardingPlan, config: DLRMConfig, per_table,
                      model_index: Optional[int] = None):
    """The (big, small) stores, ``[n_model, r_big_pad, dim]`` and
    ``[n_model, r_small_pad, dim]`` logical rows, from per-(pseudo-)table
    weights (a dict or list of ``[rows_t, dim_t]``, numpy or tensors on one
    device; f32 out, numpy or tensors alike). With ``model_index`` only that
    shard's ``[r_big_pad, dim]`` and ``[r_small_pad, dim]``: a rank's own."""
    first = per_table[next(iter(per_table))] if isinstance(per_table, dict) else per_table[0]
    lead = () if model_index is not None else (plan.n_model,)
    big = _zeros(first, lead + (plan.r_big_pad, plan.dim))
    small = _zeros(first, lead + (plan.r_small_pad, plan.dim))
    for pos, t in enumerate(plan.device_table_order):
        d = pos // plan.t_pad
        if t < 0 or (model_index is not None and d != model_index):
            continue
        off = plan.row_offsets[pos]
        w = per_table[t]
        out = big if pos % plan.t_pad < plan.n_big_slots else small
        if model_index is None:
            out = out[d]
        # MD tables have d_t < dim: zero-padded columns
        out[off: off + w.shape[0], : w.shape[1]] = w
    return big, small


def _logical(a, n_model, rows, dim):
    if a is None:
        return None
    return a.reshape(n_model, rows, dim)


def extract_tables(plan: ShardingPlan, config: DLRMConfig, emb, emb_small=None):
    """Inverse of build_sharded_emb: per-canonical-table weights (for export,
    checkpoints and tests) from the whole stores (``[n_model, ...]``,
    logical or the JAX package's physical layout; numpy or tensors). QR
    tables yield their quotient store."""
    emb = _logical(emb, plan.n_model, plan.r_big_pad, plan.dim)
    emb_small = _logical(emb_small, plan.n_model, plan.r_small_pad, plan.dim)
    out = {}
    for pos, pid in enumerate(plan.device_table_order):
        if pid < 0:
            continue
        if plan.pseudo_xform[pid] == 2:
            continue  # concat remainder slot: the canonical extract is the quotient
        tt = plan.pseudo_table[pid]
        d = pos // plan.t_pad
        off = plan.row_offsets[pos]
        n = plan.pseudo_rows[pid]
        src = emb if pos % plan.t_pad < plan.n_big_slots else emb_small
        out[tt] = src[d, off: off + n, : config.emb_dims[tt]]
    return [out[tt] for tt in range(len(config.emb_rows))]


def _gather(a, idx, axis):
    if isinstance(a, torch.Tensor):
        return a.index_select(axis, torch.as_tensor(idx, device=a.device))
    return np.take(a, idx, axis=axis)


def arrange_sparse_inputs(plan: ShardingPlan, indices, weights):
    """Reorder canonical [T, B, L] sparse inputs into device-major
    [n_model * t_pad, B, L] slots (padding slots: index 0, weight 0); numpy
    or tensors.

    The reference's per-rank input re-layout (``distribute_batched_emb_data``,
    dlrm_s_pytorch.py:772-824)."""
    order = np.asarray(plan.device_table_order)
    src = np.asarray(plan.pseudo_table)
    valid = order >= 0
    sel = np.where(valid, src[np.where(valid, order, 0)], 0)
    out_i = _gather(indices, sel, 0)
    out_w = _gather(weights, sel, 0)
    mask = valid[:, None, None]
    if isinstance(out_i, torch.Tensor):
        m = torch.as_tensor(mask, device=out_i.device)
        return (torch.where(m, out_i, torch.zeros((), dtype=out_i.dtype, device=out_i.device)),
                torch.where(m, out_w, torch.zeros((), dtype=out_w.dtype, device=out_w.device)))
    return (np.where(mask, out_i, 0).astype(out_i.dtype),
            np.where(mask, out_w, 0).astype(out_w.dtype))
