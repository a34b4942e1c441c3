"""Table-batched embedding storage, pooled lookup (EmbeddingBag sum) and
its row gradients.

The port of ``dlrm_yx_tpu/ops/embedding.py``. Tables are grouped by (dim,
size class); each group is one flat store with static row offsets, so a
multi-table lookup is one gather. The stores take no autograd gradient:
``flat_row_grads`` expands the pooled cotangent into per-row updates that
the optimizer applies sparsely.

Weighted pooling (the reference's per-row pooling weights v_W,
``dlrm_s_pytorch.py:308-316,545-548``): a group's ``vw`` is a 1-D
``[total_rows]`` vector, and a lookup weighs row ``i`` by ``w * vw[i]``,
in the lookup and in its row gradients; ``vw_row_grads`` gives the
gradient of a learned ``vw``.

Fixed multi-hot bags (the port's own, for DLRM-DCNv2's
``--multi-hot-sizes``): table t takes ``h_t`` ids a sample, every one
live. A batch holds them as ``[sum(h), B, 1]`` slots, table t's ``h_t``
slots in a row (``DLRMConfig.slot_tables``), so a group's lookup is the
L=1 gather over its slots, each at its table's row offset, and its pooled
vectors the sum of each table's slots (``lookup_bags``: a table's slots
are adjacent, so one reduction over each table's run of slots, a repeated
id counted each time, as ``EmbeddingBag(mode="sum")``). The row gradients
are the pooled cotangent taken back to the slots (``bag_row_grads``), one
item a slot and sample: no padding, and the rows the lookup gathered serve
the write-only update as at L=1. The bag layout's ``weights`` are not
read: a bag is unweighted.

Stores: the JAX package keeps sub-128 dims in a packed physical layout
``[total_rows/pack, 128]``, which is a pure row-major reshape of the logical
``[total_rows, dim]`` rows (``pack_store`` / ``unpack_store``). The port
keeps the logical layout, with the same group row offsets, ``ROW_ALIGN``
and ``SENTINEL_ROWS``, so indices and stores compare element by element
with the JAX package's; ``pack`` stays as metadata for that alignment.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

LANES = 128
ROW_ALIGN = 8  # each table's row block starts 8-aligned (in PHYSICAL rows;
               # packed groups align to 8*pack logical rows)
SENTINEL_ROWS = 8  # dead PHYSICAL rows at the end of every group store,
                   # never looked up (the JAX update kernels' scratch rows)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class TableGroup:
    """Static metadata for one group of tables.

    table_ids: canonical table indices in this group (order within group).
    rows: true row counts per table.
    dim: embedding dim shared by the group.
    row_offsets: start row of each table inside the flat store.
    total_rows: padded total (logical) rows of the store.
    size_class: 0 = small-table group, 1 = big/unsplit.
    pack: logical rows per 128-lane physical row of the JAX package's
      store (128/dim for sub-128 dims dividing 128, else 1).
    """

    table_ids: Tuple[int, ...]
    rows: Tuple[int, ...]
    dim: int
    row_offsets: Tuple[int, ...]
    total_rows: int
    size_class: int = 1
    pack: int = 1

    @property
    def num_tables(self) -> int:
        return len(self.table_ids)

    @property
    def store_shape(self) -> Tuple[int, int]:
        """Physical shape of the JAX package's store of this group."""
        return (self.total_rows // self.pack, self.dim * self.pack)


@dataclasses.dataclass(frozen=True)
class BagSlots:
    """A group's tables in the bag layout.

    slots: the batch's slots of the group's tables, in group order.
    offsets: each slot's store row offset (its table's).
    owner: each slot's table, as its position in the group.
    sizes: each of the group's tables' bag size (its run of adjacent slots).
    """

    slots: Tuple[int, ...]
    offsets: Tuple[int, ...]
    owner: Tuple[int, ...]
    sizes: Tuple[int, ...]


@functools.lru_cache(maxsize=64)
def _bag_slots(groups: Tuple[TableGroup, ...], hotness: Tuple[int, ...]):
    first = [0]
    for h in hotness:
        first.append(first[-1] + h)
    out = []
    for g in groups:
        slots, offsets, owner = [], [], []
        for i, (t, off) in enumerate(zip(g.table_ids, g.row_offsets)):
            for s in range(first[t], first[t + 1]):
                slots.append(s)
                offsets.append(off)
                owner.append(i)
        out.append(BagSlots(tuple(slots), tuple(offsets), tuple(owner),
                            tuple(hotness[t] for t in g.table_ids)))
    return tuple(out)


def bag_slots(groups: Sequence[TableGroup], hotness: Sequence[int]):
    """Each group's ``BagSlots`` for the fixed bag sizes ``hotness`` (one a
    table, canonical order), or None for the ``[T, B, L]`` layout."""
    if not hotness:
        return None
    return _bag_slots(tuple(groups), tuple(int(h) for h in hotness))


def dim_pack(d: int) -> int:
    """Logical rows per 128-lane physical row for dim d."""
    return LANES // d if d < LANES and LANES % d == 0 else 1


def pack_store(arr, group: TableGroup):
    """[total_rows, dim] (logical) -> the JAX package's physical store
    shape; a pure row-major reshape (numpy or torch)."""
    return arr.reshape(group.store_shape)


def unpack_store(arr, group: TableGroup):
    """Physical store -> [total_rows, dim] logical rows."""
    return arr.reshape(group.total_rows, group.dim)


def build_table_groups(
    emb_rows: Sequence[int],
    emb_dims: Sequence[int],
    table_ids: Optional[Sequence[int]] = None,
    small_threshold: Optional[int] = None,
) -> List[TableGroup]:
    """Group tables by dim (and, with small_threshold, by rows <= threshold
    vs above); compute aligned flat-store row offsets. Every group store
    carries SENTINEL_ROWS * pack dead rows at the end."""
    if table_ids is None:
        table_ids = range(len(emb_rows))
    by_key = {}
    for t in table_ids:
        n, d = emb_rows[t], emb_dims[t]
        size_class = 0 if small_threshold is None or n <= small_threshold else 1
        by_key.setdefault((int(d), size_class), []).append((int(t), int(n)))
    groups = []
    for key in sorted(by_key):
        d, size_class = key
        entries = by_key[key]
        pack = dim_pack(d)
        align = ROW_ALIGN * pack
        offsets, cur = [], 0
        for _, n in entries:
            offsets.append(cur)
            cur += _round_up(n, align)
        groups.append(
            TableGroup(
                table_ids=tuple(t for t, _ in entries),
                rows=tuple(n for _, n in entries),
                dim=d,
                row_offsets=tuple(offsets),
                total_rows=cur + SENTINEL_ROWS * pack,
                size_class=1 if small_threshold is None else size_class,
                pack=pack,
            )
        )
    return groups


def device_ints(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A static int32 vector on ``device``, copied there once: a fresh
    host-to-device copy in every step would stall the host on the card.
    Made outside inference mode, so that a vector first asked for by an
    eval step can serve a train step's autograd later. Under
    ``torch.export`` (or ``torch.compile``) tracing it is made afresh, a
    constant of the traced program: a cached one would be a fake tensor."""
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=torch.int32, device=device)
    return _cached_ints(values, device)


@functools.lru_cache(maxsize=256)
def _cached_ints(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.int32, device=device)


def global_row_ids(group: TableGroup, indices: torch.Tensor) -> torch.Tensor:
    """Map per-table indices [T, B, L] to rows of the flat store."""
    offs = device_ints(group.row_offsets, indices.device)
    return indices + offs[:, None, None]


def gather_rows(store: torch.Tensor, flat_gidx: torch.Tensor) -> torch.Tensor:
    """Store rows at logical global ids -> [N, dim]."""
    return store.index_select(0, flat_gidx)


def _vw_weights(w: torch.Tensor, vw: Optional[torch.Tensor], gidx: torch.Tensor):
    """w [T, B, L] times the pooling weights of the rows ``gidx`` looks up."""
    if vw is None:
        return w
    return w * vw.index_select(0, gidx.reshape(-1)).reshape(gidx.shape)


def lookup_group(
    store: torch.Tensor,
    group: TableGroup,
    indices: torch.Tensor,
    weights: torch.Tensor,
    vw: Optional[torch.Tensor] = None,
    return_rows: bool = False,
):
    """Pooled-sum lookup: store [total_rows, dim]; indices / weights
    [T, B, L] (weight 0 = padding); vw: the group's [total_rows] pooling
    weights, or None. Returns pooled [T, B, dim] f32 =
    sum_l w * vw[idx] * store[idx], pooled in f32 as the reference does.

    With ``return_rows`` at L=1 it also returns the gathered rows
    [T, B, dim] f32: the rows the optimizer will update, which lets the
    write-only update skip reading them again."""
    t, b, l = indices.shape
    gidx = global_row_ids(group, indices)
    w = _vw_weights(weights, vw, gidx)
    rows = gather_rows(store, gidx.reshape(-1)).float().reshape(t, b, l, group.dim)
    if l == 1:
        r1 = rows[:, :, 0, :]
        pooled = r1 * w[:, :, 0, None]
        return (pooled, r1) if return_rows else pooled
    return (w[..., None] * rows).sum(dim=2)


def bag_global_ids(bags: BagSlots, indices: torch.Tensor) -> torch.Tensor:
    """Store rows [S_g, B] of the group's slots of a bag batch's ids [S, B, 1]."""
    ids = indices[:, :, 0]
    if bags.slots != tuple(range(indices.shape[0])):
        ids = ids.index_select(0, device_ints(bags.slots, indices.device))
    return ids + device_ints(bags.offsets, indices.device)[:, None]


def lookup_bags(store: torch.Tensor, group: TableGroup, bags: BagSlots,
                indices: torch.Tensor, return_rows: bool = False):
    """Pooled sums of the group's bags: ids [S, B, 1] of every slot ->
    pooled [T_g, B, dim] f32, each table's slots summed in f32. With
    ``return_rows`` also the gathered rows [S_g, B, dim] f32, the rows the
    update overwrites."""
    gidx = bag_global_ids(bags, indices)
    s, b = gidx.shape
    rows = gather_rows(store, gidx.reshape(-1)).float().reshape(s, b, group.dim)
    # a table's slots are adjacent: one sum over each table's run of slots
    pooled = torch.stack([r.sum(dim=0) for r in rows.split(bags.sizes, dim=0)])
    return (pooled, rows) if return_rows else pooled


@dataclasses.dataclass(frozen=True)
class BagRowGrads:
    """A bag group's row gradients where they lie: item k = s * batch + b
    (slot s, sample b) takes row ``owner[s] * batch + b`` of ``table``, the
    pooled cotangent [T_g * batch, dim] f32; ``owner`` [S_g] int32 on the
    table's device. ``expand()`` writes them out, one row an item."""

    table: torch.Tensor
    owner: torch.Tensor
    batch: int

    def rows(self, items: torch.Tensor) -> torch.Tensor:
        """The table rows [n] int64 of items [n]."""
        s = torch.div(items, self.batch, rounding_mode="floor")
        return self.owner.long()[s] * self.batch + (items - s * self.batch)

    def expand(self) -> torch.Tensor:
        """[S_g * batch, dim] f32: item k's row at row k."""
        d = self.table.shape[1]
        return self.table.view(-1, self.batch, d).index_select(0, self.owner).reshape(-1, d)


def bag_row_grads(bags: BagSlots, indices: torch.Tensor, g_pooled: torch.Tensor,
                  expand: bool = True):
    """The pooled cotangent [T_g, B, dim] taken back to the group's bag
    items: (flat_idx [S_g * B] store rows, flat_g [S_g * B, dim] f32), one
    item a slot and sample, none padded; with ``expand=False`` flat_g is a
    ``BagRowGrads``, which reads each item's row from the cotangent."""
    gidx = bag_global_ids(bags, indices)
    t, b, d = g_pooled.shape
    grads = BagRowGrads(g_pooled.float().reshape(t * b, d),
                        device_ints(bags.owner, g_pooled.device), b)
    return gidx.reshape(-1), grads.expand() if expand else grads


def _pad_l_sublane(gidx: torch.Tensor, w: torch.Tensor, fill_idx: int):
    """Pad the L axis of [T, B, L] ids / weights to a multiple of 8 with
    ``fill_idx`` ids and zero weights, as the JAX package does for packed
    groups (its TPU layout needs it). The port keeps the padding so that a
    packed group's update sees the same K items, the same routing and the
    same inactive tail."""
    l = gidx.shape[2]
    pad = (-l) % 8
    if pad == 0 or l == 1:
        return gidx, w
    return (torch.nn.functional.pad(gidx, (0, pad), value=fill_idx),
            torch.nn.functional.pad(w, (0, pad)))


def flat_row_grads(
    group: TableGroup,
    indices: torch.Tensor,
    weights: torch.Tensor,
    g_pooled: torch.Tensor,
    vw: Optional[torch.Tensor] = None,
):
    """Expand the pooled-output cotangent into per-row gradient
    contributions: d loss / d store[idx[t,b,l]] += w[t,b,l] * vw[idx] *
    g_pooled[t,b] (vw 1 without weighted pooling; duplicates not yet
    coalesced).

    Returns (flat_idx [K] global row ids, flat_g [K, dim] f32 logical
    rows). Padded entries (weight 0) keep their row id and contribute zero;
    a packed group pads L to a multiple of 8 with the sentinel id
    ``total_rows`` (see ``_pad_l_sublane``)."""
    gidx = global_row_ids(group, indices)
    w = _vw_weights(weights, vw, gidx)
    if group.pack > 1:
        gidx, w = _pad_l_sublane(gidx, w, group.total_rows)
    t, b, l = gidx.shape
    flat_g = (w[..., None] * g_pooled[:, :, None, :]).reshape(t * b * l, group.dim)
    return gidx.reshape(-1), flat_g


def vw_row_grads(
    group: TableGroup,
    store: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
    g_pooled: torch.Tensor,
):
    """Gradient contributions for learned pooling weights v_W:
    d loss / d vw[idx[t,b,l]] += w[t,b,l] * <g_pooled[t,b], store[idx]>.
    Reads the store as it is, so its in-place update comes after.

    Returns (flat_idx [T*B*L] global row ids, flat_g [T*B*L] f32)."""
    gidx = global_row_ids(group, indices)
    t, b, l = gidx.shape
    rows = gather_rows(store, gidx.reshape(-1)).float().reshape(t, b, l, group.dim)
    g = (rows * g_pooled[:, :, None, :]).sum(dim=-1) * weights
    return gidx.reshape(-1), g.reshape(-1)
