"""Column-sharded embedding tables over the "model" axis of a mesh of ranks.

The port of ``dlrm_yx_tpu/parallel/col_sharded.py`` (``--shard-mode col``):
every big table keeps all its rows on every model rank, but only a
``D / n_model`` column slice. Small tables live full-width in the
replicated small store, as in row sharding (``parallel/row_sharded.py``,
which holds the pieces both share). One process per device, over
``torch.distributed``:

  * every model rank of a data shard pools its column slice for the whole
    index block ``[Tb, Bd, L]``;
  * JAX's ``all_to_all(pooled, "model", split_axis=1, concat_axis=2,
    tiled=True)`` is ``all_to_all_single`` over the model group on the
    pooled slice laid out ``[M, Tb, Bd/M, d_local]`` (batch chunk j to
    model rank j); source j's columns land at ``j * d_local``: the
    batch-sharded full-width ``[Tb, Bd/M, D]``. Its backward is the
    reverse exchange;
  * each rank applies its own column slice's row grads
    (``_sparse_slice_update``); RWSAdagrad's row momentum takes the
    full-width row norm as an ``all_reduce`` over the model group of the
    per-slice squares, and a learned ``vw`` (replicated) the same of its
    per-slice dots.

The port keeps the slice as logical ``[total_rows, d_local]`` rows, and a
row grad is just its ``[K, d_local]`` slice (JAX places it in its lane
block of a packed 128-lane row). JAX's ``pack`` stays as metadata: the
kernel gate of ``_sparse_slice_update`` is JAX's, computed on JAX's
physical layout, whatever the port's kernels could take: K2 (write-only)
and K4 (row read-modify-write) on an f32 slice whose physical row is 128
lanes wide, a scatter otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.ops.coalesce import coalesce_rows
from dlrm_yx_tpu_torch.ops.embedding import ROW_ALIGN, SENTINEL_ROWS, TableGroup, _round_up
from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add
from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
from dlrm_yx_tpu_torch.optim import optimizer as _optim
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, _add_at, _take_fill
from dlrm_yx_tpu_torch.parallel.mesh import Mesh
from dlrm_yx_tpu_torch.parallel.row_sharded import (
    ShardedRunner,
    _copy,
    _dense_backward,
    _draw_tables,
    _layouts,
    _old_rows_taken,
    _Rank,
    _reject_unsupported_variants,
    _small_accum_inputs,
    _small_from_tables,
    _small_lookup,
    _small_params,
    _small_tables,
    _take_tables,
    _update_small,
    _vw_update,
    gather_model_batch,
    split_tables,
)
from dlrm_yx_tpu_torch.parallel.runner import dense_copy, single_device_tables
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.profiling import phase_scope


@dataclasses.dataclass(frozen=True)
class ColShardPlan:
    """Static layout, field for field the JAX package's: the big tables'
    ``total_rows`` (with a sentinel tail of ``SENTINEL_ROWS * pack``) on
    every model shard, ``d_local`` columns each; ``pack = 128 // d_local``
    logical rows a physical row where ``d_local`` divides 128."""

    n_model: int
    dim: int
    d_local: int
    rows: tuple
    row_offsets: tuple
    total_rows: int
    pack: int = 1
    big_ids: tuple = ()
    small_group: Optional[TableGroup] = None
    dups_in_big: bool = True

    @property
    def store_rows(self) -> int:
        """Physical rows of the JAX package's slice store."""
        return self.total_rows // self.pack

    @property
    def store_width(self) -> int:
        return self.d_local * self.pack

    @property
    def canonical_perm(self) -> np.ndarray:
        order = list(self.big_ids) + (
            list(self.small_group.table_ids) if self.small_group else [])
        return np.argsort(np.asarray(order))


def make_col_plan(config: DLRMConfig, n_model: int) -> ColShardPlan:
    _reject_unsupported_variants(config, "col")
    dims = set(config.emb_dims)
    if len(dims) != 1:
        raise ValueError("col-sharded plan requires homogeneous table dims")
    dim = dims.pop()
    if dim % n_model:
        raise ValueError(f"dim {dim} not divisible by n_model {n_model}")
    d_local = dim // n_model
    pack = 128 // d_local if d_local < 128 and 128 % d_local == 0 else 1
    big_ids, small_group, dups = split_tables(config)
    align = max(ROW_ALIGN, pack)
    offsets, cur = [], 0
    for t in big_ids:
        offsets.append(cur)
        cur += _round_up(config.emb_rows[t], align)
    return ColShardPlan(
        n_model=n_model, dim=dim, d_local=d_local,
        rows=tuple(config.emb_rows[t] for t in big_ids), row_offsets=tuple(offsets),
        # the dead sentinel tail the row kernels need; ids never reach it
        total_rows=cur + SENTINEL_ROWS * pack, pack=pack, big_ids=tuple(big_ids),
        small_group=small_group, dups_in_big=dups)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def build_col_sharded_emb(plan: ColShardPlan, per_table) -> np.ndarray:
    """[n_model, total_rows, d_local] logical slice stores from per-big-table
    weights in ``plan.big_ids`` order (the JAX package's packed stores as
    logical rows)."""
    flat = np.zeros((plan.total_rows, plan.dim), np.float32)
    for t, w in enumerate(per_table):
        off = plan.row_offsets[t]
        flat[off: off + w.shape[0]] = np.asarray(w)
    parts = flat.reshape(plan.total_rows, plan.n_model, plan.d_local)
    return np.ascontiguousarray(np.transpose(parts, (1, 0, 2)))


def extract_col_sharded_tables(plan: ColShardPlan, emb, emb_small=None):
    """Canonical per-table weights from the slice stores (``[n_model,
    ...]``, physical or logical; numpy or torch) and the small store."""
    unpacked = emb.reshape(plan.n_model, plan.total_rows, plan.d_local)
    flat = unpacked.transpose(1, 0, 2) if isinstance(unpacked, np.ndarray) else \
        unpacked.permute(1, 0, 2)
    flat = flat.reshape(plan.total_rows, plan.dim)
    out = {t: _copy(flat[off: off + n])
           for t, off, n in zip(plan.big_ids, plan.row_offsets, plan.rows)}
    if plan.small_group is not None:
        _small_tables(plan.small_group, emb_small, out)
    return [out[t] for t in sorted(out)]


def init_col_sharded_params(config: DLRMConfig, plan: ColShardPlan, seed: int = 123,
                            model_index: int = 0,
                            device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The same draws as ``init_dlrm`` (and the JAX package's
    ``init_col_sharded_params``), shard ``model_index``'s column slice of the
    big tables laid into its ``[total_rows, d_local]`` f32 store, the small
    tables into the replicated small store; with weighted pooling ``vw``
    (replicated: every shard holds every big row) and ``vw_small`` ones on
    the live rows."""
    from dlrm_yx_tpu_torch.models.dlrm import _dense_params
    from dlrm_yx_tpu_torch.parallel.row_sharded import _ones

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    store = torch.zeros((plan.total_rows, plan.d_local), dtype=torch.float32, device=dev)
    sg = plan.small_group
    small = (torch.zeros((sg.total_rows, sg.dim), dtype=torch.float32, device=dev)
             if sg is not None else None)
    big = dict(zip(plan.big_ids, plan.row_offsets))
    where_small = dict(zip(sg.table_ids, sg.row_offsets)) if sg is not None else {}
    c0 = model_index * plan.d_local

    def place(t, r0, rows):
        if t in big:
            off = big[t] + r0
            store[off: off + rows.shape[0]] = torch.from_numpy(
                np.ascontiguousarray(rows[:, c0: c0 + plan.d_local]))
        else:
            off = where_small[t] + r0
            small[off: off + rows.shape[0]] = torch.from_numpy(rows)

    _draw_tables(config, rng, place)
    params = {**_dense_params(rng, config, dev), "emb": store, "vw": None,
              **_small_params(config, sg, small, dev)}
    if config.weighted_pooling is not None:
        params["vw"] = _ones(plan.total_rows, zip(plan.row_offsets, plan.rows), dev)
    return params


def params_from_single_device(config: DLRMConfig, plan: ColShardPlan, params: Dict,
                              model_index: int = 0) -> Dict:
    """Shard ``model_index``'s column-sharded params from the single-device
    params of ``models.dlrm`` (plain tables, on their device)."""
    tables = single_device_tables(config, params)
    like = params["emb"][0]
    store = torch.zeros((plan.total_rows, plan.d_local), dtype=torch.float32,
                        device=like.device)
    c0 = model_index * plan.d_local
    for t, off in zip(plan.big_ids, plan.row_offsets):
        store[off: off + tables[t].shape[0]] = tables[t][:, c0: c0 + plan.d_local]
    return {**dense_copy(params), "emb": store, "vw": None,
            **_small_params(config, plan.small_group, _small_from_tables(plan, tables, like),
                            like.device)}


def col_layouts(plan: ColShardPlan, opt: OptConfig) -> Dict:
    return _layouts(plan, opt, (plan.total_rows, plan.d_local),
                    (plan.store_rows, plan.store_width), "rep")


# ---------------------------------------------------------------------------
# the slice update
# ---------------------------------------------------------------------------

def kernel_gate(plan: ColShardPlan, config: DLRMConfig, store: torch.Tensor, k: int) -> bool:
    """The JAX package's gate for the row kernels on a column slice
    (``col_sharded.py:195-205``), on its physical layout: an f32 slice whose
    physical row is 128 lanes wide (natural, or packed), of at least
    ``PALLAS_MIN_STORE_BYTES``, with ``K * DENSE_ACCUM_FACTOR`` under its
    physical rows."""
    pk = plan.pack
    return (config.sparse_update_impl in ("pallas", "stream")
            and store.dtype == torch.float32
            and ((pk == 1 and plan.store_width % 128 == 0)
                 or (pk > 1 and plan.store_width == 128))
            and store.numel() * store.element_size() >= _optim.PALLAS_MIN_STORE_BYTES
            and k * _optim.DENSE_ACCUM_FACTOR < plan.store_rows)


def _sparse_slice_update(plan: ColShardPlan, config: DLRMConfig, opt: OptConfig, mesh: Mesh,
                         store: torch.Tensor, acc, flat_idx: torch.Tensor,
                         flat_g: torch.Tensor, lr, old_rows=None):
    """Sparse update of the rank's column slice and its optimizer state, in
    place; returns (store, acc). flat_idx: [K] logical row ids; flat_g: [K,
    d_local] row grads; old_rows: [K, d_local] the slice's rows as the
    forward gathered them (all-gathered over "data" with the grads).

    On the kernel route (``kernel_gate``) with old_rows the write-only
    update applies new = old + delta (K2), Adagrad's accumulator through K4,
    with per-occurrence momentum; else duplicates are coalesced first and
    the store (and Adagrad's accumulator) take K4. Off the kernel route the
    updates are scatters. RWSAdagrad's momentum adds the full-width row
    norm: the per-slice squares summed over the model group."""
    n = plan.total_rows
    kern = kernel_gate(plan, config, store, flat_idx.shape[0])

    def kernel_add(arr, uniq, vals):
        return sparse_rows_add(arr, uniq, vals, (uniq < n).to(torch.int32))

    def row_norms(g):
        return mesh.all_reduce_model((g * g).sum(dim=-1)) / plan.dim

    if kern and old_rows is not None and not config.exact_row_momentum:
        active = (flat_idx < n).to(torch.int32)

        def apply_store(delta):
            return sparse_rows_overwrite(store, flat_idx, old_rows + delta, delta, active)

        if opt.name == "sgd":
            return apply_store(-lr * flat_g), acc
        if opt.name == "adagrad":
            acc2 = kernel_add(acc, flat_idx, flat_g * flat_g)
            denom = _take_fill(acc2, flat_idx, 1.0, n).sqrt() + opt.eps
            return apply_store(-lr * flat_g / denom), acc2
        safe = torch.where(active > 0, flat_idx, n)
        _add_at(acc, safe, row_norms(flat_g) * active, n)
        denom = _take_fill(acc, safe, 1.0, n).sqrt() + opt.eps
        return apply_store(-lr * flat_g / denom[:, None]), acc

    if opt.name == "sgd":
        if not kern:
            _add_at(store, flat_idx, (-lr * flat_g).to(store.dtype), n)
            return store, acc
        uniq, sg = coalesce_rows(flat_idx, flat_g, n)
        return kernel_add(store, uniq, -lr * sg), acc

    uniq, sg = coalesce_rows(flat_idx, flat_g, n)
    if opt.name == "adagrad":
        gsq = sg * sg
        if kern:
            kernel_add(acc, uniq, gsq)
        else:
            _add_at(acc, uniq, gsq, n)
        delta = -lr * sg / (_take_fill(acc, uniq, 1.0, n).sqrt() + opt.eps)
    else:
        _add_at(acc, uniq, row_norms(sg), n)
        delta = -lr * sg / (_take_fill(acc, uniq, 1.0, n).sqrt() + opt.eps)[:, None]
    if kern:
        kernel_add(store, uniq, delta)
    else:
        _add_at(store, uniq, delta.to(store.dtype), n)
    return store, acc


# ---------------------------------------------------------------------------
# the column-sharded step
# ---------------------------------------------------------------------------

def _local_pooled(store: torch.Tensor, plan: ColShardPlan, gid, weights, vw=None):
    """(pooled slice [Tb, Bd, d_local], effective weights [Tb, Bd, L],
    gathered rows [Tb, Bd, L, d_local] f32)."""
    t, b, l = gid.shape
    safe = gid.clamp(max=plan.total_rows - 1)
    w = weights
    if vw is not None:
        w = w * vw.index_select(0, safe.reshape(-1)).reshape(t, b, l)
    rows = store.index_select(0, safe.reshape(-1)).float().reshape(t, b, l, plan.d_local)
    if l == 1:
        return rows[:, :, 0, :] * w[:, :, 0, None], w, rows
    return (w[..., None] * rows).sum(dim=2), w, rows


def _exchange(mesh: Mesh, pooled: torch.Tensor) -> torch.Tensor:
    """[Tb, Bd, d_local] -> [Tb, Bd/M, D]: batch chunk j to model rank j,
    source j's columns at ``j * d_local``."""
    n_model = mesh.shape["model"]
    t, bd, dl = pooled.shape
    send = pooled.reshape(t, n_model, bd // n_model, dl).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    with phase_scope("alltoall_fwd"):
        mesh.all_to_all_model(recv, send)
    return recv.permute(1, 2, 0, 3).reshape(t, bd // n_model, n_model * dl)


def _exchange_back(mesh: Mesh, g: torch.Tensor) -> torch.Tensor:
    """The exchange's transpose: [Tb, Bd/M, D] -> [Tb, Bd, d_local]."""
    n_model = mesh.shape["model"]
    t, bs, d = g.shape
    send = g.reshape(t, bs, n_model, d // n_model).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    with phase_scope("alltoall_bwd"):
        mesh.all_to_all_model(recv, send)
    return recv.transpose(0, 1).reshape(t, n_model * bs, d // n_model)


@dataclasses.dataclass
class _ColLookup:
    """One micro-batch's slice lookup: global ids [Tb, Bd, L], effective
    weights, raw weights and gathered rows [Tb, Bd, L, d_local]."""

    gid: torch.Tensor
    w_eff: torch.Tensor
    w_b: torch.Tensor
    rows: torch.Tensor


def _col_lookups(rk: _Rank, params: Dict, b: Batch):
    """(the exchanged full-width pooled [Tb, bs, D], the small lookup or
    None, the slice lookup)."""
    gid, w_b = rk.big_ids(b)
    with torch.no_grad():
        with phase_scope("embedding_lookup"):
            pooled, w_eff, rows = _local_pooled(params["emb"], rk.plan, gid, w_b,
                                                params.get("vw"))
        ly = _exchange(rk.mesh, pooled)
        with phase_scope("embedding_lookup"):
            small = _small_lookup(rk, params, b, b.labels.shape[0])
    return ly, small, _ColLookup(gid, w_eff, w_b, rows)


def _col_forward_backward(rk: _Rank, params, b):
    ly, small, look = _col_lookups(rk, params, b)
    share, grads, g_ly, g_small = _dense_backward(rk, params, b, ly, small)
    g_pooled = _exchange_back(rk.mesh, g_ly)
    g_s_full = gather_model_batch(rk.mesh, g_small) if small is not None else None
    return share, grads, (look, g_pooled, small, g_s_full)


def _col_vw_grads(rk: _Rank, rows, g_pooled, w_b):
    """d loss / d vw[row] = w * <g_pooled, store[row]> over the full width:
    the per-slice dots summed over the model group."""
    dots = (rows * g_pooled[..., None, :]).sum(dim=-1)
    return rk.mesh.all_reduce_model((dots * w_b).reshape(-1))


def _slice_update(rk: _Rank, opt: OptConfig, params: Dict, opt_state: Dict, flat_idx,
                  flat_g, lr, old_rows=None) -> None:
    mesh = rk.mesh
    _sparse_slice_update(rk.plan, rk.config, opt, mesh, params["emb"],
                         None if opt.name == "sgd" else opt_state["emb"],
                         mesh.all_gather_data(flat_idx), mesh.all_gather_data(flat_g), lr,
                         old_rows)


def _col_updates(rk: _Rank, opt: OptConfig, params, opt_state, b, piece, lr):
    """The sparse updates of one step (``col_sharded.py:631-702``)."""
    look, g_pooled, small, g_s_full = piece
    c, plan, mesh = rk.config, rk.plan, rk.mesh
    t, bd, l = look.gid.shape
    learned = params.get("vw") is not None and c.weighted_pooling == "learned"
    gv = _col_vw_grads(rk, look.rows, g_pooled, look.w_b) if learned else None
    flat_g = (look.w_eff[..., None] * g_pooled[:, :, None, :]).reshape(-1, plan.d_local)
    old = None
    if _old_rows_taken(c, plan, params["emb"], l):
        # a slice owns every row: the forward's rows are the old values
        old = mesh.all_gather_data(look.rows[:, :, 0, :].reshape(t * bd, -1))
    _slice_update(rk, opt, params, opt_state, look.gid.reshape(-1), flat_g, lr, old)
    if small is not None:
        _update_small(rk, opt, params, opt_state, small.idx, small.w, g_s_full, lr)
    if learned:
        _vw_update(rk, opt, params, opt_state, _vw_ids(plan, look.gid), gv, lr,
                   plan.total_rows)


def _vw_ids(plan: ColShardPlan, gid: torch.Tensor) -> torch.Tensor:
    flat = gid.reshape(-1)
    return torch.where(flat < plan.total_rows, flat, plan.total_rows)


def _col_accum_updates(rk: _Rank, opt: OptConfig, params, opt_state, batches, pieces, lr):
    """The accumulation step's sparse updates (``col_sharded.py:811-936``)."""
    c, plan = rk.config, rk.plan
    gid = torch.stack([p[0].gid for p in pieces])  # [n, Tb, Bd, L]
    g_pooled = torch.stack([p[1] for p in pieces])  # [n, Tb, Bd, d_local]
    w_big = _take_tables(batches.weights, plan.big_ids, 1)
    safe = gid.clamp(max=plan.total_rows - 1)
    vw = params.get("vw")
    wt = w_big
    if vw is not None:
        wt = wt * vw.index_select(0, safe.reshape(-1)).reshape(safe.shape)
    learned = vw is not None and c.weighted_pooling == "learned"
    gv = None
    if learned:
        rows = params["emb"].index_select(0, safe.reshape(-1)).float().reshape(
            *safe.shape, plan.d_local)
        gv = _col_vw_grads(rk, rows, g_pooled, w_big)
    flat_g = (wt[..., None] * g_pooled[:, :, :, None, :]).reshape(-1, plan.d_local)
    _slice_update(rk, opt, params, opt_state, gid.reshape(-1), flat_g, lr)
    if rk.small_ids is not None:
        _update_small(rk, opt, params, opt_state,
                      *_small_accum_inputs(rk, batches, [p[3] for p in pieces]), lr)
    if learned:
        _vw_update(rk, opt, params, opt_state, _vw_ids(plan, gid), gv, lr,
                   plan.total_rows)


class ColShardedRunner(ShardedRunner):
    """The runner of the column-sharded path (--shard-mode col)."""

    sharded_keys = ("emb",)
    make_plan = staticmethod(make_col_plan)
    init_params = staticmethod(init_col_sharded_params)
    layouts = staticmethod(col_layouts)
    extract_tables = staticmethod(extract_col_sharded_tables)
    lookups = staticmethod(_col_lookups)
    forward_backward = staticmethod(_col_forward_backward)
    updates = staticmethod(_col_updates)
    accum_updates = staticmethod(_col_accum_updates)
