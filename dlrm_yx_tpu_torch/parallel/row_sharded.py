"""Row-sharded embedding tables over the "model" axis of a mesh of ranks.

The port of ``dlrm_yx_tpu/parallel/row_sharded.py`` (``--shard-mode row``):
the big tables' flat row space ``[total_rows, dim]`` is split row-wise into
``n_model`` equal shards, so one table may span every rank of a model
group. Tables at or under ``emb_split_threshold`` rows live in one
replicated small store a rank (a ``size_class`` 0 group: the exact dense
accumulate, K3 under RWSAdagrad), looked up after the exchange on the
rank's own batch slice. One process per device, over ``torch.distributed``
(``parallel/mesh.py``):

  * every model rank of a data shard sees that shard's whole index block
    ``[T, Bd, L]`` and pools only the rows it owns (``local = gid - m *
    rows_local``; every other row is masked to weight 0): a partial pooled
    sum ``[Tb, Bd, dim]``;
  * JAX's ``psum_scatter(partial, "model", scatter_dimension=1,
    tiled=True)`` is ``reduce_scatter_tensor`` over the model group on the
    partial laid out ``[M, Tb, Bd/M, dim]`` (batch chunk j to model rank
    j): it completes the sum and splits the batch in one collective;
  * its transpose, ``all_gather(g, "model", axis=1, tiled=True)``, is
    ``all_gather_into_tensor`` over the model group, concatenated along
    the batch axis; each rank applies the row grads it owns, with the
    forward's gathered rows (the write-only update, K2) where the JAX
    package takes them;
  * ``psum`` over both axes is one ``all_reduce`` over the world of the
    loss share (``local mean * b_local / B_global``) and the dense grads;
    row grads, ids and gathered rows are all-gathered over "data".

The port keeps logical ``[rows, dim]`` stores, as for every group store;
JAX's ``pack`` stays as metadata: it sets the row alignment (so each
logical row sits on the shard and at the offset it has in JAX) and the
update gates read the packed layout from it (``optim.sparse_update``).
``RowShardedRunner`` supplies the mode's bodies to the runner base
(``parallel/runner.py``), whose steps run as CUDA-graph replays over NCCL
on the card and eagerly elsewhere; its checkpoints keep the JAX package's
npz layout of the runner's pytrees.

The helpers shared with column sharding (``parallel/col_sharded.py``) live
here, as in the JAX package: ``_reject_unsupported_variants``,
``_take_tables``, ``_small_lookup``, ``_update_small``, the towers and the
runner's batch and checkpoint plumbing (``ShardedRunner``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import _array, _tensor, _towers
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import (
    _INIT_CHUNK_ROWS,
    DTYPES,
    _dense_params,
    dense_leaves,
    nest_dense,
)
from dlrm_yx_tpu_torch.ops.embedding import (
    ROW_ALIGN,
    SENTINEL_ROWS,
    TableGroup,
    _round_up,
    build_table_groups,
    device_ints,
    dim_pack,
    flat_row_grads,
    lookup_group,
    vw_row_grads,
)
from dlrm_yx_tpu_torch.ops.interaction import interact_features
from dlrm_yx_tpu_torch.ops.losses import loss_fn
from dlrm_yx_tpu_torch.ops.mlp import apply_mlp
from dlrm_yx_tpu_torch.optim.optimizer import (
    OptConfig,
    init_dense_state,
    sparse_update,
    sparse_update_1d,
    store_state,
)
from dlrm_yx_tpu_torch.parallel.mesh import Mesh, batch_split
from dlrm_yx_tpu_torch.parallel.runner import (
    Runner,
    dense_copy,
    mesh_accum_body,
    mesh_eval_body,
    mesh_train_body,
    single_device_tables,
)
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.profiling import phase_scope


def _reject_unsupported_variants(config: DLRMConfig, mode: str) -> None:
    """The row and column paths train plain tables; QR and MD raise, as in
    the JAX package (--shard-mode table takes them)."""
    unsupported = []
    if config.qr_table_ids:
        unsupported.append("--qr-flag")
    if config.md_table_ids:
        unsupported.append("--md-flag")
    if unsupported:
        raise NotImplementedError(
            f"{mode}-sharded mode does not support {', '.join(unsupported)}; "
            "use --shard-mode=table (hybrid) for these model variants"
        )


@dataclasses.dataclass(frozen=True)
class RowShardPlan:
    """Static layout, field for field the JAX package's: the big tables
    (one shared dim) concatenated into a flat row space split evenly over
    ``n_model`` shards, ``rows_local`` address rows a shard (owner = gid //
    rows_local) plus ``SENTINEL_ROWS * pack`` dead rows; the small tables in
    one replicated ``small_group`` (None when every table is big, or all
    are small: then all of them stay sharded); ``dups_in_big`` when a table
    at or under the duplicate threshold shares the sharded space."""

    n_model: int
    dim: int
    rows: tuple
    row_offsets: tuple
    rows_local: int
    pack: int = 1
    big_ids: tuple = ()
    small_group: Optional[TableGroup] = None
    dups_in_big: bool = True

    @property
    def total_rows(self) -> int:
        return self.n_model * self.rows_local

    @property
    def store_rows(self) -> int:
        """Logical rows of a shard's store: the address space and the dead
        sentinel rows."""
        return self.rows_local + SENTINEL_ROWS * self.pack

    @property
    def store_shape(self):
        """The JAX package's physical shard store shape."""
        return (self.store_rows // self.pack, self.dim * self.pack)

    @property
    def num_tables(self) -> int:
        return len(self.rows)

    @property
    def canonical_perm(self) -> np.ndarray:
        """concat([big tables, small tables]) order -> canonical order."""
        order = list(self.big_ids) + (
            list(self.small_group.table_ids) if self.small_group else [])
        return np.argsort(np.asarray(order))


def split_tables(config: DLRMConfig):
    """(big ids, small group or None, dups_in_big) of the JAX package's
    store split at ``emb_split_threshold`` (the row and column plans')."""
    thr = config.emb_split_threshold or 0
    ids = list(range(len(config.emb_rows)))
    small_ids = [t for t in ids if thr and config.emb_rows[t] <= thr]
    big_ids = [t for t in ids if t not in set(small_ids)]
    if not big_ids:
        # every table under the threshold: all of them stay sharded, so the
        # path still shards (tiny configs)
        big_ids, small_ids = ids, []
    small_group = None
    if small_ids:
        (small_group,) = build_table_groups(config.emb_rows, config.emb_dims,
                                            table_ids=small_ids)
        # small stores always take the exact dense accumulate
        small_group = dataclasses.replace(small_group, size_class=0)
    dup_thr = thr if thr > 0 else 65536
    return big_ids, small_group, any(config.emb_rows[t] <= dup_thr for t in big_ids)


def make_row_plan(config: DLRMConfig, n_model: int) -> RowShardPlan:
    _reject_unsupported_variants(config, "row")
    dims = set(config.emb_dims)
    if len(dims) != 1:
        raise ValueError("row-sharded plan requires homogeneous table dims")
    dim = dims.pop()
    pack = dim_pack(dim)
    big_ids, small_group, dups = split_tables(config)
    align = ROW_ALIGN * pack  # shard stores stay physically 8-row aligned
    offsets, cur = [], 0
    for t in big_ids:
        offsets.append(cur)
        cur += _round_up(config.emb_rows[t], align)
    return RowShardPlan(
        n_model=n_model, dim=dim, rows=tuple(config.emb_rows[t] for t in big_ids),
        row_offsets=tuple(offsets), rows_local=_round_up(cur, n_model * align) // n_model,
        pack=pack, big_ids=tuple(big_ids), small_group=small_group, dups_in_big=dups)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else np.array(x)


def build_row_sharded_emb(plan: RowShardPlan, per_table) -> np.ndarray:
    """[n_model, store_rows, dim] logical shard stores from per-big-table
    weights in ``plan.big_ids`` order (each shard's slice, then its dead
    sentinel rows): the JAX package's stores as logical rows."""
    flat = np.zeros((plan.total_rows, plan.dim), np.float32)
    for t, w in enumerate(per_table):
        off = plan.row_offsets[t]
        flat[off: off + w.shape[0]] = np.asarray(w)
    out = np.zeros((plan.n_model, plan.store_rows, plan.dim), np.float32)
    out[:, : plan.rows_local] = flat.reshape(plan.n_model, plan.rows_local, plan.dim)
    return out


def build_small_store(group: TableGroup, per_table) -> np.ndarray:
    """The replicated small store [total_rows, dim] from per-table weights
    in ``group.table_ids`` order."""
    store = np.zeros((group.total_rows, group.dim), np.float32)
    for w, off in zip(per_table, group.row_offsets):
        w = np.asarray(w)
        store[off: off + w.shape[0]] = w
    return store


def _small_tables(group: TableGroup, emb_small, out: Dict) -> None:
    s = emb_small.reshape(group.total_rows, group.dim)
    for t, off, n in zip(group.table_ids, group.row_offsets, group.rows):
        out[t] = _copy(s[off: off + n])


def extract_row_sharded_tables(plan: RowShardPlan, emb, emb_small=None) -> List:
    """Canonical per-table weights from the shard stores (``[n_model, ...]``
    in the JAX package's physical layout or as logical rows; numpy or
    torch) and the small store: the inverse of ``build_row_sharded_emb`` /
    ``build_small_store``."""
    logical = emb.reshape(plan.n_model, plan.store_rows, plan.dim)
    flat = logical[:, : plan.rows_local].reshape(plan.total_rows, plan.dim)
    out = {t: _copy(flat[off: off + n])
           for t, off, n in zip(plan.big_ids, plan.row_offsets, plan.rows)}
    if plan.small_group is not None:
        _small_tables(plan.small_group, emb_small, out)
    return [out[t] for t in sorted(out)]


def _ones(n: int, spans, device) -> torch.Tensor:
    """[n] f32: 1 on the rows of each (offset, rows) span, 0 elsewhere."""
    v = torch.zeros(n, dtype=torch.float32, device=device)
    for off, rows in spans:
        v[off: off + rows] = 1.0
    return v


def _small_params(config: DLRMConfig, group: Optional[TableGroup], store, device) -> Dict:
    """``emb_small`` and, with weighted pooling, ``vw_small``."""
    out = {"emb_small": store, "vw_small": None}
    if group is not None and config.weighted_pooling is not None:
        out["vw_small"] = _ones(group.total_rows, zip(group.row_offsets, group.rows), device)
    return out


def _draw_tables(config: DLRMConfig, rng: np.random.RandomState, place) -> None:
    """Every table's draw from ``rng`` in canonical order, as ``init_dlrm``
    (and the JAX package's ``init_row_sharded_params``) draws them, in
    chunks of rows: ``place(t, r0, rows)`` keeps what this rank holds."""
    for t, (n, d) in enumerate(zip(config.emb_rows, config.emb_dims)):
        bound = np.sqrt(1.0 / n)
        for r0 in range(0, n, _INIT_CHUNK_ROWS):
            r1 = min(n, r0 + _INIT_CHUNK_ROWS)
            place(t, r0, rng.uniform(-bound, bound, size=(r1 - r0, d)).astype(np.float32))


def _place_rows(dst: torch.Tensor, lo: int, g0: int, rows) -> None:
    """Copy the global rows [g0, g0 + len(rows)) that fall in a shard's
    address range [lo, lo + len(dst)) into ``dst``."""
    a, b = max(g0, lo), min(g0 + rows.shape[0], lo + dst.shape[0])
    if a < b:
        src = rows[a - g0: b - g0]
        dst[a - lo: b - lo] = src if isinstance(src, torch.Tensor) else torch.from_numpy(src)


def init_row_sharded_params(config: DLRMConfig, plan: RowShardPlan, seed: int = 123,
                            model_index: int = 0,
                            device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The same draws as ``init_dlrm`` (and the JAX package's
    ``init_row_sharded_params``: one RandomState, every table in canonical
    order, then the bottom and top MLPs), shard ``model_index``'s rows of
    the big space laid into its ``[store_rows, dim]`` f32 store, the small
    tables into the replicated small store and, with weighted pooling,
    ``vw`` / ``vw_small`` ones on the live rows."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    store = torch.zeros((plan.store_rows, plan.dim), dtype=torch.float32, device=dev)
    sg = plan.small_group
    small = (torch.zeros((sg.total_rows, sg.dim), dtype=torch.float32, device=dev)
             if sg is not None else None)
    lo = model_index * plan.rows_local
    big = dict(zip(plan.big_ids, plan.row_offsets))
    where_small = dict(zip(sg.table_ids, sg.row_offsets)) if sg is not None else {}

    def place(t, r0, rows):
        if t in big:
            _place_rows(store[: plan.rows_local], lo, big[t] + r0, rows)
        else:
            off = where_small[t] + r0
            small[off: off + rows.shape[0]] = torch.from_numpy(rows)

    _draw_tables(config, rng, place)
    params = {**_dense_params(rng, config, dev), "emb": store, "vw": None,
              **_small_params(config, sg, small, dev)}
    if config.weighted_pooling is not None:
        # v_W ones on the live rows, sharded with the big space; padding and
        # sentinel rows 0 (dlrm_s_pytorch.py:313-316)
        live = _ones(plan.total_rows, zip(plan.row_offsets, plan.rows), dev)
        params["vw"] = torch.cat([live[lo: lo + plan.rows_local],
                                  live.new_zeros(plan.store_rows - plan.rows_local)])
    return params


def _small_from_tables(plan, tables, like: torch.Tensor):
    sg = plan.small_group
    if sg is None:
        return None
    small = torch.zeros((sg.total_rows, sg.dim), dtype=torch.float32, device=like.device)
    for t, off in zip(sg.table_ids, sg.row_offsets):
        small[off: off + tables[t].shape[0]] = tables[t]
    return small


def params_from_single_device(config: DLRMConfig, plan: RowShardPlan, params: Dict,
                              model_index: int = 0) -> Dict:
    """Shard ``model_index``'s row-sharded params from the single-device
    params of ``models.dlrm`` (plain tables, on their device): its rows of
    the big space and the small store laid out by the plan, the MLPs
    copied. The two runs then start from the same state."""
    tables = single_device_tables(config, params)
    like = params["emb"][0]
    store = torch.zeros((plan.store_rows, plan.dim), dtype=torch.float32, device=like.device)
    lo = model_index * plan.rows_local
    for t, off in zip(plan.big_ids, plan.row_offsets):
        _place_rows(store[: plan.rows_local], lo, off, tables[t].float())
    return {**dense_copy(params), "emb": store, "vw": None,
            **_small_params(config, plan.small_group, _small_from_tables(plan, tables, like),
                            like.device)}


def init_sharded_opt_state(opt: OptConfig, params: Dict, plan) -> Dict:
    """Zeros as the JAX package's ``init_row_sharded_opt_state`` /
    ``init_col_sharded_opt_state`` give them, a rank's part: SGD none;
    Adagrad per element; RWSAdagrad one momentum a logical row of the shard
    store (``acc_len`` long, flat) and of the small store (unpadded);
    per-entry sums for ``vw`` / ``vw_small``. Keys as the JAX package's."""
    if opt.name == "sgd":
        return {}
    emb = params["emb"]
    state = {**init_dense_state(params), "emb": store_state(opt, emb, emb.shape[0])}
    if params.get("emb_small") is not None:
        state["emb_small"] = store_state(opt, params["emb_small"])
    if params.get("vw") is not None:
        state["vw"] = torch.zeros_like(params["vw"])
        if params.get("vw_small") is not None:
            state["vw_small"] = torch.zeros_like(params["vw_small"])
    return state



# ---------------------------------------------------------------------------
# the JAX package's whole pytrees <-> a rank's trees
# ---------------------------------------------------------------------------
#
# A layout maps a leaf to how the JAX package holds it: "shard" ([M, ...]:
# row m is model rank m's), "flat" (RWSAdagrad's momenta, flat over the M
# shards) or "rep" (replicated), with the rank's logical shape (None: as it
# is) and JAX's physical one.

def _layouts(plan, opt: OptConfig, emb_logical, emb_phys, vw_mode: str) -> Dict:
    sg = plan.small_group
    small = ("rep", None if sg is None else (sg.total_rows, sg.dim),
             None if sg is None else sg.store_shape)
    params = {"emb": ("shard", emb_logical, emb_phys), "emb_small": small,
              "vw": (vw_mode, None, None), "vw_small": ("rep", None, None)}
    state = dict(params)
    if opt.name == "rwsadagrad":
        state["emb"] = ("flat", None, None)
        state["emb_small"] = ("rep", None, None)
    return {"params": params, "opt_state": state}


def tree_from_jax(tree: Dict, layout: Dict, n_model: int, m: int, device) -> Dict:
    """Model rank ``m``'s tree (tensors on ``device``) from the JAX
    package's whole pytree as numpy."""
    if not tree:
        return {}
    conv = lambda a: _tensor(a, device)  # noqa: E731
    out = {}
    for key, v in tree.items():
        if key in ("bot", "top"):
            out[key] = _towers(tree, conv)[key]
        elif key == "dense":
            out[key] = _towers(v, conv)
        elif v is None:
            out[key] = None
        else:
            mode, logical, _ = layout[key]
            a = np.asarray(v)
            if mode == "shard":
                a = a[m]
            elif mode == "flat":
                n = a.shape[0] // n_model
                a = a[m * n: (m + 1) * n]
            out[key] = conv(a.reshape(logical) if logical else a)
    return out


def tree_to_jax(shards: List[Dict], layout: Dict) -> Dict:
    """The JAX package's whole pytree (numpy) from the M model ranks' trees
    (in model order; the replicated leaves are the first's)."""
    if not shards[0]:
        return {}
    out = {}
    for key, v in shards[0].items():
        if key in ("bot", "top"):
            out[key] = _towers(shards[0], _array)[key]
        elif key == "dense":
            out[key] = _towers(v, _array)
        elif v is None:
            out[key] = None
        else:
            mode, _, phys = layout[key]
            if mode == "rep":
                out[key] = _array(v).reshape(phys) if phys else _array(v)
            elif mode == "flat":
                out[key] = np.concatenate([_array(s[key]) for s in shards])
            else:
                out[key] = np.stack([_array(s[key]).reshape(phys) if phys else _array(s[key])
                                     for s in shards])
    return out


# ---------------------------------------------------------------------------
# the step: pieces shared with column sharding
# ---------------------------------------------------------------------------

def _take_tables(arr: torch.Tensor, ids: tuple, axis: int = 0) -> torch.Tensor:
    """A static table subset of ``arr`` along ``axis`` (``arr`` itself
    when the subset is every table in order)."""
    if ids == tuple(range(arr.shape[axis])):
        return arr
    return arr.index_select(axis, device_ints(ids, arr.device))


def local_batch(mesh: Mesh, b: Batch) -> Batch:
    """This rank's part of a global batch: its data shard's index block
    (replicated over "model") and its ``(d, m)`` slice of dense and labels;
    a stacked batch (labels ``[n, B, 1]``) is sliced the same way under its
    leading axis. numpy or tensors."""
    lead = (slice(None),) * (len(b.labels.shape) == 3)
    bd, bl, lo = batch_split(mesh, b.labels.shape[-2])
    blk = lead + (slice(None), slice(mesh.d * bd, (mesh.d + 1) * bd))
    return Batch(b.dense[lead + (slice(lo, lo + bl),)], b.indices[blk], b.weights[blk],
                 b.labels[lead + (slice(lo, lo + bl),)])


class _Rank:
    """A rank's static view of a row or column plan: the big and small
    table ids, the big tables' row offsets as a device vector, the
    canonical order as one."""

    def __init__(self, config: DLRMConfig, plan, mesh: Mesh):
        self.config, self.plan, self.mesh = config, plan, mesh
        dev = mesh.device
        self.offs = device_ints(plan.row_offsets, dev)
        self.small_ids = plan.small_group.table_ids if plan.small_group is not None else None
        self.perm = device_ints(tuple(int(p) for p in plan.canonical_perm), dev)
        self.cdt = DTYPES[config.compute_dtype]
        self.n_total = mesh.shape["data"] * mesh.shape["model"]

    def big_ids(self, b: Batch):
        """(global ids [Tb, Bd, L] of the big tables, their weights)."""
        idx = _take_tables(b.indices, self.plan.big_ids)
        return idx + self.offs[:, None, None].to(idx.dtype), _take_tables(b.weights,
                                                                           self.plan.big_ids)


@dataclasses.dataclass
class _Small:
    """The small tables' lookup on a rank's batch slice: pooled [Ts, bs,
    dim] and the data shard's whole ids / weights [Ts, Bd, L]."""

    pooled: torch.Tensor
    idx: torch.Tensor
    w: torch.Tensor


def _small_lookup(rk: _Rank, params: Dict, b: Batch, bs: int) -> Optional[_Small]:
    """The small tables' pooled values for this rank's post-exchange batch
    slice (``m * bs`` on), from the replicated small store."""
    if rk.small_ids is None:
        return None
    idx_s = _take_tables(b.indices, rk.small_ids)
    w_s = _take_tables(b.weights, rk.small_ids)
    lo = rk.mesh.m * bs
    pooled = lookup_group(params["emb_small"], rk.plan.small_group, idx_s[:, lo: lo + bs],
                          w_s[:, lo: lo + bs], vw=params.get("vw_small"))
    return _Small(pooled, idx_s, w_s)


def _tower_forward(rk: _Rank, dense: Dict, b: Batch, pooled: torch.Tensor,
                   bsz_global: int):
    """The shared dense towers on pooled [T, b, dim] (canonical order):
    (the local mean loss scaled to its share of ``bsz_global``, logits)."""
    c = rk.config
    ly = pooled.transpose(0, 1)  # [b, T, dim]
    d = c.base_dim
    if rk.plan.dim != d:
        ly = ly.reshape(ly.shape[0], -1, d)
    with phase_scope("bottom_mlp"):
        x = apply_mlp(b.dense, dense["bot"], c.sigmoid_bot, rk.cdt)
    with phase_scope("interaction"):
        z = interact_features(x, ly, c.interaction, c.interact_itself, rk.cdt,
                              impl=c.interaction_impl)
    with phase_scope("top_mlp"):
        logits = apply_mlp(z, dense["top"], c.sigmoid_top, rk.cdt, skip_last_activation=True)
    with phase_scope("loss_compute"):
        local = loss_fn(logits, b.labels, c.loss, c.loss_threshold, c.wbce_weights)
    return local * (b.labels.shape[0] / bsz_global), logits


def _assemble(rk: _Rank, pooled_big: torch.Tensor, small: Optional[torch.Tensor]):
    """concat(big, small) pooled, back in canonical table order."""
    if small is None:
        return pooled_big
    return torch.cat([pooled_big, small]).index_select(0, rk.perm)


def _dense_backward(rk: _Rank, params: Dict, b: Batch, pooled_big: torch.Tensor,
                    small: Optional[_Small]):
    """The towers' forward and backward with the pooled values as leaves:
    (the loss share, the dense grads in ``dense_leaves`` order, the big
    pooled cotangent, the small one or None)."""
    dense = [p.detach().requires_grad_() for p in dense_leaves(params)]
    leaves = [pooled_big.detach().requires_grad_()]
    if small is not None:
        leaves.append(small.pooled.detach().requires_grad_())
    with torch.enable_grad():
        pooled = _assemble(rk, leaves[0], leaves[1] if small is not None else None)
        share, _ = _tower_forward(rk, nest_dense(params, dense), b, pooled,
                                  b.labels.shape[0] * rk.n_total)
    with phase_scope("backward"):
        grads = torch.autograd.grad(share, dense + leaves)
    n = len(grads) - len(leaves)
    return (share.detach(), list(grads[:n]), grads[n],
            grads[n + 1] if small is not None else None)


def gather_model_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x [t, b, ...] gathered over "model" along the batch axis -> [t, M*b,
    ...] (JAX's tiled ``all_gather(x, "model", axis=1)``)."""
    if mesh.shape["model"] == 1:
        return x
    g = mesh.all_gather_model(x.unsqueeze(0))  # [M, t, b, ...]
    return g.transpose(0, 1).reshape((x.shape[0], -1) + tuple(x.shape[2:]))


def _update_small(rk: _Rank, opt: OptConfig, params: Dict, opt_state: Dict, idx_s, w_s,
                  g_s_full: torch.Tensor, lr) -> None:
    """The replicated small store's update, the same on every rank (its
    inputs gathered over the mesh): the exact dense accumulate of a
    ``size_class`` 0 group; a learned ``vw_small`` from the store before
    its update."""
    c, sg, mesh = rk.config, rk.plan.small_group, rk.mesh
    sgd = opt.name == "sgd"
    vws = params.get("vw_small")
    learned = vws is not None and c.weighted_pooling == "learned"
    if learned:
        vidx, vg = vw_row_grads(sg, params["emb_small"], idx_s, w_s, g_s_full)
    fidx, fg = flat_row_grads(sg, idx_s, w_s, g_s_full, vws)
    sparse_update(opt, params["emb_small"], None if sgd else opt_state["emb_small"],
                  mesh.all_gather_data(fidx), mesh.all_gather_data(fg), lr, sg.total_rows,
                  impl=c.sparse_update_impl, size_class=0, dim=sg.dim)
    if learned:
        sparse_update_1d(opt, vws, None if sgd else opt_state["vw_small"],
                         mesh.all_gather_data(vidx), mesh.all_gather_data(vg), lr,
                         sg.total_rows)


def _small_accum_inputs(rk: _Rank, batches: Batch, g_s: List[torch.Tensor]):
    """The micro axis folded into the batch axis for one coalesced small
    update: (ids [Ts, n*Bd, L], weights, cotangent [Ts, n*Bd, dim])."""
    def fold(x):  # [n, Ts, Bd, ...] -> [Ts, n*Bd, ...]
        return x.transpose(0, 1).reshape((x.shape[1], -1) + tuple(x.shape[3:]))

    return (fold(_take_tables(batches.indices, rk.small_ids, 1)),
            fold(_take_tables(batches.weights, rk.small_ids, 1)), fold(torch.stack(g_s)))


def _old_rows_taken(c: DLRMConfig, plan, store: torch.Tensor, l: int) -> bool:
    """Do the forward's gathered rows go to the update (the write-only
    route; ``row_sharded.py:699-711``)?"""
    return (l == 1 and not plan.dups_in_big and store.dtype == torch.float32
            and not c.exact_row_momentum and not c.stochastic_rounding
            and c.sparse_update_impl in ("pallas", "stream"))


# ---------------------------------------------------------------------------
# the row-sharded step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RowLookup:
    """One micro-batch's big-space lookup on a rank: the masked local ids
    [Tb, Bd, L] (``rows_local`` where the rank does not own a live
    occurrence), the effective weights (times ``vw``), the raw weights and
    the gathered rows [Tb, Bd, L, dim] f32."""

    local_ids: torch.Tensor
    w_eff: torch.Tensor
    w_b: torch.Tensor
    rows: torch.Tensor


def _partial_pooled(store: torch.Tensor, plan: RowShardPlan, gid, weights, vw, m: int):
    """The masked pooled sum over this shard's rows of the big space:
    (partial [Tb, Bd, dim], the lookup)."""
    local = gid - m * plan.rows_local
    owned = (local >= 0) & (local < plan.rows_local)
    w = torch.where(owned, weights, 0.0)
    safe = local.clamp(0, plan.rows_local - 1)  # sentinel rows never read
    t, b, l = gid.shape
    if vw is not None:
        w = w * vw.index_select(0, safe.reshape(-1)).reshape(t, b, l)
    rows = store.index_select(0, safe.reshape(-1)).float().reshape(t, b, l, plan.dim)
    if l == 1:
        pooled = rows[:, :, 0, :] * w[:, :, 0, None]
    else:
        pooled = (w[..., None] * rows).sum(dim=2)
    sent = torch.where(owned & (weights > 0), local, plan.rows_local)
    return pooled, _RowLookup(sent, w, weights, rows)


def _row_lookups(rk: _Rank, params: Dict, b: Batch):
    """(pooled_big [Tb, bs, dim] of this rank's batch slice, the small
    lookup or None, the big lookup)."""
    plan, mesh = rk.plan, rk.mesh
    gid, w_b = rk.big_ids(b)
    n_model = mesh.shape["model"]
    with torch.no_grad():
        with phase_scope("embedding_lookup"):
            partial, look = _partial_pooled(params["emb"], plan, gid, w_b, params.get("vw"),
                                            mesh.m)
        t, bd, dim = partial.shape
        bs = bd // n_model
        with phase_scope("reduce_scatter"):
            # batch chunk j to model rank j, summed over the model group
            pooled_big = mesh.reduce_scatter_model(
                partial.reshape(t, n_model, bs, dim).transpose(0, 1))
        with phase_scope("embedding_lookup"):
            small = _small_lookup(rk, params, b, bs)
    return pooled_big, small, look


def _row_forward_backward(rk: _Rank, params, b):
    pooled_big, small, look = _row_lookups(rk, params, b)
    share, grads, g_big, g_small = _dense_backward(rk, params, b, pooled_big, small)
    g_full = gather_model_batch(rk.mesh, g_big)
    g_s_full = gather_model_batch(rk.mesh, g_small) if small is not None else None
    return share, grads, (look, g_full, small, g_s_full)


def _row_vw_grads(plan: RowShardPlan, local_ids, w_b, rows, g_full):
    """d loss / d vw[row] = w * <g_pooled, store[row]> of each owned
    occurrence (``rows`` from the store before its update)."""
    dots = (rows * g_full[..., None, :]).sum(dim=-1)
    return (dots * torch.where(local_ids < plan.rows_local, w_b, 0.0)).reshape(-1)


def _row_big_update(rk: _Rank, opt: OptConfig, params: Dict, opt_state: Dict, flat_idx,
                    flat_g, lr, old_rows=None) -> None:
    c, plan, mesh = rk.config, rk.plan, rk.mesh
    sparse_update(opt, params["emb"], None if opt.name == "sgd" else opt_state["emb"],
                  mesh.all_gather_data(flat_idx), mesh.all_gather_data(flat_g), lr,
                  plan.rows_local, impl=c.sparse_update_impl,
                  exact_momentum=c.exact_row_momentum or plan.dups_in_big, dim=plan.dim,
                  old_rows=old_rows, density_hint=c.dup_density_hint)


def _vw_update(rk: _Rank, opt: OptConfig, params: Dict, opt_state: Dict, vidx, gv, lr,
               sentinel: int) -> None:
    """A learned ``vw``'s update from every data shard's occurrences."""
    mesh = rk.mesh
    sparse_update_1d(opt, params["vw"], None if opt.name == "sgd" else opt_state["vw"],
                     mesh.all_gather_data(vidx), mesh.all_gather_data(gv), lr, sentinel)


def _row_updates(rk: _Rank, opt: OptConfig, params, opt_state, b, piece, lr):
    """The sparse updates of one step (``row_sharded.py:668-766``)."""
    look, g_full, small, g_s_full = piece
    c, plan, mesh = rk.config, rk.plan, rk.mesh
    t, bd, l = look.local_ids.shape
    learned = params.get("vw") is not None and c.weighted_pooling == "learned"
    gv = _row_vw_grads(plan, look.local_ids, look.w_b, look.rows, g_full) if learned else None
    flat_g = (look.w_eff[..., None] * g_full[:, :, None, :]).reshape(-1, plan.dim)
    old = None
    if _old_rows_taken(c, plan, params["emb"], l):
        # the rows the lookup gathered, over "data": the write-only update
        old = mesh.all_gather_data(look.rows[:, :, 0, :].reshape(t * bd, -1))
    _row_big_update(rk, opt, params, opt_state, look.local_ids.reshape(-1), flat_g, lr, old)
    if small is not None:
        _update_small(rk, opt, params, opt_state, small.idx, small.w, g_s_full, lr)
    if learned:
        _vw_update(rk, opt, params, opt_state, look.local_ids.reshape(-1), gv, lr,
                   plan.rows_local)


def _row_accum_updates(rk: _Rank, opt: OptConfig, params, opt_state, batches, pieces, lr):
    """The accumulation step's sparse updates: every micro-batch's row
    grads in one coalesced update a store, learned ``vw`` grads from the
    stores before their update (``row_sharded.py:887-1009``)."""
    c, plan = rk.config, rk.plan
    ids = torch.stack([p[0].local_ids for p in pieces])  # [n, Tb, Bd, L]
    g_full = torch.stack([p[1] for p in pieces])  # [n, Tb, Bd, dim]
    w_big = _take_tables(batches.weights, plan.big_ids, 1)
    owned = ids < plan.rows_local
    safe = ids.clamp(0, plan.rows_local - 1)
    vw = params.get("vw")
    wt = torch.where(owned, w_big, 0.0)
    if vw is not None:
        wt = wt * vw.index_select(0, safe.reshape(-1)).reshape(safe.shape)
    learned = vw is not None and c.weighted_pooling == "learned"
    gv = None
    if learned:
        rows = params["emb"].index_select(0, safe.reshape(-1)).float().reshape(
            *safe.shape, plan.dim)
        gv = _row_vw_grads(plan, ids, w_big, rows, g_full)
    flat_g = (wt[..., None] * g_full[:, :, :, None, :]).reshape(-1, plan.dim)
    _row_big_update(rk, opt, params, opt_state, ids.reshape(-1), flat_g, lr)
    if rk.small_ids is not None:
        _update_small(rk, opt, params, opt_state,
                      *_small_accum_inputs(rk, batches, [p[3] for p in pieces]), lr)
    if learned:
        _vw_update(rk, opt, params, opt_state, ids.reshape(-1), gv, lr, plan.rows_local)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class ShardedRunner(Runner):
    """What the row and column runners share beyond the runner base: the
    batch split, the trees in the JAX package's layouts, the tables and
    the bodies. A subclass names its mode's plan, init, layouts, extraction
    and step pieces (``lookups``, ``forward_backward``, ``updates``,
    ``accum_updates``; each takes the rank's ``_Rank`` first)."""

    init_opt_state = staticmethod(init_sharded_opt_state)

    def make_bodies(self):
        rk = _Rank(self.config, self.plan, self.mesh)
        fb = functools.partial(self.forward_backward, rk)

        def logits(params, b):
            pooled, small, _ = self.lookups(rk, params, b)
            pooled = _assemble(rk, pooled, small.pooled if small is not None else None)
            return _tower_forward(rk, params, b, pooled, b.labels.shape[0])[1]

        return (mesh_train_body(self.mesh, self.opt, fb,
                                functools.partial(self.updates, rk, self.opt)),
                mesh_accum_body(self.mesh, self.opt, self.n_accum, fb,
                                functools.partial(self.accum_updates, rk, self.opt)),
                mesh_eval_body(self.mesh, self.config, logits))

    def prepare_batch(self, b: Batch) -> Batch:
        return local_batch(self.mesh, b)

    def reshard(self, params, opt_state):
        """This rank's tensors from the JAX package's whole pytrees as numpy
        (e.g. a loaded checkpoint)."""
        n, m, dev = self.mesh.shape["model"], self.mesh.m, self.device
        layout = self.layouts(self.plan, self.opt)
        return (tree_from_jax(params, layout["params"], n, m, dev),
                tree_from_jax(opt_state, layout["opt_state"], n, m, dev))

    def _to_jax(self, shards: List[Dict], states: List[Dict]):
        layout = self.layouts(self.plan, self.opt)
        return tree_to_jax(shards, layout["params"]), tree_to_jax(states, layout["opt_state"])

    def tables(self, params: Dict) -> List[torch.Tensor]:
        """Every table's weights in canonical order, on every rank, from the
        model group's shards (``extract_*_sharded_tables``; a collective)."""
        return self.extract_tables(self.plan, self.mesh.all_gather_model(
            params["emb"].unsqueeze(0)), params.get("emb_small"))


def row_layouts(plan: RowShardPlan, opt: OptConfig) -> Dict:
    return _layouts(plan, opt, (plan.store_rows, plan.dim), plan.store_shape, "shard")


class RowShardedRunner(ShardedRunner):
    """The runner of the row-sharded path (--shard-mode row)."""

    sharded_keys = ("emb", "vw")
    make_plan = staticmethod(make_row_plan)
    init_params = staticmethod(init_row_sharded_params)
    layouts = staticmethod(row_layouts)
    extract_tables = staticmethod(extract_row_sharded_tables)
    lookups = staticmethod(_row_lookups)
    forward_backward = staticmethod(_row_forward_backward)
    updates = staticmethod(_row_updates)
    accum_updates = staticmethod(_row_accum_updates)
