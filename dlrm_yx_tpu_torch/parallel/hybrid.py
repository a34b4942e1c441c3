"""Hybrid-parallel DLRM training over a ("data", "model") mesh of ranks.

The port of ``dlrm_yx_tpu/parallel/hybrid.py``, the reference's
``distributed_forward`` (``dlrm_s_pytorch.py:686-730``): each rank holds
whole tables, looks them up for its data shard's batch, exchanges the pooled
vectors with an all-to-all that overlaps the bottom MLP, and runs the
interaction and top MLP on its slice of the batch; dense grads are summed
over the world (DDP's allreduce) and the row grads are applied locally. One
process per device, over ``torch.distributed`` (``parallel/mesh.py``):

  * tables sharded over "model" as two stores a rank, big tables in
    ``[r_big_pad, dim]`` (the row-touching kernels: K2, K4, or K5 / K6 on
    the sorted stream) and small ones in ``[r_small_pad, dim]`` (the exact
    dense accumulate, K3 under RWSAdagrad), placed by ``parallel/plan.py``;
  * the batch sharded over "data" for the lookups and over ("data",
    "model") for the towers (``prepare_batch``: every rank gets the same
    global host batch and keeps its part);
  * JAX's ``all_to_all(pooled, "model", split_axis=1, concat_axis=0,
    tiled=True)`` is ``all_to_all_single`` over the model group on
    ``pooled`` laid out ``[M, t_pad, b/M, dim]`` (batch chunk j to model
    rank j); what comes back, ``[M * t_pad, b/M, dim]``, is JAX's concat
    by source. It is issued asynchronously before the bottom MLP and
    waited on after it (the reference's Req/Wait pair,
    extend_distributed.py:405-508). Its transpose, which ``jax.vjp`` gives
    JAX, is an explicit reverse ``all_to_all_single`` of the exchanged
    activations' gradient;
  * ``psum`` over both axes is one ``all_reduce`` (sum) over the world of
    the loss share (``local mean * b_local / B_global``) and the dense
    grads; the row grads (and the stream route's factors and the looked-up
    rows) are all-gathered over "data" only.

The embedding variants run inside the step as in the JAX package: QR
'mult' / 'add' tables keep their quotient store sharded and their remainder
stores in one replicated ``qr_r`` store (combined per sample before
pooling; its dense gradient summed over the world), QR 'concat' tables
become two plain pseudo-tables with an index transform; mixed-dimension
tables are zero-padded to the slot dim and up-projected by ``md_proj``
after the exchange; k*D mixes are sliced back after it; RWSAdagrad's row
momentum of a zero-padded table divides by its true dim (``row_dim``);
pooling weights ``vw`` / ``vw_small`` scale the lookups, and learned ones
train through ``sparse_update_1d``.

The updates go through the port's ``optim.sparse_update`` and
``sparse_update_stream`` with the JAX package's routing gates.
``HybridRunner`` supplies the mode's bodies to the runner base
(``parallel/runner.py``), whose steps run, on the card over NCCL, as
replays of CUDA graphs, collectives included; gloo's collectives cannot be
captured, so on the CPU (and over gloo on the card) the same bodies run
eagerly. Checkpoints keep the JAX package's hybrid npz layout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import (
    _INIT_CHUNK_ROWS,
    DTYPES,
    _dense_params,
    dense_leaves,
    nest_dense,
    qr_specs,
)
from dlrm_yx_tpu_torch.ops.embedding import device_ints, dim_pack
from dlrm_yx_tpu_torch.ops.interaction import interact_features
from dlrm_yx_tpu_torch.ops.losses import loss_fn
from dlrm_yx_tpu_torch.ops.md_embedding import init_md_projection
from dlrm_yx_tpu_torch.ops.mlp import apply_mlp
from dlrm_yx_tpu_torch.ops.qr_embedding import init_qr
from dlrm_yx_tpu_torch.optim.optimizer import (
    DENSE_ACCUM_FACTOR,
    OptConfig,
    finish_dense,
    init_dense_state,
    sparse_update,
    sparse_update_1d,
    sparse_update_stream,
    store_state,
    stream_eligible,
)
from dlrm_yx_tpu_torch.parallel.mesh import Mesh, batch_split
from dlrm_yx_tpu_torch.parallel.plan import (
    ShardingPlan,
    arrange_sparse_inputs,
    build_sharded_emb,
    extract_tables,
    make_plan,
)
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


@dataclasses.dataclass(frozen=True)
class _StreamGroupShim:
    """A TableGroup stand-in for sparse_update_stream on the big store (it
    reads dim / pack / total_rows / size_class)."""

    dim: int
    pack: int
    total_rows: int
    size_class: int = 1


# ---------------------------------------------------------------------------
# parameter / batch placement
# ---------------------------------------------------------------------------

def _slot_places(plan: ShardingPlan, model_index: int):
    """(section, row offset) of each pseudo-table on shard ``model_index``."""
    places = {}
    for pos, pid in enumerate(plan.device_table_order):
        if pid >= 0 and pos // plan.t_pad == model_index:
            places[pid] = ("big" if pos % plan.t_pad < plan.n_big_slots else "small",
                           plan.row_offsets[pos])
    return places


def init_hybrid_params(config: DLRMConfig, plan: ShardingPlan, seed: int = 123,
                       model_index: int = 0,
                       device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The same draws as ``init_dlrm`` (and as the JAX package's
    ``init_hybrid_params``: one RandomState, every table in canonical order,
    a QR table its quotient then its remainder table, then the MD
    projections, then the bottom and top MLPs), with shard ``model_index``'s
    (pseudo-)tables laid into its ``[r_big_pad, dim]`` and ``[r_small_pad,
    dim]`` f32 stores (the JAX package's hybrid stores are f32 whatever
    ``emb_dtype``), the QR remainder tables of 'mult' / 'add' into the
    replicated ``qr_r`` and, with weighted pooling, ``vw`` / ``vw_small``
    ones on the live rows. Every table is drawn, so that the draws after it
    follow; only this shard's are kept."""
    if config.qr_table_ids and config.weighted_pooling == "learned":
        # a learned per-row weight of a QR slot would train at quotient-row
        # granularity, which the reference does not define
        raise NotImplementedError("learned weighted pooling with QR tables")
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    stores = {"big": torch.zeros((plan.r_big_pad, plan.dim), dtype=torch.float32, device=dev),
              "small": torch.zeros((plan.r_small_pad, plan.dim), dtype=torch.float32,
                                   device=dev)}
    places = _slot_places(plan, model_index)
    pids = {}
    for pid, t in enumerate(plan.pseudo_table):
        pids.setdefault(t, []).append(pid)
    concat = any(plan.pseudo_xform)
    roff = {t: plan.slot_roff[pos] for pos, t in enumerate(plan.device_table_order)
            if t >= 0 and plan.slot_coll[pos]}
    qr_r = (torch.zeros((plan.qr_r_rows, plan.dim), dtype=torch.float32, device=dev)
            if plan.qr_r_rows else None)
    specs = {s.table_id: s for s in qr_specs(config)}

    def place(pid, rows, r0=0):
        section, off = places.get(pid, (None, 0))
        if section is not None:
            stores[section][off + r0: off + r0 + rows.shape[0], :rows.shape[1]] = \
                torch.from_numpy(rows)

    for t, (n, d) in enumerate(zip(config.emb_rows, config.emb_dims)):
        if t in specs:
            q, r = init_qr(rng, specs[t])
            place(pids[t][0], q)
            if concat:
                place(pids[t][1], r)  # the remainder is its own pseudo-table
            else:
                qr_r[roff[t]: roff[t] + r.shape[0]] = torch.from_numpy(r)
            continue
        bound = np.sqrt(1.0 / n)
        for r0 in range(0, n, _INIT_CHUNK_ROWS):
            r1 = min(n, r0 + _INIT_CHUNK_ROWS)
            place(pids[t][0], rng.uniform(-bound, bound, size=(r1 - r0, d)).astype(np.float32),
                  r0)
    md_proj = [torch.from_numpy(init_md_projection(rng, config.emb_dims[t],
                                                   config.base_dim)).to(dev)
               for t in config.md_table_ids]
    params = {**_dense_params(rng, config, dev), "emb": stores["big"],
              "emb_small": stores["small"], "vw": None}
    if config.weighted_pooling is not None:
        # v_W = ones per real row (dlrm_s_pytorch.py:313-316), zero padding
        vw = {"big": torch.zeros(plan.r_big_pad, dtype=torch.float32, device=dev),
              "small": torch.zeros(plan.r_small_pad, dtype=torch.float32, device=dev)}
        for pid, (section, off) in places.items():
            vw[section][off: off + plan.pseudo_rows[pid]] = 1.0
        params["vw"], params["vw_small"] = vw["big"], vw["small"]
    if qr_r is not None:
        params["qr_r"] = qr_r
    if md_proj:
        params["md_proj"] = md_proj
    return params


def params_from_single_device(config: DLRMConfig, plan: ShardingPlan, params: Dict,
                              model_index: int = 0) -> Dict:
    """Shard ``model_index``'s hybrid params from the single-device params of
    ``models.dlrm`` (plain tables: its group stores, on their device): the
    tables laid out by the plan (``build_sharded_emb`` on the stores' rows),
    the MLPs copied. The two runs then start from the same state."""
    big, small = build_sharded_emb(plan, config, single_device_tables(config, params),
                                   model_index)
    return {**dense_copy(params), "emb": big, "emb_small": small, "vw": None}


def init_hybrid_opt_state(opt: OptConfig, params: Dict, plan: ShardingPlan) -> Dict:
    """Zeros as the JAX package's ``init_hybrid_opt_state`` gives them, a
    rank's part: SGD none; Adagrad per element; RWSAdagrad one momentum a
    logical row, a flat ``acc_len``-long vector a store (and one a row of
    ``qr_r``); per-entry sums for ``vw`` / ``vw_small`` and ``md_proj``."""
    if opt.name == "sgd":
        return {}
    state = {**init_dense_state(params), "emb": store_state(opt, params["emb"], plan.r_big_pad),
             "emb_small": store_state(opt, params["emb_small"], plan.r_small_pad)}
    if params.get("vw") is not None:
        state["vw"] = torch.zeros_like(params["vw"])
        state["vw_small"] = torch.zeros_like(params["vw_small"])
    if "qr_r" in params:
        state["qr_r"] = store_state(opt, params["qr_r"])
    return state


def _local_batch(plan: ShardingPlan, mesh: Mesh, b: Batch) -> Batch:
    """This rank's part of a global batch: its model index's slots of
    ``arrange_sparse_inputs`` over its data shard's batch, and its
    ``(d, m)`` slice of dense and labels for the towers."""
    bd, bl, lo = batch_split(mesh, b.labels.shape[0])
    ai, aw = arrange_sparse_inputs(plan, b.indices[:, mesh.d * bd:(mesh.d + 1) * bd],
                                   b.weights[:, mesh.d * bd:(mesh.d + 1) * bd])
    s0 = mesh.m * plan.t_pad
    return Batch(b.dense[lo: lo + bl], ai[s0: s0 + plan.t_pad], aw[s0: s0 + plan.t_pad],
                 b.labels[lo: lo + bl])


def prepare_batch(plan: ShardingPlan, mesh: Mesh, b: Batch) -> Batch:
    """``_local_batch`` of a batch, or of each batch of a stack (labels
    ``[n, B, 1]``: the multi-step dispatch and the accumulation step),
    stacked again; numpy or tensors."""
    if len(b.labels.shape) != 3:
        return _local_batch(plan, mesh, b)
    parts = [_local_batch(plan, mesh, Batch(*(f[i] for f in b)))
             for i in range(b.labels.shape[0])]
    stack = torch.stack if isinstance(b.labels, torch.Tensor) else np.stack
    return Batch(*(stack([getattr(p, f) for p in parts]) for f in Batch._fields))


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def _row_dim_tables(config: DLRMConfig, plan: ShardingPlan):
    """Per-(shard, store-section) true embedding dims for RWSAdagrad's row
    momentum with zero-padded columns (MD or k*D mixes): (big, small) f32
    arrays [n_model, r_{big,small}_pad] (``hybrid.py:400-424``)."""
    nb = plan.n_big_slots
    big = np.full((plan.n_model, plan.r_big_pad), float(plan.dim), np.float32)
    small = np.full((plan.n_model, plan.r_small_pad), float(plan.dim), np.float32)
    for pos, pid in enumerate(plan.device_table_order):
        if pid < 0:
            continue
        dst = big if pos % plan.t_pad < nb else small
        off = plan.row_offsets[pos]
        dst[pos // plan.t_pad, off: off + plan.pseudo_rows[pid]] = float(
            config.emb_dims[plan.pseudo_table[pid]])
    return big, small


class _Rank:
    """A rank's static view of the plan (JAX's ``axis_index("model")``
    picks of ``offs_all``, ``coll_all``, ``roff_all``, ``xform_all``): per
    section its slots' row offsets, QR collisions and remainder offsets and
    'concat' index transforms as device vectors, the canonical gather, and
    its rows' true dims for RWSAdagrad where tables are zero-padded."""

    def __init__(self, config: DLRMConfig, plan: ShardingPlan, mesh: Mesh, opt=None):
        self.config, self.plan, self.mesh = config, plan, mesh
        dev = mesh.device
        self.nb = plan.n_big_slots
        self.ns = plan.t_pad - plan.n_big_slots
        lo, hi = mesh.m * plan.t_pad, (mesh.m + 1) * plan.t_pad
        self.has_qr = plan.qr_r_rows > 0
        self.has_xf = any(plan.pseudo_xform)
        xform = [plan.pseudo_xform[pid] if pid >= 0 else 0
                 for pid in plan.device_table_order[lo:hi]]

        def sections(values):
            v = tuple(values)
            return device_ints(v[:self.nb], dev), device_ints(v[self.nb:], dev)

        self.offs = sections(plan.row_offsets[lo:hi])
        self.coll = sections(plan.slot_coll[lo:hi]) if self.has_qr else (None, None)
        self.roff = sections(plan.slot_roff[lo:hi]) if self.has_qr else (None, None)
        self.xform = sections(xform) if self.has_xf else (None, None)
        self.gather = device_ints(tuple(plan.canonical_gather), dev)
        self.cdt = DTYPES[config.compute_dtype]
        self.row_dim = (None, None)
        if opt is not None and opt.name == "rwsadagrad" and (
                config.md_table_ids or len(set(config.emb_dims)) > 1):
            big, small = _row_dim_tables(config, plan)
            self.row_dim = (torch.from_numpy(big[mesh.m]).to(dev),
                            torch.from_numpy(small[mesh.m]).to(dev))
        # the JAX package packs a plain plan's sub-128 dims (plan.pack); the
        # port's update routing reads that layout from the dim
        self.packed = plan.pack == dim_pack(plan.dim)

    def sections(self):
        """(section index, slot range, store key, rows, vw key) of each
        section present."""
        out = []
        if self.nb:
            out.append((0, slice(0, self.nb), "emb", self.plan.r_big_pad, "vw"))
        if self.ns:
            out.append((1, slice(self.nb, self.plan.t_pad), "emb_small",
                        self.plan.r_small_pad, "vw_small"))
        return out


@dataclasses.dataclass
class _Lookup:
    """One section's lookup: pooled [t, b, dim] f32, global ids [t, b, L],
    quotient rows [t, b, L, dim] f32, the effective weights [t, b, L] (times
    v_W), and for QR 'mult' / 'add' the remainder ids and rows and the slots'
    QR mask."""

    pooled: torch.Tensor
    gidx: torch.Tensor
    rows: torch.Tensor
    w_eff: torch.Tensor
    ridx: Optional[torch.Tensor] = None
    r_rows: Optional[torch.Tensor] = None
    is_qr: Optional[torch.Tensor] = None


def _qr_index(rk: _Rank, si: int, indices: torch.Tensor):
    """The quotient-store index of a section's slots (``_local_lookup``'s
    transforms): 'concat' pseudo-slots take idx // c or idx % c, 'mult' /
    'add' QR slots idx // c."""
    c = rk.config.qr_collisions
    if rk.has_xf:
        xf = rk.xform[si][:, None, None]
        return torch.where(xf == 1, indices // c, torch.where(xf == 2, indices % c, indices))
    if rk.has_qr:
        coll = rk.coll[si][:, None, None]
        return torch.where(coll > 0, indices // coll.clamp(min=1), indices)
    return indices


def _lookup(rk: _Rank, si: int, params: Dict, indices, weights, key, rows, vw_key):
    """Per-section pooled lookup on a rank's store: indices / weights
    [t, b, L] (padding slots point at ``rows``: clamped gather, zero
    weight); QR slots combine the quotient row with the replicated
    remainder row per sample before pooling (QREmbeddingBag semantics)."""
    t, b, l = indices.shape
    gidx = _qr_index(rk, si, indices) + rk.offs[si][:, None, None]
    safe = gidx.clamp(max=rows - 1)
    vw = params.get(vw_key) if params.get("vw") is not None else None
    if vw is not None:
        # per-row pooling weights v_W (dlrm_s_pytorch.py:545-548); padding
        # rows carry vw = 0
        weights = weights * vw.index_select(0, safe.reshape(-1)).reshape(t, b, l)
    q_rows = params[key].index_select(0, safe.reshape(-1)).float().reshape(t, b, l, -1)
    out = _Lookup(None, gidx, q_rows, weights)
    emb = q_rows
    if rk.has_qr:
        coll = rk.coll[si][:, None, None]
        out.ridx = (torch.where(coll > 0, indices % coll.clamp(min=1), 0)
                    + rk.roff[si][:, None, None])
        out.r_rows = params["qr_r"].index_select(0, out.ridx.reshape(-1)).reshape(
            t, b, l, -1)
        out.is_qr = (rk.coll[si] > 0)[:, None, None, None]
        combined = (q_rows * out.r_rows if rk.config.qr_operation == "mult"
                    else q_rows + out.r_rows)
        emb = torch.where(out.is_qr, combined, q_rows)
    if l == 1:
        out.pooled = emb[:, :, 0, :] * weights[:, :, 0, None]
    else:
        out.pooled = (weights[..., None] * emb).sum(dim=2)
    return out


def _lookups(rk: _Rank, params: Dict, b: Batch):
    """Every section's lookup: (pooled [t_pad, b, dim], [_Lookup per
    section present])."""
    parts = []
    with torch.no_grad(), phase_scope("embedding_lookup"):
        for si, sl, key, rows, vw_key in rk.sections():
            parts.append(_lookup(rk, si, params, b.indices[sl], b.weights[sl], key, rows,
                                 vw_key))
    pooled = parts[0].pooled if len(parts) == 1 else torch.cat([p.pooled for p in parts])
    return pooled, parts


def _exchange(mesh: Mesh, pooled: torch.Tensor):
    """Issue the pooled all-to-all: [t_pad, b, dim] laid out as [M, t_pad,
    b/M, dim] (batch chunk j to model rank j). Returns (the receive buffer
    [M * t_pad, b/M, dim], the work handle or None)."""
    n_model = mesh.shape["model"]
    t, b, dim = pooled.shape
    send = pooled.reshape(t, n_model, b // n_model, dim).transpose(0, 1).reshape(
        n_model * t, b // n_model, dim)
    recv = torch.empty_like(send)
    with phase_scope("alltoall_fwd"):
        work = mesh.all_to_all_model(recv, send, async_op=True)
    return recv, work


def _exchange_back(mesh: Mesh, g_ex: torch.Tensor, t_pad: int) -> torch.Tensor:
    """The exchange's transpose: the gradient of the received [M * t_pad,
    b/M, dim] back to the pooled [t_pad, b, dim] it came from."""
    n_model = mesh.shape["model"]
    _, bq, dim = g_ex.shape
    recv = torch.empty_like(g_ex)
    with phase_scope("alltoall_bwd"):
        mesh.all_to_all_model(recv, g_ex.contiguous())
    return recv.reshape(n_model, t_pad, bq, dim).transpose(0, 1).reshape(
        t_pad, n_model * bq, dim)


def _slots_from_canonical(ly_can: torch.Tensor, config: DLRMConfig,
                          md_proj=None) -> torch.Tensor:
    """[T, b, dim] canonical pooled -> [b, S, D] interaction slots: the
    split trick for dim = k*D, k*D mixes sliced back to each table's dim,
    MD tables sliced to d_t and up-projected (PrEmbeddingBag's Linear,
    after the exchange). With QR 'concat' the leading axis is canonical
    slots."""
    t, b, dim = ly_can.shape
    d = config.base_dim
    if config.md_table_ids:
        md = {tid: i for i, tid in enumerate(config.md_table_ids)}
        slots = [ly_can[tid][:, :config.emb_dims[tid]] @ md_proj[md[tid]] if tid in md
                 else ly_can[tid] for tid in range(t)]
        return torch.stack(slots, dim=1)
    if t == len(config.emb_dims) and len(set(config.emb_dims)) > 1:
        slots = [ly_can[tid, :, :dt].reshape(b, dt // d, d).transpose(0, 1)
                 for tid, dt in enumerate(config.emb_dims)]
        return torch.cat(slots, dim=0).transpose(0, 1)
    k = dim // d
    if k == 1:
        return ly_can.transpose(0, 1)
    return ly_can.reshape(t, b, k, d).permute(1, 0, 2, 3).reshape(b, t * k, d)


def _bottom_and_exchange(rk: _Rank, dense: Dict, b: Batch, pooled: torch.Tensor):
    """The bottom MLP between the exchange's issue and its wait; returns
    (x, the exchanged pooled [M * t_pad, b/M, dim])."""
    recv, work = _exchange(rk.mesh, pooled)
    with phase_scope("bottom_mlp"):
        x = apply_mlp(b.dense, dense["bot"], rk.config.sigmoid_bot, rk.cdt)
    with phase_scope("alltoall_wait"):
        if work is not None:
            work.wait()
    return x, recv


def _top(rk: _Rank, dense: Dict, x: torch.Tensor, ly_ex: torch.Tensor) -> torch.Tensor:
    """The interaction and the top MLP on the canonical exchanged pooled ->
    logits."""
    c = rk.config
    ly = _slots_from_canonical(ly_ex.index_select(0, rk.gather), c, dense.get("md_proj"))
    with phase_scope("interaction"):
        z = interact_features(x, ly, c.interaction, c.interact_itself, rk.cdt,
                              impl=c.interaction_impl)
    with phase_scope("top_mlp"):
        return apply_mlp(z, dense["top"], c.sigmoid_top, rk.cdt, skip_last_activation=True)


def _forward_backward(rk: _Rank, params: Dict, b: Batch):
    """One micro-batch: lookups, exchange, dense forward and backward.
    Returns (this rank's loss share, its dense grads in ``dense_leaves``
    order, (the pooled cotangent [t_pad, b, dim], the sections'
    lookups))."""
    pooled, parts = _lookups(rk, params, b)
    leaves = [p.detach().requires_grad_() for p in dense_leaves(params)]
    dense = nest_dense(params, leaves)
    c = rk.config
    with torch.enable_grad():
        x, ly_ex = _bottom_and_exchange(rk, dense, b, pooled)
        ly_ex.requires_grad_()
        logits = _top(rk, dense, x, ly_ex)
        with phase_scope("loss_compute"):
            local = loss_fn(logits, b.labels, c.loss, c.loss_threshold, c.wbce_weights)
            # local mean * local count / global count = the global mean's share
            b_local = b.labels.shape[0]
            share = local * (b_local / (b_local * rk.mesh.shape["data"] * rk.mesh.shape["model"]))
    with phase_scope("backward"):
        grads = torch.autograd.grad(share, leaves + [ly_ex])
    g_pooled = _exchange_back(rk.mesh, grads[-1], rk.plan.t_pad)
    return share.detach(), list(grads[:-1]), (g_pooled, parts)


def _gather_batch_axis(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x [t, b, ...] gathered over "data" along the batch axis -> [t, D*b, ...]."""
    g = mesh.all_gather_data(x.unsqueeze(0))  # [D, t, b, ...]
    return g.transpose(0, 1).reshape((x.shape[0], -1) + tuple(x.shape[2:]))


def _update_qr_r(rk: _Rank, opt: OptConfig, params: Dict, opt_state: Dict, ridx, gr, lr):
    """The replicated remainder store's update from every rank's row grads:
    their dense sum over the world (``psum``), then SGD / Adagrad /
    RWSAdagrad on the whole store."""
    plan = rk.plan
    dense_gr = torch.zeros((plan.qr_r_rows, plan.dim), dtype=torch.float32,
                           device=rk.mesh.device)
    dense_gr.index_add_(0, ridx.reshape(-1), gr.reshape(-1, plan.dim))
    rk.mesh.all_reduce(dense_gr)
    qr_r = params["qr_r"]
    if opt.name == "sgd":
        qr_r.sub_(lr * dense_gr)
        return
    acc = opt_state["qr_r"]
    if opt.name == "adagrad":
        acc.add_(dense_gr * dense_gr)
        qr_r.sub_(lr * dense_gr / (acc.sqrt() + opt.eps))
    else:
        acc.add_((dense_gr * dense_gr).mean(dim=-1))
        qr_r.sub_(lr * dense_gr / (acc.sqrt() + opt.eps)[:, None])


def _update_vw(rk: _Rank, opt, params, opt_state, vw_key, rows, gidx, gv, lr):
    """A learned ``vw`` section's update: d loss / d vw[row] += base_w *
    <g_pooled, store[row]> over every occurrence, gathered over "data"."""
    vidx = torch.where(gidx.reshape(-1) < rows, gidx.clamp(max=rows - 1).reshape(-1), rows)
    vidx = rk.mesh.all_gather_data(vidx)
    gv = rk.mesh.all_gather_data(gv.reshape(-1))
    sparse_update_1d(opt, params[vw_key], opt_state[vw_key] if opt.name != "sgd" else None,
                     vidx, gv, lr, rows)


def _sparse_updates(rk: _Rank, opt: OptConfig, params: Dict, opt_state: Dict, b: Batch,
                    parts, g_pooled: torch.Tensor, lr) -> None:
    """The row updates of both stores (and ``qr_r``, and a learned ``vw``)
    from one step's pooled cotangent, with the JAX package's routes
    (``hybrid.py:1081-1316``)."""
    c, plan, mesh = rk.config, rk.plan, rk.mesh
    t, bd, l = b.indices.shape
    sgd = opt.name == "sgd"
    w_eff = parts[0].w_eff if len(parts) == 1 else torch.cat([p.w_eff for p in parts])
    w_g = w_eff[..., None] * g_pooled[:, :, None, :]  # [t, bd, l, dim]
    if rk.has_qr:
        # the chain rule through the per-sample combine: d/dQ (Q*R) = R,
        # d/dQ (Q+R) = 1 (qr_embedding.qr_row_grads)
        cat = (lambda f: f(parts[0])) if len(parts) == 1 else (
            lambda f: torch.cat([f(p) for p in parts]))
        is_qr, q_rows = cat(lambda p: p.is_qr), cat(lambda p: p.rows)
        if c.qr_operation == "mult":
            gr = torch.where(is_qr, w_g * q_rows, 0.0)
            w_g = w_g * torch.where(is_qr, cat(lambda p: p.r_rows), 1.0)
        else:
            gr = torch.where(is_qr, w_g, 0.0)
        _update_qr_r(rk, opt, params, opt_state, cat(lambda p: p.ridx), gr, lr)
    learned = params.get("vw") is not None and c.weighted_pooling == "learned"
    gv_all = None
    if learned:
        # from the stores before their update
        gv_all = torch.cat([(p.rows * g_pooled[sl, :, None, :]).sum(dim=-1)
                            for p, (_, sl, *_r) in zip(parts, rk.sections())]) * b.weights

    shim = _StreamGroupShim(plan.dim, plan.pack, plan.r_big_pad)
    # the sections' dense-branch K3 finishes, in one launch after both
    # updates: nothing in between reads the two stores, which are disjoint
    dense = []
    for p, (si, sl, key, rows, vw_key) in zip(parts, rk.sections()):
        acc = None if sgd else opt_state[key]
        if si == 0 and (
            (c.sparse_update_impl == "stream"
             # pallas + SGD routes its dense regime through the sorted
             # stream too, as the single-device router does
             or (c.sparse_update_impl == "pallas" and sgd))
            and stream_eligible(opt, params[key], shim)
            and not rk.has_qr
            and not c.exact_row_momentum
            and not c.stochastic_rounding
            # the dense regime: K over all data shards vs the shard's physical rows
            and rk.nb * bd * l * mesh.shape["data"] * DENSE_ACCUM_FACTOR
            >= plan.r_big_pad // plan.pack
        ):
            # the factored exchange: row ids, weights and the pooled cotangent
            # over "data" instead of [K, dim] row grads (about L times less)
            sparse_update_stream(
                opt, params[key], acc, shim, _gather_batch_axis(mesh, p.gidx),
                _gather_batch_axis(mesh, p.w_eff.float()),
                _gather_batch_axis(mesh, g_pooled[sl].float()), lr, row_dim=rk.row_dim[0])
        else:
            idx_f = mesh.all_gather_data(p.gidx.reshape(-1))
            g_f = mesh.all_gather_data(w_g[sl].reshape(-1, plan.dim))
            kw = dict(size_class=0)
            if si == 0:
                old = None
                if (l == 1 and params[key].dtype == torch.float32
                        and not c.exact_row_momentum and not c.stochastic_rounding
                        and c.sparse_update_impl in ("pallas", "stream")):
                    # the write-only update: the rows the lookup gathered,
                    # over "data"
                    old = mesh.all_gather_data(p.rows[:, :, 0, :].reshape(-1, plan.dim))
                kw = dict(exact_momentum=c.exact_row_momentum, old_rows=old,
                          density_hint=c.dup_density_hint)
            # small tables: the exact dense accumulate over the small store
            sparse_update(opt, params[key], acc, idx_f, g_f, lr, rows,
                          impl=c.sparse_update_impl, dim=plan.dim, packed=rk.packed,
                          row_dim=rk.row_dim[si], finish=dense, **kw)
        if learned:
            _update_vw(rk, opt, params, opt_state, vw_key, rows, p.gidx, gv_all[sl], lr)
    finish_dense(dense, lr, opt.eps)


def _accum_updates(rk: _Rank, opt: OptConfig, params: Dict, opt_state: Dict, batches: Batch,
                   gidx_stk, g_stk: torch.Tensor, lr) -> None:
    """The accumulation step's sparse updates: one coalesced update a store
    section over every micro-batch's row grads, the QR chain-rule pieces and
    learned ``vw`` grads recomputed from the stores as they were through the
    window (``hybrid.py:615-834``)."""
    c, plan, mesh = rk.config, rk.plan, rk.mesh
    sgd = opt.name == "sgd"
    learned = params.get("vw") is not None and c.weighted_pooling == "learned"
    qr_parts = []
    dense = []  # one K3 launch after both sections, as in _sparse_updates
    for si, sl, key, rows, vw_key in rk.sections():
        gidx = gidx_stk[si]  # [n, s, bd, l]
        safe = gidx.clamp(max=rows - 1)
        wt = batches.weights[:, sl]
        if params.get("vw") is not None:
            wt = wt * params[vw_key].index_select(0, safe.reshape(-1)).reshape(safe.shape)
        w_g = wt[..., None] * g_stk[:, sl][:, :, :, None, :]
        if rk.has_qr:
            coll = rk.coll[si][None, :, None, None]
            is_qr = (coll > 0)[..., None]
            ridx = torch.where(coll > 0, batches.indices[:, sl] % coll.clamp(min=1),
                               plan.qr_r_rows) + rk.roff[si][None, :, None, None]
            r_rows = params["qr_r"].index_select(
                0, ridx.clamp(0, plan.qr_r_rows - 1).reshape(-1)).reshape(*ridx.shape, -1)
            if c.qr_operation == "mult":
                q_rows = params[key].index_select(0, safe.reshape(-1)).float().reshape(
                    *safe.shape, -1)
                gr = torch.where(is_qr, w_g * q_rows, 0.0)
                w_g = w_g * torch.where(is_qr, r_rows, 1.0)
            else:
                gr = torch.where(is_qr, w_g, 0.0)
            qr_parts.append((ridx, gr))
        idx_f = mesh.all_gather_data(gidx.reshape(-1))
        g_f = mesh.all_gather_data(w_g.reshape(-1, plan.dim))
        big = si == 0
        gv = None
        if learned:
            # from the store before its update
            rows_v = params[key].index_select(0, safe.reshape(-1)).float().reshape(
                *safe.shape, -1)
            gv = (rows_v * g_stk[:, sl][:, :, :, None, :]).sum(dim=-1) * batches.weights[:, sl]
        sparse_update(opt, params[key], None if sgd else opt_state[key], idx_f, g_f, lr, rows,
                      impl=c.sparse_update_impl, size_class=1 if big else 0, dim=plan.dim,
                      exact_momentum=c.exact_row_momentum if big else False,
                      density_hint=c.dup_density_hint if big else -1.0,
                      packed=rk.packed, row_dim=rk.row_dim[si], finish=dense)
        if learned:
            _update_vw(rk, opt, params, opt_state, vw_key, rows, gidx, gv, lr)
    finish_dense(dense, lr, opt.eps)
    if qr_parts:
        # JAX's mode='drop': the non-QR slots' remainder ids point past the store
        ridx = torch.cat([r.reshape(-1) for r, _ in qr_parts])
        gr = torch.cat([g.reshape(-1, plan.dim) for _, g in qr_parts])
        keep = ridx < plan.qr_r_rows
        _update_qr_r(rk, opt, params, opt_state, torch.where(keep, ridx, 0),
                     torch.where(keep[:, None], gr, 0.0), lr)


def _logits(rk: _Rank, params: Dict, b: Batch) -> torch.Tensor:
    """The forward alone: the logits of the rank's tower rows."""
    pooled, _ = _lookups(rk, params, b)
    return _top(rk, params, *_bottom_and_exchange(rk, params, b, pooled))


class HybridRunner(Runner):
    """The hybrid-parallel runner (--shard-mode table: the reference picks
    its parallel path inside DLRM_Net.forward, dlrm_s_pytorch.py:675-684),
    so the CLI's --mesh-data / --mesh-model flags drive the same epoch loop
    as single-device training. ``sharder`` and ``allocation`` place the
    tables (``parallel/plan.make_plan``); ``params`` (this rank's hybrid
    params, e.g. from ``params_from_single_device``) replaces the host draw
    of ``init_hybrid_params``."""

    sharded_keys = ("emb", "emb_small", "vw", "vw_small")
    init_params = staticmethod(init_hybrid_params)
    init_opt_state = staticmethod(init_hybrid_opt_state)

    @staticmethod
    def make_plan(config: DLRMConfig, n_model: int, sharder: str = "greedy", allocation=None):
        return make_plan(config, n_model, sharder, allocation)

    def make_bodies(self):
        rk = _Rank(self.config, self.plan, self.mesh, self.opt)
        opt = self.opt
        fb = functools.partial(_forward_backward, rk)

        def updates(params, opt_state, b, piece, lr):
            g_pooled, parts = piece
            _sparse_updates(rk, opt, params, opt_state, b, parts, g_pooled, lr)

        def accum_updates(params, opt_state, batches, pieces, lr):
            ids = [[], []]
            for _, parts in pieces:
                for p, (si, *_r) in zip(parts, rk.sections()):
                    ids[si].append(p.gidx)
            _accum_updates(rk, opt, params, opt_state, batches,
                           [torch.stack(x) if x else None for x in ids],
                           torch.stack([g for g, _ in pieces]), lr)

        return (mesh_train_body(self.mesh, opt, fb, updates),
                mesh_accum_body(self.mesh, opt, self.n_accum, fb, accum_updates),
                mesh_eval_body(self.mesh, self.config, functools.partial(_logits, rk)))

    def prepare_batch(self, b: Batch) -> Batch:
        return prepare_batch(self.plan, self.mesh, b)

    def reshard(self, params, opt_state):
        """This rank's tensors, on its device, from the JAX package's whole
        hybrid pytrees as numpy (``emb`` ``[M, ...]``, the RWSAdagrad
        momenta flat over the shards; e.g. a loaded checkpoint)."""
        from dlrm_yx_tpu_torch.convert import hybrid_opt_state_from_jax, hybrid_params_from_jax

        m, dev = self.mesh.m, self.device
        return (hybrid_params_from_jax(params, self.plan, m, dev),
                hybrid_opt_state_from_jax(opt_state, self.opt, self.plan, m, dev))

    def tables(self, params: Dict):
        """Every table's weights by canonical id, on every rank, from the
        model group's stores (``extract_tables``; a collective)."""
        big = self.mesh.all_gather_model(params["emb"].unsqueeze(0))
        small = self.mesh.all_gather_model(params["emb_small"].unsqueeze(0))
        return extract_tables(self.plan, self.config, big, small)

    def _to_jax(self, shards: List[Dict], states: List[Dict]):
        """The JAX package's hybrid pytrees (``emb`` ``[M, r_big_pad / pack,
        dim * pack]``, RWSAdagrad's momenta flat over the shards)."""
        from dlrm_yx_tpu_torch.convert import hybrid_opt_state_to_jax, hybrid_params_to_jax

        return hybrid_params_to_jax(shards, self.plan), hybrid_opt_state_to_jax(states, self.plan)
