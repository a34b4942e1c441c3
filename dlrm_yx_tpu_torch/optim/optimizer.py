"""Optimizers: SGD / Adagrad / RWSAdagrad with sparse row updates.

The port of ``dlrm_yx_tpu/optim/optimizer.py`` (the reference's optimizer
wiring, ``dlrm_s_pytorch.py:1639-1666``): MLP params take the dense
update; embedding stores take sparse per-row updates from the lookup's row
gradients, routed by the JAX package's gates, copied as they are:

  * ``PALLAS_MIN_STORE_BYTES``, ``size_class``, the layout rule and
    ``DENSE_ACCUM_FACTOR`` with the duplicate-density hint choose between
    the row-touching kernel route and the XLA routes;
  * on the kernel route, ``MOMENTUM_EXACT_DENSITY`` chooses per-occurrence
    or coalesce-first momentum, and ``can_overwrite`` the write-only update
    (K2, ``ops/sparse_rows_overwrite.py``) over the row read-modify-write
    (K4, ``ops/sparse_rows_add.py``), which takes bf16 stores, stochastic
    rounding and updates without the lookup's rows. K4 also applies
    Adagrad's per-element accumulator on that route and, past
    ``ACC_KERNEL_MIN_BYTES``, RWSAdagrad's 1-D momentum viewed as
    ``[len, 1]`` rows. RWSAdagrad's coalesce-first write-only update of an
    f32 store (``_coalesced_overwrite``) sums and finishes only the
    distinct rows: K7a's segment sums and increments
    (``ops/coalesce.coalesce_segments``), K4 on the momentum, K7b's new rows
    (``coalesce_finish``), K2; a bag batch's row gradients reach it
    unexpanded (``ops/embedding.BagRowGrads``), and every other route
    expands them;
  * the dense branch builds the exactly coalesced gradient with a
    zeros-plus-scatter; under ``impl='pallas'`` RWSAdagrad's finish is K3
    (``ops/dense_finish.py``), run by ``finish_dense``, which builds every
    store's gradient in one buffer and finishes the stores in one launch:
    the one store at once, or, given a collector (``finish=``), every
    store a step collected;
  * ``sparse_update_stream``, which the train step chooses for the high-L
    dense regime, sorts the occurrences by row and applies them with K5 or
    K6 (``ops/stream_update.py``).

Each call counts the route it takes (``utils.profiling.count``):
``sparse_update.overwrite`` (K2), ``.row_add`` (K4), ``.scatter`` (SGD's
scatter-add), ``.dense_k3`` (the dense branch finished by K3), ``.dense``
(the dense branch in torch), ``.coalesce`` (coalesce first, then scatter)
and ``.stream`` (``sparse_update_stream``); a captured step counts them
per replay (``train/capture.py``).

``lr`` is a Python float or a 0-dim f32 tensor on the params' device, and
``sr_seed`` an int or a 0-dim integer tensor: a step captured in a CUDA
graph (``train/capture.py``) passes tensors that the host refills before
each replay, so nothing here reads a value back to the host and an LR
schedule or the SR seed does not freeze at its captured value. A tensor
and a float of the same f32 value give the same bits.

Differences of form from the JAX package, none of result:
  * updates are in place (the multi-GB stores are never copied); each
    function returns the updated tensors, which are its inputs;
  * stores are logical ``[total_rows, dim]`` rows and row gradients are
    ``[K, dim]``. Where a JAX gate reads the physical layout (rows of a
    packed sub-128-dim store, ``pack = 128 // dim``), the port computes
    the physical count from the group's dim;
  * XLA's ``mode='drop'`` scatters and ``mode='fill'`` gathers become
    ``_add_at`` / ``_take_fill``, which mask the ids that can fall out of
    range (static shape checks; nothing waits for the device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.ops import stream_update
from dlrm_yx_tpu_torch.ops.coalesce import (
    MAX_DIM,
    coalesce_finish,
    coalesce_rows,
    coalesce_segments,
    kernel_width,
)
from dlrm_yx_tpu_torch.ops.dense_finish import rwsadagrad_dense_finish_many
from dlrm_yx_tpu_torch.models.dlrm import dense_leaves, nest_dense
from dlrm_yx_tpu_torch.ops.embedding import BagRowGrads, TableGroup, device_ints, dim_pack
from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add
from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import CLIP_MARGIN, sparse_rows_overwrite
from dlrm_yx_tpu_torch.utils.profiling import count

# the JAX package's routing constants (optimizer.py:129-211)
PALLAS_MIN_STORE_BYTES = 64 << 20
ACC_KERNEL_MIN_BYTES = 160 << 20
ACC_SENTINEL_PAD = 256
DENSE_ACCUM_FACTOR = 8
MOMENTUM_EXACT_DENSITY = 0.95

Scalar = Union[float, torch.Tensor]  # an lr: a float, or a 0-dim f32 device tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW (torch.optim.AdamW's update, no weight decay): HSTU's dense
    leaves' optimizer; its lr is their base lr, scaled by the same LR policy
    as the table's (``OptConfig.lr``)."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "sgd"  # sgd | adagrad | rwsadagrad
    lr: float = 0.1    # base lr (may be rescaled per step by LRPolicy)
    eps: float = 1e-10

    def __post_init__(self):
        if self.name not in ("sgd", "adagrad", "rwsadagrad"):
            raise ValueError(f"unknown optimizer {self.name!r}")


def acc_len(total_rows: int) -> int:
    """Padded length of a per-row 1-D momentum accumulator: rounded to 128
    with a dead tail of ACC_SENTINEL_PAD entries (the JAX package's layout;
    updates address rows < total_rows, the dense finish keeps the tail)."""
    return ((total_rows + 127) // 128) * 128 + ACC_SENTINEL_PAD


def init_opt_state(opt: OptConfig, params: Dict, groups: Sequence[TableGroup]) -> Dict:
    """SGD: empty. Adagrad: per-element sums everywhere. RWSAdagrad:
    per-element sums for the MLPs, MD projections and cross layers, one per row
    (``acc_len`` long) for the stores, one per row (unpadded) for each QR
    sub-table. Learned or fixed pooling weights ``vw`` get per-entry sums.
    Zeros on the params' device, with the JAX package's keys."""
    if opt.name == "sgd":
        return {}
    if len(groups) != len(params["emb"]):
        raise ValueError(f"{len(groups)} groups vs {len(params['emb'])} emb stores")
    state = {**init_dense_state(params),
             "emb": [store_state(opt, e, g.total_rows) for g, e in zip(groups, params["emb"])]}
    if params.get("vw") is not None:
        state["vw"] = [torch.zeros_like(v) for v in params["vw"]]
    if "qr" in params:
        state["qr"] = [(store_state(opt, q), store_state(opt, r)) for q, r in params["qr"]]
    return state


def store_state(opt: OptConfig, store: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Zeros for an Adagrad-family store: Adagrad's per-element f32 sums, or
    RWSAdagrad's row momentum, ``acc_len(rows)`` long (a group or shard
    store's padded layout) or, without ``rows``, one a row of ``store``."""
    if opt.name == "adagrad":
        return torch.zeros(store.shape, dtype=torch.float32, device=store.device)
    n = store.shape[0] if rows is None else acc_len(rows)
    return torch.zeros(n, dtype=torch.float32, device=store.device)


def init_dense_state(params: Dict) -> Dict:
    """Zero per-element sums of every dense leaf, in the JAX package's
    layout: the towers' under ``dense``, the MD projections' and the cross
    layers' under their own keys."""
    zeros = nest_dense(params, [torch.zeros_like(p) for p in dense_leaves(params)])
    return {"dense": {k: zeros.pop(k) for k in ("bot", "top")}, **zeros}


@torch.no_grad()
def dense_update(opt: OptConfig, ps: List[torch.Tensor], gs: List[torch.Tensor],
                 accs, lr: Scalar) -> None:
    """The dense-parameter update of every tensor in ``ps``, in place, as a
    few multi-tensor (``torch._foreach_*``) launches. SGD: p -= lr * g.
    Adagrad and RWSAdagrad's dense part are both full Adagrad
    (rwsadagrad.py:118-121): acc += g * g; p -= lr * g / (sqrt(acc) + eps),
    element by element in the JAX package's order."""
    if opt.name == "sgd":
        torch._foreach_sub_(ps, torch._foreach_mul(gs, lr))
        return
    torch._foreach_add_(accs, torch._foreach_mul(gs, gs))
    denom = torch._foreach_sqrt(accs)
    torch._foreach_add_(denom, opt.eps)
    step = torch._foreach_mul(gs, lr)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(ps, step)


def update_dense_towers(opt: OptConfig, params: Dict, opt_state: Dict, g_dense: Dict,
                        lr: Scalar) -> None:
    """``dense_update`` of every dense leaf (``models.dlrm.dense_leaves``):
    the bottom and top MLPs, the MD projections (dense params too: the
    reference's ``PrEmbeddingBag`` Linear) and DLRM-DCNv2's cross layers
    (Adagrad on them under RWSAdagrad, as the MLPerf reference's
    ``torch.optim.Adagrad`` on every dense param), in place."""
    accs = (dense_leaves({**opt_state, **opt_state["dense"]}) if opt.name != "sgd"
            else None)
    dense_update(opt, dense_leaves(params), dense_leaves(g_dense), accs, lr)


def uniform_stream_density(emb_rows, emb_split_threshold: int, n_draws: int,
                           seed: int = 0) -> float:
    """Unique rows per occurrence of a uniform synthetic stream over the
    big (kernel-eligible) tables: the statistic ``cli._measure_dup_density``
    takes from a real first batch."""
    r = np.random.RandomState(seed)
    big = [n for n in emb_rows if not emb_split_threshold or n > emb_split_threshold]
    if not big:
        return 1.0
    uniq = sum(len(np.unique(r.randint(0, n, n_draws))) for n in big)
    return max(1e-3, min(1.0, uniq / (len(big) * n_draws)))


def stream_eligible(opt: OptConfig, store: torch.Tensor, group: TableGroup) -> bool:
    """Would the JAX package take the sorted-stream update (K5/K6)?"""
    return (
        opt.name in ("sgd", "rwsadagrad")
        and store.dtype == torch.float32
        and group.dim * group.pack == 128
        and group.size_class != 0
    )


def sparse_update_stream(opt: OptConfig, store: torch.Tensor, acc, group: TableGroup,
                         gidx: torch.Tensor, weights: torch.Tensor,
                         g_pooled: torch.Tensor, lr: Scalar, row_dim=None):
    """The sorted-stream update of one group store (the high-L dense
    regime), in place; returns (store, acc). The port of the JAX package's
    ``sparse_update_stream`` (``optimizer.py:594-711``).

    gidx: [T, B, L] global row ids; weights: [T, B, L] (0 = padding, which
    keeps its row id and stays in the stream); g_pooled: [T, B, dim] pooled
    cotangent. The scalar triples (row, segment, weight) are sorted by row
    with a stable sort (no [K, dim] payload moves); K5
    (``sorted_stream_apply``) expands each occurrence's update from the
    pooled-gradient table, or, when the table is over ``GTAB_MAX_BYTES``,
    the values are expanded here and K6 (``sorted_stream_add``) adds them.
    SGD is exact. RWSAdagrad's row momentum accumulates per occurrence:
    every occurrence adds w^2 * sum(g^2) / dim first, then every occurrence
    divides by the final accumulator. ``row_dim``: optional [R] f32 true
    dims of the rows (a hybrid store holding zero-padded narrower tables),
    which divide the momentum in place of ``dim``."""
    count("sparse_update.stream")
    t, b, l = gidx.shape
    dim = group.dim
    rows_s, perm = torch.sort(gidx.reshape(-1).to(torch.int32), stable=True)
    seg_s = torch.div(perm, l, rounding_mode="floor").to(torch.int32)
    w_s = weights.reshape(-1).float()[perm]
    gtab = g_pooled.float().reshape(t * b, dim)
    fits = stream_update.gtab_fits(t * b)

    def apply_update(w_eff):
        if fits:
            stream_update.sorted_stream_apply(store, rows_s, seg_s, w_eff, gtab)
        else:
            vals = gtab.index_select(0, seg_s) * w_eff[:, None]
            stream_update.sorted_stream_add(store, rows_s, vals)
        return store

    if opt.name == "sgd":
        return apply_update(-lr * w_s), acc
    active = (rows_s < group.total_rows).float()
    sumsq = (gtab * gtab).sum(dim=-1)
    dims = dim if row_dim is None else _take_fill(row_dim, rows_s, 1.0, group.total_rows)
    mom_inc = w_s * w_s * sumsq.index_select(0, seg_s) / dims * active
    safe = torch.where(active > 0, rows_s, group.total_rows)
    _add_at(acc, safe, mom_inc, group.total_rows)
    denom = _take_fill(acc, safe, 1.0, group.total_rows).sqrt() + opt.eps
    return apply_update(-lr * w_s / denom), acc


def _where_rows(keep: torch.Tensor, vals: torch.Tensor, other: float) -> torch.Tensor:
    """``vals`` on the items where ``keep`` [K] holds, else ``other``."""
    return torch.where(keep.view((-1,) + (1,) * (vals.dim() - 1)), vals, other)


def _add_at(target: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
            limit: int) -> None:
    """``target[idx] += vals`` dropping ids past the end (XLA's
    ``mode='drop'``); ``limit`` is the largest id that can occur, so the
    mask is only built when some id can fall out of range."""
    n = target.shape[0]
    if limit >= n:
        keep = idx < n
        idx, vals = torch.where(keep, idx, n - 1), _where_rows(keep, vals, 0.0)
    target.index_add_(0, idx, vals)


def _take_fill(src: torch.Tensor, idx: torch.Tensor, fill: float, limit: int):
    """``src[idx]`` with ``fill`` for ids past the end (``mode='fill'``)."""
    n = src.shape[0]
    if limit < n:
        return src[idx]
    return _where_rows(idx < n, src[idx.clamp(max=n - 1)], fill)


def _acc_update_1d(acc, flat_idx, mom_inc, active, sentinel, impl):
    """acc[idx] += mom_inc for active items: a scatter, or, past
    ACC_KERNEL_MIN_BYTES, the row-RMW kernel (K4) on the accumulator viewed
    as [len, 1] rows."""
    if (
        impl in ("pallas", "stream")
        and acc.shape[0] % 128 == 0
        and acc.shape[0] >= sentinel + 129
        and acc.shape[0] * 4 >= ACC_KERNEL_MIN_BYTES
    ):
        sparse_rows_add(acc.view(-1, 1), flat_idx, mom_inc[:, None], active)
        return
    safe = torch.where(active > 0, flat_idx, sentinel)
    _add_at(acc, safe, mom_inc * active, sentinel)


def sparse_update(
    opt: OptConfig,
    store: torch.Tensor,
    acc,
    flat_idx: torch.Tensor,
    flat_g: torch.Tensor,
    lr: Scalar,
    sentinel: int,
    impl: str = "xla",
    stochastic_round: bool = False,
    sr_seed: Union[int, torch.Tensor] = 0,
    size_class: int = 1,
    dim: int | None = None,
    exact_momentum: bool = False,
    old_rows=None,
    density_hint: float = -1.0,
    packed: bool = True,
    row_dim=None,
    finish: Optional[List] = None,
):
    """Sparse row update of one group store, in place; returns (store, acc).

    store: [R, dim] logical rows (f32 or bf16); acc: the group's state
    (None for SGD, [R, dim] for Adagrad, 1-D per-row for RWSAdagrad);
    flat_idx: [K] row ids, duplicates allowed, ``sentinel`` (= R) for
    padding; flat_g: [K, dim] f32 row gradients, or a bag batch's
    ``BagRowGrads``; old_rows: [K, dim] f32
    store rows gathered by the forward lookup (L=1), which enable the
    write-only update; stochastic_round and sr_seed (the step) apply to a
    bf16 store on the kernel route; size_class: 0 for a small-table group,
    which always takes the dense branch; packed: whether the JAX package
    packs ``128 // dim`` rows of this store to a physical row below 128 (a
    group store; the gates read the physical layout), False for a store it
    keeps in its natural layout (a QR sub-table: a width that is not a
    multiple of 128 never takes a kernel); row_dim: optional [R] f32 true
    dim of each row, for a hybrid store of zero-padded narrower tables
    (mixed-dimension or k*D mixes): RWSAdagrad's row momentum is
    sum(g^2) / row_dim (rwsadagrad.py:108), not over the padded width, and
    the dense branch then skips K3, as in the JAX package; finish: a list
    that collects a store which takes the dense branch's K3 finish, as
    ``(store, acc, flat_idx, flat_g, sentinel)``, instead of finishing it:
    the store and acc are unchanged until ``finish_dense`` runs the
    collected ones. See the module docstring for the routes.
    """
    d = store.shape[1]
    if dim is not None and dim != d:
        raise ValueError(f"dim {dim} != store width {d} (the port's stores are logical rows)")
    # logical rows per physical row of the JAX package's store
    pack = dim_pack(d) if packed else 1
    r_phys = store.shape[0] // pack
    store_bytes = store.numel() * store.element_size()
    layout_ok = d % 128 == 0 or pack > 1
    k_raw = flat_idx.shape[0]
    k_eff = k_raw
    if 0.0 < density_hint <= 1.0:
        k_eff = max(1, int(k_raw * density_hint))
    dense_by_density = k_eff * DENSE_ACCUM_FACTOR >= r_phys
    if k_eff != k_raw and k_raw * DENSE_ACCUM_FACTOR >= r_phys:
        # the hint flipped a dense-regime decision to the kernel: the raw
        # stream is duplicate-heavy, so coalesce first
        exact_momentum = True
    use_kernel = (
        impl in ("pallas", "stream")
        and size_class != 0
        and layout_ok
        and not dense_by_density
        and store_bytes >= PALLAS_MIN_STORE_BYTES
    )
    if use_kernel and opt.name != "sgd" and not exact_momentum:
        # unmeasured or duplicate-heavy streams coalesce first; measured
        # duplicate-light ones keep per-occurrence momentum
        exact_momentum = not (density_hint >= MOMENTUM_EXACT_DENSITY)
    if use_kernel:
        return _kernel_route(opt, store, acc, flat_idx, flat_g, lr, sentinel, impl,
                             stochastic_round, sr_seed, exact_momentum, old_rows, row_dim)

    flat_g = _expanded(flat_g)
    if opt.name == "sgd":
        # linear: a scatter-add is exact on duplicates
        count("sparse_update.scatter")
        _add_at(store, flat_idx, (-lr * flat_g).to(store.dtype), sentinel)
        return store, acc

    if size_class == 0 or dense_by_density or store_bytes < PALLAS_MIN_STORE_BYTES:
        # the scatter into zeros IS the coalesced gradient; untouched rows
        # see zero and their update is a no-op. A spare row takes the
        # sentinel ids, so nothing is masked.
        k3 = (
            opt.name == "rwsadagrad"
            and impl in ("pallas", "stream")
            and row_dim is None
            and store.dtype in (torch.float32, torch.bfloat16)
            and acc.dim() == 1
            and layout_ok
        )
        count("sparse_update.dense_k3" if k3 else "sparse_update.dense")
        if k3:
            item = (store, acc, flat_idx, flat_g, sentinel)
            if finish is None:
                finish_dense([item], lr, opt.eps)
            else:
                finish.append(item)
            return store, acc
        r = store.shape[0]
        dense_g = torch.zeros(r + 1, d, dtype=torch.float32, device=store.device)
        _add_at(dense_g, flat_idx, flat_g, sentinel)
        dense_g = dense_g[:r]
        if opt.name == "adagrad":
            acc.add_(dense_g * dense_g)
            store.copy_(store.float() - lr * dense_g / (acc.sqrt() + opt.eps))
            return store, acc
        head = acc[:r]
        sq = dense_g * dense_g
        head.add_(sq.mean(dim=1) if row_dim is None else sq.sum(dim=1) / row_dim[:r])
        denom = head.sqrt()[:, None] + opt.eps
        store.copy_(store.float() - lr * (dense_g / denom))
        return store, acc

    count("sparse_update.coalesce")
    uniq, sg = coalesce_rows(flat_idx, flat_g, sentinel)
    if opt.name == "adagrad":
        _add_at(acc, uniq, sg * sg, sentinel)
        denom = _take_fill(acc, uniq, 1.0, sentinel).sqrt() + opt.eps
        _add_at(store, uniq, (-lr * sg / denom).to(store.dtype), sentinel)
        return store, acc
    # rwsadagrad: row momentum += mean(g^2 over dim) (rwsadagrad.py:108-115)
    dims = d if row_dim is None else _take_fill(row_dim, uniq, 1.0, sentinel)
    _add_at(acc, uniq, (sg * sg).sum(dim=-1) / dims, sentinel)
    denom = _take_fill(acc, uniq, 1.0, sentinel).sqrt() + opt.eps
    _add_at(store, uniq, (-lr * sg / denom[:, None]).to(store.dtype), sentinel)
    return store, acc


def finish_dense(collected: Sequence, lr: Scalar, eps: float) -> None:
    """Finish the stores that ``sparse_update`` collected (``finish=``), in
    place, as it would have finished each: one f32 buffer holds every
    store's exactly coalesced gradient, each store's rows and a spare row
    that takes its sentinel ids, the stores of one width side by side and
    each width's region 16-byte aligned; the buffer is zero-filled once,
    each width's row gradients are scattered into it at once, and K3
    finishes every store in one launch (``rwsadagrad_dense_finish_many``).
    On the CPU the scatter adds each row's items in their order, so the
    result equals ``sparse_update``'s without a collector bit for bit.

    A caller may defer a store's finish only while nothing reads the store
    or its accumulator before ``finish_dense``, and may collect a store
    once a step."""
    if not collected:
        return
    device = collected[0][0].device
    by_width: Dict[int, list] = {}
    for item in collected:
        by_width.setdefault(item[0].shape[1], []).append(item)
    regions, size = [], 0
    for d, items in by_width.items():
        starts = np.cumsum([0] + [it[0].shape[0] + 1 for it in items])
        regions.append((d, size, starts, items))
        size += -(-int(starts[-1]) * d // 4) * 4
    buf = torch.zeros(size, dtype=torch.float32, device=device)
    stores = []
    for d, base, starts, items in regions:
        seg = buf[base:base + int(starts[-1]) * d].view(-1, d)
        ids = []
        for store, _, flat_idx, _, sentinel in items:
            r = store.shape[0]
            # ids past the store's rows (XLA's mode='drop') go to its spare row
            ids.append(flat_idx.clamp(max=r) if sentinel > r else flat_idx)
        counts = tuple(i.shape[0] for i in ids)
        ids = torch.cat(ids) if len(ids) > 1 else ids[0]
        if len(items) > 1:
            ids = ids + torch.repeat_interleave(
                device_ints(tuple(int(x) for x in starts[:-1]), device),
                device_ints(counts, device), output_size=ids.shape[0])
        grads = [it[3] for it in items]
        seg.index_add_(0, ids, torch.cat(grads) if len(grads) > 1 else grads[0])
        stores += [(store, acc, seg[int(o):int(o) + store.shape[0]])
                   for (store, acc, *_), o in zip(items, starts)]
    rwsadagrad_dense_finish_many(stores, lr, eps)


def sparse_update_1d(opt: OptConfig, vec: torch.Tensor, acc, flat_idx: torch.Tensor,
                     flat_g: torch.Tensor, lr: Scalar, sentinel: int):
    """Sparse update of a 1-D per-row parameter (learned pooling weights
    v_W), in place; returns (vec, acc). The reference's dense update of
    v_W: an entry with zero gradient is a no-op in every optimizer here,
    so the sparse form is exact. SGD adds every occurrence; Adagrad and
    RWSAdagrad (whose dense part is Adagrad) coalesce first."""
    if opt.name == "sgd":
        _add_at(vec, flat_idx, -lr * flat_g, sentinel)
        return vec, acc
    uniq, sg = coalesce_rows(flat_idx, flat_g, sentinel)
    _add_at(acc, uniq, sg * sg, sentinel)
    denom = _take_fill(acc, uniq, 1.0, sentinel).sqrt() + opt.eps
    _add_at(vec, uniq, -lr * sg / denom, sentinel)
    return vec, acc


def _expanded(flat_g):
    """[K, dim] row gradients: a ``BagRowGrads`` written out."""
    return flat_g.expand() if isinstance(flat_g, BagRowGrads) else flat_g


def _coalesced_overwrite(opt, store, acc, flat_idx, flat_g, lr, sentinel, impl, old_rows):
    """RWSAdagrad's coalesce-first write-only update of an f32 store, in
    place; returns (store, acc). K7a sums each distinct row's items and
    gives its momentum increment, K4 (or a scatter) adds the increments
    to the row momentum, K7b computes each distinct row's new values from
    its representative's gathered row, K2 writes them: every [K, dim] pass
    touches the distinct rows only. The same function as the torch route
    (coalesce, momentum, finish on every item), which the CPU's plain
    versions give bit for bit."""
    count("sparse_update.overwrite")
    seg = coalesce_segments(flat_idx, flat_g, sentinel, mdim=store.shape[1], zero_tail=False)
    _overwrite_segments(opt, store, acc, seg, old_rows, lr, sentinel, impl)
    return store, acc


def _overwrite_segments(opt, store, acc, seg, old_rows, lr, sentinel, impl,
                        in_place=False) -> None:
    """The update after K7a: the momentum increments added (K4 or a
    scatter), K7b's new rows from ``old_rows`` (read at ``seg.rep``;
    written over them with ``in_place``, where each place reads its own),
    K2."""
    active = (seg.ids < sentinel).to(torch.int32)
    _acc_update_1d(acc, seg.ids, seg.inc, active, sentinel, impl)
    new_vals, delta = coalesce_finish(acc, seg, old_rows, lr, opt.eps, sentinel,
                                      out=old_rows if in_place else None)
    sparse_rows_overwrite(store, seg.ids, new_vals, delta, active)


def coalesced_rows_update(opt: OptConfig, store: torch.Tensor, acc: torch.Tensor,
                          flat_idx: torch.Tensor, grads: List[torch.Tensor], lr: Scalar,
                          sentinel: int) -> None:
    """Exact row-wise Adagrad (RWSAdagrad with coalesce-first momentum) of
    an f32 store of any size, in place, on the coalesce-first write-only
    route without its gates: K7a, the momentum (K4 or a scatter), K7b, K2.
    The ids lie below ``sentinel``; the store holds ``CLIP_MARGIN`` + 1
    spare rows from there on (K2 clips its ids below them and sends its
    inactive items to the last).
    ``flat_idx`` [K] row ids, ``grads``: a list holding the one [K, dim]
    f32 gradient tensor, which this takes out of the list and lets go once
    K7a has summed it, so that the update's other [K, dim] tensors (K7a's
    sums; the distinct rows' old values, gathered by distinct row, not an
    item each, since a segment's representative is its own place, and
    overwritten by K7b with the new ones) need not live beside it. It
    serves HSTU's item table, whose step of a few million items would take
    ``sparse_update``'s dense branch: a second buffer the table's size."""
    if opt.name != "rwsadagrad" or store.dtype != torch.float32 or acc.dim() != 1:
        raise ValueError("the coalesced row update is exact row-wise Adagrad of an f32 store")
    if store.shape[0] < sentinel + CLIP_MARGIN + 1:
        raise ValueError(f"a store of {store.shape[0]} rows holds fewer than "
                         f"{CLIP_MARGIN + 1} spare rows past its sentinel {sentinel}")
    count("sparse_update.overwrite")
    seg = coalesce_segments(flat_idx, grads.pop(), sentinel, mdim=store.shape[1],
                            zero_tail=False)
    old = store.index_select(0, seg.ids.clamp(max=sentinel - 1))
    own = seg._replace(rep=torch.arange(seg.ids.shape[0], device=store.device))
    _overwrite_segments(opt, store, acc, own, old, lr, sentinel, "pallas", in_place=True)


def init_adamw_state(params: Dict) -> Dict:
    """AdamW's first and second moments of every dense leaf, zeros, nested
    as the params' dense leaves."""
    return {name: nest_dense(params, [torch.zeros_like(p) for p in dense_leaves(params)])
            for name in ("adam_m", "adam_v")}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, ps: List[torch.Tensor], gs: List[torch.Tensor],
                 ms: List[torch.Tensor], vs: List[torch.Tensor], lr: Scalar,
                 step: torch.Tensor) -> None:
    """``torch.optim.AdamW``'s update (no weight decay) of every tensor in
    ``ps``, in place, as multi-tensor launches: m = lerp(m, g, 1 - b1);
    v = b2 v + (1 - b2) g^2; p -= lr / (1 - b1^t) * m / (sqrt(v) /
    sqrt(1 - b2^t) + eps). ``lr`` a float or a 0-dim f32 device tensor,
    ``step`` t, a 0-dim f32 device tensor (the first step is 1), so a
    captured step reads both from device memory."""
    b1, b2 = cfg.betas
    torch._foreach_lerp_(ms, gs, 1.0 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, 1.0 - b2)
    denom = torch._foreach_sqrt(vs)
    torch._foreach_mul_(denom, torch.rsqrt(1.0 - torch.pow(b2, step)))
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(ms, denom)
    torch._foreach_mul_(upd, lr / (1.0 - torch.pow(b1, step)))
    torch._foreach_sub_(ps, upd)


def _kernel_route(opt, store, acc, flat_idx, flat_g, lr, sentinel, impl,
                  stochastic_round, sr_seed, exact_momentum, old_rows, row_dim=None):
    """The row-touching route (``optimizer.py:333-429``)."""
    if (
        exact_momentum
        and opt.name == "rwsadagrad"
        and old_rows is not None
        and row_dim is None
        and not stochastic_round
        and store.dtype == torch.float32
        and store.shape[1] % 4 == 0
        and store.shape[1] <= MAX_DIM
        and (store.device.type == "cpu" or kernel_width(flat_g) is not None)
    ):
        return _coalesced_overwrite(opt, store, acc, flat_idx, flat_g, lr, sentinel, impl,
                                    old_rows)
    flat_g = _expanded(flat_g)
    if exact_momentum:
        # coalesce first: momentum sees each row's summed gradient once;
        # occurrences of one row carry the same gathered row, so old_rows
        # coalesce by representative and the write-only update survives
        if old_rows is not None:
            flat_idx, flat_g, old_rows = coalesce_rows(flat_idx, flat_g, sentinel,
                                                       aux=old_rows)
        else:
            flat_idx, flat_g = coalesce_rows(flat_idx, flat_g, sentinel)
    active = (flat_idx < sentinel).to(torch.int32)
    can_overwrite = (
        old_rows is not None
        and not stochastic_round
        and store.dtype == torch.float32
    )
    count("sparse_update.overwrite" if can_overwrite else "sparse_update.row_add")

    def apply_store(delta):
        if can_overwrite:
            sparse_rows_overwrite(store, flat_idx, old_rows + delta, delta, active)
        else:
            sparse_rows_add(store, flat_idx, delta, active, stochastic_round, sr_seed)
        return store

    if opt.name == "sgd":
        return apply_store(-lr * flat_g), acc
    safe = torch.where(active > 0, flat_idx, sentinel)
    if opt.name == "adagrad":
        # per-element accumulator: K4 adds g^2, then the update divides by
        # the updated entries (sentinel items read 1.0)
        sparse_rows_add(acc, flat_idx, flat_g * flat_g, active)
        denom = _take_fill(acc, safe, 1.0, sentinel).sqrt() + opt.eps
        return apply_store(-lr * flat_g / denom), acc
    # rwsadagrad: 1-D per-row momentum, per occurrence unless coalesced
    dims = store.shape[1] if row_dim is None else _take_fill(row_dim, safe, 1.0, sentinel)
    mom_inc = ((flat_g * flat_g).sum(dim=-1) / dims) * active
    _acc_update_1d(acc, flat_idx, mom_inc, active, sentinel, impl)
    denom = _take_fill(acc, safe, 1.0, sentinel).sqrt() + opt.eps
    return apply_store(-lr * flat_g / denom[:, None]), acc
