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
    (K2, ``ops/sparse_rows_overwrite.py``);
  * the dense branch builds the exactly coalesced gradient with a
    zeros-plus-scatter and finishes RWSAdagrad with K3
    (``ops/dense_finish.py``) under ``impl='pallas'``;
  * ``sparse_update_stream``, which the train step chooses for the high-L
    dense regime, sorts the occurrences by row and applies them with K5 or
    K6 (``ops/stream_update.py``).

Routes whose kernel is not ported yet raise ``NotImplementedError`` naming
it, and take no other path: K4 ``sparse_rows_add`` (a bf16 store or
stochastic rounding on the kernel route, no gathered rows, Adagrad on the
kernel route, a 1-D accumulator of ``ACC_KERNEL_MIN_BYTES`` or more).

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
from typing import Dict, List, Sequence

import numpy as np
import torch

from dlrm_yx_tpu_torch.ops import stream_update
from dlrm_yx_tpu_torch.ops.coalesce import coalesce_rows
from dlrm_yx_tpu_torch.ops.dense_finish import rwsadagrad_dense_finish
from dlrm_yx_tpu_torch.ops.embedding import TableGroup, dim_pack
from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite

# the JAX package's routing constants (optimizer.py:129-211)
PALLAS_MIN_STORE_BYTES = 64 << 20
ACC_KERNEL_MIN_BYTES = 160 << 20
ACC_SENTINEL_PAD = 256
DENSE_ACCUM_FACTOR = 8
MOMENTUM_EXACT_DENSITY = 0.95

K4_MISSING = "the sparse_rows_add kernel (K4) is not yet ported to dlrm_yx_tpu_torch"


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
    per-element sums for the MLPs, one per row (``acc_len`` long) for the
    stores. Zeros on the params' device."""
    if opt.name == "sgd":
        return {}
    if len(groups) != len(params["emb"]):
        raise ValueError(f"{len(groups)} groups vs {len(params['emb'])} emb stores")
    dense = {
        k: [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params[k]]
        for k in ("bot", "top")
    }
    if opt.name == "adagrad":
        emb = [torch.zeros(e.shape, dtype=torch.float32, device=e.device)
               for e in params["emb"]]
    else:
        emb = [torch.zeros(acc_len(g.total_rows), dtype=torch.float32, device=e.device)
               for g, e in zip(groups, params["emb"])]
    return {"dense": dense, "emb": emb}


@torch.no_grad()
def dense_update(opt: OptConfig, ps: List[torch.Tensor], gs: List[torch.Tensor],
                 accs, lr: float) -> None:
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
                        lr: float) -> None:
    """``dense_update`` of the bottom and top MLPs, in place."""
    def flat(tree):
        return [t for k in ("bot", "top") for pair in tree[k] for t in pair]

    accs = flat(opt_state["dense"]) if opt.name != "sgd" else None
    dense_update(opt, flat(params), flat(g_dense), accs, lr)


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
                         g_pooled: torch.Tensor, lr: float):
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
    divides by the final accumulator."""
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
    mom_inc = w_s * w_s * sumsq.index_select(0, seg_s) / dim * active
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
    ACC_KERNEL_MIN_BYTES, the row-RMW kernel on the accumulator (K4)."""
    if (
        impl in ("pallas", "stream")
        and acc.shape[0] % 128 == 0
        and acc.shape[0] >= sentinel + 129
        and acc.shape[0] * 4 >= ACC_KERNEL_MIN_BYTES
    ):
        raise NotImplementedError(
            f"a 1-D accumulator of {acc.shape[0] * 4} bytes updates through {K4_MISSING}"
        )
    safe = torch.where(active > 0, flat_idx, sentinel)
    _add_at(acc, safe, mom_inc * active, sentinel)


def sparse_update(
    opt: OptConfig,
    store: torch.Tensor,
    acc,
    flat_idx: torch.Tensor,
    flat_g: torch.Tensor,
    lr: float,
    sentinel: int,
    impl: str = "xla",
    stochastic_round: bool = False,
    size_class: int = 1,
    dim: int | None = None,
    exact_momentum: bool = False,
    old_rows=None,
    density_hint: float = -1.0,
):
    """Sparse row update of one group store, in place; returns (store, acc).

    store: [R, dim] logical rows (f32 or bf16); acc: the group's state
    (None for SGD, [R, dim] for Adagrad, 1-D per-row for RWSAdagrad);
    flat_idx: [K] row ids, duplicates allowed, ``sentinel`` (= R) for
    padding; flat_g: [K, dim] f32 row gradients; old_rows: [K, dim] f32
    store rows gathered by the forward lookup (L=1), which enable the
    write-only update; size_class: 0 for a small-table group, which always
    takes the dense branch. See the module docstring for the routes.
    """
    d = store.shape[1]
    if dim is not None and dim != d:
        raise ValueError(f"dim {dim} != store width {d} (the port's stores are logical rows)")
    pack = dim_pack(d)  # logical rows per physical row of the JAX package's store
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
                             stochastic_round, exact_momentum, old_rows)

    if opt.name == "sgd":
        # linear: a scatter-add is exact on duplicates
        _add_at(store, flat_idx, (-lr * flat_g).to(store.dtype), sentinel)
        return store, acc

    if size_class == 0 or dense_by_density or store_bytes < PALLAS_MIN_STORE_BYTES:
        # the scatter into zeros IS the coalesced gradient; untouched rows
        # see zero and their update is a no-op. A spare row takes the
        # sentinel ids, so nothing is masked.
        r = store.shape[0]
        dense_g = torch.zeros(r + 1, d, dtype=torch.float32, device=store.device)
        _add_at(dense_g, flat_idx, flat_g, sentinel)
        dense_g = dense_g[:r]
        if opt.name == "adagrad":
            acc.add_(dense_g * dense_g)
            store.copy_(store.float() - lr * dense_g / (acc.sqrt() + opt.eps))
            return store, acc
        if (
            impl in ("pallas", "stream")
            and store.dtype in (torch.float32, torch.bfloat16)
            and acc.dim() == 1
            and layout_ok
        ):
            return rwsadagrad_dense_finish(store, acc, dense_g, lr, d, opt.eps)
        head = acc[:r]
        head.add_((dense_g * dense_g).mean(dim=1))
        denom = head.sqrt()[:, None] + opt.eps
        store.copy_(store.float() - lr * (dense_g / denom))
        return store, acc

    uniq, sg = coalesce_rows(flat_idx, flat_g, sentinel)
    if opt.name == "adagrad":
        _add_at(acc, uniq, sg * sg, sentinel)
        denom = _take_fill(acc, uniq, 1.0, sentinel).sqrt() + opt.eps
        _add_at(store, uniq, (-lr * sg / denom).to(store.dtype), sentinel)
        return store, acc
    # rwsadagrad: row momentum += mean(g^2 over dim) (rwsadagrad.py:108-115)
    _add_at(acc, uniq, (sg * sg).sum(dim=-1) / d, sentinel)
    denom = _take_fill(acc, uniq, 1.0, sentinel).sqrt() + opt.eps
    _add_at(store, uniq, (-lr * sg / denom[:, None]).to(store.dtype), sentinel)
    return store, acc


def _kernel_route(opt, store, acc, flat_idx, flat_g, lr, sentinel, impl,
                  stochastic_round, exact_momentum, old_rows):
    """The row-touching route (``optimizer.py:333-429``)."""
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

    def apply_store(delta):
        if not can_overwrite:
            why = ("stochastic rounding" if stochastic_round
                   else f"a {store.dtype} store" if store.dtype != torch.float32
                   else "an update without the lookup's rows (write_only_update off, L > 1)")
            raise NotImplementedError(f"{why} on the kernel route needs {K4_MISSING}")
        sparse_rows_overwrite(store, flat_idx, old_rows + delta, delta, active)
        return store

    if opt.name == "sgd":
        return apply_store(-lr * flat_g), acc
    if opt.name == "adagrad":
        raise NotImplementedError(f"adagrad on the kernel route needs {K4_MISSING}")
    # rwsadagrad: 1-D per-row momentum, per occurrence unless coalesced
    mom_inc = ((flat_g * flat_g).sum(dim=-1) / store.shape[1]) * active
    _acc_update_1d(acc, flat_idx, mom_inc, active, sentinel, impl)
    safe = torch.where(active > 0, flat_idx, sentinel)
    denom = _take_fill(acc, safe, 1.0, sentinel).sqrt() + opt.eps
    return apply_store(-lr * flat_g / denom[:, None]), acc
