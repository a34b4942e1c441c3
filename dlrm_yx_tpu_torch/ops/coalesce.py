"""Duplicate-index coalescing for sparse gradients.

The port of ``dlrm_yx_tpu/ops/coalesce.py``: the ``grad.coalesce()`` that
the reference runs before its non-linear optimizer updates
(``optim/rwsadagrad.py:98``), as a stable sort, a neighbour compare, a
cumulative sum of segment starts and an ``index_add_`` per segment. Every
shape is static and nothing waits for the device (no ``torch.unique``, no
``nonzero``), so a step that coalesces can later be captured in a CUDA
graph.

On the card the sums are K7 (``csrc/coalesce_rows.cu``), which the JAX
package has no kernel for (XLA fuses its ops):

  * ``coalesce_segments`` (K7a) sorts the ids with ``torch.sort`` and sums
    each distinct id's rows in occurrence order, reading each item's row
    where it lies (a [K, dim] gradient, or a bag batch's pooled cotangent,
    ``embedding.BagRowGrads``, never expanded), with no float atomics: two
    calls give the same bits. It also gives each distinct id's first item
    and, asked for, RWSAdagrad's momentum increment ``sum(g^2) / dim``;
  * ``coalesce_finish`` (K7b) turns the sums into the write-only update's
    rows, ``new = old_rows[rep] + delta``, ``delta = -lr * g / (sqrt(acc) +
    eps)``, once K4 has added the increments to the row momentum;
  * ``coalesce_rows`` takes K7a for CUDA f32 gradients of a width it takes
    (``kernel_width``) and its plain version (``coalesce_rows_reference``)
    otherwise.

On CPU tensors each runs its plain PyTorch version (``coalesce_rows`` as
it always has), which sums each segment 0 + g_0 + g_1 + ... in occurrence
order: ``index_add_`` on the CPU adds in item order. K7a sums a segment
that lies inside one of its chunks in the same order, bit for bit, and a
longer one as its chunks' sums in chunk order.

Each K7a call counts ``coalesce.kernel`` (``utils.profiling.count``) and
adds, on the card, its live distinct ids and its segments summed across
chunks to two device counts that ``coalesce_counts`` reads as
``coalesce.rows`` and ``coalesce.split_runs``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Union

import torch

from dlrm_yx_tpu_torch.ops import _build
from dlrm_yx_tpu_torch.ops.dense_finish import device_lr
from dlrm_yx_tpu_torch.ops.embedding import BagRowGrads
from dlrm_yx_tpu_torch.utils.profiling import count

# what K7a counts on the device, in its order: live distinct ids, segments
# summed across chunks
COALESCE_COUNTS = ("coalesce.rows", "coalesce.split_runs")
MAX_DIM = 1024  # csrc/coalesce_rows.cu's widest row (coalesce_rows_max_dim)
CHUNK = 128  # csrc/coalesce_rows.cu's kChunk: sorted items K7a sums in order

Grads = Union[torch.Tensor, BagRowGrads]


class Segments(NamedTuple):
    """K7a's outputs, one place a segment (a distinct id) in ascending id
    order, then the places after the last segment.

    ids [K]: each segment's id, then the sentinel; sums [K, dim] (or [K]
    for a 1-D gradient) f32: each segment's rows summed, then zeros (or
    whatever was there, where the call did not ask for zeros); rep [K]
    int64: each segment's first item, then 0; count: 0-dim int64 on the
    device, the number of segments (a segment of the sentinel's items
    included); inc [K] f32 or None: ``sum(sums^2) / mdim`` of each segment
    of an id below the sentinel, else 0."""

    ids: torch.Tensor
    sums: torch.Tensor
    rep: torch.Tensor
    count: torch.Tensor
    inc: Optional[torch.Tensor]


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
    if kernel_width(flat_g) is None:
        return coalesce_rows_reference(flat_idx, flat_g, sentinel, aux)
    seg = coalesce_segments(flat_idx, flat_g, sentinel)
    if aux is None:
        return seg.ids, seg.sums
    live = torch.arange(flat_idx.shape[0], device=aux.device) < seg.count
    rows = aux.index_select(0, seg.rep)
    return seg.ids, seg.sums, torch.where(live.view((-1,) + (1,) * (aux.dim() - 1)), rows, 0)


def coalesce_rows_reference(flat_idx: torch.Tensor, flat_g: torch.Tensor, sentinel: int,
                            aux: torch.Tensor | None = None):
    """Plain PyTorch version of ``coalesce_rows`` (every CPU call's): on a
    card its ``index_add_`` adds a segment's rows in no fixed order."""
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


def kernel_width(grads: Grads) -> Optional[int]:
    """The row width at which K7a takes these gradients, or None where it
    does not: CUDA f32 rows of width 1 (a 1-D gradient) or a multiple of 4
    up to ``MAX_DIM``."""
    t = grads.table if isinstance(grads, BagRowGrads) else grads
    if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() not in (1, 2):
        return None
    d = 1 if t.dim() == 1 else t.shape[1]
    return d if d == 1 or (d % 4 == 0 and d <= MAX_DIM) else None


def coalesce_segments_reference(flat_idx: torch.Tensor, grads: Grads, sentinel: int,
                                mdim: Optional[int] = None) -> Segments:
    """Plain PyTorch version of K7a: ``coalesce_rows``' sort, segment ids
    and ``index_add_`` on the items' rows (read through the bag map for a
    ``BagRowGrads``); the first item of a segment by a min-scatter."""
    k = flat_idx.shape[0]
    s_idx, order = torch.sort(flat_idx, stable=True)
    new_seg = torch.cat([s_idx.new_zeros(1), s_idx[1:] != s_idx[:-1]])
    seg_id = torch.cumsum(new_seg, 0)
    if isinstance(grads, BagRowGrads):
        g = grads.table.index_select(0, grads.rows(order))
    else:
        g = grads[order]
    sums = torch.zeros_like(g).index_add_(0, seg_id, g)
    ids = torch.full((k,), sentinel, dtype=s_idx.dtype, device=s_idx.device)
    ids.index_copy_(0, seg_id, s_idx)
    rep = torch.zeros(k, dtype=torch.int64, device=s_idx.device)
    rep.scatter_reduce_(0, seg_id, order, "amin", include_self=False)
    inc = None if mdim is None else (sums * sums).sum(dim=-1) / mdim * (ids < sentinel)
    return Segments(ids, sums, rep, seg_id[-1] + 1, inc)


def coalesce_segments(flat_idx: torch.Tensor, grads: Grads, sentinel: int,
                      mdim: Optional[int] = None, zero_tail: bool = True) -> Segments:
    """K7a: each distinct id of flat_idx [K] with its items' rows of
    ``grads`` (a [K, dim] or [K] f32 tensor, or a ``BagRowGrads``) summed in
    occurrence order, as ``Segments``; ``mdim`` asks for the momentum
    increments (``sum(g^2) / mdim``); ``zero_tail=False`` leaves the sums
    after the last segment unwritten.

    A CUDA call sorts (``torch.sort``, stable), launches the kernels on the
    current stream, counts ``coalesce.kernel`` and adds one to
    ``coalesce_segments.launches``; widths ``kernel_width`` refuses raise.
    A CPU call runs the plain version."""
    table = grads.table if isinstance(grads, BagRowGrads) else grads
    k = flat_idx.shape[0]
    if flat_idx.dim() != 1 or k < 1:
        raise ValueError(f"want flat_idx [K] with K >= 1, got {tuple(flat_idx.shape)}")
    if isinstance(grads, torch.Tensor) and grads.shape[0] != k:
        raise ValueError(f"want grads of {k} rows, got {tuple(grads.shape)}")
    if table.device != flat_idx.device:
        raise ValueError("flat_idx and grads must share a device")
    if table.device.type == "cpu":
        return coalesce_segments_reference(flat_idx, grads, sentinel, mdim)
    d = kernel_width(grads)
    if d is None:
        raise ValueError(f"K7a takes CUDA f32 rows of width 1 or a multiple of 4 up to "
                         f"{MAX_DIM}, got {table.dtype} {tuple(table.shape)} on {table.device}")
    keys = flat_idx
    if keys.dtype not in (torch.int32, torch.int64) or sentinel >= 2**31 - 1:
        keys = keys.long()
    s_idx, order = torch.sort(keys.contiguous(), stable=True)
    table = table.contiguous()
    dev = table.device
    owner = grads.owner.to(torch.int32).contiguous() if isinstance(grads, BagRowGrads) else None
    ids = torch.empty_like(s_idx)
    sums = torch.empty((k, d) if table.dim() == 2 else (k,), dtype=torch.float32, device=dev)
    inc = None if mdim is None else torch.empty(k, dtype=torch.float32, device=dev)
    rep = torch.empty(k, dtype=torch.int64, device=dev)
    nseg = torch.empty((), dtype=torch.int64, device=dev)
    fn, nbytes = _kernel("coalesce_rows_segments")
    scratch = torch.empty(nbytes(k, d), dtype=torch.uint8, device=dev)
    counts = _build.device_counts("coalesce_rows", dev, len(COALESCE_COUNTS))
    err = fn(
        s_idx.data_ptr(), int(s_idx.dtype == torch.int64), order.data_ptr(), table.data_ptr(),
        None if owner is None else owner.data_ptr(),
        grads.batch if isinstance(grads, BagRowGrads) else 0, k, d, sentinel, ids.data_ptr(),
        sums.data_ptr(), None if inc is None else inc.data_ptr(), mdim or 1, rep.data_ptr(),
        nseg.data_ptr(), scratch.data_ptr(), int(zero_tail), counts.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"coalesce_rows_segments kernel launch failed: CUDA error {err}")
    count("coalesce.kernel")
    coalesce_segments.launches += 1
    return Segments(ids, sums, rep, nseg, inc)


coalesce_segments.launches = 0


def _rep_denominators(acc: torch.Tensor, ids: torch.Tensor, sentinel: int, eps: float):
    """``sqrt(acc[id]) + eps`` of each place, the sentinel's ids reading
    ``acc[sentinel]``, or 1.0 past the end of acc (``optimizer._take_fill``)."""
    safe = torch.where(ids < sentinel, ids, sentinel)
    n = acc.shape[0]
    a = acc[safe] if sentinel < n else torch.where(safe < n, acc[safe.clamp(max=n - 1)], 1.0)
    return a.sqrt() + eps


def coalesce_finish_reference(acc: torch.Tensor, seg: Segments, old_rows: torch.Tensor,
                              lr, eps: float, sentinel: int):
    """Plain PyTorch version of K7b on every place: (new_vals, delta)."""
    delta = -lr * seg.sums / _rep_denominators(acc, seg.ids, sentinel, eps)[:, None]
    return old_rows.index_select(0, seg.rep) + delta, delta


def coalesce_finish(acc: torch.Tensor, seg: Segments, old_rows: torch.Tensor, lr,
                    eps: float, sentinel: int, out: Optional[torch.Tensor] = None):
    """K7b: (new_vals [K, dim], delta [K, dim]) f32 of K7a's segments
    ``seg`` (its sums, which delta reuses on the card) after K4 has added
    their increments to ``acc`` (the 1-D f32 row momentum): ``delta =
    -lr * sums / (sqrt(acc[id]) + eps)`` and ``new_vals = old_rows[rep] +
    delta`` for each segment of an id below the sentinel; other places are
    left as they are on the card (K2 skips their items). old_rows [K, dim]
    f32: the rows the forward lookup gathered, one an item; lr a float or a
    0-dim f32 tensor on the device. ``out``: a [K, dim] f32 tensor that
    takes new_vals in place of a new one; it may be ``old_rows`` itself
    where ``seg.rep`` is every place's own (each element is read, then
    written, by one thread).

    A CUDA call launches the kernel on the current stream and adds one to
    ``coalesce_finish.launches``; a CPU call runs the plain version."""
    k, d = seg.sums.shape
    if old_rows.shape != (k, d) or old_rows.dtype != torch.float32:
        raise ValueError(f"want old_rows [{k}, {d}] f32, got {old_rows.dtype} "
                         f"{tuple(old_rows.shape)}")
    if acc.dim() != 1 or acc.dtype != torch.float32:
        raise ValueError(f"want acc 1-D f32, got {acc.dtype} {tuple(acc.shape)}")
    if acc.device.type == "cpu":
        new_vals, delta = coalesce_finish_reference(acc, seg, old_rows, lr, eps, sentinel)
        return (new_vals, delta) if out is None else (out.copy_(new_vals), delta)
    if d % 4 or d > MAX_DIM:
        raise ValueError(f"K7b takes widths of a multiple of 4 up to {MAX_DIM}, got {d}")
    dev = acc.device
    old_rows = old_rows.contiguous()
    if old_rows.data_ptr() % 16:
        raise ValueError("K7b's 16-byte loads need a 16-byte aligned old_rows")
    lr_t = device_lr(lr, dev)
    new_vals = torch.empty((k, d), dtype=torch.float32, device=dev) if out is None else out
    if new_vals.shape != (k, d) or not new_vals.is_contiguous():
        raise ValueError(f"want out [{k}, {d}] f32 contiguous, got {tuple(new_vals.shape)}")
    delta = seg.sums
    fn = _kernel("coalesce_rows_finish_rows")
    err = fn(
        seg.ids.data_ptr(), int(seg.ids.dtype == torch.int64), seg.rep.data_ptr(),
        seg.count.data_ptr(), k, sentinel, acc.contiguous().data_ptr(), lr_t.data_ptr(),
        float(eps), seg.sums.data_ptr(), old_rows.data_ptr(), d, new_vals.data_ptr(),
        delta.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"coalesce_rows_finish_rows kernel launch failed: CUDA error {err}")
    coalesce_finish.launches += 1
    return new_vals, delta


coalesce_finish.launches = 0


def coalesce_counts() -> Dict[str, int]:
    """``COALESCE_COUNTS`` summed over every K7a call on a card so far (a
    copy from each card), or {} where none has run on one or a CUDA graph
    is being captured."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return {}
    totals = _build.counts_of(("coalesce_rows",))
    return {} if totals is None else dict(zip(COALESCE_COUNTS, totals))


def _kernel(entry: str):
    """The launch function ``entry`` of the library, its argument types set
    (and, for K7a, its scratch size as a function of (K, dim))."""
    lib = _build.load("coalesce_rows")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        i, p, f, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
        if entry == "coalesce_rows_segments":
            fn.argtypes = [p, i, p, p, p, ll, ll, i, ll, p, p, p, i, p, p, p, i, p, i, p]
        else:
            fn.argtypes = [p, i, p, p, ll, ll, p, p, f, p, p, i, p, p, i, p]
        fn.restype = i
    if entry != "coalesce_rows_segments":
        return fn
    nbytes = lib.coalesce_rows_scratch_bytes
    if nbytes.argtypes is None:
        nbytes.argtypes, nbytes.restype = [ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong
    return fn, nbytes
