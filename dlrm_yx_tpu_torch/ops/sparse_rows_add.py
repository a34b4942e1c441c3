"""Row read-modify-write sparse update: ``store[idx[k]] += upd[k]``, rounded
to the store's type after every add.

The port of ``sparse_rows_add`` in ``dlrm_yx_tpu/ops/pallas_sparse_update.py``
(the RMW pass ``_kernel`` and the serialized tail ``_tail_kernel``). In
place on ``store [R, dim]`` (f32 or bf16 logical rows; ``dim=1`` for a 1-D
accumulator viewed as ``[len, 1]``), for the K items of one batch:

  * an active item k does ``v = f32(store[row]) + upd[k]`` and writes ``v``
    rounded to the store's type back to its row: a row hit three times in
    bf16 is rounded three times;
  * inactive items do nothing.

Ids of active items are clipped to ``[0, R - 1 - unit]`` as the JAX kernel
clips them (``unit`` below; the last unit holds the store's dead sentinel
rows, which the port never writes).

A row's occurrences apply in the JAX kernel's order. That kernel runs a
main pass over the items in k order and then a serialized tail for the
items it flags: an active item is flagged when an active item among the
``WINDOW - 1`` before it hits the same transfer unit (``unit`` rows: 1 for
an f32 store, 8 for bf16, times ``128 // dim`` for the packed dims that
divide 128). So a row takes its unflagged occurrences in ascending k,
then its flagged ones in ascending k. The TPU mechanics behind that order
(the DMA slot window, 8-row bf16 transfers, sentinel redirection) have no
counterpart here.

Stochastic rounding (bf16 stores only, as in JAX) applies to unflagged
occurrences: ``u = bits(v) + (r & 0xFFFF)``, then the low 16 bits are
dropped. The tail rounds to nearest even, as the JAX tail does. ``r`` is a
counter-based hash of (seed, k, element) (``sr_bits``), so the CUDA kernel
and the plain version give the same store bit for bit; the TPU's own random
stream cannot be reproduced. The seed (the step) is an int or a 0-dim
integer tensor; the kernels read it from device memory, so a step captured
in a CUDA graph rounds with the seed its replay is given.

On a CUDA tensor the wrapper launches ``csrc/sparse_rows_add.cu``: the row
plan of ``csrc/row_plan.cuh``, four launches with no sort of the items
and no host sync (a plan kernel computes the flags by the window compare
of ``conflict_flags`` and counts each row's occurrences; an apply kernel
updates the rows that occur once; a place kernel lays the duplicated
items out a segment a row; a tail orders each segment by (flag, k) and
walks it, the runs spread over the card). Each call adds its duplicated
items, runs and long runs to counts on the device that ``row_plan_counts``
reads (K2's calls too). On a CPU tensor it runs ``sparse_rows_add_reference``,
the plain PyTorch version, which orders the items with ``sorted_order``.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Union

import torch

from dlrm_yx_tpu_torch.ops import _build
from dlrm_yx_tpu_torch.ops.embedding import dim_pack

WINDOW = 64  # the JAX kernel's hazard look-back, in items (2 x its DMA window)
# what the row plan's tail counts on the device, in its order: the items
# of duplicated rows, their rows (runs), the runs of 64 items or more
ROW_PLAN_COUNTS = ("row_plan.dup_keys", "row_plan.runs", "row_plan.long_runs")
_GOLDEN = 0x9E3779B9  # the seed's multiplier in the SR hash
_M32 = 0xFFFFFFFF


def unit_rows(dtype: torch.dtype, dim: int) -> int:
    """Logical rows per transfer unit of the JAX kernel: 8-row units for
    bf16 (1 row for f32), times the pack factor of a sub-128 dim."""
    return (1 if dtype == torch.float32 else 8) * dim_pack(dim)


def _check(store, idx, upd, active):
    if store.dim() != 2 or store.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"want a 2-D f32 or bf16 store, got {store.dtype} "
                        f"{tuple(store.shape)}")
    r, dim = store.shape
    k = idx.shape[0]
    unit = unit_rows(store.dtype, dim)
    if r % unit or r < 2 * unit:
        raise ValueError(f"a store of {r} rows is not a whole number (at least 2) of "
                         f"{unit}-row units")
    if idx.dim() != 1 or active.shape != (k,):
        raise ValueError(f"want idx and active [K], got {tuple(idx.shape)}, "
                         f"{tuple(active.shape)}")
    if upd.shape != (k, dim) or upd.dtype != torch.float32:
        raise ValueError(f"want upd [{k}, {dim}] f32, got {upd.dtype} {tuple(upd.shape)}")
    if len({t.device for t in (store, idx, upd, active)}) != 1:
        raise ValueError("store, idx, upd and active must share a device")


def conflict_flags(unit: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """[K] bool: active items that an active item among the WINDOW - 1
    before them hits in the same unit (``unit`` [K] ids): the JAX package's
    WINDOW - 1 shifted compares, as the CUDA plan kernel makes them."""
    live = active > 0
    flags = torch.zeros(unit.shape[0], dtype=torch.bool, device=unit.device)
    for j in range(1, min(WINDOW, unit.shape[0])):
        flags[j:] |= (unit[j:] == unit[:-j]) & live[:-j]
    return flags & live


def sorted_order(store: torch.Tensor, idx: torch.Tensor, active: torch.Tensor):
    """(key, perm): key [K] ascending is ``row * 2 + flag`` of each active
    item (``2 * R`` for an inactive one), perm [K] int64 the item each
    sorted position came from. int32 keys unless 2R + 1 needs more."""
    r, dim = store.shape
    unit = unit_rows(store.dtype, dim)
    kdt = torch.int32 if 2 * r < 2**31 - 1 else torch.int64
    live = active > 0
    rows = idx.to(kdt).clamp(0, r - 1 - unit)
    flag = conflict_flags(rows // unit, active)
    key = torch.where(live, rows * 2 + flag.to(kdt), 2 * r)
    return torch.sort(key, stable=True)


def _seed_mix(seed: Union[int, torch.Tensor]):
    """The seed's part of the SR hash input, as a 32-bit value (an int64
    tensor in [0, 2^32) for a tensor seed)."""
    if isinstance(seed, torch.Tensor):
        return _mul32(seed.long() & _M32, _GOLDEN)
    return ((int(seed) & _M32) * _GOLDEN) & _M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sr_bits(seed: Union[int, torch.Tensor], items: torch.Tensor, dim: int) -> torch.Tensor:
    """[n, dim] int64 in [0, 2^32): murmur3's fmix32 of
    ``seed * 0x9E3779B9 ^ (k * dim + c)`` for item k and element c, in
    32-bit arithmetic, as ``csrc/sparse_rows_add.cu`` computes it."""
    cols = torch.arange(dim, device=items.device)
    h = ((items[:, None] * dim + cols) & _M32) ^ _seed_mix(seed)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _round_to_store(v: torch.Tensor, dtype: torch.dtype, sr_rows=None, seed=0,
                    items=None) -> torch.Tensor:
    """f32 rows v [n, dim] rounded to ``dtype`` (returned as f32): f32 is
    unchanged; bf16 rounds to nearest even, or stochastically on the rows
    where ``sr_rows`` [n] holds (``items`` [n] name the items, for the bits)."""
    if dtype == torch.float32:
        return v
    rn = v.to(dtype).float()
    if sr_rows is None:
        return rn
    u = (v.view(torch.int32).long() & _M32) + (sr_bits(seed, items, v.shape[1]) & 0xFFFF)
    u = u & 0xFFFF0000
    sr = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)
    return torch.where(sr_rows[:, None], sr, rn)


def sparse_rows_add_reference(store: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                              active: torch.Tensor, stochastic_round: bool = False,
                              seed: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Plain PyTorch version, in place: on the kernel's order, round j
    applies the j-th occurrence of every row at once (a gather, an add,
    the rounding, an ``index_copy_``). Reads the number of rounds back to
    the host."""
    _check(store, idx, upd, active)
    key, perm = sorted_order(store, idx, active)
    r, k = store.shape[0], key.shape[0]
    pos = (key >> 1).long()
    main = (key & 1) == 0
    sr = stochastic_round and store.dtype != torch.float32
    p = torch.arange(k, device=store.device)
    head = torch.ones(k, dtype=torch.bool, device=store.device)
    head[1:] = pos[1:] != pos[:-1]
    rank = p - torch.where(head, p, 0).cummax(0).values
    rank = torch.where(pos < r, rank, -1)
    for j in range(int(rank.max()) + 1 if k else 0):
        sel = (rank == j).nonzero().squeeze(1)
        rows, items = pos[sel], perm[sel]
        v = store.index_select(0, rows).float() + upd.index_select(0, items)
        v = _round_to_store(v, store.dtype, main[sel] if sr else None, seed, items)
        store.index_copy_(0, rows, v.to(store.dtype))
    return store


def sparse_rows_add(store: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                    active: torch.Tensor, stochastic_round: bool = False,
                    seed: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """store [R, dim] f32 or bf16 (R a whole number of units), idx [K] int,
    upd [K, dim] f32, active [K] (0 = skip); stochastic_round takes effect
    on a bf16 store only; seed is the step's (an int, or a 0-dim integer
    tensor on the store's device). Updates ``store`` in place and returns
    it.

    A CUDA call launches the kernels on the current stream and adds one to
    ``sparse_rows_add.launches``; a CPU call runs the plain version."""
    _check(store, idx, upd, active)
    if store.device.type == "cpu":
        return sparse_rows_add_reference(store, idx, upd, active, stochastic_round, seed)
    if store.device.type != "cuda":
        raise ValueError(f"unsupported device {store.device}")
    r, dim = store.shape
    if r >= 2**30:
        raise ValueError(f"a store of {r} rows: the kernel keys row * 2 + flag in 31 bits")
    if not store.is_contiguous() or not upd.is_contiguous():
        raise ValueError("store and upd must be contiguous")
    if dim % 4 == 0 and (store.data_ptr() % (4 * store.element_size()) or upd.data_ptr() % 16):
        raise ValueError("the kernel's vector loads need aligned store and upd rows")
    idx, active = kernel_ids(idx, active)
    k = idx.shape[0]
    fn, nbytes = _kernel()
    scratch = _build.zeroed_scratch("sparse_rows_add", store.device, nbytes(k))
    counts = _build.device_counts("sparse_rows_add", store.device, len(ROW_PLAN_COUNTS))
    sr = stochastic_round and store.dtype != torch.float32
    step = device_step(seed, store.device) if sr else None
    err = fn(
        store.data_ptr(), int(store.dtype == torch.bfloat16), idx.data_ptr(),
        int(idx.dtype == torch.int64), active.data_ptr(), upd.data_ptr(), scratch.data_ptr(),
        counts.data_ptr(), r, k, dim, unit_rows(store.dtype, dim), int(sr),
        None if step is None else step.data_ptr(), store.device.index,
        torch.cuda.current_stream(store.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"sparse_rows_add kernel launch failed: CUDA error {err}")
    sparse_rows_add.launches += 1
    return store


sparse_rows_add.launches = 0


def device_step(seed: Union[int, torch.Tensor], device: torch.device) -> torch.Tensor:
    """The SR step as a 0-dim int64 tensor on ``device``: a tensor as it is
    (checked; cast when it is another integer type), an int by a fill on the
    device (no host-to-device copy, no sync)."""
    if isinstance(seed, torch.Tensor):
        if seed.dim() != 0 or seed.dtype.is_floating_point or seed.device != device:
            raise ValueError(f"want the seed as a 0-dim integer tensor on {device}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return seed.to(torch.int64)
    return torch.full((), int(seed), dtype=torch.int64, device=device)


def row_plan_counts() -> Dict[str, int]:
    """``ROW_PLAN_COUNTS`` summed over every K2 and K4 call on a card so
    far (a copy from each card), or {} where neither has run on one or a
    CUDA graph is being captured."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return {}
    totals = _build.counts_of(("sparse_rows_overwrite", "sparse_rows_add"))
    return {} if totals is None else dict(zip(ROW_PLAN_COUNTS, totals))


def kernel_ids(idx: torch.Tensor, active: torch.Tensor):
    """idx as contiguous int32 or int64 and active as contiguous int32, the
    types the row plan's kernels read (a copy only where they differ)."""
    if idx.shape[0] >= 2**26:
        raise ValueError(f"{idx.shape[0]} items: the row plan's table takes fewer than 2^26")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    return idx.contiguous(), active.to(torch.int32).contiguous()


def _kernel():
    """(the launch function, the scratch size as a function of K)."""
    lib = _build.load("sparse_rows_add")
    fn, nbytes = lib.sparse_rows_add, lib.sparse_rows_add_scratch_bytes
    if fn.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, i, p, i, p, p, p, p, ll, ll, i, i, i, p, i, p]
        fn.restype = i
        nbytes.argtypes, nbytes.restype = [ll], ll
    return fn, nbytes
