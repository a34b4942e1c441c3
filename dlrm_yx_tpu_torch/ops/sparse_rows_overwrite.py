"""Write-only sparse row update: overwrite unique rows, add on duplicates.

The port of ``sparse_rows_overwrite`` in
``dlrm_yx_tpu/ops/pallas_sparse_update.py``. In place on ``store [R, W]``
f32, for the K items of one batch:

  * an active item whose row occurs once among the active items:
    ``store[idx[k]] = new_vals[k]``;
  * active items whose row occurs several times: ``store[idx[k]] +=
    delta[k]``, one after another in ascending k (their new_vals, each
    computed from the same pre-update row, are ignored);
  * inactive items: nothing.

The caller computes ``new_vals = old_rows + delta`` from the rows the
forward lookup gathered, so the update never reads the store for a unique
row. Ids of active items are clipped to ``[0, R - 9]`` as the JAX package
clips them (the last ``SENTINEL_ROWS`` rows are never live).

On a CUDA tensor the wrapper launches ``csrc/sparse_rows_overwrite.cu``:
the row plan of ``csrc/row_plan.cuh``, four launches with no sort of the
items and no host sync (a plan kernel counts each row's active
occurrences; an apply kernel copies the rows that occur once; a place
kernel lays the duplicated items out a segment a row; a tail orders each
segment by k and walks it, the runs spread over the card), at any row
width: 16-byte vectors when W % 4 == 0, else one f32 a lane (the
mixed-dimension groups' widths 1 and 2). On a CPU tensor it runs
``sparse_rows_overwrite_reference``, the plain PyTorch version, which
finds duplicates by counting. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from dlrm_yx_tpu_torch.ops import _build
from dlrm_yx_tpu_torch.ops.sparse_rows_add import ROW_PLAN_COUNTS, kernel_ids

CLIP_MARGIN = 8     # active ids are clipped to R - 1 - CLIP_MARGIN


def _check(store, idx, new_vals, delta, active):
    if store.dim() != 2 or store.dtype != torch.float32:
        raise TypeError(f"want a 2-D f32 store, got {store.dtype} {tuple(store.shape)}")
    r, w = store.shape
    k = idx.shape[0]
    if r <= CLIP_MARGIN + 1:
        raise ValueError(f"a store of {r} rows has no room for its sentinel rows")
    if idx.dim() != 1 or active.shape != (k,):
        raise ValueError(f"want idx and active [K], got {tuple(idx.shape)}, "
                         f"{tuple(active.shape)}")
    for name, t in (("new_vals", new_vals), ("delta", delta)):
        if t.shape != (k, w) or t.dtype != torch.float32:
            raise ValueError(f"want {name} [{k}, {w}] f32, got {t.dtype} {tuple(t.shape)}")
    if len({t.device for t in (store, idx, new_vals, delta, active)}) != 1:
        raise ValueError("store, idx, new_vals, delta and active must share a device")


def _active_rows(store, idx, active, dead):
    """Active ids clipped as the JAX package clips them; ``dead`` elsewhere."""
    hi = store.shape[0] - 1 - CLIP_MARGIN
    return torch.where(active > 0, idx.clamp(0, hi), dead).to(torch.int32)


def sparse_rows_overwrite_reference(
    store: torch.Tensor,
    idx: torch.Tensor,
    new_vals: torch.Tensor,
    delta: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version, in place: count each row's active
    occurrences, copy new_vals into the rows that occur once, then add the
    duplicates' deltas with ``index_add_`` (serial on the CPU, in item
    order). Inactive items target the last row and change nothing."""
    r = store.shape[0]
    rows = _active_rows(store, idx, active, r - 1).long()
    live = active > 0
    counts = torch.zeros(r, dtype=torch.int32, device=store.device)
    counts.index_add_(0, rows, live.to(torch.int32))
    once = live & (counts[rows] == 1)
    dup = live & (counts[rows] > 1)
    # every item writes: a unique row its new values, any other item the
    # row's current values, so items sharing a row write the same thing
    store.index_copy_(0, rows, torch.where(once[:, None], new_vals, store[rows]))
    store.index_add_(0, rows, torch.where(dup[:, None], delta, 0.0))
    return store


def sparse_rows_overwrite(
    store: torch.Tensor,
    idx: torch.Tensor,
    new_vals: torch.Tensor,
    delta: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """store [R, W] f32 (any W), idx [K] int, new_vals and delta [K, W]
    f32, active [K] (0 = skip). Updates ``store`` in place and returns it.

    A CUDA call launches the kernels on the current stream and adds one to
    ``sparse_rows_overwrite.launches``; a CPU call runs the plain version."""
    _check(store, idx, new_vals, delta, active)
    if store.device.type == "cpu":
        return sparse_rows_overwrite_reference(store, idx, new_vals, delta, active)
    if store.device.type != "cuda":
        raise ValueError(f"unsupported device {store.device}")
    r, w = store.shape
    tensors = (store, new_vals, delta)
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("store, new_vals and delta must be contiguous")
    if w % 4 == 0 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel's 16-byte vectors need 16-byte aligned store, new_vals "
                         "and delta")
    if r >= 2**30:
        raise ValueError(f"a store of {r} rows: the kernel keys row * 2 in 31 bits")
    idx, active = kernel_ids(idx, active)
    k = idx.shape[0]
    fn, nbytes = _kernel()
    scratch = _build.zeroed_scratch("sparse_rows_overwrite", store.device, nbytes(k))
    counts = _build.device_counts("sparse_rows_overwrite", store.device, len(ROW_PLAN_COUNTS))
    err = fn(
        store.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), active.data_ptr(),
        new_vals.data_ptr(), delta.data_ptr(), scratch.data_ptr(), counts.data_ptr(), r, k, w,
        store.device.index, torch.cuda.current_stream(store.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"sparse_rows_overwrite kernel launch failed: CUDA error {err}")
    sparse_rows_overwrite.launches += 1
    return store


sparse_rows_overwrite.launches = 0


def _kernel():
    """(the launch function, the scratch size as a function of K)."""
    lib = _build.load("sparse_rows_overwrite")
    fn, nbytes = lib.sparse_rows_overwrite, lib.sparse_rows_overwrite_scratch_bytes
    if fn.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, i, p, p, p, p, p, ll, ll, i, i, p]
        fn.restype = i
        nbytes.argtypes, nbytes.restype = [ll], ll
    return fn, nbytes
