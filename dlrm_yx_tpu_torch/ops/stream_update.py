"""Sorted-stream sparse row updates: the high-L (multi-hot) update's apply.

The port of ``dlrm_yx_tpu/ops/pallas_stream_update.py``. Both functions
act in place on a logical ``[R, dim]`` f32 store, for K updates whose row
ids ``pos`` [K] are sorted ascending (duplicates allowed); an entry with
``pos >= R`` is dropped:

  * ``sorted_stream_apply(store, pos, seg, w, gtab)``:
    ``store[pos[k]] += w[k] * gtab[seg[k]]`` (K5): the update rows are
    expanded from the small pooled-gradient table ``gtab [S, dim]`` inside
    the kernel, so no ``[K, dim]`` array is built;
  * ``sorted_stream_add(store, pos, upd)``: ``store[pos[k]] += upd[k]``
    (K6), for update rows ``upd [K, dim]`` expanded by the caller.

Each product ``w * g`` is rounded to f32 before it is added, as in the JAX
package; a row's updates add in ascending k.

The JAX kernels stream the whole store through VMEM block by block, with
the grad table resident in VMEM, sub-128 dims packed into 128-lane rows
(the ``h`` sub-slot) and scalar streams padded by ``CHP`` sentinels. None of
that carries over: the port's stores are logical rows, so a packed
group's update is a ``dim``-wide row, and the CUDA kernels touch only the
rows that occur in ``pos``: K5 only those with a live occurrence (a
nonzero weight, or a grad row that is not finite, whose 0 * inf is NaN);
a weight-0 occurrence of a finite grad row adds +-0, which changes no
value but turns a ``-0.0`` element into ``+0.0`` in the JAX kernel and
the plain version, and leaves it ``-0.0`` in K5's kernel.
``GTAB_MAX_BYTES`` is kept as the port's own
constant: it is the TPU's VMEM budget for the grad table, but the
optimizer's choice between K5 and K6 follows it, as the JAX package's
does.

On a CUDA tensor each wrapper launches its kernels in
``csrc/sorted_stream_apply.cu`` or ``csrc/sorted_stream_add.cu``; on a CPU
tensor it runs its plain PyTorch version (``*_reference``: an
``index_add_``, serial in k on the CPU). There is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch

from dlrm_yx_tpu_torch.ops import _build

LANES = 128
GTAB_MAX_BYTES = 9 << 20  # grad tables of more bytes take K6 (the JAX package's rule)


def gtab_fits(rows: int) -> bool:
    """Does a grad table of ``rows`` pooled rows take K5? The JAX package's
    test (``optimizer.py:671-677``): the table as it lays it out, lane-tiled
    to 128 lanes whatever the dim, rows padded to 8, within GTAB_MAX_BYTES."""
    return -(-rows // 8) * 8 * LANES * 4 <= GTAB_MAX_BYTES


def _check(store, pos, rows, dim, what):
    if store.dim() != 2 or store.dtype != torch.float32:
        raise TypeError(f"want a 2-D f32 store, got {store.dtype} {tuple(store.shape)}")
    if pos.dim() != 1 or pos.dtype != torch.int32:
        raise ValueError(f"want pos [K] int32, got {pos.dtype} {tuple(pos.shape)}")
    if rows.dim() != 2 or rows.shape[1] != store.shape[1] or rows.dtype != torch.float32:
        raise ValueError(f"want {what} [*, {store.shape[1]}] f32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if dim != store.shape[1]:
        raise ValueError(f"dim {dim} != store width {store.shape[1]}")


def _live(store, pos):
    """pos with dropped entries sent to the last row, and the mask of the
    others; no host sync."""
    r = store.shape[0]
    keep = (pos >= 0) & (pos < r)
    return torch.where(keep, pos, r - 1).long(), keep[:, None]


def sorted_stream_apply_reference(store, pos, seg, w, gtab):
    """Plain PyTorch version, in place: the products w * gtab[seg], then one
    ``index_add_`` (dropped entries add zero to the last row)."""
    idx, keep = _live(store, pos)
    vals = w[:, None] * gtab.index_select(0, seg.long())
    store.index_add_(0, idx, torch.where(keep, vals, 0.0))
    return store


def sorted_stream_add_reference(store, pos, upd):
    """Plain PyTorch version, in place: one ``index_add_`` of upd."""
    idx, keep = _live(store, pos)
    store.index_add_(0, idx, torch.where(keep, upd, 0.0))
    return store


def _cuda_ready(tensors, names):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t, n in zip(tensors, names):
        if t.device != dev:
            raise ValueError(f"{n} is on {t.device}, the store on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    dim = tensors[0].shape[1]
    if dim % 4 == 0 and any(t.data_ptr() % 16 for t in tensors if t.dim() == 2):
        raise ValueError("the kernel's 16-byte loads need 16-byte aligned rows")
    return torch.cuda.current_stream(dev).cuda_stream


def sorted_stream_apply(store: torch.Tensor, pos: torch.Tensor, seg: torch.Tensor,
                        w: torch.Tensor, gtab: torch.Tensor) -> torch.Tensor:
    """store [R, dim] f32; pos [K] int32 ascending (>= R dropped); seg [K]
    int32 rows of gtab, each in [0, S) (the kernel does not check them: the
    optimizer makes them from the batch's shape); w [K] f32; gtab [S, dim]
    f32. Updates ``store`` in place and returns it.

    A CUDA call launches its four kernels (grad-row flags, count, compaction
    of the live occurrences, run walk) on the current stream and adds one
    to ``sorted_stream_apply.launches``; a CPU call runs the plain version.
    The CUDA route keeps a scratch buffer per (device, K, S), made at the
    first call of that size: make that call before capturing one in a CUDA
    graph, and do not run two calls of one size on two streams at once."""
    _check(store, pos, gtab, store.shape[1], "gtab")
    k = pos.shape[0]
    if seg.shape != (k,) or seg.dtype != torch.int32:
        raise ValueError(f"want seg [{k}] int32, got {seg.dtype} {tuple(seg.shape)}")
    if w.shape != (k,) or w.dtype != torch.float32:
        raise ValueError(f"want w [{k}] f32, got {w.dtype} {tuple(w.shape)}")
    if store.device.type == "cpu":
        return sorted_stream_apply_reference(store, pos, seg, w, gtab)
    stream = _cuda_ready((store, pos, seg, w, gtab), ("store", "pos", "seg", "w", "gtab"))
    r, dim = store.shape
    s = gtab.shape[0]
    lib = _build.load("sorted_stream_apply")
    scratch = _build.zeroed_scratch("sorted_stream_apply", store.device,
                                    _scratch_bytes(lib, k, s))
    err = _kernel("sorted_stream_apply")(
        store.data_ptr(), pos.data_ptr(), seg.data_ptr(), w.data_ptr(), gtab.data_ptr(),
        r, k, s, dim, scratch.data_ptr(), store.device.index, stream,
    )
    if err:
        raise RuntimeError(f"sorted_stream_apply kernel launch failed: CUDA error {err}")
    sorted_stream_apply.launches += 1
    return store


sorted_stream_apply.launches = 0


def sorted_stream_add(store: torch.Tensor, pos: torch.Tensor,
                      upd: torch.Tensor) -> torch.Tensor:
    """store [R, dim] f32; pos [K] int32 ascending (>= R dropped); upd
    [K, dim] f32. Updates ``store`` in place and returns it.

    A CUDA call launches the kernel on the current stream and adds one to
    ``sorted_stream_add.launches``; a CPU call runs the plain version."""
    _check(store, pos, upd, store.shape[1], "upd")
    k = pos.shape[0]
    if upd.shape[0] != k:
        raise ValueError(f"want upd [{k}, {store.shape[1]}], got {tuple(upd.shape)}")
    if store.device.type == "cpu":
        return sorted_stream_add_reference(store, pos, upd)
    stream = _cuda_ready((store, pos, upd), ("store", "pos", "upd"))
    r, dim = store.shape
    err = _kernel("sorted_stream_add")(
        store.data_ptr(), pos.data_ptr(), upd.data_ptr(), r, k, dim,
        store.device.index, stream,
    )
    if err:
        raise RuntimeError(f"sorted_stream_add kernel launch failed: CUDA error {err}")
    sorted_stream_add.launches += 1
    return store


sorted_stream_add.launches = 0


def _scratch_bytes(lib, k, s):
    fn = lib.sorted_stream_apply_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
    return fn(k, s)


def _kernel(name):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        if name == "sorted_stream_apply":
            fn.argtypes = [p] * 5 + [ll, ll, ll, i, p, i, p]
        else:
            fn.argtypes = [p] * 3 + [ll, ll, i, i, p]
        fn.restype = i
    return fn
