"""Row-wise Adagrad finish over an exactly coalesced dense gradient.

The port of ``rwsadagrad_dense_finish`` in
``dlrm_yx_tpu/ops/pallas_dense_finish.py``: the last step of the
dense-accumulate RWSAdagrad update (``optim/optimizer.py``'s dense
branch). In place, for every row r of ``store [R, dim]`` with
``g = dense_g[r]``:

    mom      = sum(g * g) / dim
    acc[r]  += mom
    store[r] = store[r] - (lr * g) / (sqrt(acc[r]) + eps)

in f32; a bf16 store is rounded to nearest even at write-back. ``acc`` is
the 1-D per-row momentum and may be longer than R (``acc_len`` padding);
its tail is kept. A row with a zero gradient comes back bit-identical.

The port keeps logical ``[R, dim]`` stores, so the JAX package's packed
layout (pack logical rows per 128-lane physical row) needs nothing here:
each logical row is a row.

``lr`` is a Python float or a 0-dim f32 tensor on the store's device. The
kernel reads it from device memory, so a step captured in a CUDA graph
takes the lr its replay is given; a float becomes a device scalar by a
fill on the card, without a host sync.

``rwsadagrad_dense_finish_many`` finishes several stores in one launch of
the same kernel (at most ``MAX_DESCS`` a launch): the train step gathers
its dense-branch stores (``optim/optimizer.finish_dense``) and finishes
them together. Each store takes the kernel's route for its width: a lane
group sized to the row up to 64 columns (16 on the scalar route, where
dim % 4 != 0), a warp per row past that (see the source's header).

On a CUDA tensor each wrapper launches ``csrc/rwsadagrad_dense_finish.cu``;
on a CPU tensor it runs its plain PyTorch version
(``rwsadagrad_dense_finish_reference``, or the same per store). There is no
fallback from one to the other. ``rwsadagrad_dense_finish.launches`` counts
the kernel's launches from either wrapper;
``rwsadagrad_dense_finish_many.launches`` those of the grouped one.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from dlrm_yx_tpu_torch.ops import _build

# stores a launch: the descriptors go by value in the kernel's parameter block
MAX_DESCS = 64

Store = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (store, acc, dense_g)


def _check(store, acc, dense_g, dim, lr):
    if store.dim() != 2 or store.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"want a 2-D f32 or bf16 store, got {store.dtype} "
                        f"{tuple(store.shape)}")
    r, w = store.shape
    if w != dim:
        raise ValueError(f"dim {dim} != store width {w} (the port's stores are logical rows)")
    if dense_g.shape != (r, w) or dense_g.dtype != torch.float32:
        raise ValueError(f"want dense_g [{r}, {w}] f32, got {dense_g.dtype} "
                         f"{tuple(dense_g.shape)}")
    if acc.dim() != 1 or acc.dtype != torch.float32 or acc.shape[0] < r:
        raise ValueError(f"want acc 1-D f32 of at least {r} rows, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if len({t.device for t in (store, acc, dense_g)}) != 1:
        raise ValueError("store, acc and dense_g must share a device")
    if store.device.type == "cuda":
        if not (store.is_contiguous() and dense_g.is_contiguous() and acc.is_contiguous()):
            raise ValueError("store, acc and dense_g must be contiguous")
        if dim % 4 == 0 and (store.data_ptr() % 16 or dense_g.data_ptr() % 16):
            raise ValueError("the kernel's 16-byte loads need 16-byte aligned store and dense_g")
    elif store.device.type != "cpu":
        raise ValueError(f"unsupported device {store.device}")
    if isinstance(lr, torch.Tensor) and (
            lr.dim() != 0 or lr.dtype != torch.float32 or lr.device != store.device):
        raise ValueError(f"want lr as a 0-dim f32 tensor on {store.device}, got {lr.dtype} "
                         f"{tuple(lr.shape)} on {lr.device}")


def device_lr(lr: Union[float, torch.Tensor], device: torch.device) -> torch.Tensor:
    """lr as a 0-dim f32 tensor on ``device``: a tensor as it is (``_check``
    has checked it), a float by a fill on the device (no host-to-device
    copy, no sync)."""
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), float(lr), dtype=torch.float32, device=device)


def rwsadagrad_dense_finish_reference(
    store: torch.Tensor, acc: torch.Tensor, dense_g: torch.Tensor,
    lr: Union[float, torch.Tensor], dim: int, eps: float,
):
    """Plain PyTorch version, in place; returns (store, acc)."""
    r = store.shape[0]
    head = acc[:r]
    head.add_((dense_g * dense_g).sum(dim=1) / dim)
    denom = head.sqrt() + eps
    store.copy_(store.float() - lr * dense_g / denom[:, None])
    return store, acc


def rwsadagrad_dense_finish(
    store: torch.Tensor, acc: torch.Tensor, dense_g: torch.Tensor,
    lr: Union[float, torch.Tensor], dim: int, eps: float,
):
    """store [R, dim] f32 or bf16, acc [>= R] f32, dense_g [R, dim] f32;
    lr a float or a 0-dim f32 tensor on the store's device; updates store
    and acc in place and returns them.

    A CUDA call launches the kernel on the current stream and adds one to
    ``rwsadagrad_dense_finish.launches``; a CPU call runs the plain
    version."""
    _check(store, acc, dense_g, dim, lr)
    if store.device.type == "cpu":
        return rwsadagrad_dense_finish_reference(store, acc, dense_g, lr, dim, eps)
    lr_t = device_lr(lr, store.device)
    err = _kernel("rwsadagrad_dense_finish")(
        store.data_ptr(), int(store.dtype == torch.bfloat16), acc.data_ptr(),
        dense_g.data_ptr(), store.shape[0], dim, lr_t.data_ptr(), float(eps),
        store.device.index, torch.cuda.current_stream(store.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rwsadagrad_dense_finish kernel launch failed: CUDA error {err}")
    rwsadagrad_dense_finish.launches += 1
    return store, acc


rwsadagrad_dense_finish.launches = 0


def rwsadagrad_dense_finish_many_reference(stores: Sequence[Store],
                                           lr: Union[float, torch.Tensor], eps: float):
    """Plain PyTorch version of the grouped finish: the plain version store
    by store, in place; returns the stores' (store, acc) pairs."""
    return [rwsadagrad_dense_finish_reference(s, a, g, lr, s.shape[1], eps)
            for s, a, g in stores]


def rwsadagrad_dense_finish_many(stores: Sequence[Store],
                                 lr: Union[float, torch.Tensor], eps: float):
    """Finish every (store [R, dim], acc [>= R], dense_g [R, dim]) of
    ``stores`` as ``rwsadagrad_dense_finish`` does, each at its own width
    and dtype, in place; returns the (store, acc) pairs. The stores must be
    distinct (they are updated at once). On CUDA tensors, one launch a
    ``MAX_DESCS`` stores on the current stream, each adding one to
    ``rwsadagrad_dense_finish_many.launches`` and to
    ``rwsadagrad_dense_finish.launches``; on CPU tensors, the plain
    version."""
    if not stores:
        return []
    device = stores[0][0].device
    for s, a, g in stores:
        _check(s, a, g, s.shape[1], lr)
        if s.device != device:
            raise ValueError(f"stores on {device} and {s.device}: one device a call")
    ptrs = [s.data_ptr() for s, _, _ in stores if s.numel()]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("a store is named twice: the grouped finish updates them at once")
    if device.type == "cpu":
        return rwsadagrad_dense_finish_many_reference(stores, lr, eps)
    lr_t = device_lr(lr, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _kernel("rwsadagrad_dense_finish_many")
    for lo in range(0, len(stores), MAX_DESCS):
        part = [x for x in stores[lo:lo + MAX_DESCS] if x[0].shape[0]]
        if not part:
            continue
        n = len(part)
        err = fn(
            n, (ctypes.c_void_p * n)(*(s.data_ptr() for s, _, _ in part)),
            (ctypes.c_int * n)(*(int(s.dtype == torch.bfloat16) for s, _, _ in part)),
            (ctypes.c_void_p * n)(*(a.data_ptr() for _, a, _ in part)),
            (ctypes.c_void_p * n)(*(g.data_ptr() for _, _, g in part)),
            (ctypes.c_longlong * n)(*(s.shape[0] for s, _, _ in part)),
            (ctypes.c_int * n)(*(s.shape[1] for s, _, _ in part)),
            lr_t.data_ptr(), float(eps), device.index, stream,
        )
        if err:
            raise RuntimeError(
                f"rwsadagrad_dense_finish_many kernel launch failed: CUDA error {err}")
        rwsadagrad_dense_finish_many.launches += 1
        rwsadagrad_dense_finish.launches += 1
    return [(s, a) for s, a, _ in stores]


rwsadagrad_dense_finish_many.launches = 0


def _kernel(entry: str):
    fn = getattr(_build.load("rwsadagrad_dense_finish"), entry)
    if fn.argtypes is None:
        i, p, f, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
        if entry == "rwsadagrad_dense_finish":
            fn.argtypes = [p, i, p, p, ll, i, p, f, i, p]
        else:
            fn.argtypes = [i, p, p, p, p, p, p, p, f, i, p]
        fn.restype = i
    return fn
