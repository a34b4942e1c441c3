"""The fixed-shape batch layout every data source emits.

A numpy copy of ``dlrm_yx_tpu/data/batch.py``:

    dense   [B, m_den]  float32
    indices [T, B, L]   int32     per-table row ids, 0 where padded
    weights [T, B, L]   float32   per-sample weights; 0 marks padding
    labels  [B, 1]      float32

L is the max pooling length (num_indices_per_lookup); Criteo has L = 1.
The fields hold numpy arrays on the host and torch tensors on the device.

A multi-step dispatch or an accumulation step takes n batches stacked on a
new leading axis (``stack_batches``: the JAX trainer's ``dispatch_stream``
and ``_group_microbatches`` stacking). A step captured in a CUDA graph reads
its batch from static device buffers (``empty_like_batch``) that
``copy_batch`` refills before each replay: host arrays through pinned
memory with a non-blocking copy, device tensors device to device.
``stage_batch`` starts a host batch's copy to the card on a side stream
(the trainer's prefetch thread). ``to_device`` serves the eager path.

HSTU trains on ``SeqBatch``, a jagged batch of user histories at a fixed
token budget. Every helper here takes either kind of batch (any
``NamedTuple`` of arrays) and keeps its kind.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dlrm_yx_tpu_torch.utils.profiling import count


class Batch(NamedTuple):
    dense: "np.ndarray | object"
    indices: "np.ndarray | object"
    weights: "np.ndarray | object"
    labels: "np.ndarray | object"


class SeqBatch(NamedTuple):
    """A jagged batch of user histories for HSTU (``models/hstu.py``): T
    tokens (the batch's fixed budget), whole histories packed back to back
    and the last one cut to fit; S histories padded to the configuration's
    bound, a padded one empty.

    ids        [T]      int32    each event's item
    times      [T]      int64    each event's timestamp (seconds; rising
                                 within a history)
    offsets    [S + 1]  int32    each history's first token, then T
                                 (a padded history starts at T)
    positives  [T]      int32    the next event's item (0 at a history's
                                 last event)
    negatives  [T, R]   int32    the position's sampled negative items
    weights    [T]      float32  1 where the position is supervised (an
                                 event with a next one), else 0
    """

    ids: "np.ndarray | object"
    times: "np.ndarray | object"
    offsets: "np.ndarray | object"
    positives: "np.ndarray | object"
    negatives: "np.ndarray | object"
    weights: "np.ndarray | object"


def csr_to_padded(
    ls_i: Sequence[np.ndarray],
    ls_o: Sequence[np.ndarray],
    batch_size: int,
    l_max: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convert per-table CSR (indices, offsets) lists — the reference's
    EmbeddingBag input layout — to padded [T, B, L] indices + weight mask.

    ls_o[t] has B entries (start offsets); a final implicit end at
    len(ls_i[t]).
    """
    t = len(ls_i)
    indices = np.zeros((t, batch_size, l_max), dtype=np.int32)
    weights = np.zeros((t, batch_size, l_max), dtype=np.float32)
    for k in range(t):
        idx = np.asarray(ls_i[k])
        off = np.asarray(ls_o[k])
        ends = np.concatenate([off[1:], [len(idx)]])
        for b in range(batch_size):
            seg = idx[off[b] : ends[b]]
            n = len(seg)
            if n > l_max:
                raise ValueError(f"pooling length {n} exceeds L={l_max}")
            indices[k, b, :n] = seg
            weights[k, b, :n] = 1.0
    return indices, weights


def padded_to_csr(indices: np.ndarray, weights: np.ndarray
                  ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The inverse of ``csr_to_padded``: per table, the live (weight > 0)
    ids in batch order and each sample's offset into them, int64."""
    t, b, _ = indices.shape
    ls_i, ls_o = [], []
    for k in range(t):
        idx_list, offsets = [], []
        cur = 0
        for i in range(b):
            seg = indices[k, i][weights[k, i] > 0]
            offsets.append(cur)
            idx_list.extend(seg.tolist())
            cur += len(seg)
        ls_i.append(np.array(idx_list, dtype=np.int64))
        ls_o.append(np.array(offsets, dtype=np.int64))
    return ls_i, ls_o


def to_device(batch: Batch, device: torch.device) -> Batch:
    """The batch as tensors on ``device`` (no copy for fields already there)."""
    return type(batch)(*(torch.as_tensor(a, device=device) for a in batch))


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """n batches stacked on a new leading axis: numpy for host batches,
    torch tensors (on their device) for device batches."""
    kind = type(batches[0])
    if isinstance(batches[0][0], torch.Tensor):
        return kind(*(torch.stack([b[i] for b in batches]) for i in range(len(kind._fields))))
    return kind(*(np.stack([np.asarray(b[i]) for b in batches])
                  for i in range(len(kind._fields))))


def signature(batch: Batch) -> Tuple:
    """The fields' shapes: one static buffer set (and one CUDA graph) each."""
    return tuple(tuple(a.shape) for a in batch)


def _torch_dtype(a) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.zeros(0, dtype=np.asarray(a).dtype)).dtype


def empty_like_batch(batch: Batch, device: torch.device) -> Batch:
    """Uninitialised tensors on ``device`` with the shapes and types of
    ``batch``'s fields (host or device)."""
    return type(batch)(*(torch.empty(tuple(a.shape), dtype=_torch_dtype(a), device=device)
                         for a in batch))


def _pinned(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory()


def copy_batch(dst: Batch, src: Batch) -> None:
    """Fill device tensors ``dst`` from ``src`` on the current stream: host
    arrays are pinned and copied without blocking the host (their bytes
    counted as ``h2d.bytes``), device tensors copied device to device."""
    pinned = 0
    for d, a in zip(dst, src):
        if tuple(d.shape) != tuple(a.shape):
            raise ValueError(f"batch field of shape {tuple(a.shape)} for a buffer of "
                             f"{tuple(d.shape)}")
        if not isinstance(a, torch.Tensor):
            if d.device.type == "cuda":
                a = _pinned(a)
                pinned += a.nbytes
            else:
                a = torch.from_numpy(np.asarray(a))
        d.copy_(a, non_blocking=True)
    if pinned:
        count("h2d.bytes", pinned)


def stage_batch(batch: Batch, device: torch.device, stream):
    """(device batch, event): a host batch pinned and copied to ``device`` on
    ``stream`` without blocking the host, with an event recorded after the
    copy; the consumer makes its stream wait for the event before it reads
    the batch. A batch already on the device is returned as it is, with no
    event. The host arrays' bytes are counted as ``h2d.bytes``."""
    if all(isinstance(a, torch.Tensor) and a.device == device for a in batch):
        return batch, None
    with torch.cuda.stream(stream):
        staged = type(batch)(*(a.to(device, non_blocking=True) if isinstance(a, torch.Tensor)
                               else _pinned(a).to(device, non_blocking=True)
                               for a in batch))
        event = torch.cuda.Event()
        event.record(stream)
    count("h2d.bytes", sum(np.asarray(a).nbytes for a in batch
                           if not isinstance(a, torch.Tensor)))
    return staged, event
