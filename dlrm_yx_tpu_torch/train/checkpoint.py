"""Checkpoint / resume, in the JAX package's npz format.

The port of the npz backend of ``dlrm_yx_tpu/train/checkpoint.py`` (the
reference's ``dlrm_s_pytorch.py:1698-1755, 2025-2038``): a checkpoint is a
directory holding ``params.npz`` and ``opt_state.npz`` (``leaf_{i}``
arrays) and ``meta.json`` (epoch, iteration, train loss, the eval metrics
and the optimizer's name); ``--load-model`` restores everything and skips
forward to the saved (epoch, batch) position (``skip_position``).

The files cross-load with the JAX package's. The leaves are written in the
order of ``jax.tree.flatten`` over JAX's pytrees (dict keys sorted, lists in
order, ``None`` no leaf): params ``bot`` (W, b)…, ``emb`` stores…, ``top``
(W, b)…; optimizer state ``dense.bot`` (aw, ab)…, ``dense.top``…, ``emb``
accumulators…; SGD has none. Each in JAX's physical layout
(``convert.params_to_jax``): a store of a dim below 128 that divides it
packed ``128 / dim`` rows to a physical row, as is an Adagrad accumulator;
RWSAdagrad's 1-D row momentum with its ``acc_len`` padding. A bf16 store is
written as raw 16-bit elements (dtype ``V2``, what ``np.savez`` records for
``ml_dtypes.bfloat16``) and read back from either form.

Orbax (the JAX package's sharded backend) is a JAX library: the port has
the npz backend only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import _tensor, opt_state_to_jax, params_to_jax


def _leaves(tree) -> List:
    """The leaves of a tree in ``jax.tree.flatten`` order: dict keys sorted,
    lists and tuples in order, None no leaf. The port's trees have the JAX
    package's keys, so a port tree and its ``params_to_jax`` /
    ``opt_state_to_jax`` tree give their leaves in the same order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def _load_leaves(path: str, tensors: List[torch.Tensor]) -> None:
    """Copy each leaf of the npz into its tensor, in place (a captured step
    stays bound to the tensors it captured); a packed store unpacks by the
    reshape."""
    with np.load(path) as d:
        n = sum(1 for k in d.files if k.startswith("leaf_"))
        if n != len(tensors):
            raise ValueError(f"{path} holds {n} leaves, the run has {len(tensors)}")
        for i, t in enumerate(tensors):
            src = _tensor(d[f"leaf_{i}"], torch.device("cpu"))
            if src.numel() != t.numel() or src.dtype != t.dtype:
                raise ValueError(f"{path} leaf_{i}: {tuple(src.shape)} {src.dtype}, the run's "
                                 f"tensor is {tuple(t.shape)} {t.dtype}")
            with torch.no_grad():
                t.copy_(src.reshape(t.shape))


def save_checkpoint(
    path: str,
    params: Dict,
    opt_state: Dict,
    config: DLRMConfig,
    *,
    epoch: int = 0,
    iteration: int = 0,
    train_loss: float = 0.0,
    metrics: Dict[str, float] | None = None,
    optimizer: str | None = None,
) -> None:
    """Write ``params`` and ``opt_state`` (the port's trees for ``config``)
    and the counters to the directory ``path``. Device tensors are copied to
    the host on their stream's order: a caller with queued work on another
    stream synchronises first."""
    os.makedirs(path, exist_ok=True)
    for name, tree in (("params", params_to_jax(params, config)),
                       ("opt_state", opt_state_to_jax(opt_state, config))):
        np.savez(os.path.join(path, f"{name}.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(_leaves(tree))})
    meta = {
        "epoch": int(epoch),
        "iteration": int(iteration),
        "train_loss": float(train_loss),
        "metrics": {k: float(v) for k, v in (metrics or {}).items()},
    }
    if optimizer is not None:
        # lets --load-model reject resuming under a different optimizer
        meta["optimizer"] = optimizer
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, params: Dict, opt_state: Dict):
    """Restore a checkpoint into ``params`` and ``opt_state`` (the port's
    trees, from ``init_dlrm`` / ``init_opt_state``), in place; returns
    (params, opt_state, meta)."""
    _load_leaves(os.path.join(path, "params.npz"), _leaves(params))
    _load_leaves(os.path.join(path, "opt_state.npz"), _leaves(opt_state))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta


def skip_position(meta: Dict, nbatches: int) -> Tuple[int, int]:
    """skip_upto_epoch / skip_upto_batch from a restored checkpoint
    (dlrm_s_pytorch.py:1838-1839,1854-1855): resume after the saved
    iteration within the saved epoch."""
    it = meta.get("iteration", 0)
    ep = meta.get("epoch", 0)
    if nbatches and it >= nbatches:
        return ep + it // nbatches, it % nbatches
    return ep, it
