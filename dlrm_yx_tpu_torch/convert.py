"""Carry parameters and optimizer state across between the JAX package and
the port, both ways.

``params_from_jax`` takes the JAX parameter pytree as numpy (``bot`` /
``top`` lists of ``(W [in, out], b)``, ``emb`` physical stores per group)
and returns the port's parameter dict on ``device``. Packed stores (dims
below 128 that divide it) are unpacked to logical ``[total_rows, dim]``
rows with ``unpack_store``, a row-major reshape. The port keeps the group
layout, so the stores carry over element by element.

``opt_state_from_jax`` does the same for the optimizer state of
``dlrm_yx_tpu.optim.optimizer.init_opt_state``: the dense Adagrad
accumulators, and per group either Adagrad's per-element accumulator
(unpacked like its store) or RWSAdagrad's 1-D per-row momentum, whose
``acc_len`` padding the port keeps.

``params_to_jax`` and ``opt_state_to_jax`` go the other way: numpy trees in
the JAX package's layout, the stores packed again with ``pack_store`` (the
inverse reshape). A bf16 tensor becomes a raw 16-bit array of dtype
``V2``: the bytes, and the dtype descriptor, that ``np.savez`` records for
an ``ml_dtypes.bfloat16`` array (``view(ml_dtypes.bfloat16)`` gives JAX its
array). The port reads either form back.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.models.dlrm import check_supported, model_groups
from dlrm_yx_tpu_torch.ops.embedding import pack_store, unpack_store
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len
from dlrm_yx_tpu_torch.utils.device import resolve_device


# raw 16-bit elements: np.savez's record of an ml_dtypes.bfloat16 array
BF16_BYTES = np.dtype("V2")


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    # ml_dtypes' bfloat16, or its raw bytes read back from an npz: torch takes the bits
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BYTES:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BYTES)
    return t.numpy()


def params_from_jax(np_params: Dict, cfg: DLRMConfig,
                    device: Optional[Union[str, torch.device]] = None) -> Dict:
    check_supported(cfg)
    if np_params.get("vw") is not None or "qr" in np_params or "md_proj" in np_params:
        raise NotImplementedError(
            "weighted pooling, QR and MD parameters are not yet ported"
        )
    dev = resolve_device(device)
    groups = model_groups(cfg)
    if len(np_params["emb"]) != len(groups):
        raise ValueError(
            f"{len(np_params['emb'])} stores for {len(groups)} table groups"
        )
    return {
        "bot": [(_tensor(w, dev), _tensor(b, dev)) for w, b in np_params["bot"]],
        "top": [(_tensor(w, dev), _tensor(b, dev)) for w, b in np_params["top"]],
        "emb": [
            _tensor(unpack_store(np.asarray(s), g), dev)
            for s, g in zip(np_params["emb"], groups)
        ],
    }


def opt_state_from_jax(np_state: Dict, opt: OptConfig, cfg: DLRMConfig,
                       device: Optional[Union[str, torch.device]] = None) -> Dict:
    if opt.name == "sgd":
        return {}
    if any(k in np_state for k in ("vw", "qr", "md_proj")):
        raise NotImplementedError(
            "weighted pooling, QR and MD optimizer state is not yet ported"
        )
    dev = resolve_device(device)
    groups = model_groups(cfg)
    dense = {
        k: [(_tensor(aw, dev), _tensor(ab, dev)) for aw, ab in np_state["dense"][k]]
        for k in ("bot", "top")
    }
    emb = []
    for a, g in zip(np_state["emb"], groups):
        a = np.asarray(a)
        if opt.name == "adagrad":
            emb.append(_tensor(unpack_store(a, g), dev))
        elif a.shape != (acc_len(g.total_rows),):
            raise ValueError(f"row momentum of shape {a.shape} for a group of "
                             f"{g.total_rows} rows")
        else:
            emb.append(_tensor(a, dev))
    return {"dense": dense, "emb": emb}


def params_to_jax(params: Dict, cfg: DLRMConfig) -> Dict:
    """The port's parameter dict as the JAX package's numpy pytree: ``bot``
    / ``top`` lists of ``(W [in, out], b)``, ``emb`` physical (packed)
    stores per group, and ``vw`` None (weighted pooling is not ported)."""
    check_supported(cfg)
    groups = model_groups(cfg)
    if len(params["emb"]) != len(groups):
        raise ValueError(f"{len(params['emb'])} stores for {len(groups)} table groups")
    return {
        "bot": [(_array(w), _array(b)) for w, b in params["bot"]],
        "top": [(_array(w), _array(b)) for w, b in params["top"]],
        "emb": [pack_store(_array(s), g) for s, g in zip(params["emb"], groups)],
        "vw": None,
    }


def opt_state_to_jax(state: Dict, cfg: DLRMConfig) -> Dict:
    """The port's optimizer state as the JAX package's numpy pytree: ``{}``
    for SGD; else the dense accumulators and per group Adagrad's
    per-element accumulator (packed like its store) or RWSAdagrad's 1-D row
    momentum (``acc_len`` long, as it is)."""
    if not state:
        return {}
    groups = model_groups(cfg)
    dense = {k: [(_array(aw), _array(ab)) for aw, ab in state["dense"][k]]
             for k in ("bot", "top")}
    emb = [pack_store(_array(a), g) if a.dim() == 2 else _array(a)
           for a, g in zip(state["emb"], groups)]
    return {"dense": dense, "emb": emb}
