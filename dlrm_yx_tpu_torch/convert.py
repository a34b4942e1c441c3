"""Carry parameters and optimizer state across from the JAX package.

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
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.models.dlrm import check_supported, model_groups
from dlrm_yx_tpu_torch.ops.embedding import unpack_store
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len
from dlrm_yx_tpu_torch.utils.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch takes its bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
