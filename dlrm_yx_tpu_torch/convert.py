"""Carry parameters and optimizer state across between the JAX package and
the port, both ways.

``params_from_jax`` takes the JAX parameter pytree as numpy (``bot`` /
``top`` lists of ``(W [in, out], b)``, ``emb`` physical stores per group)
and returns the port's parameter dict on ``device``. Packed stores (dims
below 128 that divide it) are unpacked to logical ``[total_rows, dim]``
rows with ``unpack_store``, a row-major reshape. The port keeps the group
layout, so the stores carry over element by element. The variants' leaves
carry over as they are: ``vw`` (per group ``[total_rows]``, or None),
``qr`` (per QR table its quotient and remainder tables, natural layout)
and ``md_proj`` (per MD table ``[dim, base_dim]``).

``opt_state_from_jax`` does the same for the optimizer state of
``dlrm_yx_tpu.optim.optimizer.init_opt_state``: the dense Adagrad
accumulators, and per group either Adagrad's per-element accumulator
(unpacked like its store) or RWSAdagrad's 1-D per-row momentum, whose
``acc_len`` padding the port keeps; and, where the model has them, the
accumulators of ``vw``, ``qr`` and ``md_proj``, as they are.

``params_to_jax`` and ``opt_state_to_jax`` go the other way: numpy trees in
the JAX package's layout, the stores packed again with ``pack_store`` (the
inverse reshape). A bf16 tensor becomes a raw 16-bit array of dtype
``V2``: the bytes, and the dtype descriptor, that ``np.savez`` records for
an ``ml_dtypes.bfloat16`` array (``view(ml_dtypes.bfloat16)`` gives JAX its
array). The port reads either form back.

``qstores_from_jax`` and ``qmlp_from_jax`` carry the JAX package's
quantized serving state (``dlrm_yx_tpu.ops.quantized``'s ``QuantizedStore``
list and ``QuantizedMLP``, their arrays read as numpy) into the port's
``ops.quantized`` types, element by element.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.models.dlrm import model_groups
from dlrm_yx_tpu_torch.ops.embedding import pack_store, unpack_store
from dlrm_yx_tpu_torch.ops.quantized import QuantizedMLP, QuantizedStore
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


def _variant_leaves(tree: Dict, conv) -> Dict:
    """``vw``, ``qr`` and ``md_proj`` of a JAX or port tree, each leaf
    through ``conv``; ``vw`` None when absent, the others only when
    present (the JAX package's keys)."""
    out = {"vw": None if tree.get("vw") is None else [conv(v) for v in tree["vw"]]}
    if "qr" in tree:
        out["qr"] = [(conv(q), conv(r)) for q, r in tree["qr"]]
    if "md_proj" in tree:
        out["md_proj"] = [conv(w) for w in tree["md_proj"]]
    return out


def params_from_jax(np_params: Dict, cfg: DLRMConfig,
                    device: Optional[Union[str, torch.device]] = None) -> Dict:
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
        **_variant_leaves(np_params, lambda a: _tensor(a, dev)),
    }


def opt_state_from_jax(np_state: Dict, opt: OptConfig, cfg: DLRMConfig,
                       device: Optional[Union[str, torch.device]] = None) -> Dict:
    if opt.name == "sgd":
        return {}
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
    state = {"dense": dense, "emb": emb,
             **_variant_leaves(np_state, lambda a: _tensor(a, dev))}
    if state["vw"] is None:
        del state["vw"]
    return state


def params_to_jax(params: Dict, cfg: DLRMConfig) -> Dict:
    """The port's parameter dict as the JAX package's numpy pytree: ``bot``
    / ``top`` lists of ``(W [in, out], b)``, ``emb`` physical (packed)
    stores per group, ``vw`` (None without weighted pooling) and, where the
    model has them, ``qr`` and ``md_proj``."""
    groups = model_groups(cfg)
    if len(params["emb"]) != len(groups):
        raise ValueError(f"{len(params['emb'])} stores for {len(groups)} table groups")
    return {
        "bot": [(_array(w), _array(b)) for w, b in params["bot"]],
        "top": [(_array(w), _array(b)) for w, b in params["top"]],
        "emb": [pack_store(_array(s), g) for s, g in zip(params["emb"], groups)],
        **_variant_leaves(params, _array),
    }


def opt_state_to_jax(state: Dict, cfg: DLRMConfig) -> Dict:
    """The port's optimizer state as the JAX package's numpy pytree: ``{}``
    for SGD; else the dense accumulators, per group Adagrad's
    per-element accumulator (packed like its store) or RWSAdagrad's 1-D row
    momentum (``acc_len`` long, as it is), and the accumulators of ``vw``,
    ``qr`` and ``md_proj`` where the state has them."""
    if not state:
        return {}
    groups = model_groups(cfg)
    dense = {k: [(_array(aw), _array(ab)) for aw, ab in state["dense"][k]]
             for k in ("bot", "top")}
    emb = [pack_store(_array(a), g) if a.dim() == 2 else _array(a)
           for a, g in zip(state["emb"], groups)]
    out = {"dense": dense, "emb": emb, **_variant_leaves(state, _array)}
    if out["vw"] is None:
        del out["vw"]
    return out


def qstores_from_jax(qstores: Sequence, device: Optional[Union[str, torch.device]] = None
                     ) -> List[QuantizedStore]:
    """The JAX package's quantized group stores (``data`` uint8, ``scale``
    and ``bias`` [R, 1] f32, ``bits``, ``dim``) as the port's, on
    ``device``."""
    dev = resolve_device(device)
    return [QuantizedStore(data=_tensor(q.data, dev), scale=_tensor(q.scale, dev),
                           bias=_tensor(q.bias, dev), bits=int(q.bits), dim=int(q.dim))
            for q in qstores]


def qmlp_from_jax(qmlp, device: Optional[Union[str, torch.device]] = None) -> QuantizedMLP:
    """The JAX package's quantized tower (layers of ``(qw, w_scale or None,
    b)``, ``mode``) as the port's, on ``device``."""
    dev = resolve_device(device)
    return QuantizedMLP(
        layers=[(_tensor(qw, dev), None if s is None else _tensor(s, dev), _tensor(b, dev))
                for qw, s, b in qmlp.layers],
        mode=qmlp.mode)
