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

``hybrid_params_from_jax`` / ``hybrid_opt_state_from_jax`` take the JAX
package's hybrid-parallel pytrees (``parallel/hybrid.py``) as numpy, the
stores ``[M, r_pad / pack, dim * pack]`` and RWSAdagrad's momenta flat over
the M shards, and return one rank's (model index ``m``) port tensors: its
stores as logical ``[r_pad, dim]`` rows, its ``acc_len``-long momentum.
``hybrid_params_to_jax`` / ``hybrid_opt_state_to_jax`` go back from the M
model shards' trees (one rank of each model index) to the whole pytrees.
The variants' leaves go with them: ``vw`` / ``vw_small`` (``[M, r_pad]``,
sharded like the stores), ``qr_r`` and ``md_proj`` (replicated).

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
    """``vw``, ``qr``, ``md_proj`` and ``dcn`` of a JAX or port tree, each
    leaf through ``conv``; ``vw`` None when absent, the others only when
    present (the JAX package's keys; ``dcn``, DLRM-DCNv2's cross layers
    ``(V, W, b)``, is the port's own)."""
    out = {"vw": None if tree.get("vw") is None else [conv(v) for v in tree["vw"]]}
    if "qr" in tree:
        out["qr"] = [(conv(q), conv(r)) for q, r in tree["qr"]]
    if "md_proj" in tree:
        out["md_proj"] = [conv(w) for w in tree["md_proj"]]
    if "dcn" in tree:
        out["dcn"] = [tuple(conv(p) for p in layer) for layer in tree["dcn"]]
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


def _towers(tree, conv):
    return {k: [(conv(w), conv(b)) for w, b in tree[k]] for k in ("bot", "top")}


def _hybrid_variant_leaves(tree: Dict, conv, model_index=None, stack=None) -> Dict:
    """A hybrid tree's variant leaves through ``conv``: ``vw`` / ``vw_small``
    (sharded over "model": row ``model_index`` of the whole ``[M, r]``
    arrays, or ``stack`` of the shards' vectors), ``qr_r`` and ``md_proj``
    (replicated); only where the tree has them."""
    out = {}
    for key in ("vw", "vw_small"):
        if tree.get(key) is not None:
            v = tree[key]
            out[key] = conv(np.asarray(v)[model_index]) if stack is None else stack(key)
    if "qr_r" in tree:
        out["qr_r"] = conv(tree["qr_r"])
    if "md_proj" in tree:
        out["md_proj"] = [conv(w) for w in tree["md_proj"]]
    return out


def hybrid_params_from_jax(np_params: Dict, plan, model_index: int,
                           device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Shard ``model_index`` of the JAX package's hybrid params (numpy) as the
    port's rank params on ``device``."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a, dev)  # noqa: E731
    out = _towers(np_params, conv)
    for key, rows in (("emb", plan.r_big_pad), ("emb_small", plan.r_small_pad)):
        out[key] = conv(np.asarray(np_params[key])[model_index].reshape(rows, plan.dim))
    out["vw"] = None
    out.update(_hybrid_variant_leaves(np_params, conv, model_index))
    return out


def hybrid_opt_state_from_jax(np_state: Dict, opt: OptConfig, plan, model_index: int,
                              device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Shard ``model_index`` of the JAX package's hybrid optimizer state."""
    if opt.name == "sgd":
        return {}
    dev = resolve_device(device)
    conv = lambda a: _tensor(a, dev)  # noqa: E731
    state = {"dense": _towers(np_state["dense"], conv)}
    for key, rows in (("emb", plan.r_big_pad), ("emb_small", plan.r_small_pad)):
        a = np.asarray(np_state[key])
        if opt.name == "adagrad":
            state[key] = conv(a[model_index].reshape(rows, plan.dim))
        else:
            n = acc_len(rows)
            if a.shape != (plan.n_model * n,):
                raise ValueError(f"row momentum of shape {a.shape} for {plan.n_model} shards "
                                 f"of {rows} rows")
            state[key] = conv(a[model_index * n:(model_index + 1) * n])
    state.update(_hybrid_variant_leaves(np_state, conv, model_index))
    return state


def hybrid_params_to_jax(shards: Sequence[Dict], plan) -> Dict:
    """The JAX package's hybrid params (numpy) from the M model shards'
    rank params (in model order; the replicated leaves are the first's)."""
    out = _towers(shards[0], _array)
    for key in ("emb", "emb_small"):
        phys = plan.store_shape("big" if key == "emb" else "small")
        out[key] = np.stack([_array(s[key]).reshape(phys) for s in shards])
    out["vw"] = None
    out.update(_hybrid_variant_leaves(
        shards[0], _array, stack=lambda k: np.stack([_array(s[k]) for s in shards])))
    return out


def hybrid_opt_state_to_jax(shards: Sequence[Dict], plan) -> Dict:
    """The JAX package's hybrid optimizer state from the M model shards'."""
    if not shards[0]:
        return {}
    out = {"dense": _towers(shards[0]["dense"], _array)}
    for key in ("emb", "emb_small"):
        if shards[0][key].dim() == 1:
            out[key] = np.concatenate([_array(s[key]) for s in shards])
        else:
            phys = plan.store_shape("big" if key == "emb" else "small")
            out[key] = np.stack([_array(s[key]).reshape(phys) for s in shards])
    out.update(_hybrid_variant_leaves(
        shards[0], _array, stack=lambda k: np.stack([_array(s[k]) for s in shards])))
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
