"""Row-wise quantized embedding tables (int8 / int4) and dynamically
quantized MLP towers, for inference.

The port of ``dlrm_yx_tpu/ops/quantized.py`` (the reference's
``--quantize-emb-with-bit`` / ``--quantize-mlp-with-bit``,
``dlrm_s_pytorch.py:549-576,1757-1781``). Each table row is stored
quantized with its own scale and bias:

    q[i, j] = clip(round((w[i, j] - min_i) / scale_i), 0, 2^bits - 1)
    scale_i = max((max_i - min_i) / (2^bits - 1), 1e-12);  w ~ q * scale_i + min_i

int4 packs two values a byte, low nibble first. A lookup gathers the
quantized rows, dequantizes them in f32 and sum-pools. The quantization
runs with torch ops on the device that holds the stores, in f32 with
round-half-to-even, so the card gives JAX's numpy result bit for bit.

The JAX package also keeps a 128-lane re-laid copy of each store
(``fuse_qstore``, ``dequantize_fused_rows``): the TPU gathers fast only at
that row width. The port serves every dim from the natural ``[R, cols]``
uint8 store and the ``[R, 1]`` f32 scale and bias; the values are the same.

The towers (``QuantizedMLP``): ``int8`` stores per-output-channel symmetric
int8 weights and quantizes the activations with one scale over the whole
batch, as ``quantize_dynamic`` does; the int8 x int8 product accumulates in
int32, exactly as JAX's ``preferred_element_type=int32`` dot. ``fp16``
stores f16 weights and multiplies their bf16 rounding with the bf16-rounded
activations into f32, as the JAX package does (a second rounding, kept).

Every step here is torch work, no kernel of the port: the JAX package
serves it with XLA outside any Pallas kernel (its interaction and towers at
their ``xla`` / f32 defaults in the fully quantized step).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from dlrm_yx_tpu_torch.config import DLRMConfig, refuse_dcn_and_bags
from dlrm_yx_tpu_torch.models.dlrm import assemble_slots, forward_from_pooled, group_indices
from dlrm_yx_tpu_torch.ops.embedding import TableGroup, device_ints
from dlrm_yx_tpu_torch.ops.interaction import interact_features
from dlrm_yx_tpu_torch.ops.losses import predictions_from_logits
from dlrm_yx_tpu_torch.ops.mlp import apply_mlp, product_f32_out
from dlrm_yx_tpu_torch.train.capture import eval_step
from dlrm_yx_tpu_torch.utils.device import resolve_device

# rows quantized a pass: the temporaries of a pass stay near 0.5 GB at dim 128
QUANT_CHUNK_ROWS = 1 << 20
def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` by IEEE division, as numpy and XLA divide: PyTorch's CUDA
    kernels divide by a host scalar as a product with its reciprocal,
    which can differ in the last bit. The divisor is filled on the device
    (capturable in a CUDA graph)."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


# the inner length up to which an f32 product of int8 values is exact: every
# partial sum is an integer of at most K * 127^2 < 2^24 in magnitude
EXACT_F32_K = (1 << 24) // (127 * 127)


@dataclasses.dataclass
class QuantizedStore:
    data: torch.Tensor    # [R, dim] uint8 (int8 mode) or [R, dim // 2] uint8 (int4)
    scale: torch.Tensor   # [R, 1] float32
    bias: torch.Tensor    # [R, 1] float32 (the row min)
    bits: int
    dim: int


def quantize_store(store: torch.Tensor, bits: int = 8) -> QuantizedStore:
    """Row-wise affine quantization of a [R, dim] store (any float dtype,
    read as f32), on the store's device, ``QUANT_CHUNK_ROWS`` rows a pass.
    int4 raises ``ValueError`` on an odd dim, as the JAX package does."""
    if bits not in (4, 8):
        raise ValueError("bits must be 4 or 8")
    r, dim = store.shape
    if bits == 4 and dim % 2:
        raise ValueError("int4 requires even dim")
    qmax = (1 << bits) - 1
    cols = dim if bits == 8 else dim // 2
    data = torch.empty((r, cols), dtype=torch.uint8, device=store.device)
    scale = torch.empty((r, 1), dtype=torch.float32, device=store.device)
    bias = torch.empty((r, 1), dtype=torch.float32, device=store.device)
    for r0 in range(0, r, QUANT_CHUNK_ROWS):
        r1 = min(r, r0 + QUANT_CHUNK_ROWS)
        w = store[r0:r1].float()
        lo = w.amin(dim=1, keepdim=True)
        hi = w.amax(dim=1, keepdim=True)
        s = torch.clamp_min(_div(hi - lo, qmax), 1e-12)
        q = torch.clamp(torch.round((w - lo) / s), 0, qmax).to(torch.uint8)
        if bits == 4:
            q = q[:, 0::2] | (q[:, 1::2] << 4)
        data[r0:r1] = q
        scale[r0:r1] = s
        bias[r0:r1] = lo
    return QuantizedStore(data=data, scale=scale, bias=bias, bits=bits, dim=dim)


def dequantize_rows(qs: QuantizedStore, row_ids: torch.Tensor) -> torch.Tensor:
    """Gather and dequantize rows: row_ids [...] -> [..., dim] f32."""
    flat = row_ids.reshape(-1)
    q = qs.data.index_select(0, flat)
    if qs.bits == 4:
        lo = (q & 0xF).float()
        hi = (q >> 4).float()
        vals = torch.stack([lo, hi], dim=-1).reshape(flat.shape[0], qs.dim)
    else:
        vals = q.float()
    rows = vals * qs.scale.index_select(0, flat) + qs.bias.index_select(0, flat)
    return rows.reshape(*row_ids.shape, qs.dim)


def quantized_lookup_group(
    qs: QuantizedStore,
    row_offsets: Sequence[int],
    indices: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Pooled-sum lookup on a quantized group store: indices / weights
    [T, B, L] -> [T, B, dim] f32 (``ops.embedding.lookup_group``'s
    contract). Like the JAX package's, it takes no pooling weights v_W:
    a learned v_W is not applied when serving quantized (ROADMAP Queue C)."""
    t, b, l = indices.shape
    offs = device_ints(tuple(row_offsets), indices.device)
    gidx = (indices + offs[:, None, None]).reshape(t, b * l)
    rows = dequantize_rows(qs, gidx).reshape(t, b, l, qs.dim)
    if l == 1:
        return rows[:, :, 0, :] * weights[:, :, 0][..., None]
    return torch.einsum("tbl,tbld->tbd", weights, rows)


def quantize_model_embeddings(params: dict, groups: Sequence[TableGroup],
                              bits: int = 8) -> List[QuantizedStore]:
    """Quantize every group store, on its device (the reference's
    quantize_embedding; the caller keeps or drops the float stores). The
    port's stores are logical ``[total_rows, dim]`` rows already."""
    if len(params["emb"]) != len(groups):
        raise ValueError(f"{len(params['emb'])} stores for {len(groups)} table groups")
    return [quantize_store(store, bits) for store in params["emb"]]


@dataclasses.dataclass
class QuantizedMLP:
    """A dynamically quantized tower: ``layers`` of (qw [n, m], w_scale [m]
    or None, b [m]); ``mode`` 'int8' (int8 qw, f32 per-output-channel
    scales) or 'fp16' (f16 qw, no scale)."""

    layers: List[Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]]
    mode: str


def quantize_mlp(layers, mode: str = "int8") -> QuantizedMLP:
    """Post-training quantization of [(W [n, m], b [m])] f32 layers, on
    their device."""
    out = []
    for w, b in layers:
        w = w.float()
        b = b.float()
        if mode == "int8":
            scale = torch.clamp_min(_div(w.abs().amax(dim=0), 127.0), 1e-12)
            qw = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
            out.append((qw, scale, b.clone()))
        elif mode == "fp16":
            out.append((w.to(torch.float16), None, b.clone()))
        else:
            raise ValueError(f"unknown MLP quant mode {mode!r}")
    return QuantizedMLP(layers=out, mode=mode)


def int_product(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The int32 product of int-valued operands in [-127, 127] (qx [B, K]
    f32, qw [K, M] int8): f32 products over slices of at most
    ``EXACT_F32_K`` of the inner length, each exact (TF32 is off on the
    card), summed in int32. It equals JAX's int32-accumulated int8 dot."""
    k = qx.shape[1]
    acc = None
    for k0 in range(0, k, EXACT_F32_K):
        k1 = min(k, k0 + EXACT_F32_K)
        part = (qx[:, k0:k1] @ qw[k0:k1].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def apply_quantized_mlp(
    x: torch.Tensor,
    qmlp: QuantizedMLP,
    sigmoid_layer: int = -1,
    skip_last_activation: bool = False,
) -> torch.Tensor:
    """Inference forward through a quantized tower (``ops.mlp.apply_mlp``'s
    contract). In int8 mode the activation scale is one max over the whole
    [B, n] input, kept on the device (no host read, so the step captures):
    a prediction depends on the rest of its batch, as in the JAX package."""
    n_layers = len(qmlp.layers)
    for i, (qw, w_scale, b) in enumerate(qmlp.layers):
        if qmlp.mode == "int8":
            x_scale = torch.clamp_min(_div(x.abs().amax(), 127.0), 1e-12)
            qx = torch.clamp(torch.round(x / x_scale), -127, 127)
            acc = int_product(qx, qw).float()
            y = acc * (x_scale * w_scale) + b
        else:  # f16 storage, bf16 products into f32
            y = product_f32_out(x.to(torch.bfloat16), qw.to(torch.bfloat16)) + b
        if i == n_layers - 1 and skip_last_activation:
            return y
        x = torch.sigmoid(y) if i == sigmoid_layer else torch.relu(y)
    return x


def _pooled(groups: Sequence[TableGroup], qstores: Sequence[QuantizedStore], b):
    return [quantized_lookup_group(qs, g.row_offsets, group_indices(g, b.indices),
                                   group_indices(g, b.weights))
            for g, qs in zip(groups, qstores)]


def make_fully_quantized_eval_step(
    config: DLRMConfig,
    groups: Sequence[TableGroup],
    qstores: Sequence[QuantizedStore],
    qbot: Optional[QuantizedMLP] = None,
    qtop: Optional[QuantizedMLP] = None,
    device: Optional[Union[str, torch.device]] = None,
    capture: Optional[bool] = None,
):
    """Inference with quantized tables and, optionally, quantized towers
    (a tower without one takes its float params): eval(params, batch) ->
    predictions [B, 1]. As in the JAX package the interaction and the
    float towers run at their defaults, the plain dot interaction in f32,
    whatever the model's compute dtype and interaction impl; slots are
    assembled without QR pooled vectors or MD projections, so a QR model
    raises ``KeyError`` and a mixed-dimension one ``TypeError`` there, as
    in the JAX package (ROADMAP Queue C). DLRM-DCNv2 (``dcn``, multi-hot
    bags) raises ``NotImplementedError``."""
    refuse_dcn_and_bags(config, "quantized serving")
    dev = resolve_device(device)

    def body(params, b):
        pooled = _pooled(groups, qstores, b)
        if qbot is not None:
            x = apply_quantized_mlp(b.dense, qbot, config.sigmoid_bot)
        else:
            x = apply_mlp(b.dense, params["bot"], config.sigmoid_bot)
        ly = assemble_slots(pooled, groups, config)
        z = interact_features(x, ly, config.interaction, config.interact_itself)
        if qtop is not None:
            logits = apply_quantized_mlp(z, qtop, config.sigmoid_top, skip_last_activation=True)
        else:
            logits = apply_mlp(z, params["top"], config.sigmoid_top, skip_last_activation=True)
        return predictions_from_logits(logits, config.loss_threshold)

    return eval_step(body, dev, capture)


def make_quantized_eval_step(
    config: DLRMConfig,
    groups: Sequence[TableGroup],
    qstores: Sequence[QuantizedStore],
    device: Optional[Union[str, torch.device]] = None,
    capture: Optional[bool] = None,
):
    """Inference with quantized tables and the model's float towers, at its
    compute dtype and interaction impl (``forward_from_pooled``):
    eval(params, batch) -> predictions [B, 1]. DLRM-DCNv2 (``dcn``,
    multi-hot bags) raises ``NotImplementedError``."""
    refuse_dcn_and_bags(config, "quantized serving")
    dev = resolve_device(device)

    def body(params, b):
        logits = forward_from_pooled(params, config, groups, b.dense, _pooled(groups, qstores, b))
        return predictions_from_logits(logits, config.loss_threshold)

    return eval_step(body, dev, capture)
