"""MLP towers (bottom / top).

The port of ``dlrm_yx_tpu/ops/mlp.py``: Linear+ReLU stacks with a sigmoid at
one configurable layer, weights stored ``[in, out]`` (``y = x @ W + b``),
and the reference's numpy init drawn in the same order as the JAX package.

bf16 compute follows the JAX package exactly: x and W are rounded to bf16,
their product accumulates in f32 and comes out f32, and the f32 bias is
added. A plain ``a.bfloat16() @ w.bfloat16()`` would return bf16 and round
every layer's output, drifting from JAX. On the card the product is one
bf16 tensor-core GEMM with f32 output (``torch.mm(..., out_dtype=f32)``);
on the CPU, where that overload is missing, the rounded operands are
multiplied in f32, which is exact per product.

The ``out_dtype`` overload has no derivative in PyTorch (2.11: "derivative
for aten::mm is not implemented"), so on the card the product is the
autograd Function ``_F32OutProduct``: its backward takes ``g @ bᵀ`` and
``aᵀ @ g`` as bf16 GEMMs with f32 output and rounds each gradient to bf16,
where JAX's transpose of the dot rounds it; the ``.to(bf16)`` casts then
carry it back to f32 as autograd does on the CPU.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def init_mlp(
    rng: np.random.RandomState, ln: Sequence[int]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """For each layer (n -> m): W ~ N(0, sqrt(2/(m+n))) shape [n, m], then
    b ~ N(0, sqrt(1/m)) shape [m] — the JAX package's draw order."""
    layers = []
    for i in range(len(ln) - 1):
        n, m = int(ln[i]), int(ln[i + 1])
        w = rng.normal(0.0, np.sqrt(2.0 / (m + n)), size=(n, m)).astype(np.float32)
        b = rng.normal(0.0, np.sqrt(1.0 / m), size=(m,)).astype(np.float32)
        layers.append((w, b))
    return layers


class _F32OutProduct(torch.autograd.Function):
    """``a @ b`` of bf16 operands (2-D, or 3-D batched) with an f32 product
    on the card's tensor cores, differentiable."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mm = torch.mm if a.dim() == 2 else torch.bmm
        g16 = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = mm(g16, b.transpose(-1, -2), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = mm(a.transpose(-1, -2), g16, out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def product_f32_out(ac: torch.Tensor, bc: torch.Tensor) -> torch.Tensor:
    """The f32 product of operands already rounded to the compute dtype
    (the JAX ``preferred_element_type=f32`` dot): on the card one GEMM with
    f32 output, on the CPU the rounded operands multiplied in f32 (exact
    per product)."""
    if ac.dtype == torch.float32 or ac.device.type == "cpu":
        return ac.float() @ bc.float()
    return _F32OutProduct.apply(ac, bc)


def apply_mlp(
    x: torch.Tensor,
    layers,
    sigmoid_layer: int = -1,
    compute_dtype: torch.dtype = torch.float32,
    skip_last_activation: bool = False,
) -> torch.Tensor:
    """Run the tower. Each layer is ReLU except index ``sigmoid_layer``
    (sigmoid); ``skip_last_activation`` returns the last layer's raw
    logits (the sigmoid is folded into the loss / prediction)."""
    n_layers = len(layers)
    for i, (w, b) in enumerate(layers):
        y = product_f32_out(x.to(compute_dtype), w.to(compute_dtype)) + b.float()
        if i == n_layers - 1 and skip_last_activation:
            return y
        x = torch.sigmoid(y) if i == sigmoid_layer else torch.relu(y)
    return x
