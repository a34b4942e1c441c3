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


def matmul_f32_out(a: torch.Tensor, w: torch.Tensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """``a @ w`` with both operands rounded to compute_dtype and an f32
    product (the JAX ``preferred_element_type=f32`` dot)."""
    if compute_dtype == torch.float32:
        return a.float() @ w.float()
    ac, wc = a.to(compute_dtype), w.to(compute_dtype)
    if a.device.type == "cuda":
        return torch.mm(ac, wc, out_dtype=torch.float32)
    return ac.float() @ wc.float()


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
        y = matmul_f32_out(x, w, compute_dtype) + b.float()
        if i == n_layers - 1 and skip_last_activation:
            return y
        x = torch.sigmoid(y) if i == sigmoid_layer else torch.relu(y)
    return x
