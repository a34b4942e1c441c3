"""Feature interaction (dot / cat).

The port of ``dlrm_yx_tpu/ops/interaction.py``, semantics of the
reference's ``interact_features`` (``dlrm_s_pytorch.py:627-673``):
  dot: T = concat([x] + slots) -> (B, F, D); Z = T @ T^T; take the strict
       lower triangle (offset -1; offset 0 when interact_itself) in
       torch.tril_indices (row-major) order; concat with the dense x.
  cat: plain concatenation.

``impl="pallas"`` (the JAX package's name for the fused path, kept so one
config drives both packages) routes eligible dot interactions to
``ops/fused_interaction.py`` by the JAX package's shape rule: D a multiple
of 128 and B a multiple of 64. The choice is made from the shapes before
any launch; other shapes take the plain formulation below.
"""

from __future__ import annotations

import numpy as np
import torch

from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
from dlrm_yx_tpu_torch.ops.mlp import product_f32_out


def tril_flat_indices(f: int, offset: int) -> np.ndarray:
    """Flattened indices into a row-major [f, f] matrix selecting the lower
    triangle with the given diagonal offset, in torch.tril_indices order."""
    li, lj = np.tril_indices(f, k=offset)
    return (li * f + lj).astype(np.int32)


def fused_eligible(op: str, b: int, d: int) -> bool:
    return op == "dot" and d % 128 == 0 and b % 64 == 0


def interact_features(
    x: torch.Tensor,
    ly: torch.Tensor,
    op: str = "dot",
    interact_itself: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "xla",
) -> torch.Tensor:
    """x: [B, D] dense feature (bottom MLP output); ly: [B, S, D] pooled
    slots. Returns [B, ln_top[0]]."""
    b, d = x.shape
    if impl == "pallas" and fused_eligible(op, b, d):
        return fused_interaction(x, ly, interact_itself, compute_dtype)
    t = torch.cat([x[:, None, :], ly], dim=1)  # [B, F, D]
    if op == "dot":
        f = t.shape[1]
        tc = t.to(compute_dtype)
        z = product_f32_out(tc, tc.transpose(1, 2))
        li, lj = torch.tril_indices(f, f, 0 if interact_itself else -1,
                                    device=x.device)
        return torch.cat([x, z[:, li, lj]], dim=1)
    if op == "cat":
        return t.reshape(b, -1)
    raise ValueError(f"unknown interaction op {op!r}")
