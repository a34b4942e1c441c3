"""DLRM-DCNv2's low-rank cross network.

TorchRec's ``LowRankCrossNet`` (``torchrec/modules/crossnet.py``), the
interaction of the MLPerf DLRM-DCNv2 reference (``--interaction_type=dcn``,
``--dcn_num_layers``, ``--dcn_low_rank_dim``). With ``x0`` the
concatenated features [B, F*D] (the bottom MLP's output, then each
table's pooled vector), layer ``l`` computes

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

where ``V_l`` maps the width N = F*D to the rank r, with no bias, and
``W_l`` maps r back to N, with the bias ``b_l`` [N]. The port keeps each
layer as ``(V [N, r], W [r, N], b [N])``, products ``x @ V`` and
``(x V) @ W`` as the towers keep ``x @ W`` (``ops/mlp.py``): TorchRec's
``V_kernels`` [r, N] and ``W_kernels`` [N, r] transposed.

The products take the towers' mixed-precision rule
(``mlp.product_f32_out``): operands rounded to the compute dtype, an f32
product, so in bf16 each is one tensor-core GEMM with f32 output on the
card, and its backward two more. The bias, the Hadamard product with
``x0`` and the residual stay in f32.

Init as TorchRec's: V and W Xavier-normal (std sqrt(2 / (N + r)) for
both), b zero, drawn V then W a layer, layer by layer.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from dlrm_yx_tpu_torch.ops.mlp import product_f32_out


def init_dcn(rng: np.random.RandomState, width: int, rank: int,
             num_layers: int) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """[(V [width, rank], W [rank, width], b [width])] f32 for each layer."""
    std = np.sqrt(2.0 / (width + rank))
    layers = []
    for _ in range(num_layers):
        v = rng.normal(0.0, std, size=(width, rank)).astype(np.float32)
        w = rng.normal(0.0, std, size=(rank, width)).astype(np.float32)
        layers.append((v, w, np.zeros(width, np.float32)))
    return layers


def cross_net(x0: torch.Tensor, layers: Sequence, compute_dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """x0 [B, N] f32 through the cross layers ``(V, W, b)`` -> [B, N] f32."""
    x = x0
    for v, w, b in layers:
        xv = product_f32_out(x.to(compute_dtype), v.to(compute_dtype))
        xw = product_f32_out(xv.to(compute_dtype), w.to(compute_dtype))
        x = x0 * (xw + b.float()) + x
    return x
