"""Losses: BCE / MSE / weighted-BCE, with optional prediction clamping.

The port of ``dlrm_yx_tpu/ops/losses.py``: BCE from logits in the stable
log-sigmoid form; with ``loss_threshold > 0`` the probabilities are clamped
to [thr, 1-thr] first, as the reference does (``dlrm_s_pytorch.py:722-728``);
wbce gathers a per-class weight by label.
"""

from __future__ import annotations

import torch


def predictions_from_logits(logits: torch.Tensor, loss_threshold: float = 0.0) -> torch.Tensor:
    p = torch.sigmoid(logits)
    if loss_threshold > 0.0:
        p = p.clamp(loss_threshold, 1.0 - loss_threshold)
    return p


def loss_fn(
    logits: torch.Tensor,
    targets: torch.Tensor,
    loss: str = "bce",
    loss_threshold: float = 0.0,
    wbce_weights=(1.0, 1.0),
) -> torch.Tensor:
    """Mean loss over the batch. logits: [B, 1]; targets: [B, 1] in [0, 1]."""
    t = targets.float()
    if loss == "mse":
        p = predictions_from_logits(logits, loss_threshold)
        return torch.mean((p - t) ** 2)

    if loss_threshold > 0.0:
        p = predictions_from_logits(logits, loss_threshold)
        per = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    else:
        # stable BCE-with-logits: max(z,0) - z*t + log(1+exp(-|z|))
        z = logits.float()
        per = torch.clamp_min(z, 0.0) - z * t + torch.log1p(torch.exp(-z.abs()))

    if loss == "wbce":
        w_neg, w_pos = wbce_weights
        per = per * torch.where(t > 0.5, w_pos, w_neg)
    return torch.mean(per)
