"""The single-device eval step.

The port of ``make_eval_step`` in ``dlrm_yx_tpu/train/train_step.py`` — the
inference path of the reference's ``dlrm_s_pytorch.py:1018-1162``. The
train steps are not ported yet. PyTorch runs eagerly, so there is nothing
to jit: the step is a plain function under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import to_device
from dlrm_yx_tpu_torch.models.dlrm import forward_logits, model_groups
from dlrm_yx_tpu_torch.ops.losses import loss_fn, predictions_from_logits
from dlrm_yx_tpu_torch.utils.device import resolve_device


def make_eval_step(config: DLRMConfig,
                   device: Optional[Union[str, torch.device]] = None):
    """Returns eval(params, batch) -> (predictions [B, 1], loss). ``params``
    is the parameter dict (``models.dlrm``) on ``device`` (the card unless
    the caller asks for the CPU); ``batch`` is a ``Batch`` of numpy arrays
    or tensors, moved to ``device`` when it is not there."""
    dev = resolve_device(device)
    groups = model_groups(config)

    @torch.inference_mode()
    def eval_step(params, batch):
        b = to_device(batch, dev)
        logits = forward_logits(params, config, groups, b.dense, b.indices,
                                b.weights)
        preds = predictions_from_logits(logits, config.loss_threshold)
        loss = loss_fn(logits, b.labels, config.loss, config.loss_threshold,
                       config.wbce_weights)
        return preds, loss

    return eval_step
