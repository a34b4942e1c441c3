"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device that is absent raises: the
    port never carries on on the CPU in place of the card.

    For CUDA this also turns TF32 off for matmuls and cuDNN: the JAX
    package computes its f32 products at ``Precision.HIGHEST``, and TF32
    would keep about three decimal digits of them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was asked for but torch.cuda.is_available() is False; "
                "pass device='cpu' (CLI: --device cpu) to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
