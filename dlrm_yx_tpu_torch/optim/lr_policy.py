"""LR schedule: linear warmup -> freeze -> quadratic polynomial decay ->
freeze at floor.

The port of ``dlrm_yx_tpu/optim/lr_policy.py``, with the reference
``LRPolicyScheduler``'s quirks (``dlrm_s_pytorch.py:188-222``):
  * step_count is 1-based, so training iteration k (0-based) sees
    step_count = k+1;
  * warmup scale at step s is s/W; between warmup and decay the lr freezes
    at the last warmup value (W-1)/W * base_lr when num_decay_steps > 0;
  * decay scale is ((ND - (s - DS)) / ND)^2 with an absolute floor of 1e-7;
  * after decay the lr freezes at the last decayed value;
  * with no warmup and no decay the lr is base_lr.

The JAX package computes the lr in float32; so does this copy, with numpy
float32 scalars in the same order, so that both give the same bits (a
double lr differs in the last ulp and the parity tests drift). The value
is a plain Python float made on the host: no device work and no sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MIN_LR = 1e-7
f32 = np.float32


@dataclasses.dataclass(frozen=True)
class LRPolicy:
    base_lr: float
    num_warmup_steps: int = 0
    decay_start_step: int = 0
    num_decay_steps: int = 0

    def __post_init__(self):
        if 0 < self.decay_start_step < self.num_warmup_steps:
            raise ValueError("warmup must finish before decay starts")

    def __call__(self, iteration: int) -> float:
        """lr at 0-based training iteration, rounded to float32."""
        s = f32(iteration) + f32(1.0)  # torch step_count
        w = float(self.num_warmup_steps)
        ds = float(self.decay_start_step)
        nd = float(self.num_decay_steps)
        base = float(self.base_lr)
        if s < f32(w):
            lr = f32(base) * (s / f32(w))
        elif nd > 0 and f32(ds) <= s < f32(ds + nd):
            x = (f32(nd) - (s - f32(ds))) / f32(nd)
            lr = max(f32(MIN_LR), f32(base) * (x * x))
        elif nd > 0 and s < f32(ds):
            lr = f32(base * ((w - 1.0) / w) if w > 0 else base)
        elif nd > 0:
            lr = f32(max(MIN_LR, base * (1.0 / nd) ** 2))
        else:
            lr = f32(base)
        return float(lr)


def lr_or_constant(lr_fn, lr: float):
    """A step's lr schedule (0-based iteration -> lr): ``lr_fn``, or without
    one the constant ``lr`` rounded to float32."""
    if lr_fn is not None:
        return lr_fn
    lr = float(f32(lr))
    return lambda _it: lr
