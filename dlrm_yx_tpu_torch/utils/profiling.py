"""Phase annotations for profiler traces, and step timing.

``phase_scope`` is the port of ``dlrm_yx_tpu/utils/profiling.py:38-42``:
a ``torch.profiler.record_function`` range with the JAX package's phase
names (``embedding_lookup``, ``bottom_mlp``, ``interaction``, ``top_mlp``,
``loss_compute``, ``backward``, ``optimizer``), so traces of the two
packages name the same phases. It costs nothing unless a profiler is
recording. ``StepTimer`` is the port of ``profiling.py:55-80``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

from torch.profiler import record_function


@contextlib.contextmanager
def phase_scope(name: str) -> Iterator[None]:
    with record_function(name):
        yield


class StepTimer:
    """Per-iteration wall-clock seconds (``times``, appended by the caller)
    and an epoch average that leaves out the first iterations (the
    reference's bookkeeping, dlrm_s_pytorch.py:1845-1846,1966-1988)."""

    def __init__(self, warmup_iters: int = 2):
        self.warmup = warmup_iters
        self.times: List[float] = []

    def mean_ms(self) -> float:
        eff = self.times[self.warmup:] or self.times
        return 1000.0 * sum(eff) / max(len(eff), 1)
