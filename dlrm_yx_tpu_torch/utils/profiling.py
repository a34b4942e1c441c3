"""Phase annotations for profiler traces, and step timing.

``phase_scope`` is the port of ``dlrm_yx_tpu/utils/profiling.py:38-42``:
a ``torch.profiler.record_function`` range with the JAX package's phase
names (``embedding_lookup``, ``bottom_mlp``, ``interaction``, ``top_mlp``,
``loss_compute``, ``backward``, ``optimizer``), so traces of the two
packages name the same phases. It costs nothing unless a profiler is
recording. ``trace`` is the port of ``profiling.py:45-52``
(``--enable-profiling``): a ``torch.profiler`` window over the enclosed
work, written as a Chrome trace (``chrome://tracing``, Perfetto) in place
of JAX's XPlane. ``StepTimer`` is the port of ``profiling.py:55-80``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def phase_scope(name: str) -> Iterator[None]:
    with record_function(name):
        yield


def activities() -> List[ProfilerActivity]:
    """What a profiler window records: host operators, and the card's
    kernels when there is one."""
    return [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the enclosed work and write ``logdir/trace.json`` at the
    end, also when the work raises."""
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities())
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Per-iteration wall-clock seconds (``times``: appended by ``stop``
    after ``start``, or by the caller) and an epoch average that leaves out
    the first iterations (the reference's bookkeeping,
    dlrm_s_pytorch.py:1845-1846,1966-1988)."""

    def __init__(self, warmup_iters: int = 2):
        self.warmup = warmup_iters
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def mean_ms(self) -> float:
        eff = self.times[self.warmup:] or self.times
        return 1000.0 * sum(eff) / max(len(eff), 1)

    def total_s(self) -> float:
        return sum(self.times)
