"""Rank-0 printing, MLPerf-style event logging and training scalars.

The port of ``dlrm_yx_tpu/utils/logging.py`` (``is_rank0``, ``rank0_print``,
``EventLogger``, ``ScalarWriter``): events are ``:::MLLOG`` JSON lines on
stdout, as the reference's ``mlperf_logger.py`` emits them; scalars go to
TensorBoard, or to a JSONL file where it is not installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch.distributed as dist


def is_rank0() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def rank0_print(*args, **kw) -> None:
    """Print only on rank 0 of an initialized process group."""
    if is_rank0():
        print(*args, **kw)


class EventLogger:
    """MLPerf-style lifecycle event logger (``log_start`` / ``log_end`` /
    ``log_event``, the reference's ``mlperf_logger.py:21-60``)."""

    def __init__(self, benchmark: str = "dlrm"):
        self.benchmark = benchmark

    def _emit(self, event_type: str, key: str, value: Any = None,
              metadata: Optional[Dict] = None) -> None:
        if not is_rank0():
            return
        rec = {
            "namespace": self.benchmark,
            "time_ms": int(time.time() * 1000),
            "event_type": event_type,
            "key": key,
            "value": value,
            "metadata": metadata or {},
        }
        print(":::MLLOG " + json.dumps(rec))

    def log_start(self, key: str, metadata: Optional[Dict] = None):
        self._emit("INTERVAL_START", key, None, metadata)

    def log_end(self, key: str, metadata: Optional[Dict] = None):
        self._emit("INTERVAL_END", key, None, metadata)

    def log_event(self, key: str, value: Any = None,
                  metadata: Optional[Dict] = None):
        self._emit("POINT_IN_TIME", key, value, metadata)


class ScalarWriter:
    """TensorBoard scalars when ``torch.utils.tensorboard`` imports, JSONL
    (``scalars.jsonl`` in ``logdir``) otherwise (Train/Loss, Test/Acc etc.,
    dlrm_s_pytorch.py:1991-1994)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._f.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._f.close()
