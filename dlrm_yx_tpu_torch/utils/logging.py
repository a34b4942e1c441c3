"""Rank-0 printing and MLPerf-style event logging.

The port of ``dlrm_yx_tpu/utils/logging.py`` (``is_rank0``, ``rank0_print``,
``EventLogger``): events are ``:::MLLOG`` JSON lines on stdout, as the
reference's ``mlperf_logger.py`` emits them.
"""

from __future__ import annotations

import json
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
