"""The traced window: a ``torch.profiler`` session over a function, reduced
to what the per-layer readers and the result's ``breakdown`` read.

Device time is taken from the trace's device events (kernels, copies and
fills). Busy time is the length of the union of their intervals, so work
that runs beside other work on another stream (an NCCL kernel beside a
GEMM) counts once; chip_smoke.py's ``profile_step`` summed self times,
which counts it twice. Idle gaps are labelled with the innermost host
operation that was running at the gap's middle.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import torch

KERNELS = Path(__file__).resolve().parent / "kernels.json"


def union_length(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length of the union of [start, end) intervals, the merged
    intervals in order)."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [tuple(m) for m in merged]


def gaps(merged) -> List[Tuple[float, float]]:
    """The idle [start, end) gaps between merged busy intervals."""
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]


def label_gaps(idle, host) -> Dict[str, float]:
    """Idle time by the innermost host operation (``host``: (start, end,
    name)) that covers each gap's middle; "no host operation" where none."""
    host = sorted(host)
    out: Dict[str, float] = defaultdict(float)
    j = 0
    active: List[Tuple[float, float, str]] = []
    for s, e in sorted(idle):
        mid = (s + e) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] > mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active else "no host operation"
        out[name] += e - s
    return dict(out)


@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # host clock over the traced window
    busy_s: float                   # union of device intervals
    op_s: Dict[str, float]          # device seconds by operation name
    idle_by_host_op: Dict[str, float]
    ranks: List["TraceSummary"] = dataclasses.field(default_factory=list)

    @property
    def per_rank(self) -> List["TraceSummary"]:
        """Each card's own summary (this one on one card)."""
        return self.ranks or [self]

    @staticmethod
    def merged(ranks: List["TraceSummary"]) -> "TraceSummary":
        """The cards of a cell together: the longest window, the mean busy
        time, device and idle seconds summed; each card's kept."""
        op_s: Dict[str, float] = defaultdict(float)
        idle: Dict[str, float] = defaultdict(float)
        for r in ranks:
            for k, v in r.op_s.items():
                op_s[k] += v
            for k, v in r.idle_by_host_op.items():
                idle[k] += v
        return TraceSummary(window_s=max(r.window_s for r in ranks),
                            busy_s=sum(r.busy_s for r in ranks) / len(ranks),
                            op_s=dict(op_s), idle_by_host_op=dict(idle), ranks=list(ranks))

    def seconds_of(self, pattern: str) -> float:
        rx = re.compile(pattern, re.IGNORECASE)
        return sum(v for k, v in self.op_s.items() if rx.search(k))

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of one of ``kernels.json``'s kernels (K1, K2, ...)."""
        with open(KERNELS) as f:
            return self.seconds_of(json.load(f)[kernel]["pattern"])

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in idle]}


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
        e, "is_user_annotation", False)


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce a profiler's function events (``prof.events()``)."""
    dev, host = [], []
    op_s: Dict[str, float] = defaultdict(float)
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if _is_device(e):
            dev.append((s, t))
            op_s[e.name] += t - s
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((s, t, e.name))
    busy, merged = union_length(dev)
    return TraceSummary(window_s=window_s, busy_s=busy, op_s=dict(op_s),
                        idle_by_host_op=label_gaps(gaps(merged), host))


def traced(fn, device):
    """(fn(), TraceSummary) of one profiler session over fn and a
    synchronise of ``device``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return out, summarize(prof.events(), window)
