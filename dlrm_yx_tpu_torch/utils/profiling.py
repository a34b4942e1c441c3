"""Spans and counters of the port's host path, profiler traces, step timing.

``phase_scope(name, req)`` is the port's one span, the port of
``dlrm_yx_tpu/utils/profiling.py:38-42``: a profiler range (a
``RecordFunction``) around a phase of the model (the JAX package's names:
``embedding_lookup``, ``bottom_mlp``, ``interaction``, ``top_mlp``,
``loss_compute``, ``backward``, ``optimizer``, so traces of the two
packages name the same phases; the port's own ``dcn``, DLRM-DCNv2's cross
network, and ``lookup.bags``, its multi-hot bag lookup inside
``embedding_lookup``) or a step of the host path
(``fit.wait_batch``, ``step.replay``, ...: ``train/trainer.py``,
``train/capture.py``). Its start and end are on the profiler's clock, the
clock of the card's kernels and copies in the same session. ``req`` goes
into the range's keyword arguments, so the spans of one dispatch or one
serving call share it; a session that records shapes on one thread keeps
them (``FunctionEvent.kwinputs``, a Chrome trace's ``args``), torch's
all-thread sessions record none. The range is torch's
``_RecordFunctionFast`` (a Chrome trace's ``cpu_op`` rows) where torch has
it, else ``record_function`` (``user_annotation``). ``span_names()`` gives
the names opened under a profiler, so a reader of the events can tell the
program's spans from torch's operators.

Cost, on the host of an NVIDIA H100 machine (torch 2.11): with no
profiler recording, ``phase_scope`` returns after one check of
``torch.autograd.profiler._is_profiler_enabled`` and its ``with`` costs
0.34 us; under a profiler, 2.0 us. A bare ``record_function`` costs
10.7 us with no profiler and 9.5 us under one. A range inside a CUDA-graph
capture records nothing at replay: replays show only the spans around
them.

``count(name, n)`` adds to a counter of the calling thread (0.34 us;
the model's lookups count ``lookup.items`` and ``lookup.pad_items``,
``models/dlrm.lookup_all_groups``), and
``counters()`` returns a snapshot over every thread, with the kernel
wrappers' ``.launches`` (``train.capture.launch_counters``) as
``launch.<kernel>``, the caching allocators' totals as ``alloc.host``
(pinned blocks made) and ``alloc.device`` (the current card's
``cudaMalloc`` calls), and the row plan's tail counts of K2 and K4 on the
card (``row_plan.dup_keys``, ``row_plan.runs``, ``row_plan.long_runs``:
the items of duplicated rows, their runs, the runs of 64 items or more;
``ops.sparse_rows_add.row_plan_counts``) and of K7a (``coalesce.rows``,
``coalesce.split_runs``: the distinct live rows it coalesced, its
segments summed across chunks; ``ops.coalesce.coalesce_counts``), read
only when a snapshot is taken.
``train.capture.GraphStep`` takes back what a body counted on its thread
while it was captured, and adds it again at each replay. A count that the
batch decides, and that a captured step cannot know on the host, is a
device count (``count_on_device``: a 0-dim integer tensor added on the
device, so a replay adds its own batch's; HSTU's ``hstu.sequences``,
``hstu.live_scores``, ``hstu.pad_scores`` and
``sampled_softmax.negatives``, ``models/hstu.py``), read only when a
snapshot is taken.

``trace`` is the port of ``profiling.py:45-52`` (``--enable-profiling``):
a ``torch.profiler`` window over the enclosed work on every thread,
written as a Chrome trace (``chrome://tracing``, Perfetto) in place of
JAX's XPlane, with the window's counter deltas beside it. ``StepTimer`` is
the port of ``profiling.py:55-80``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Union

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import ProfilerActivity, profile, record_function

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # an older torch: the same range, at record_function's cost
    _RecordFunctionFast = None

TRACE_FILE = "trace.json"
COUNTERS_FILE = "counters.json"

_OFF = contextlib.nullcontext()
_names: set = set()


def phase_scope(name: str, req: Optional[Union[int, str]] = None):
    """A profiler range named ``name`` over the ``with`` block, carrying
    ``req`` (an int or a str); nothing when no profiler is recording."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    _names.add(name)
    if _RecordFunctionFast is None:
        return record_function(name, None if req is None else str(req))
    if req is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, [], {"req": req if isinstance(req, str) else int(req)})


def span_names() -> frozenset:
    """The names of every span opened while a profiler was recording."""
    return frozenset(_names)


_local = threading.local()
_stores: List[Dict[str, int]] = []  # every thread's counts
_stores_lock = threading.Lock()


def thread_counts() -> Dict[str, int]:
    """The calling thread's counters (only this thread writes them)."""
    counts = getattr(_local, "counts", None)
    if counts is None:
        counts = _local.counts = {}
        with _stores_lock:
            _stores.append(counts)
    return counts


def count(name: str, n: int = 1) -> None:
    counts = thread_counts()
    counts[name] = counts.get(name, 0) + n


_device_counts: Dict[tuple, torch.Tensor] = {}  # (name, device) -> 0-dim int64


def count_on_device(name: str, n: torch.Tensor) -> None:
    """Add ``n``, a 0-dim integer tensor, to the device count ``name`` on
    its device, without waiting for it. Inside a CUDA-graph capture the add
    is a node of the graph, so every replay adds its own value; the count
    must have been made by an eager call first (a captured step's warm-up
    makes it)."""
    key = (name, str(n.device))
    acc = _device_counts.get(key)
    if acc is None:
        if n.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device count {name!r} first met inside a CUDA-graph capture")
        acc = _device_counts[key] = torch.zeros((), dtype=torch.int64, device=n.device)
    acc.add_(n)


def device_counts() -> Dict[str, int]:
    """Every device count, summed over devices (a copy from each), or {}
    while a CUDA graph is being captured."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return {}
    out: Dict[str, int] = {}
    for (name, _), acc in list(_device_counts.items()):
        out[name] = out.get(name, 0) + int(acc)
    return out


def _alloc_counts() -> Dict[str, int]:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    out = {}
    host = torch.cuda.host_memory_stats().get("num_host_alloc")
    if host is not None:
        out["alloc.host"] = int(host)
    # the current card's: a process of the port drives one card, and reading
    # another's would start a context there
    dev = torch.cuda.memory_stats(torch.cuda.current_device()).get("num_device_alloc")
    if dev is not None:
        out["alloc.device"] = int(dev)
    return out


def counters() -> Dict[str, int]:
    """A snapshot of every counter: the threads' counts summed, the kernel
    launches, the allocators' totals, the row plan's and K7a's device
    counts and those of ``count_on_device``."""
    from dlrm_yx_tpu_torch.ops.coalesce import coalesce_counts
    from dlrm_yx_tpu_torch.ops.sparse_rows_add import row_plan_counts
    from dlrm_yx_tpu_torch.train.capture import launch_counters

    out: Dict[str, int] = {}
    with _stores_lock:
        stores = [dict(c) for c in _stores]
    for c in stores:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    out.update({f"launch.{name}": f.launches for name, f in launch_counters().items()})
    out.update(_alloc_counts())
    out.update(row_plan_counts())
    out.update(coalesce_counts())
    out.update(device_counts())
    return out


def counter_deltas(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """``after - before``, counter by counter, leaving out those that did not
    move."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def activities() -> List[ProfilerActivity]:
    """What a profiler window records: host operators, and the card's
    kernels when there is one."""
    return [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()


def _all_threads():
    """The profiler option that records every thread's ranges, where the
    installed torch has it (the staging thread's ``fit.stage``)."""
    try:
        from torch.profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the enclosed work on every thread (on a torch without that
    option, the calling thread's, with shapes and span ids), and write
    ``logdir/trace.json`` and the window's counter deltas,
    ``logdir/counters.json``, at the end, also when the work raises."""
    os.makedirs(logdir, exist_ok=True)
    before = counters()
    prof = profile(activities=activities(), record_shapes=True, **_all_threads())
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
        with open(os.path.join(logdir, COUNTERS_FILE), "w") as f:
            json.dump(counter_deltas(before, counters()), f, indent=1, sort_keys=True)


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
