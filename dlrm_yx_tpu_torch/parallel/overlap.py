"""Check the all-to-all / bottom-MLP overlap in a profiler trace.

The port of ``check_a2a_overlap`` (``dlrm_yx_tpu/parallel/overlap.py:107``).
The reference hand-codes the overlap: it launches an async all_to_all of the
pooled embeddings, computes the bottom MLP, then waits
(``dlrm_s_pytorch.py:708-713``, the Req/Wait pair of
``extend_distributed.py:405-508``). The port's hybrid step does the same
(``parallel/hybrid.py``: ``all_to_all_single(async_op=True)`` inside the
``alltoall_fwd`` range, the bottom MLP's GEMMs inside ``bottom_mlp``, the
wait inside ``alltoall_wait``). JAX reads the order off the scheduled HLO;
the port reads it off a ``torch.profiler`` Chrome trace of one eager step
(a CUDA-graph replay records no host ranges). That order is the host's:
NCCL enqueues even a blocking exchange without holding the host, so the
check also reads the device side of the same trace, where it has one: the
exchange's device work (launched inside ``alltoall_fwd``) against the
bottom MLP's GEMM kernels, and the time both run at once.
``aot_compile_hybrid_hlo`` compiles against a TPU topology and has no
counterpart.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple, Union

GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm")  # the GEMMs themselves, not their callers
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # host calls that start device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(trace: Dict, cats) -> List[Tuple[str, float, float, Dict]]:
    """(name, start, end, args) of a Chrome trace's complete events of ``cats``."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e.get("args", {}))
            for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") in cats]


def _launched_within(launches, device, ranges):
    """The device events whose host launch lies inside one of ``ranges``."""
    ids = {a.get("correlation") for _, t0, t1, a in launches
           if any(r0 <= t0 and t1 <= r1 for _, r0, r1, *_ in ranges)}
    return [(t0, t1, a.get("stream")) for _, t0, t1, a in device if a.get("correlation") in ids]


def _union(spans):
    out = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _both_us(a, b):
    """The time (µs) that the union of spans ``a`` and that of ``b`` share."""
    return sum(max(0.0, min(x1, y1) - max(x0, y0))
               for x0, x1 in _union(a) for y0, y1 in _union(b))


def check_a2a_overlap(trace: Union[str, Dict]) -> Dict[str, object]:
    """The order of the exchange and the bottom MLP in a Chrome trace (a
    path or the loaded dict) of one hybrid step: {issued: an all-to-all was
    issued, bottom_mlp_gemms: the bottom MLP's GEMMs, issued_before: the
    exchange's issue ended before the first of them began, waited_after:
    its wait began after the last of them ended, overlapped: all of
    these}; and from the device side: a2a_streams and gemm_streams (the
    streams that ran them), device_a2a_us (the busy time of the work launched
    inside the exchange's issue) and device_overlap_us (the time it ran
    beside the bottom MLP's GEMM kernels), None in a trace without device
    events. With several steps in the window, the first one is read."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    ranges = _events(trace, ("user_annotation", "cpu_op"))

    def first(name):
        hits = sorted((r for r in ranges if r[0] == name), key=lambda r: r[1])
        return hits[0] if hits else None

    issue, bottom, wait = first("alltoall_fwd"), first("bottom_mlp"), first("alltoall_wait")
    gemms = []
    if bottom is not None:
        gemms = sorted((r for r in ranges if r[0] in GEMM_OPS
                        and bottom[1] <= r[1] and r[2] <= bottom[2]), key=lambda r: r[1])
    issued_before = bool(issue and gemms and issue[2] <= gemms[0][1])
    waited_after = bool(wait and gemms and gemms[-1][2] <= wait[1])
    out = {"issued": issue is not None, "bottom_mlp_gemms": len(gemms),
           "issued_before": issued_before, "waited_after": waited_after,
           "overlapped": issued_before and waited_after,
           "a2a_streams": None, "gemm_streams": None,
           "device_a2a_us": None, "device_overlap_us": None}
    device = _events(trace, DEVICE_CATS)
    if device and issue is not None:
        launches = _events(trace, LAUNCH_CATS)
        a2a = _launched_within(launches, device, [issue])
        mm = _launched_within(launches, device, gemms)
        out.update(a2a_streams=sorted({s for *_, s in a2a}),
                   gemm_streams=sorted({s for *_, s in mm}),
                   device_a2a_us=sum(t1 - t0 for t0, t1 in _union([x[:2] for x in a2a])),
                   device_overlap_us=_both_us([x[:2] for x in a2a], [x[:2] for x in mm]))
    return out
