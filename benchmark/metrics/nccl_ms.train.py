"""nccl_ms.train: device ms a step of the NCCL kernels (``kernels.json``'s
"nccl") on the slowest card in the traced window; it holds each card's wait
for the last one to arrive."""


def read(run):
    trace = run.get("trace")
    if run["mode"] != "train" or trace is None or run["chips"] < 2:
        return None
    ms = max(1e3 * r.kernel_s("nccl") / run["steps"] for r in trace.per_rank)
    return ms if ms > 0 else None
