"""coalesce_roofline.train_dcn: K7's share of its roofline over the traced
window: the least time for the least bytes of the coalesce-first route's
kernels in each traced step, 8 K + 8 dim U + 8 U (the sorted ids and
their order read; each distinct row's pre-update row read and its new row
written, f32; its momentum read and its increment written), from each
step's big-store items (``run["step_items"]``: ``items`` K, ``rows`` U),
over the device time of the kernels whose names hold ``coalesce_rows_``
(``csrc/coalesce_rows.cu``), in %. Each item's gradient row, which the sums
read from the pooled cotangent, is left out: the cotangent may sit in the
L2. None where no such kernel ran (a program without K7)."""

from benchmark import counts_dcn

PATTERN = "coalesce_rows_"


def least_bytes(items: dict, dim: int) -> int:
    k, u = items["items"], items["rows"]
    return 8 * k + 8 * dim * u + 8 * u


def read(run):
    trace = run.get("trace")
    if run.get("bench_mode") != "train_dcn" or trace is None:
        return None
    kernel_s = trace.seconds_of(PATTERN)
    if kernel_s <= 0:
        return None
    nbytes = sum(least_bytes(s, run["shape"]["dim"]) for s in run["step_items"])
    return 100 * counts_dcn.bytes_s(nbytes) / kernel_s
