"""coalesce_roofline.train_hstu: K7's share of its roofline over the traced
window of an HSTU cell: the least time for the least bytes of K7a and K7b
in each traced step (``counts_hstu.coalesce_bytes``, from each step's item
table items and distinct rows, ``run["step_items"]``), over the device
time of the kernels whose names hold ``coalesce_rows_``, in %. None where
no such kernel ran."""

from benchmark import counts_dcn, counts_hstu


def read(run):
    trace = run.get("trace")
    if run.get("bench_mode") != "train_hstu" or trace is None or not run.get("step_items"):
        return None
    kernel_s = trace.seconds_of(counts_hstu.COALESCE_PATTERN)
    if kernel_s <= 0:
        return None
    nbytes = sum(counts_hstu.coalesce_bytes(s, run["shape"]["dim"]) for s in run["step_items"])
    return 100 * counts_dcn.bytes_s(nbytes) / kernel_s
