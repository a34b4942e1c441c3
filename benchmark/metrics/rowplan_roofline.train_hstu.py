"""rowplan_roofline.train_hstu: the row plan's kernels' share of their
roofline over the traced window of an HSTU cell: the least time for the
bytes that each traced step's item-table items and distinct rows
(``run["step_items"]``) need of K2 and K4 (``counts_dcn.row_plan_bytes``,
one call of each a step), over the device time of the kernels of
``csrc/row_plan.cuh``, in %. None where no such kernel ran."""

from benchmark import counts_dcn


def read(run):
    trace = run.get("trace")
    if run.get("bench_mode") != "train_hstu" or trace is None or not run.get("step_items"):
        return None
    kernel_s = trace.seconds_of(counts_dcn.ROW_PLAN_PATTERN)
    if kernel_s <= 0:
        return None
    nbytes = sum(counts_dcn.row_plan_bytes(s, run["shape"]) for s in run["step_items"])
    return 100 * counts_dcn.bytes_s(nbytes) / kernel_s
