"""k2_roofline.train: K2's share of its roofline over the traced window:
the least time for the bytes and operations that the window's batches
need of K2 (``counts.k2_step``, one call a step), over K2's device time
(its kernels in ``kernels.json``), in %."""

from benchmark import counts


def read(run):
    trace = run.get("trace")
    if run["mode"] != "train" or trace is None:
        return None
    k2_s = trace.kernel_s("K2")
    if k2_s <= 0:
        return None
    nbytes = flops = 0
    for b in run["batches"]:
        bb, ff = counts.k2_step(b[1], run["shape"])
        nbytes, flops = nbytes + bb, flops + ff
    return 100 * counts.bound_s(nbytes, flops) / k2_s
