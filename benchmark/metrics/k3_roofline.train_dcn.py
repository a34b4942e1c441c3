"""k3_roofline.train_dcn: K3's share of its roofline over the traced window:
the least time for the bytes that the window's small-table finishes need
(``counts_dcn.k3_bytes``, one a step), over the device time of
``csrc/rwsadagrad_dense_finish.cu``'s kernels, in %."""

from benchmark import counts_dcn


def read(run):
    trace = run.get("trace")
    if run.get("bench_mode") != "train_dcn" or trace is None:
        return None
    kernel_s = trace.seconds_of(counts_dcn.K3_PATTERN)
    if kernel_s <= 0:
        return None
    nbytes = sum(counts_dcn.k3_bytes(s, run["shape"]) for s in run["step_items"])
    return 100 * counts_dcn.bytes_s(nbytes) / kernel_s
