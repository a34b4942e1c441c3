"""mfu.train_dcn: the whole captured DLRM-DCNv2 train step's share of the
card's bf16 peak in the traced window: the model's operations
(``counts_dcn.train_flops``, 96.18 MFLOP an example at the cell's widths)
times the examples trained, over the window's seconds and the peak, in %."""

from benchmark import counts, counts_dcn


def read(run):
    trace = run.get("trace")
    if run.get("bench_mode") != "train_dcn" or trace is None or trace.busy_s <= 0:
        return None
    flops = counts_dcn.train_flops(run["shape"]) * run["examples"]
    return 100 * flops / trace.window_s / (counts.peak_flop_per_s(run["shape"]) * run["chips"])
