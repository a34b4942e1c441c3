"""mfu.train_hstu: the whole captured HSTU train step's share of the card's
bf16 peak in the traced window: the model's operations of each traced step
(``counts_hstu.train_flops``: the blocks' projections over the step's
tokens, their attention over its live causal scores, the sampled softmax
over its supervised positions, the backward twice the forward) over the
window's seconds and the peak (989 TFLOP/s), in %."""

from benchmark import counts, counts_hstu


def read(run):
    trace = run.get("trace")
    if run.get("bench_mode") != "train_hstu" or trace is None or trace.busy_s <= 0:
        return None
    flops = sum(counts_hstu.train_flops(run["shape"], lengths, positions)
                for lengths, positions in run["step_work"])
    return 100 * flops / trace.window_s / (counts.peak_flop_per_s(run["shape"]) * run["chips"])
