"""mfu.train: the whole captured train step's share of the card's peak in
the traced window: the model's operations (``counts.train_flops``) times
the examples trained, over the window's seconds and the peak of every card
of the cell, in %."""

from benchmark import counts


def read(run):
    trace = run.get("trace")
    if run["mode"] != "train" or trace is None or trace.busy_s <= 0:
        return None
    flops = counts.train_flops(run["shape"]) * run["examples"]
    return 100 * flops / trace.window_s / (counts.peak_flop_per_s(run["shape"]) * run["chips"])
