"""mfu.serve: the whole captured eval step's share of the card's peak in the
traced window: forward operations (``counts.forward_flops``) times the
examples scored, over the window's seconds and the peak, in %."""

from benchmark import counts


def read(run):
    trace = run.get("trace")
    if run["mode"] != "serve" or trace is None or trace.busy_s <= 0:
        return None
    flops = counts.forward_flops(run["shape"]) * run["examples"]
    return 100 * flops / trace.window_s / (counts.peak_flop_per_s(run["shape"]) * run["chips"])
