"""idle_share.serve: the share of the traced window in which no kernel, copy or
fill ran on the card (1 - the union of the device intervals over the
window), in %; on several cards the highest card's."""


def read(run):
    trace = run.get("trace")
    if run["mode"] != "serve" or trace is None or trace.busy_s <= 0:
        return None
    return max(100 * (1 - r.busy_s / r.window_s) for r in trace.per_rank)
