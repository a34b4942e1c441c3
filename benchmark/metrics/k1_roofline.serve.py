"""k1_roofline.serve: K1's share of its roofline over the traced window: the
least time for one forward call's bytes and operations
(``counts.k1_forward``) times the queries, over K1's device time, in %."""

from benchmark import counts


def read(run):
    trace = run.get("trace")
    if run["mode"] != "serve" or trace is None:
        return None
    k1_s = trace.kernel_s("K1")
    if k1_s <= 0:
        return None
    shape = run["shape"]
    nbytes, flops = counts.k1_forward(run["query_samples"], len(shape["rows"]), shape["dim"])
    return 100 * counts.bound_s(nbytes, flops) * run["calls"] / k1_s
