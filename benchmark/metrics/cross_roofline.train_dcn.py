"""cross_roofline.train_dcn: K8's share of its roofline over the traced
window: the least time for the cross network's element-wise bytes, 48 x
width x cross_layers an example times the window's examples, over the
device time of the kernels whose names hold ``cross_layer_``
(``csrc/cross_layer.cu``), in %.

A layer's 48 bytes an element of [B, width]: the forward's 18 (xw, x0 and
x_l read in f32; x_{l+1} written in f32 and in bf16) and the backward's 30
(the incoming cotangent, the layer above's first-product input gradient,
x0, xw and x0's running gradient read in f32; the outgoing cotangent and
x0's gradient written in f32, the second product's cotangent in bf16).
The edges are left out: the top layer writes no bf16 copy (2) and its
backward reads no input gradient and no x0 gradient and writes no
cotangent (12), the bottom layer writes no cotangent (4), and x0's last
term after the bottom layer reads and writes 12, so the kernels move 138
bytes an element where three layers count 144; the bias's band sums
(under 1% of a layer) and b itself are left out too. None where no such
kernel ran (a program without K8)."""

from benchmark import counts_dcn

PATTERN = "cross_layer_"


def least_bytes(shape) -> int:
    """The bytes one example moves through the cross network's element-wise
    terms, forward and backward."""
    return 48 * shape["width"] * shape["cross_layers"]


def read(run):
    trace = run.get("trace")
    if run.get("bench_mode") != "train_dcn" or trace is None:
        return None
    kernel_s = trace.seconds_of(PATTERN)
    if kernel_s <= 0:
        return None
    return 100 * counts_dcn.bytes_s(least_bytes(run["shape"]) * run["examples"]) / kernel_s
