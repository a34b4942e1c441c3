"""DLRM-DCNv2's low-rank cross network.

TorchRec's ``LowRankCrossNet`` (``torchrec/modules/crossnet.py``), the
interaction of the MLPerf DLRM-DCNv2 reference (``--interaction_type=dcn``,
``--dcn_num_layers``, ``--dcn_low_rank_dim``). With ``x0`` the
concatenated features [B, F*D] (the bottom MLP's output, then each
table's pooled vector), layer ``l`` computes

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

where ``V_l`` maps the width N = F*D to the rank r, with no bias, and
``W_l`` maps r back to N, with the bias ``b_l`` [N]. The port keeps each
layer as ``(V [N, r], W [r, N], b [N])``, products ``x @ V`` and
``(x V) @ W`` as the towers keep ``x @ W`` (``ops/mlp.py``): TorchRec's
``V_kernels`` [r, N] and ``W_kernels`` [N, r] transposed.

The products take the towers' mixed-precision rule
(``mlp.product_f32_out``): operands rounded to the compute dtype, an f32
product, so in bf16 each is one tensor-core GEMM with f32 output on the
card, and its backward two more. The bias, the Hadamard product with
``x0`` and the residual stay in f32.

Two routes, chosen from the compute dtype and the input's device:

  * f32 compute, on either device: the formula above in torch autograd
    (``cross_net_autograd``);
  * bf16 compute: ``_CrossNet``, one autograd Function for the whole
    network, with the same products, operands and roundings as autograd
    through the formula, and the same saved tensors (each layer's f32 xw,
    its bf16 operand and its bf16 xv; x0 shared). Everything between the
    products is K8 (``csrc/cross_layer.cu``) on CUDA tensors: a layer's
    forward in one launch (``cross_layer_fwd``: 18 bytes an element of
    [B, N]: xw, x0 and x_l read, x_{l+1} written in f32 and bf16), its
    backward in one launch and a small one for the bias's sum
    (``cross_layer_bwd``, ``cross_layer_bias_grad``: 30 bytes an element:
    the incoming cotangent, the layer above's first-product input
    gradient, x0, xw and x0's running gradient read; the outgoing
    cotangent, x0's gradient and the second product's bf16 cotangent
    written), and x0's last term after the bottom layer
    (``cross_layer_x0_grad``): 48 B N bytes a layer, 4.08 GB a step at
    DLRM-DCNv2's cell, 1.22 ms at 3.35 TB/s. On CPU tensors the same
    steps run their plain version (``cross_layer_forward_reference``,
    ``cross_layer_backward_reference``, ``cross_layer_finish_reference``),
    which repeats the kernels' arithmetic: the same roundings, x0's
    gradient summed in place, b's gradient summed by bands of
    ``band_rows`` rows in band order. One difference: the second
    product's cotangent g * x0 stays f32 there, where autograd's CPU
    product takes it unrounded; the kernel writes it in bf16, where
    ``mlp._F32OutProduct.backward`` rounds it on the card. A CUDA input
    that the kernels do not take (not contiguous f32, or a width not a
    multiple of 8) raises: nothing falls back.

Each bf16 call counts ``dcn.kernel`` or ``dcn.plain``
(``utils.profiling.count``); ``cross_net.launches`` counts K8's launches
(a step of L layers: L forward, 2 L + 1 backward).

Init as TorchRec's: V and W Xavier-normal (std sqrt(2 / (N + r)) for
both), b zero, drawn V then W a layer, layer by layer.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrm_yx_tpu_torch.ops import _build
from dlrm_yx_tpu_torch.ops.mlp import product_f32_out
from dlrm_yx_tpu_torch.utils.profiling import count

VEC = 8  # csrc/cross_layer.cu's kVec: elements a thread moves, so widths a multiple of it
BIAS_GROUPS = 8  # csrc/cross_layer.cu's kBiasGroups: runs of bands in b's gradient
BAND_THREADS = 132 * 1024  # the backward's threads, a band each: 1,024 on each of 132 SMs
BF16 = torch.bfloat16


def init_dcn(rng: np.random.RandomState, width: int, rank: int,
             num_layers: int) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """[(V [width, rank], W [rank, width], b [width])] f32 for each layer."""
    std = np.sqrt(2.0 / (width + rank))
    layers = []
    for _ in range(num_layers):
        v = rng.normal(0.0, std, size=(width, rank)).astype(np.float32)
        w = rng.normal(0.0, std, size=(rank, width)).astype(np.float32)
        layers.append((v, w, np.zeros(width, np.float32)))
    return layers


def cross_net(x0: torch.Tensor, layers: Sequence, compute_dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """x0 [B, N] f32 through the cross layers ``(V, W, b)`` -> [B, N] f32:
    bf16 compute through ``_CrossNet`` (K8 on CUDA tensors, its plain
    version on CPU tensors), f32 through ``cross_net_autograd``."""
    if compute_dtype != BF16 or not layers:
        return cross_net_autograd(x0, layers, compute_dtype)
    if x0.device.type == "cuda":
        _check_kernel_input(x0, layers)
        count("dcn.kernel")
    else:
        count("dcn.plain")
    return _CrossNet.apply(x0, *(p for layer in layers for p in layer))


cross_net.launches = 0


def cross_net_autograd(x0: torch.Tensor, layers: Sequence,
                       compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The formula in torch autograd, products by ``product_f32_out``."""
    x = x0
    for v, w, b in layers:
        xv = product_f32_out(x.to(compute_dtype), v.to(compute_dtype))
        xw = product_f32_out(xv.to(compute_dtype), w.to(compute_dtype))
        x = x0 * (xw + b.float()) + x
    return x


def band_rows(rows: int, width: int) -> int:
    """Rows a band in K8's backward: enough bands of ``width // VEC``
    threads each to give ``BAND_THREADS`` threads, at most one a row. The
    plain version takes the same bands, so b's gradient is summed in the
    same order on both routes."""
    nbands = min(rows, max(1, -(-BAND_THREADS // max(1, width // VEC))))
    return -(-rows // nbands)


def cross_layer_forward_reference(xw: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                                  x: torch.Tensor, want16: bool):
    """Plain version of ``cross_layer_fwd``: (x0 * (xw + b) + x [B, N] f32,
    its bf16 copy or None)."""
    y = x0 * (xw + b) + x
    return y, (y.to(BF16) if want16 else None)


def cross_layer_backward_reference(g_in: torch.Tensor, gx: Optional[torch.Tensor],
                                   x0: torch.Tensor, xw: torch.Tensor, b: torch.Tensor,
                                   x0grad: Optional[torch.Tensor], with_g: bool,
                                   rows_per_band: int):
    """Plain version of ``cross_layer_bwd`` and ``cross_layer_bias_grad``:
    (g, t, x0grad, gb) with g = g_in + f32(bf16(gx)) (g_in where gx is
    None), t = g * x0 in f32 (the kernel writes it rounded to bf16), x0grad
    plus g * (xw + b) in place (that product where x0grad is None), then
    plus g where ``with_g``, and gb = t summed over rows by
    ``bias_grad_reference``."""
    g = g_in if gx is None else g_in + gx.to(BF16).float()
    t = g * x0
    u = g * (xw + b)
    x0grad = u if x0grad is None else x0grad.add_(u)
    if with_g:
        x0grad.add_(g)
    return g, t, x0grad, bias_grad_reference(t, rows_per_band)


def bias_grad_reference(t: torch.Tensor, rows_per_band: int) -> torch.Tensor:
    """t [B, N] summed over rows in K8's order: each band's rows in row
    order from 0, then ``BIAS_GROUPS`` runs of consecutive bands, each in
    band order, then the runs in order (zero padding adds nothing)."""
    rows, width = t.shape
    nbands = -(-rows // rows_per_band)
    per = -(-nbands // BIAS_GROUPS)
    padded = t.new_zeros(nbands * rows_per_band, width)
    padded[:rows] = t
    padded = padded.view(nbands, rows_per_band, width)
    bands = t.new_zeros(BIAS_GROUPS * per, width)
    for r in range(rows_per_band):
        bands[:nbands] = bands[:nbands] + padded[:, r]
    bands = bands.view(BIAS_GROUPS, per, width)
    runs = t.new_zeros(BIAS_GROUPS, width)
    for k in range(per):
        runs = runs + bands[:, k]
    total = runs[0]
    for y in range(1, BIAS_GROUPS):
        total = total + runs[y]
    return total


def cross_layer_finish_reference(x0grad: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cross_layer_x0_grad``: x0grad + f32(bf16(gx)) in
    place."""
    return x0grad.add_(gx.to(BF16).float())


class _CrossNet(torch.autograd.Function):
    """The bf16 cross network: x0, then each layer's (V, W, b) flat."""

    @staticmethod
    def forward(ctx, x0, *flat):
        n = len(flat) // 3
        x, x16 = x0, x0.to(BF16)
        saved = []
        for i in range(n):
            v, w, b = flat[3 * i:3 * i + 3]
            v16, w16, b = v.to(BF16), w.to(BF16), b.float().contiguous()
            xv16 = _product(x16, v16).to(BF16)
            xw = _product(xv16, w16)
            x_next, x16_next = _layer_forward(xw, b, x0, x, want16=i < n - 1)
            saved += [x16, v16, xv16, w16, xw, b]
            x, x16 = x_next, x16_next
        ctx.save_for_backward(x0, *saved)
        return x

    @staticmethod
    def backward(ctx, g):
        x0, *saved = ctx.saved_tensors
        n = len(saved) // 6
        rows_per_band = band_rows(*x0.shape)
        g_in, gx, x0grad, buf = g.contiguous(), None, None, None
        grads: List[torch.Tensor] = []
        for l in reversed(range(n)):
            x16, v16, xv16, w16, xw, b = saved[6 * l:6 * l + 6]
            # the cotangent of x_{l+1} goes on to the layer below where one
            # reads it (the top layer's is g itself; the bottom has none below)
            g_out = None
            if 0 < l < n - 1:
                buf = g_out = torch.empty_like(x0) if buf is None else buf
            g_next, t, x0grad, gb = _layer_backward(g_in, gx, x0, xw, b, g_out, x0grad, l == 0,
                                                    rows_per_band)
            gxv, gw = _product_backward(t, xv16, w16)
            gx, gv = _product_backward(gxv.to(BF16), x16, v16)
            grads[:0] = [gv, gw, gb]
            if g_out is not None:
                g_in = g_next
        _finish(x0grad, gx)
        return (x0grad, *grads)


def _product(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """The f32 product of bf16 operands: one GEMM with f32 output on the
    card, the operands multiplied in f32 on the CPU (``product_f32_out``)."""
    if a16.is_cuda:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return a16.float() @ b16.float()


def _product_backward(t: torch.Tensor, a16: torch.Tensor, b16: torch.Tensor):
    """(t @ b16ᵀ in f32, f32(bf16(a16ᵀ @ t))) for the product ``a16 @ b16``
    of cotangent t: on the card bf16 GEMMs with f32 output, as
    ``_F32OutProduct.backward`` (t already bf16); on the CPU the f32
    products autograd takes through ``product_f32_out`` (t as it is)."""
    if t.is_cuda:
        return (torch.mm(t, b16.t(), out_dtype=torch.float32),
                torch.mm(a16.t(), t, out_dtype=torch.float32).to(BF16).float())
    tf = t.float()
    return tf.mm(b16.float().t()), a16.float().t().mm(tf).to(BF16).float()


def _check_kernel_input(x0: torch.Tensor, layers: Sequence) -> None:
    if x0.dim() != 2 or x0.dtype != torch.float32 or not x0.is_contiguous():
        raise ValueError(f"K8 takes a contiguous 2-D f32 x0, got {x0.dtype} "
                         f"{tuple(x0.shape)} (strides {x0.stride()})")
    if x0.shape[1] % VEC or x0.data_ptr() % 16:
        raise ValueError(f"K8 takes a width that is a multiple of {VEC} and 16-byte aligned "
                         f"rows, got width {x0.shape[1]}")
    if any(p.device != x0.device for layer in layers for p in layer):
        raise ValueError("the cross layers must lie on x0's device")


def _layer_forward(xw, b, x0, x, want16):
    if not xw.is_cuda:
        return cross_layer_forward_reference(xw, b, x0, x, want16)
    dev = x0.device
    out = torch.empty_like(x0)
    out16 = torch.empty(x0.shape, dtype=BF16, device=dev) if want16 else None
    err = _kernel("cross_layer_forward")(
        xw.data_ptr(), b.data_ptr(), x0.data_ptr(), x.data_ptr(), out.data_ptr(),
        None if out16 is None else out16.data_ptr(), x0.shape[0], x0.shape[1], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "cross_layer_forward")
    cross_net.launches += 1
    return out, out16


def _layer_backward(g_in, gx, x0, xw, b, g_out, x0grad, bottom, rows_per_band):
    """One layer's element-wise backward: (g, t, x0grad, gb), g the
    cotangent of x_{l+1}: on the card written to g_out where it is given
    (g_out, else None), on the CPU a new tensor."""
    if not x0.is_cuda:
        return cross_layer_backward_reference(g_in, gx, x0, xw, b, x0grad, bottom,
                                              rows_per_band)
    dev = x0.device
    rows, width = x0.shape
    add = x0grad is not None
    if not add:
        x0grad = torch.empty_like(x0)
    t16 = torch.empty((rows, width), dtype=BF16, device=dev)
    partial = torch.empty((-(-rows // rows_per_band), width), dtype=torch.float32, device=dev)
    gb = torch.empty(width, dtype=torch.float32, device=dev)
    err = _kernel("cross_layer_backward")(
        g_in.data_ptr(), None if gx is None else gx.data_ptr(), x0.data_ptr(), xw.data_ptr(),
        b.data_ptr(), None if g_out is None else g_out.data_ptr(), t16.data_ptr(),
        x0grad.data_ptr(), int(add), int(bottom), partial.data_ptr(), gb.data_ptr(), rows, width,
        rows_per_band, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "cross_layer_backward")
    cross_net.launches += 2
    return g_out, t16, x0grad, gb


def _finish(x0grad, gx):
    if not x0grad.is_cuda:
        return cross_layer_finish_reference(x0grad, gx)
    dev = x0grad.device
    err = _kernel("cross_layer_finish")(x0grad.data_ptr(), gx.data_ptr(), x0grad.shape[0],
                                        x0grad.shape[1], dev.index,
                                        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "cross_layer_finish")
    cross_net.launches += 1
    return x0grad


def _raise_on(err: int, entry: str) -> None:
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _kernel(entry: str):
    """The launch function ``entry`` of ``csrc/cross_layer.cu``, its
    argument types set; the library's vector width and bias runs checked
    against this module's at the first load."""
    lib = _build.load("cross_layer")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        if (lib.cross_layer_vec(), lib.cross_layer_bias_groups()) != (VEC, BIAS_GROUPS):
            raise RuntimeError("csrc/cross_layer.cu's kVec or kBiasGroups differ from "
                               "ops/dcn.py's VEC or BIAS_GROUPS")
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = {
            "cross_layer_forward": [p, p, p, p, p, p, ll, i, i, p],
            "cross_layer_backward": [p, p, p, p, p, p, p, p, i, i, p, p, ll, i, i, i, p],
            "cross_layer_finish": [p, p, ll, i, i, p],
        }[entry]
        fn.restype = i
    return fn
