"""Fused dot interaction (forward): ``[x | tril(T Tᵀ)]`` in one kernel.

The port of ``dlrm_yx_tpu/ops/pallas_interaction.py`` (``fused_interaction``
and ``fused_interaction_fwd``). With ``T = concat(x, ly)`` of shape
``[B, F, D]`` (``F = S + 1``), the output row b is the unrounded f32 dense
feature ``x[b]`` in lanes ``[0, D)`` followed by the ``P`` pair products
``<Tc[b, i], Tc[b, j]>`` in ``torch.tril_indices(F, F, offset)`` order
(row-major), where ``Tc`` is T rounded to ``compute_dtype`` and every dot
accumulates in f32. offset is -1, or 0 with ``interact_itself``.

On a CUDA tensor the forward launches the hand-written kernel
``csrc/fused_interaction.cu`` (its source note gives the design and the
bound); on a CPU tensor it runs ``fused_interaction_reference``, the plain
PyTorch version of the same function. There is no fallback from one to the
other.

``fused_interaction`` is an autograd Function on both devices, so the
kernel's output carries a gradient. Its backward is a torch expression of
the JAX package's ``_vjp_bwd`` (``pallas_interaction.py:176-203``, XLA
there too, not Pallas): the pair gradients scattered into a symmetric
``[B, F, F]`` dz (a diagonal pair counts twice), ``dt = dz @ T`` in f32
with T rounded to the compute dtype, split into the x and ly gradients.
"""

from __future__ import annotations

import ctypes

import torch

from dlrm_yx_tpu_torch.ops import _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100


def num_pairs(f: int, interact_itself: bool) -> int:
    return f * (f - 1) // 2 + (f if interact_itself else 0)


def fused_interaction_reference(
    x: torch.Tensor,
    ly: torch.Tensor,
    interact_itself: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version: cat, round, f32 bmm, tril gather, cat.

    The rounded operands are multiplied as f32, so a bf16 product is exact
    and only the summation order can differ from the kernel."""
    f = ly.shape[1] + 1
    t = torch.cat([x[:, None, :], ly], dim=1).to(compute_dtype).float()
    z = torch.bmm(t, t.transpose(1, 2))
    li, lj = torch.tril_indices(f, f, 0 if interact_itself else -1,
                                device=x.device)
    return torch.cat([x, z[:, li, lj]], dim=1)


def _check(x: torch.Tensor, ly: torch.Tensor, compute_dtype: torch.dtype):
    if x.dim() != 2 or ly.dim() != 3:
        raise ValueError(f"want x [B, D] and ly [B, S, D], got {tuple(x.shape)} "
                         f"and {tuple(ly.shape)}")
    b, d = x.shape
    if ly.shape[0] != b or ly.shape[2] != d:
        raise ValueError(f"x {tuple(x.shape)} and ly {tuple(ly.shape)} disagree")
    if x.dtype != torch.float32 or ly.dtype != torch.float32:
        raise TypeError(f"want f32 x and ly, got {x.dtype} and {ly.dtype}")
    if x.device != ly.device:
        raise ValueError(f"x on {x.device} but ly on {ly.device}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")


def _forward(x, ly, interact_itself, compute_dtype):
    """The forward on either device; a CUDA call launches the kernel."""
    if x.device.type == "cpu":
        return fused_interaction_reference(x, ly, interact_itself, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, d = x.shape
    s = ly.shape[1]
    if x.stride(1) != 1 or ly.stride(2) != 1:
        raise ValueError("the feature dim of x and ly must be contiguous")
    # the kernel reads 4 floats at a time and sums 16 lanes a tensor-core step
    if (d % 16 or x.data_ptr() % 16 or ly.data_ptr() % 16
            or x.stride(0) % 4 or ly.stride(0) % 4 or ly.stride(1) % 4):
        raise ValueError("the kernel needs D % 16 == 0 and 16-byte aligned rows")
    bf16 = int(compute_dtype == torch.bfloat16)
    if s < 1 or _smem_bytes(s, d, int(interact_itself), bf16) > SMEM_LIMIT:
        raise ValueError(f"{s + 1} x {d} features do not fit the kernel's shared memory")
    out = torch.empty((b, d + num_pairs(s + 1, interact_itself)),
                      dtype=torch.float32, device=x.device)
    err = _kernel()(
        x.data_ptr(), x.stride(0), ly.data_ptr(), ly.stride(0), ly.stride(1),
        out.data_ptr(), b, s, d, int(interact_itself), bf16, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_interaction kernel launch failed: CUDA error {err}")
    fused_interaction.launches += 1
    return out


class _FusedInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ly, interact_itself, compute_dtype):
        ctx.save_for_backward(x, ly)
        ctx.interact_itself = interact_itself
        ctx.compute_dtype = compute_dtype
        return _forward(x, ly, interact_itself, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, ly = ctx.saved_tensors
        b, d = x.shape
        f = ly.shape[1] + 1
        li, lj = torch.tril_indices(f, f, 0 if ctx.interact_itself else -1,
                                    device=x.device)
        gz = g[:, d:]
        dz = g.new_zeros(b, f * f)
        dz.index_add_(1, li * f + lj, gz)
        dz.index_add_(1, lj * f + li, gz)
        t = torch.cat([x[:, None, :], ly], dim=1).to(ctx.compute_dtype).float()
        dt = torch.bmm(dz.view(b, f, f), t)
        return g[:, :d] + dt[:, 0], dt[:, 1:], None, None


def fused_interaction(
    x: torch.Tensor,
    ly: torch.Tensor,
    interact_itself: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x [B, D] f32, ly [B, S, D] f32 -> [B, D + P] f32, differentiable
    with respect to x and ly.

    A CUDA call launches the kernel on the current stream and adds one to
    ``fused_interaction.launches``; a CPU call runs the plain version."""
    _check(x, ly, compute_dtype)
    return _FusedInteraction.apply(x, ly, interact_itself, compute_dtype)


fused_interaction.launches = 0


def _smem_bytes(s, d, diag, bf16):
    """Shared memory a block of one batch row needs (the kernel's own count)."""
    fn = _build.load("fused_interaction").fused_interaction_smem_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return fn(s, d, diag, bf16)


def _kernel():
    fn = _build.load("fused_interaction").fused_interaction_fwd
    if fn.argtypes is None:
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, ll, p, ll, ll, p, i, i, i, i, i, i, p]
        fn.restype = i
    return fn
