"""The port's fused dot interaction (dlrm_yx_tpu_torch/ops/fused_interaction.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On a CPU tensor the port's wrapper runs its plain PyTorch version, so these
tests hold that version (the one the CUDA kernel is checked against on the
card) to the JAX kernel, and hold the routing rule to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_yx_tpu.ops.interaction import interact_features as jax_interact
from dlrm_yx_tpu.ops.pallas_interaction import fused_interaction as jax_fused
from dlrm_yx_tpu_torch.ops import interaction as port_interaction
from dlrm_yx_tpu_torch.ops.fused_interaction import (
    fused_interaction,
    fused_interaction_reference,
)
from dlrm_yx_tpu_torch.ops.interaction import interact_features

TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# f32: rtol 1e-5 / atol 1e-6, plus the summation-order allowance below.
# bf16: the JAX kernel test's own tolerance — bf16-rounded inputs can flip
# on 1-ulp f32 differences.
TOL = {jnp.float32: dict(rtol=1e-5, atol=1e-6), jnp.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# The two packages add a pair's D products in different orders, so an f32
# pair product may differ by a few ulp of sum_k |T_ik T_jk| (not of the
# result, which can cancel to near zero): measured at the headline shape,
# each package is about 1e-5 from the float64 value and the two differ by up
# to 1.05e-5, where sum_k |T_ik T_jk| is about 100. 1e-6 of that sum is ~17
# f32 ulp, below the worst case of D ulp.
ORDER_ULPS = 1e-6


def _inputs(b, s, d, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(b, d).astype(np.float32), rng.randn(b, s, d).astype(np.float32)


def _abs_pair_sums(x, ly, itself):
    """[B, D + P]: 0 on the x lanes, sum_k |T_ik T_jk| on each pair lane."""
    t = np.abs(np.concatenate([x[:, None, :], ly], axis=1).astype(np.float64))
    li, lj = np.tril_indices(t.shape[1], k=0 if itself else -1)
    sums = np.einsum("bfd,bgd->bfg", t, t)[:, li, lj]
    return np.concatenate([np.zeros_like(x, np.float64), sums], axis=1)


def assert_interaction_close(got, want, x, ly, itself, rtol, atol):
    slack = atol + rtol * np.abs(want) + ORDER_ULPS * _abs_pair_sums(x, ly, itself)
    excess = np.abs(got.astype(np.float64) - want) - slack
    assert excess.max() <= 0, f"max excess over tolerance {excess.max()}"


@pytest.mark.parametrize(
    "b,s,d,itself,cdt",
    [
        (256, 26, 128, False, jnp.float32),   # headline shape
        (256, 26, 128, False, jnp.bfloat16),  # headline compute dtype
        (128, 7, 128, True, jnp.float32),     # interact_itself
        (128, 2, 256, False, jnp.float32),    # wide dim, tiny slot count
    ],
)
def test_fused_matches_jax_kernel(b, s, d, itself, cdt):
    x, ly = _inputs(b, s, d, s * d)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(ly), itself, cdt, 64, True))
    launches = fused_interaction.launches
    got = fused_interaction(torch.from_numpy(x), torch.from_numpy(ly), itself, TORCH_DT[cdt])
    assert fused_interaction.launches == launches  # CPU tensors launch nothing
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_interaction_close(got.numpy(), want, x, ly, itself, **TOL[cdt])
    # the x lanes are the unrounded f32 input, whatever the compute dtype
    np.testing.assert_array_equal(got.numpy()[:, :d], x)


@pytest.mark.parametrize(
    "b,d,fused",
    [(128, 128, True), (64, 256, True), (96, 128, False), (128, 64, False)],
)
def test_routing_follows_jax_shape_rule(monkeypatch, b, d, fused):
    """impl='pallas' takes the kernel iff D % 128 == 0 and B % 64 == 0;
    other shapes give the JAX package's plain formulation."""
    calls = []

    def spy(*args):
        calls.append(args)
        return fused_interaction(*args)

    monkeypatch.setattr(port_interaction, "fused_interaction", spy)
    x, ly = _inputs(b, 5, d, b + d)
    got = interact_features(torch.from_numpy(x), torch.from_numpy(ly), "dot",
                            False, torch.float32, impl="pallas")
    assert bool(calls) == fused
    want = jax_interact(jnp.asarray(x), jnp.asarray(ly), "dot", False,
                        jnp.float32, impl="pallas")
    assert_interaction_close(got.numpy(), np.asarray(want), x, ly, False,
                             **TOL[jnp.float32])


@pytest.mark.parametrize("itself", [False, True])
@pytest.mark.parametrize("cdt", [jnp.float32, jnp.bfloat16])
def test_plain_formulation_matches_jax(itself, cdt):
    x, ly = _inputs(32, 6, 16, 7)
    got = interact_features(torch.from_numpy(x), torch.from_numpy(ly), "dot",
                            itself, TORCH_DT[cdt])
    want = jax_interact(jnp.asarray(x), jnp.asarray(ly), "dot", itself, cdt)
    assert_interaction_close(got.numpy(), np.asarray(want, np.float32), x, ly,
                             itself, **TOL[cdt])


def test_cat_matches_jax():
    x, ly = _inputs(8, 3, 4, 1)
    got = interact_features(torch.from_numpy(x), torch.from_numpy(ly), "cat")
    want = jax_interact(jnp.asarray(x), jnp.asarray(ly), "cat")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "x_shape,ly_shape,dtype,error",
    [
        ((64, 128), (64, 3, 128), torch.float64, TypeError),
        ((64, 128), (32, 3, 128), torch.float32, ValueError),
        ((64, 128), (64, 3, 64), torch.float32, ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(x_shape, ly_shape, dtype, error):
    with pytest.raises(error):
        fused_interaction(torch.zeros(x_shape, dtype=dtype),
                          torch.zeros(ly_shape, dtype=dtype))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("itself,cdt", [(False, torch.float32), (False, torch.bfloat16),
                                        (True, torch.float32)])
def test_cuda_kernel_matches_plain_version(cuda_device, itself, cdt):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(128, 128, device=cuda_device, generator=g)
    ly = torch.randn(128, 9, 128, device=cuda_device, generator=g)
    launches = fused_interaction.launches
    got = fused_interaction(x, ly, itself, cdt)
    torch.cuda.synchronize()
    assert fused_interaction.launches == launches + 1
    want = fused_interaction_reference(x, ly, itself, cdt)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    assert torch.equal(got[:, :128], x)
