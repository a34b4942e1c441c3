"""The port's sparse-update kernels K2 (ops/sparse_rows_overwrite.py) and K3
(ops/dense_finish.py) against the JAX package's Pallas kernels, run in
interpret mode on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so these
tests hold that version (the one the CUDA kernel is checked against on the
card) to the JAX kernel. The card-only cases at the end hold the CUDA
kernels to the plain versions and skip without a card. The file imports
JAX only where it is installed, so that on a machine with the card and
without JAX the card cases run and the JAX cases skip:
``python -m pytest --noconftest tests/test_torch_sparse_kernels.py``.
"""

import numpy as np
import pytest
import torch

from dlrm_yx_tpu_torch.ops.dense_finish import (
    rwsadagrad_dense_finish,
    rwsadagrad_dense_finish_reference,
)
from dlrm_yx_tpu_torch.ops.sparse_rows_add import row_plan_counts
from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import (
    CLIP_MARGIN,
    sparse_rows_overwrite,
    sparse_rows_overwrite_reference,
)
from torch_row_plan_cases import STREAMS, stream, tail_counts

try:
    import jax.numpy as jnp

    from dlrm_yx_tpu.ops.pallas_dense_finish import BLOCK_ROWS
    from dlrm_yx_tpu.ops.pallas_dense_finish import rwsadagrad_dense_finish as jax_finish
    from dlrm_yx_tpu.ops.pallas_sparse_update import sparse_rows_overwrite as jax_overwrite
except ImportError:  # a machine with the card and no JAX: the card cases alone
    jnp = jax_finish = jax_overwrite = None
    BLOCK_ROWS = 2048  # pallas_dense_finish.BLOCK_ROWS, for the cases' names alone

SENTINEL_ROWS = 8


@pytest.fixture
def jax_package():
    if jnp is None:
        pytest.skip("needs the JAX package: these cases hold the plain versions to its kernels")


needs_jax = pytest.mark.usefixtures("jax_package")


def _overwrite_case(seed, rows, k, w, consistent):
    r = np.random.RandomState(seed)
    store = r.randn(rows + SENTINEL_ROWS, w).astype(np.float32)
    idx = r.randint(0, rows, k).astype(np.int32)
    idx[40:60] = idx[39]
    idx[100:103] = idx[7]
    active = (r.rand(k) > 0.2).astype(np.int32)
    delta = r.randn(k, w).astype(np.float32)
    # the caller's new values are old row + delta; the kernel must not care
    new_vals = store[idx] + delta if consistent else r.randn(k, w).astype(np.float32)
    return store, idx, new_vals, delta, active


@pytest.mark.parametrize("consistent", [True, False])
@needs_jax
def test_overwrite_plain_matches_jax_kernel(consistent):
    """Mirrors tests/test_sparse_update.py::test_sparse_rows_overwrite_dup_and_inactive,
    and with unrelated new_vals checks that unique rows take new_vals and
    duplicated rows take their deltas in item order."""
    store, idx, new_vals, delta, active = _overwrite_case(1, 2048, 300, 128, consistent)
    want = np.asarray(jax_overwrite(
        jnp.asarray(store), jnp.asarray(idx), jnp.asarray(new_vals),
        jnp.asarray(delta), jnp.asarray(active), interpret=True))
    got = sparse_rows_overwrite(torch.from_numpy(store.copy()), torch.from_numpy(idx),
                                torch.from_numpy(new_vals), torch.from_numpy(delta),
                                torch.from_numpy(active)).numpy()
    # the JAX kernel parks dead items on its last (sentinel) row; the port
    # leaves that row alone
    np.testing.assert_array_equal(got[:-SENTINEL_ROWS], want[:-SENTINEL_ROWS])
    np.testing.assert_array_equal(got[-SENTINEL_ROWS:], store[-SENTINEL_ROWS:])


@pytest.mark.parametrize("name", ["skewed", "one_row"])
@needs_jax
def test_overwrite_plain_matches_jax_kernel_on_streams(name):
    """A skewed stream (30% of the items on 10 rows) and one where every
    item hits one row, a fifth of them inactive: unique rows take new_vals,
    duplicated rows their deltas in item order, as in the JAX kernel."""
    r = np.random.RandomState(8)
    store = r.randn(2048 + SENTINEL_ROWS, 128).astype(np.float32)
    if name == "skewed":
        idx = r.randint(0, 2048, 400).astype(np.int32)
        hot = r.rand(400) < 0.3
        idx[hot] = idx[:10][r.randint(0, 10, hot.sum())]
    else:
        idx = np.full(400, 1234, np.int32)
    active = (r.rand(400) > 0.2).astype(np.int32)
    delta = r.randn(400, 128).astype(np.float32)
    new_vals = store[idx] + delta
    want = np.asarray(jax_overwrite(
        jnp.asarray(store), jnp.asarray(idx), jnp.asarray(new_vals),
        jnp.asarray(delta), jnp.asarray(active), interpret=True))
    got = sparse_rows_overwrite(torch.from_numpy(store.copy()), torch.from_numpy(idx),
                                torch.from_numpy(new_vals), torch.from_numpy(delta),
                                torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got[:-SENTINEL_ROWS], want[:-SENTINEL_ROWS])
    np.testing.assert_array_equal(got[-SENTINEL_ROWS:], store[-SENTINEL_ROWS:])
    assert (got != store).any()


def test_overwrite_rejects_bad_inputs():
    store = torch.zeros(64, 128)
    idx, active = torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32)
    # any row width is taken now (the mixed-dimension groups' widths 1 and
    # 2; tests/test_torch_variants.py holds widths 1, 2 and 4 to JAX): four
    # items on row 0 of a width-6 store add their deltas
    got = sparse_rows_overwrite(torch.zeros(64, 6), idx, torch.zeros(4, 6),
                                torch.ones(4, 6), active)
    assert (got[0] == 4).all() and not got[1:].any()
    with pytest.raises(ValueError, match="no room for its sentinel rows"):
        sparse_rows_overwrite(torch.zeros(9, 6), idx, torch.zeros(4, 6),
                              torch.zeros(4, 6), active)
    with pytest.raises(ValueError, match="new_vals"):
        sparse_rows_overwrite(store, idx, torch.zeros(4, 64), torch.zeros(4, 128), active)
    with pytest.raises(TypeError, match="f32 store"):
        sparse_rows_overwrite(store.bfloat16(), idx, torch.zeros(4, 128),
                              torch.zeros(4, 128), active)


def _finish_case(seed, r, w, acc_extra, touched=None):
    rng = np.random.RandomState(seed)
    store = rng.randn(r, w).astype(np.float32)
    acc = np.abs(rng.randn(r + acc_extra)).astype(np.float32)
    g = np.zeros((r, w), np.float32)
    rows = rng.choice(r, size=touched or max(4, r // 5), replace=False)
    g[rows] = rng.randn(len(rows), w).astype(np.float32)
    return store, acc, g


@pytest.mark.parametrize(
    "r,dim,w,acc_extra",
    [  # the cases of tests/test_dense_finish.py::test_finish_matches_reference
        (512, 128, 128, 0),
        (BLOCK_ROWS + 72, 128, 128, 0),
        (640, 64, 128, 0),
        (1024, 32, 128, 24),
        (384, 256, 256, 0),
        (BLOCK_ROWS, 128, 128, 128),
        # the widths of K3's lane-group route (JAX's packed layout) and 512
        (64, 1, 128, 0),
        (96, 2, 128, 8),
        (128, 4, 128, 0),
        (160, 8, 128, 24),
        (200, 16, 128, 0),
        (300, 512, 512, 16),
    ],
)
@needs_jax
def test_finish_plain_matches_jax_kernel(r, dim, w, acc_extra):
    """The JAX store is physical [r, w] (pack = w // dim logical rows per
    row); the port's is the same memory as logical [r * pack, dim] rows."""
    pack = w // dim
    store, _, g = _finish_case(r + dim, r, w, 0)
    acc = np.abs(np.random.RandomState(r).randn(r * pack + acc_extra)).astype(np.float32)
    want_s, want_a = jax_finish(jnp.asarray(store), jnp.asarray(acc), jnp.asarray(g),
                                0.05, dim=dim, eps=1e-10, interpret=True)
    got_s, got_a = rwsadagrad_dense_finish(
        torch.from_numpy(store.reshape(r * pack, dim).copy()), torch.from_numpy(acc.copy()),
        torch.from_numpy(g.reshape(r * pack, dim)), 0.05, dim, 1e-10)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_s.numpy().reshape(r, w), np.asarray(want_s),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_a.numpy()[r * pack:], acc[r * pack:])


@needs_jax
def test_finish_bf16_store_matches_jax_kernel():
    store, acc, g = _finish_case(5, 640, 128, 0, touched=100)
    store16 = store.astype(jnp.bfloat16)
    want_s, want_a = jax_finish(jnp.asarray(store16), jnp.asarray(acc), jnp.asarray(g),
                                0.05, dim=128, eps=1e-10, interpret=True)
    got_s, got_a = rwsadagrad_dense_finish(
        torch.from_numpy(store16.astype(np.float32)).bfloat16(),
        torch.from_numpy(acc.copy()), torch.from_numpy(g), 0.05, 128, 1e-10)
    assert got_s.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_s.float().numpy(),
                                  np.asarray(want_s).astype(np.float32))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finish_zero_gradient_rows_are_bit_identical(dtype):
    store, acc, g = _finish_case(0, 300, 128, 40, touched=1)
    s0 = torch.from_numpy(store).to(dtype)
    got_s, got_a = rwsadagrad_dense_finish(s0.clone(), torch.from_numpy(acc.copy()),
                                           torch.from_numpy(g), 0.1, 128, 1e-10)
    hit = np.abs(g).sum(1) > 0
    assert torch.equal(got_s[~hit], s0[~hit])
    assert (got_s[hit] != s0[hit]).any()
    np.testing.assert_array_equal(got_a.numpy()[:300][~hit], acc[:300][~hit])
    np.testing.assert_array_equal(got_a.numpy()[300:], acc[300:])


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("w", [128, 36])
def test_cuda_overwrite_matches_plain_version(cuda_device, w):
    case = _overwrite_case(3, 5000, 4096, w, consistent=True)
    store, idx, new_vals, delta, active = (torch.from_numpy(a).to(cuda_device) for a in case)
    launches = sparse_rows_overwrite.launches
    got = sparse_rows_overwrite(store.clone(), idx, new_vals, delta, active)
    torch.cuda.synchronize()
    assert sparse_rows_overwrite.launches == launches + 1
    want = sparse_rows_overwrite_reference(store.clone(), idx, new_vals, delta, active)
    # duplicates' deltas add in item order in the kernel, in atomic order
    # in the plain version's index_add_ on the card
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dim,dtype", [(128, torch.float32), (128, torch.bfloat16),
                                       (2, torch.float32), (64, torch.float32),
                                       (1, torch.float32), (8, torch.bfloat16),
                                       (512, torch.float32)])
def test_cuda_finish_matches_plain_version(cuda_device, dim, dtype):
    store, acc, g = _finish_case(4, 3000, dim, 100)
    s = torch.from_numpy(store).to(cuda_device, dtype)
    a = torch.from_numpy(acc).to(cuda_device)
    gt = torch.from_numpy(g).to(cuda_device)
    launches = rwsadagrad_dense_finish.launches
    got_s, got_a = rwsadagrad_dense_finish(s.clone(), a.clone(), gt, 0.05, dim, 1e-10)
    torch.cuda.synchronize()
    assert rwsadagrad_dense_finish.launches == launches + 1
    want_s, want_a = rwsadagrad_dense_finish_reference(s.clone(), a.clone(), gt, 0.05,
                                                       dim, 1e-10)
    torch.testing.assert_close(got_a, want_a, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_s.float(), want_s.float(),
                               rtol=1e-6 if dtype == torch.float32 else 8e-3, atol=0)


ROWS = (1 << 20) + SENTINEL_ROWS + 1  # the streams' rows and the clip margin


@pytest.mark.parametrize("w", [128, 36, 1, 2, 64, 640])
@pytest.mark.parametrize("name", STREAMS)
def test_cuda_overwrite_is_the_plain_version_bit_for_bit(cuda_device, name, w):
    """K2 on the card against its plain version run on a CPU copy of the
    rows its items name, where index_add_ adds a row's duplicates in item
    order: equal bit for bit, every other row untouched, and the tail's
    counts grown by this call's duplicated items, runs and long runs. The
    widths take 16-byte vectors (128, 64, 640: past a tail block's
    columns), one f32 a lane (36, 1, 2)."""
    idx, act = stream(name, ROWS - CLIP_MARGIN - 1)
    gen = torch.Generator(device=cuda_device).manual_seed(w)
    store = torch.rand(ROWS, w, device=cuda_device, generator=gen) - 0.5
    ids, active = (torch.from_numpy(a).to(cuda_device) for a in (idx, act))
    delta = torch.randn(ids.numel(), w, device=cuda_device, generator=gen) * 1e-2
    new_vals = store[ids.long()] + delta
    launches, before = sparse_rows_overwrite.launches, row_plan_counts()
    got = sparse_rows_overwrite(store.clone(), ids, new_vals, delta, active)
    torch.cuda.synchronize()
    assert sparse_rows_overwrite.launches == launches + 1
    after = row_plan_counts()
    grown = tuple(after[k] - before.get(k, 0) for k in
                  ("row_plan.dup_keys", "row_plan.runs", "row_plan.long_runs"))
    assert grown == tail_counts(idx, act)
    rows, inv = torch.unique(ids.long(), return_inverse=True)
    want = torch.cat([store[rows], store.new_zeros(CLIP_MARGIN + 1, w)]).cpu()
    sparse_rows_overwrite_reference(want, inv.int().cpu(), new_vals.cpu(), delta.cpu(),
                                    active.cpu())
    assert torch.equal(got[rows].cpu().view(torch.int32),
                       want[:rows.numel()].view(torch.int32))
    named = torch.zeros(ROWS, dtype=torch.bool, device=cuda_device)
    named[rows] = True
    assert not ((got != store).any(dim=1) & ~named).any()
