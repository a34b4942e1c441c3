"""K3's grouped finish (ops/dense_finish.rwsadagrad_dense_finish_many) and
the optimizer's dense-branch collector (optim/optimizer.finish_dense)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the grouped wrapper runs its plain version (the single
store's, store by store), so these tests hold that version, the one the
CUDA kernel is checked against on the card, to the JAX kernel called per
store. A store narrower than 128 columns goes through JAX's packed layout
(``pack = 128 // dim`` logical rows a physical row). The card-only cases
at the end hold the CUDA kernel's routes and its grouped launch to the
plain versions and skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_yx_tpu.ops.pallas_dense_finish import rwsadagrad_dense_finish as jax_finish
from dlrm_yx_tpu_torch.ops.dense_finish import (
    MAX_DESCS,
    rwsadagrad_dense_finish,
    rwsadagrad_dense_finish_many,
    rwsadagrad_dense_finish_many_reference,
    rwsadagrad_dense_finish_reference,
)
from dlrm_yx_tpu_torch.optim import optimizer as port_opt
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len, finish_dense, sparse_update

LR, EPS = 0.05, 1e-10

# (logical rows, dim, store dtype): widths 1 to 512, f32 and bf16, mixed rows
STORES = [(512, 1, "float32"), (384, 2, "bfloat16"), (256, 8, "float32"),
          (96, 16, "float32"), (200, 128, "bfloat16"), (60, 512, "float32"),
          (320, 4, "float32")]


def _store_case(seed, rows, dim, dtype, acc_extra=40):
    """(store [rows, dim] f32 values, acc, g) with a fifth of the rows
    touched; bf16 stores hold bf16-representable values."""
    rng = np.random.RandomState(seed)
    store = rng.randn(rows, dim).astype(np.float32)
    if dtype == "bfloat16":
        store = np.asarray(jnp.asarray(store, jnp.bfloat16).astype(jnp.float32))
    acc = np.abs(rng.randn(rows + acc_extra)).astype(np.float32)
    g = np.zeros((rows, dim), np.float32)
    hit = rng.choice(rows, size=max(2, rows // 5), replace=False)
    g[hit] = rng.randn(len(hit), dim).astype(np.float32)
    return store, acc, g


def _jax_finish(store, acc, g, dim, dtype):
    """JAX's kernel on its layout: a 128-lane physical row packs 128 // dim
    logical rows below 128 columns."""
    pack = 128 // dim if dim < 128 else 1
    w = dim * pack
    s = jnp.asarray(store.reshape(-1, w)).astype(jnp.dtype(dtype))
    got_s, got_a = jax_finish(s, jnp.asarray(acc), jnp.asarray(g.reshape(-1, w)), LR,
                              dim=dim, eps=EPS, interpret=True)
    return np.asarray(got_s.astype(jnp.float32)).reshape(-1, dim), np.asarray(got_a)


def _torch(store, acc, g, dtype):
    return (torch.from_numpy(store.copy()).to(getattr(torch, dtype)),
            torch.from_numpy(acc.copy()), torch.from_numpy(g))


def test_grouped_plain_version_matches_jax_kernel_per_store():
    """Seven stores of widths 1 to 512, f32 and bf16, in one grouped call
    against JAX's kernel store by store: accumulators at rtol 1e-6 / atol
    1e-7, f32 stores at 1e-6, bf16 stores bit for bit; each accumulator's
    padding kept."""
    cases = [_store_case(i, *spec) for i, spec in enumerate(STORES)]
    items = [_torch(s, a, g, dt) for (s, a, g), (_, _, dt) in zip(cases, STORES)]
    got = rwsadagrad_dense_finish_many(items, LR, EPS)
    for (gs, ga), (s, a, g), (rows, dim, dt) in zip(got, cases, STORES):
        want_s, want_a = _jax_finish(s, a, g, dim, dt)
        np.testing.assert_allclose(ga.numpy(), want_a, rtol=1e-6, atol=1e-7)
        if dt == "bfloat16":
            np.testing.assert_array_equal(gs.float().numpy(), want_s)
        else:
            np.testing.assert_allclose(gs.numpy(), want_s, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ga.numpy()[rows:], a[rows:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_keeps_untouched_rows_and_padding_bit_identical(dtype):
    cases = [_store_case(10 + i, rows, dim, dtype) for i, (rows, dim, _) in enumerate(STORES)]
    items = [_torch(s, a, g, dtype) for s, a, g in cases]
    before = [(s.clone(), a.clone()) for s, a, _ in items]
    rwsadagrad_dense_finish_many(items, LR, EPS)
    for (s, a, g), (s0, a0), (rows, _, _) in zip(items, before, STORES):
        idle = ~(g != 0).any(dim=1)
        assert torch.equal(s[idle], s0[idle]) and torch.equal(a[:rows][idle], a0[:rows][idle])
        assert torch.equal(a[rows:], a0[rows:])
        assert (s[~idle] != s0[~idle]).any()


def test_grouped_plain_version_is_the_single_store_plain_version():
    cases = [_store_case(20 + i, *spec) for i, spec in enumerate(STORES)]
    items = [_torch(s, a, g, dt) for (s, a, g), (_, _, dt) in zip(cases, STORES)]
    want = [rwsadagrad_dense_finish_reference(s.clone(), a.clone(), g, LR, s.shape[1], EPS)
            for s, a, g in items]
    got = rwsadagrad_dense_finish_many_reference(items, LR, EPS)
    for (gs, ga), (ws, wa) in zip(got, want):
        assert torch.equal(gs, ws) and torch.equal(ga, wa)


def test_grouped_rejects_bad_input():
    s, a, g = _torch(*_store_case(0, 64, 8, "float32"), "float32")
    with pytest.raises(ValueError, match="named twice"):
        rwsadagrad_dense_finish_many([(s, a, g), (s, a.clone(), g)], LR, EPS)
    with pytest.raises(ValueError, match="dense_g"):
        rwsadagrad_dense_finish_many([(s, a, g[:10])], LR, EPS)
    with pytest.raises(ValueError, match="acc"):
        rwsadagrad_dense_finish_many([(s, a[:10], g)], LR, EPS)
    assert rwsadagrad_dense_finish_many([], LR, EPS) == []
    assert MAX_DESCS == 64


# ------------------------------------------------- the optimizer's collector


def _update_case(seed, rows, dim, dtype, k=300, sentinel_extra=0):
    """A store, its padded 1-D momentum and a stream of row grads with
    duplicates and sentinel ids (the store's row count, and past it where
    ``sentinel_extra`` > 0)."""
    rng = np.random.RandomState(seed)
    store = torch.from_numpy(rng.randn(rows, dim).astype(np.float32)).to(getattr(torch, dtype))
    acc = torch.from_numpy(np.abs(rng.randn(acc_len(rows))).astype(np.float32))
    sentinel = rows + sentinel_extra
    idx = rng.randint(0, rows, k).astype(np.int32)
    idx[5:25] = idx[4]
    idx[-7:] = sentinel  # padding
    if sentinel_extra:
        idx[-12:-7] = rows + rng.randint(0, sentinel_extra, 5)  # ids past the store
    g = rng.randn(k, dim).astype(np.float32)
    return store, acc, torch.from_numpy(idx), torch.from_numpy(g), sentinel


def _finish_alone(store, acc, idx, g, sentinel, eps):
    """One store's dense-branch finish, written out: the exactly coalesced
    gradient by a scatter into zeros (ids past the store dropped, the
    sentinel to a spare row), then the plain K3."""
    r, d = store.shape
    dense_g = torch.zeros(r + 1, d)
    keep = idx <= r
    dense_g.index_add_(0, torch.where(keep, idx, r).long(), g * keep[:, None])
    rwsadagrad_dense_finish_reference(store, acc, dense_g[:r], LR, d, eps)


@pytest.mark.parametrize("sentinel_extra", [0, 9])
def test_finish_dense_equals_sparse_update_bit_for_bit(sentinel_extra):
    """Eight dense-branch stores of five widths (two of one width share a
    scatter), f32 and bf16, collected and finished at once, against
    sparse_update finishing each alone and against the per-store finish
    written out (``_finish_alone``): every store and accumulator equal bit
    for bit on the CPU; the ids past the store (XLA's mode='drop') and the
    sentinels touch nothing."""
    opt = OptConfig("rwsadagrad", LR)
    specs = [(640, 1, "float32"), (300, 8, "bfloat16"), (300, 8, "float32"),
             (100, 128, "float32"), (50, 512, "bfloat16"), (900, 4, "float32"),
             (77, 128, "bfloat16"), (64, 16, "float32")]
    cases = [_update_case(i, *spec, sentinel_extra=sentinel_extra)
             for i, spec in enumerate(specs)]
    alone = [(s.clone(), a.clone()) for s, a, *_ in cases]
    written_out = [(s.clone(), a.clone()) for s, a, *_ in cases]
    together = [(s.clone(), a.clone()) for s, a, *_ in cases]
    for (s, a), (_, _, idx, g, sentinel) in zip(alone, cases):
        sparse_update(opt, s, a, idx, g, LR, sentinel, impl="pallas", size_class=0)
    for (s, a), (_, _, idx, g, sentinel) in zip(written_out, cases):
        _finish_alone(s, a, idx, g, sentinel, opt.eps)
    collected = []
    for (s, a), (_, _, idx, g, sentinel) in zip(together, cases):
        sparse_update(opt, s, a, idx, g, LR, sentinel, impl="pallas", size_class=0,
                      finish=collected)
    assert len(collected) == len(cases)
    for (s, a), (s0, a0, *_) in zip(together, cases):  # nothing finished yet
        assert torch.equal(s, s0) and torch.equal(a, a0)
    finish_dense(collected, LR, opt.eps)
    for (s1, a1), (s2, a2), (s3, a3), (s0, *_) in zip(alone, together, written_out, cases):
        assert torch.equal(s1, s2) and torch.equal(a1, a2)
        assert torch.equal(s3, s2) and torch.equal(a3, a2)
        assert not torch.equal(s2, s0)


def test_finish_dense_takes_only_the_k3_route(monkeypatch):
    """The collector takes exactly the stores sparse_update would finish
    with K3 (RWSAdagrad, impl pallas or stream, 1-D momentum, no row_dim):
    Adagrad, the XLA impl and a row_dim store update at once as before."""
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    s, a, idx, g, sentinel = _update_case(1, 200, 16, "float32")
    row_dim = torch.full((200,), 8.0)
    for opt, impl, kw in ((OptConfig("adagrad", LR), "pallas", {}),
                          (OptConfig("rwsadagrad", LR), "xla", {}),
                          (OptConfig("rwsadagrad", LR), "pallas", {"row_dim": row_dim})):
        acc = torch.ones_like(s) if opt.name == "adagrad" else a.clone()
        store, collected = s.clone(), []
        sparse_update(opt, store, acc, idx, g, LR, sentinel, impl=impl, size_class=0,
                      finish=collected, **kw)
        assert collected == [] and not torch.equal(store, s)
    collected = []
    sparse_update(OptConfig("rwsadagrad", LR), s.clone(), a.clone(), idx, g, LR, sentinel,
                  impl="stream", size_class=0, finish=collected)
    assert len(collected) == 1


def test_finish_dense_launches_the_grouped_finish_once(monkeypatch):
    calls = []
    real = port_opt.rwsadagrad_dense_finish_many
    monkeypatch.setattr(port_opt, "rwsadagrad_dense_finish_many",
                        lambda stores, lr, eps: calls.append(len(stores)) or real(stores, lr, eps))
    opt = OptConfig("rwsadagrad", LR)
    collected = []
    for i, (rows, dim) in enumerate(((100, 8), (50, 128), (70, 8))):
        s, a, idx, g, sentinel = _update_case(30 + i, rows, dim, "float32")
        sparse_update(opt, s, a, idx, g, LR, sentinel, impl="pallas", size_class=0,
                      finish=collected)
    finish_dense(collected, LR, opt.eps)
    finish_dense([], LR, opt.eps)
    assert calls == [3]
    # without a collector, sparse_update finishes its store the same way
    sparse_update(opt, s, a, idx, g, LR, sentinel, impl="pallas", size_class=0)
    assert calls == [3, 1]


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _cuda_case(seed, rows, dim, dtype, device):
    return tuple(t.to(device) for t in _torch(*_store_case(seed, rows, dim, dtype), dtype))


def _assert_close(got, want, dtype):
    (gs, ga), (ws, wa) = got, want
    torch.testing.assert_close(ga, wa, rtol=1e-6, atol=0)
    torch.testing.assert_close(gs.float(), ws.float(),
                               rtol=1e-6 if dtype == "float32" else 8e-3, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [4, 8, 16, 32, 64, 1, 2, 3, 9, 128, 512])
def test_cuda_routes_match_plain_version(cuda_device, dim, dtype):
    """Each lane-group width G = 1, 2, 4, 8, 16 (16-byte dims 4-64, scalar
    dims 1-9) and the warp-per-row route at 128 and 512, one launch each."""
    s, a, g = _cuda_case(dim, 3001, dim, dtype, cuda_device)
    launches = rwsadagrad_dense_finish.launches
    got = rwsadagrad_dense_finish(s.clone(), a.clone(), g, LR, dim, EPS)
    torch.cuda.synchronize()
    assert rwsadagrad_dense_finish.launches == launches + 1
    _assert_close(got, rwsadagrad_dense_finish_reference(s.clone(), a.clone(), g, LR, dim, EPS),
                  dtype)


def test_cuda_grouped_launch_of_mixed_widths_matches_plain_version(cuda_device):
    cases = [_cuda_case(40 + i, rows, dim, dt, cuda_device)
             for i, (rows, dim, dt) in enumerate(STORES)]
    many, one = rwsadagrad_dense_finish_many.launches, rwsadagrad_dense_finish.launches
    got = rwsadagrad_dense_finish_many([(s.clone(), a.clone(), g) for s, a, g in cases], LR, EPS)
    torch.cuda.synchronize()
    assert rwsadagrad_dense_finish_many.launches == many + 1
    assert rwsadagrad_dense_finish.launches == one + 1
    want = rwsadagrad_dense_finish_many_reference(
        [(s.clone(), a.clone(), g) for s, a, g in cases], LR, EPS)
    for gw, ww, (_, _, dt) in zip(got, want, STORES):
        _assert_close(gw, ww, dt)
