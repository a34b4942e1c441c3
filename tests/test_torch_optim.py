"""The port's optimizer pieces (dlrm_yx_tpu_torch/optim, ops/coalesce.py)
against the JAX package on the CPU.

``sparse_update`` is held to JAX's on one store and one duplicate-heavy
batch over every optimizer, impl, duplicate-density hint and size class,
with the kernel routes forced on the small store by patching
``PALLAS_MIN_STORE_BYTES`` in both packages; the JAX Pallas kernels run in
interpret mode. The kernel routes that take K4 (``sparse_rows_add``) are
counted: Adagrad's accumulator, a bf16 store, an update without the
lookup's rows and a 1-D accumulator past ``ACC_KERNEL_MIN_BYTES``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_yx_tpu.optim.optimizer as jax_opt
import dlrm_yx_tpu_torch.optim.optimizer as port_opt
from dlrm_yx_tpu.ops.coalesce import coalesce_rows as jax_coalesce
from dlrm_yx_tpu.optim.lr_policy import LRPolicy as JaxLRPolicy
from dlrm_yx_tpu_torch.ops.coalesce import coalesce_rows
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len

TOL = dict(rtol=1e-5, atol=1e-6)


def assert_within_one_bf16_ulp(got, want):
    """|got - want| at most one bf16 ulp of the larger magnitude, element by
    element (exact where both are 0)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    ulp = np.ldexp(np.float32(1.0), e - 8)  # 8 significant bits
    bad = np.abs(got - want) > np.where(got == want, 0, ulp)
    assert not bad.any(), f"{bad.sum()} elements beyond one bf16 ulp"


def _counted(monkeypatch, *attrs):
    """Count the port optimizer's calls of each kernel wrapper in attrs."""
    calls = dict.fromkeys(attrs, 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in attrs:
        monkeypatch.setattr(port_opt, name, counted(name, getattr(port_opt, name)))
    return calls


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, num_warmup_steps=5, decay_start_step=10, num_decay_steps=20),
    dict(base_lr=0.07, num_warmup_steps=7),
    dict(base_lr=0.2, decay_start_step=3, num_decay_steps=9),
    dict(base_lr=0.03),
])
def test_lr_policy_matches_jax_bitwise(kw):
    want, got = JaxLRPolicy(**kw), LRPolicy(**kw)
    for it in range(41):
        assert got(it) == float(np.float32(want(it))), it


@pytest.mark.parametrize("with_aux", [False, True])
def test_coalesce_rows_matches_jax(with_aux):
    r = np.random.RandomState(0)
    idx = r.randint(0, 20, 64).astype(np.int32)
    g = r.randn(64, 8).astype(np.float32)
    aux = r.randn(20, 8).astype(np.float32)[idx]  # one payload per row
    want = jax_coalesce(jnp.asarray(idx), jnp.asarray(g), 99,
                        aux=jnp.asarray(aux) if with_aux else None)
    got = coalesce_rows(torch.from_numpy(idx), torch.from_numpy(g), 99,
                        aux=torch.from_numpy(aux) if with_aux else None)
    assert len(got) == len(want)
    for w, p in zip(want, got):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    n = len(np.unique(idx))
    assert (got[0][:n].diff() > 0).all() and (got[0][n:] == 99).all()
    assert not got[1][n:].any()


def _update_case(optname, size_class):
    r = np.random.RandomState(13)
    d, rows = 128, (1 << 12) + 8
    store = r.randn(rows, d).astype(np.float32)
    store[-8:] = 0.0  # sentinel rows, zero as in a model's store
    if optname == "adagrad":
        acc = np.abs(r.randn(rows, d)).astype(np.float32)
    elif optname == "rwsadagrad":
        acc = np.zeros(acc_len(rows), np.float32)
        acc[:rows] = np.abs(r.randn(rows))
    else:
        acc = None
    idx = r.randint(0, 24, 96).astype(np.int32)  # heavy duplicates
    idx[::5] = r.randint(0, rows - 8, len(idx[::5]))
    g = r.randn(96, d).astype(np.float32)
    return store, acc, idx, g, store[idx]


@pytest.mark.parametrize("size_class", [0, 1])
@pytest.mark.parametrize("hint", [-1.0, 0.99])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("optname", ["sgd", "adagrad", "rwsadagrad"])
def test_sparse_update_matches_jax(monkeypatch, optname, impl, hint, size_class):
    monkeypatch.setattr(jax_opt, "PALLAS_MIN_STORE_BYTES", 0)
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    store, acc, idx, g, old = _update_case(optname, size_class)
    rows = store.shape[0]
    kw = dict(impl=impl, size_class=size_class, density_hint=hint)
    t = torch.from_numpy
    args = (OptConfig(optname, 0.05), t(store.copy()),
            None if acc is None else t(acc.copy()), t(idx), t(g), 0.05, rows)
    # K3: the optimizer finishes a dense-branch store through the grouped
    # wrapper (finish_dense), one call for the store
    calls = _counted(monkeypatch, "sparse_rows_overwrite", "rwsadagrad_dense_finish_many",
                     "sparse_rows_add")
    got_s, got_a = port_opt.sparse_update(*args, old_rows=t(old), **kw)
    want_s, want_a = jax_opt.sparse_update(
        jax_opt.OptConfig(optname, 0.05), jnp.asarray(store),
        None if acc is None else jnp.asarray(acc), jnp.asarray(idx),
        jnp.asarray(g), 0.05, rows, interpret=True, old_rows=jnp.asarray(old), **kw)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    if acc is not None:
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    kernel_route = impl == "pallas" and size_class == 1
    assert calls["sparse_rows_overwrite"] == int(kernel_route)
    assert calls["rwsadagrad_dense_finish_many"] == int(impl == "pallas" and size_class == 0
                                                        and optname == "rwsadagrad")
    # Adagrad's per-element accumulator takes K4 on the kernel route
    assert calls["sparse_rows_add"] == int(kernel_route and optname == "adagrad")
    assert np.abs(got_s.numpy() - store).max() > 0


@pytest.mark.parametrize("why", ["bf16 store", "no rows", "big accumulator"])
def test_kernel_routes_without_a_kernel_raise(monkeypatch, why):
    """The kernel routes that raised while K4 was missing: a bf16 store, an
    update without the lookup's rows, and a 1-D accumulator past
    ACC_KERNEL_MIN_BYTES (gates patched to 0 in both packages). Each now
    takes K4 and matches the JAX package: an f32 store and the accumulators
    to TOL, a bf16 store to one bf16 ulp (the f32 updates it rounds are
    summed in other orders by torch and XLA)."""
    for mod in (jax_opt, port_opt):
        monkeypatch.setattr(mod, "PALLAS_MIN_STORE_BYTES", 0)
        if why == "big accumulator":
            monkeypatch.setattr(mod, "ACC_KERNEL_MIN_BYTES", 0)
    store, acc, idx, g, old = _update_case("rwsadagrad", 1)
    rows = store.shape[0]
    jstore = jnp.asarray(store, jnp.bfloat16 if why == "bf16 store" else jnp.float32)
    before = np.array(jstore.astype(jnp.float32))  # a copy: the port updates in place
    store_t = torch.from_numpy(before.copy())
    if why == "bf16 store":
        store_t = store_t.bfloat16()
    old = None if why == "no rows" else old
    calls = _counted(monkeypatch, "sparse_rows_overwrite", "sparse_rows_add")
    t = torch.from_numpy
    got_s, got_a = port_opt.sparse_update(
        OptConfig("rwsadagrad", 0.05), store_t, t(acc.copy()), t(idx), t(g), 0.05, rows,
        impl="pallas", old_rows=None if old is None else t(old))
    want_s, want_a = jax_opt.sparse_update(
        jax_opt.OptConfig("rwsadagrad", 0.05), jstore, jnp.asarray(acc), jnp.asarray(idx),
        jnp.asarray(g), 0.05, rows, impl="pallas", interpret=True,
        old_rows=None if old is None else jnp.asarray(old))
    want_s = np.asarray(want_s.astype(jnp.float32))
    if why == "bf16 store":
        assert got_s.dtype == torch.bfloat16
        assert_within_one_bf16_ulp(got_s.float().numpy(), want_s)
    else:
        np.testing.assert_allclose(got_s.numpy(), want_s, **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    k2 = why == "big accumulator"  # f32 store with the lookup's rows: write-only
    assert calls == {"sparse_rows_overwrite": int(k2),
                     "sparse_rows_add": 1 + (why == "big accumulator") - k2}
    assert (got_s.float().numpy() != before).any()


def test_dense_update_matches_jax():
    r = np.random.RandomState(2)
    p, g = r.randn(2, 33, 7).astype(np.float32)
    acc = np.abs(r.randn(33, 7)).astype(np.float32)
    for name in ("sgd", "adagrad"):
        got_p, got_a = torch.from_numpy(p.copy()), torch.from_numpy(acc.copy())
        port_opt.dense_update(OptConfig(name, 0.03), [got_p], [torch.from_numpy(g)],
                              None if name == "sgd" else [got_a], 0.03)
        want_p, want_a = jax_opt.dense_update(
            jax_opt.OptConfig(name, 0.03), jnp.asarray(p), jnp.asarray(g),
            None if name == "sgd" else jnp.asarray(acc), jnp.float32(0.03))
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
        if name != "sgd":
            np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def test_uniform_stream_density_matches_jax():
    rows = (70000, 5, 300000, 100)
    assert port_opt.uniform_stream_density(rows, 65536, 2048, seed=4) == \
        jax_opt.uniform_stream_density(rows, 65536, 2048, seed=4)
