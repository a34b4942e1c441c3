"""The port's row read-modify-write update K4 (ops/sparse_rows_add.py)
against the JAX package's ``sparse_rows_add``, run in interpret mode on the
CPU.

On a CPU tensor the wrapper runs its plain PyTorch version, so these tests
hold that version (the one the CUDA kernel is checked against on the card,
bit for bit) to the JAX kernel: every row outside the sentinel unit must be
equal bit for bit, in f32 and in bf16, because the port applies each row's
occurrences in the JAX kernel's order (main pass, then the flagged tail)
and rounds after every add as it does. JAX's interpret mode skips
stochastic rounding, so SR is held to its definition and to statistics.
The card-only cases at the end hold the CUDA kernel to the plain version
and skip without a card. The file imports JAX only where it is installed,
so that on a machine with the card and without JAX the card cases run and
the JAX cases skip: ``python -m pytest --noconftest
tests/test_torch_sparse_rows_add.py``.
"""

import numpy as np
import pytest
import torch

from dlrm_yx_tpu_torch.ops.embedding import dim_pack
from dlrm_yx_tpu_torch.ops.sparse_rows_add import (
    conflict_flags,
    sparse_rows_add,
    sparse_rows_add_reference,
    sr_bits,
    unit_rows,
)
from dlrm_yx_tpu_torch.optim.optimizer import acc_len
from torch_row_plan_cases import stream

try:
    import jax.numpy as jnp

    from dlrm_yx_tpu.ops.pallas_sparse_update import conflict_flags as jax_conflict_flags
    from dlrm_yx_tpu.ops.pallas_sparse_update import sparse_rows_add as jax_rows_add
except ImportError:  # a machine with the card and no JAX: the card cases alone
    jnp = jax_conflict_flags = jax_rows_add = None

SENTINEL_ROWS = 8
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jax_package():
    if jnp is None:
        pytest.skip("needs the JAX package: these cases hold the plain version to its kernel")


needs_jax = pytest.mark.usefixtures("jax_package")


@needs_jax
def test_conflict_flags_fixed_case():
    """tests/test_sparse_update.py::test_conflict_flags: items 2 and 5
    re-hit row 5; item 3's only earlier 9 is inactive."""
    idx = np.array([5, 9, 5, 9, 100, 5], np.int32)
    act = np.array([1, 0, 1, 1, 1, 1], np.int32)
    got = conflict_flags(torch.from_numpy(idx), torch.from_numpy(act))
    assert got.int().tolist() == [0, 0, 1, 0, 0, 1]
    assert got.int().tolist() == np.asarray(
        jax_conflict_flags(jnp.asarray(idx), jnp.asarray(act))).tolist()


@pytest.mark.parametrize("unit", [1, 8, 16, 128])
@needs_jax
def test_conflict_flags_match_jax(unit):
    """The port's window compare against JAX's 63 shifted compares, on row
    streams with near and far repeats, cut into units of ``unit`` rows."""
    r = np.random.RandomState(unit)
    rows = r.randint(0, 3000, 2000).astype(np.int32)
    rows[100:180] = r.randint(0, 40, 80)  # repeats inside the window
    rows[500:900:50] = 7  # repeats 50 items apart, just inside it
    rows[1000:1700:70] = 9  # 70 apart, just outside it
    act = (r.rand(2000) > 0.3).astype(np.int32)
    unit_ids = rows // unit
    want = np.asarray(jax_conflict_flags(jnp.asarray(unit_ids), jnp.asarray(act)))
    got = conflict_flags(torch.from_numpy(unit_ids), torch.from_numpy(act))
    np.testing.assert_array_equal(got.int().numpy(), want)
    assert want.sum() > 0


def _window_stream(unit, n_units, pairs, k=400, seed=0):
    """(rows [k] int32, active [k] int32): items on distinct units, except
    that for each (first, distance, first_active) of ``pairs`` the item
    ``distance`` later hits the first item's unit (another row of it when
    the unit has several rows); ``first_active`` 0 makes the first item
    inactive. Pairs from item 230 cross the CUDA plan kernel's 256-item
    blocks."""
    r = np.random.RandomState(seed + unit)
    units = r.permutation(n_units - 1)[:k]  # the last unit holds the sentinel rows
    rows = units * unit + r.randint(0, unit, k)
    act = np.ones(k, np.int32)
    for first, distance, live in pairs:
        rows[first + distance] = units[first] * unit + (rows[first] + 1) % unit
        act[first] = live
    return rows.astype(np.int32), act


@pytest.mark.parametrize("unit", [1, 8, 128])
@pytest.mark.parametrize("distance", [62, 63, 64])
@needs_jax
def test_conflict_flags_window_edges(unit, distance):
    """Repeats of a unit exactly ``distance`` items apart: flagged within
    63 items of an active item, as JAX flags them, and not after an
    inactive one (the third pair) or 64 items on."""
    pairs = ((20, distance, 1), (230, distance, 1), (330, distance, 0))
    rows, act = _window_stream(unit, 600, pairs)
    units = rows // unit
    want = np.asarray(jax_conflict_flags(jnp.asarray(units), jnp.asarray(act)))
    got = conflict_flags(torch.from_numpy(units), torch.from_numpy(act)).int().numpy()
    np.testing.assert_array_equal(got, want)
    expected = [20 + distance, 230 + distance] if distance < 64 else []
    assert np.flatnonzero(got).tolist() == expected


# pairs at all three distances, one of them after an inactive item
WINDOW_PAIRS = ((20, 62, 1), (120, 63, 1), (230, 64, 1), (240, 63, 1), (330, 62, 0))


def _fuzz_case(trial):
    """Trial ``trial`` of tests/test_sparse_update.py::test_sparse_rows_add_fuzz
    (its RandomState(99) draws, in its order)."""
    rng = np.random.RandomState(99)
    for t in range(trial + 1):
        R = int(rng.randint(5, 375)) * 8 + SENTINEL_ROWS
        K = int(rng.randint(1, 700))
        d = 128 * int(rng.choice([1, 2]))
        dupmax = int(rng.randint(1, R - SENTINEL_ROWS))
        store = rng.randn(R, d).astype(np.float32)
        idx = rng.randint(0, dupmax, K).astype(np.int32)
        upd = rng.randn(K, d).astype(np.float32)
        act = (rng.rand(K) > 0.3).astype(np.int32)
    return store, idx, upd, act, ("float32" if trial % 2 == 0 else "bfloat16")


def _case(name, arg, dtype):
    """(logical store [R, d], idx, upd, active, dtype) of a JAX kernel test."""
    if name == "fuzz":
        return _fuzz_case(arg)
    if name == "reference":  # test_sparse_rows_add_matches_reference
        dupmax, d = arg
        r = np.random.RandomState(0)
        store = r.randn(4096 + SENTINEL_ROWS, d).astype(np.float32)
        idx = r.randint(0, dupmax, 512).astype(np.int32)
        upd = r.randn(512, d).astype(np.float32)
        return store, idx, upd, (r.rand(512) > 0.2).astype(np.int32), dtype
    if name == "same_row":  # test_sparse_rows_add_all_same_row_overflows_to_fallback
        r = np.random.RandomState(1)
        store = r.randn(64 + SENTINEL_ROWS, 128).astype(np.float32)
        upd = r.randn(2048, 128).astype(np.float32)
        return store, np.full(2048, 7, np.int32), upd, np.ones(2048, np.int32), dtype
    if name == "packed":  # test_sparse_rows_add_packed_sub128_dims
        d = arg
        pack = dim_pack(d)
        r = np.random.RandomState(11)
        rows = 2048 * pack
        store = r.randn(rows, d).astype(np.float32)
        idx = r.randint(0, rows - 8 * pack, 512).astype(np.int32)
        idx[:32] = r.randint(0, 4 * pack, 32)  # unit conflicts
        upd = r.randn(512, d).astype(np.float32)
        return store, idx, upd, (r.rand(512) > 0.2).astype(np.int32), dtype
    if name == "skewed":  # 30% of the items on 10 rows
        r = np.random.RandomState(5)
        store = r.randn(4096 + SENTINEL_ROWS, 128).astype(np.float32)
        idx = r.randint(0, 4096, 512).astype(np.int32)
        hot = r.rand(512) < 0.3
        idx[hot] = idx[:10][r.randint(0, 10, hot.sum())]
        upd = r.randn(512, 128).astype(np.float32)
        return store, idx, upd, (r.rand(512) > 0.2).astype(np.int32), dtype
    if name == "one_row":  # every item on one row, a fifth of them inactive
        r = np.random.RandomState(6)
        store = r.randn(256 + SENTINEL_ROWS, 128).astype(np.float32)
        upd = r.randn(300, 128).astype(np.float32)
        return store, np.full(300, 77, np.int32), upd, (r.rand(300) > 0.2).astype(np.int32), dtype
    if name == "window":  # WINDOW_PAIRS in units of 1 (f32), 8 (bf16), 128 ([len, 1])
        r = np.random.RandomState(7)
        if dtype == "acc":
            rows, act = _window_stream(128, 600, WINDOW_PAIRS)
            store = np.abs(r.randn(128 * 600)).astype(np.float32)[:, None]
            return store, rows, np.abs(r.randn(400, 1)).astype(np.float32), act, "float32"
        unit = 8 if dtype == "bfloat16" else 1
        rows, act = _window_stream(unit, 4096 // unit + 1, WINDOW_PAIRS)
        store = r.randn(4096 + SENTINEL_ROWS, 128).astype(np.float32)
        return store, rows, r.randn(400, 128).astype(np.float32), act, dtype
    if name in ("hot row on half of K", "power law, K=65536"):  # the row plan's tail
        r = np.random.RandomState(12)
        rows = 1 << 18
        idx, act = stream(name, rows)
        if dtype == "acc":  # a [len, 1] accumulator, 128-row units
            store = np.abs(r.randn(rows + 128)).astype(np.float32)[:, None]
            upd = np.abs(r.randn(idx.size, 1)).astype(np.float32)
            return store, idx, upd, act, "float32"
        store = r.randn(rows + SENTINEL_ROWS, 128).astype(np.float32)
        return store, idx, r.randn(idx.size, 128).astype(np.float32), act, dtype
    if name == "bf16":  # test_sparse_rows_add_bfloat16_store
        r = np.random.RandomState(0)
        store = r.randn(4096 + SENTINEL_ROWS, 128).astype(np.float32)
        idx = r.randint(0, 4000, 512).astype(np.int32)
        upd = r.randn(512, 128).astype(np.float32)
        return store, idx, upd, (r.rand(512) > 0.2).astype(np.int32), dtype
    # the [len, 1] view of a 1-D momentum accumulator
    # (test_huge_accumulator_kernel_route_matches_scatter)
    rng = np.random.RandomState(3)
    total = 1000
    acc = np.abs(rng.randn(acc_len(total))).astype(np.float32)
    idx = rng.randint(0, total, size=300).astype(np.int32)
    idx[-7:] = total
    idx[40:50] = idx[39]  # duplicates in one 128-entry unit
    inc = np.abs(rng.randn(300)).astype(np.float32)
    return acc[:, None], idx, inc[:, None], (idx < total).astype(np.int32), dtype


CASES = (
    [("reference", a, "float32") for a in ((16, 128), (500, 128), (500, 256), (4096, 128))]
    + [("same_row", None, "float32"), ("same_row", None, "bfloat16"),
       ("bf16", None, "bfloat16"), ("acc", None, "float32")]
    + [("packed", d, dt) for d in (8, 32, 64) for dt in ("float32", "bfloat16")]
    + [("fuzz", t, None) for t in range(8)]
    + [(name, None, dt) for name in ("skewed", "one_row") for dt in ("float32", "bfloat16")]
    + [("window", None, dt) for dt in ("float32", "bfloat16", "acc")]
)


@pytest.mark.parametrize("name,arg,dtype", CASES)
@needs_jax
def test_plain_matches_jax_kernel_bitwise(name, arg, dtype):
    store, idx, upd, act, dtype = _case(name, arg, dtype)
    rows, d = store.shape
    pack = dim_pack(d)
    jstore = jnp.asarray(store, dtype).reshape(rows // pack, d * pack)
    want = np.asarray(jax_rows_add(
        jstore, jnp.asarray(idx), jnp.asarray(upd), jnp.asarray(act), interpret=True,
        dim=d if pack > 1 else None).astype(jnp.float32)).reshape(rows, d)
    before = torch.from_numpy(store).to(TDT[dtype])
    got = sparse_rows_add(before.clone(), torch.from_numpy(idx), torch.from_numpy(upd),
                          torch.from_numpy(act))
    assert got.dtype == TDT[dtype]
    got = got.float().numpy()
    # the JAX kernel parks dead items on its last transfer unit (sentinel
    # rows, which it rewrites); the port never touches that unit
    dead = unit_rows(TDT[dtype], d)
    np.testing.assert_array_equal(got[:-dead], want[:-dead])
    np.testing.assert_array_equal(got[-dead:], before.float().numpy()[-dead:])
    assert (got != before.float().numpy()).any()


def _fmix32_bits(seed, k, c, dim):
    """murmur3's fmix32 of seed * 0x9E3779B9 ^ (k * dim + c), in Python ints."""
    m = 0xFFFFFFFF
    h = ((seed * 0x9E3779B9) & m) ^ ((k * dim + c) & m)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def test_sr_bits_are_fmix32():
    items = torch.tensor([0, 1, 7, 16383, 40000])
    for seed in (0, 1, 12345, 2**32 + 3):
        got = sr_bits(seed, items, 128)
        for i, k in enumerate(items.tolist()):
            for c in (0, 1, 77, 127):
                assert got[i, c].item() == _fmix32_bits(seed & 0xFFFFFFFF, k, c, 128)


def _bf16_case(seed=0, rows=4096, k=1024, unique=True):
    r = np.random.RandomState(seed)
    store = torch.from_numpy(r.randn(rows + SENTINEL_ROWS, 128).astype(np.float32)).bfloat16()
    idx = (r.permutation(rows)[:k] if unique else r.randint(0, rows, k)).astype(np.int32)
    upd = r.randn(k, 128).astype(np.float32) * 0.05
    return store, torch.from_numpy(idx), torch.from_numpy(upd), torch.ones(k, dtype=torch.int32)


def _bits(t):
    return t.view(torch.int16).numpy()


@needs_jax
def test_sr_takes_one_of_the_two_bracketing_bf16_values():
    """Each updated element is the f32 sum truncated to bf16 or the next
    bf16 away from zero (both occur); untouched rows keep every bit."""
    store, idx, upd, act = _bf16_case()
    got = sparse_rows_add(store.clone(), idx, upd, act, stochastic_round=True, seed=5)
    v = store[idx.long()].float() + upd
    lo = (v.view(torch.int32) & ~0xFFFF).view(torch.float32)
    hi = ((v.view(torch.int32) & ~0xFFFF) + 0x10000).view(torch.float32)
    new = got[idx.long()].float()
    assert ((new == lo) | (new == hi)).all()
    assert (new == lo).float().mean() > 0.3 and (new == hi).float().mean() > 0.3
    untouched = torch.ones(store.shape[0], dtype=torch.bool)
    untouched[idx.long()] = False
    np.testing.assert_array_equal(_bits(got[untouched]), _bits(store[untouched]))
    # without SR the store is JAX's, rounded to nearest even; SR differs
    # from it where it rounds the other way, on about a quarter of the
    # elements (probability min(p, 1 - p) for a uniform fraction p)
    rn = np.asarray(jax_rows_add(
        jnp.asarray(store.float().numpy(), jnp.bfloat16), jnp.asarray(idx.numpy()),
        jnp.asarray(upd.numpy()), jnp.asarray(act.numpy()), interpret=True,
    ).astype(jnp.float32))
    np.testing.assert_array_equal(
        sparse_rows_add(store.clone(), idx, upd, act).float().numpy(), rn)
    frac = (got.float().numpy() != rn)[idx.numpy()].mean()
    assert 0.15 < frac < 0.35


def test_sr_is_reproducible_by_seed_and_off_for_f32():
    store, idx, upd, act = _bf16_case(1, unique=False)
    a = sparse_rows_add(store.clone(), idx, upd, act, stochastic_round=True, seed=3)
    b = sparse_rows_add(store.clone(), idx, upd, act, stochastic_round=True, seed=3)
    c = sparse_rows_add(store.clone(), idx, upd, act, stochastic_round=True, seed=4)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert (_bits(a) != _bits(c)).any()
    f = store.float()
    np.testing.assert_array_equal(
        sparse_rows_add(f.clone(), idx, upd, act, stochastic_round=True, seed=3).numpy(),
        sparse_rows_add(f.clone(), idx, upd, act).numpy())


def test_sr_moves_the_mean_of_sub_ulp_updates():
    """16 updates of 2^-12 onto a bf16 store of 1.0 (512 rows, 65,536
    elements, one row in each 8-row unit, so that every update is in the
    main pass): round-to-nearest keeps 1.0 (half an ulp is 2^-8); SR moves
    the mean by 16 * 2^-12 within 5% (the mean's standard error is about
    0.5%)."""
    rows = 512
    idx = torch.arange(rows, dtype=torch.int32) * 8
    upd = torch.full((rows, 128), 2.0 ** -12)
    act = torch.ones(rows, dtype=torch.int32)
    moved = {}
    for sr in (False, True):
        store = torch.ones(8 * rows + SENTINEL_ROWS, 128, dtype=torch.bfloat16)
        for step in range(16):
            sparse_rows_add(store, idx, upd, act, stochastic_round=sr, seed=step)
        moved[sr] = store[idx.long()].double().mean().item() - 1.0
        assert (store[:-SENTINEL_ROWS].view(-1, 8, 128)[:, 1:] == 1).all()
    assert moved[False] == 0.0
    assert abs(moved[True] / (16 * 2.0 ** -12) - 1) < 0.05


def test_sr_applies_in_the_main_pass_only():
    """A row hit at items 0, 1 and 2: item 0 is in the JAX kernel's main
    pass and rounds stochastically; items 1 and 2 are flagged (tail) and
    round to nearest even."""
    r = np.random.RandomState(2)
    store = torch.from_numpy(r.randn(24, 128).astype(np.float32)).bfloat16()
    upd = torch.from_numpy(r.randn(3, 128).astype(np.float32) * 0.05)
    idx, act = torch.full((3,), 4, dtype=torch.int32), torch.ones(3, dtype=torch.int32)
    got = sparse_rows_add(store.clone(), idx, upd, act, stochastic_round=True, seed=9)
    v = store[4].float() + upd[0]
    u = (v.view(torch.int32).long() & 0xFFFFFFFF) + (sr_bits(9, torch.tensor([0]), 128)[0]
                                                     & 0xFFFF)
    u = u & 0xFFFF0000
    v = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)
    for k in (1, 2):
        v = (v + upd[k]).bfloat16().float()
    np.testing.assert_array_equal(got[4].float().numpy(), v.numpy())


def test_rows_add_rejects_bad_inputs():
    idx, act = torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="f32 or bf16"):
        sparse_rows_add(torch.zeros(64, 128, dtype=torch.float16), idx, torch.zeros(4, 128),
                        act)
    with pytest.raises(ValueError, match="units"):
        sparse_rows_add(torch.zeros(60, 128, dtype=torch.bfloat16), idx,
                        torch.zeros(4, 128), act)
    with pytest.raises(ValueError, match="upd"):
        sparse_rows_add(torch.zeros(64, 128), idx, torch.zeros(4, 64), act)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name,arg,dtype,sr", [
    ("bf16", None, "bfloat16", False), ("bf16", None, "bfloat16", True),
    ("packed", 64, "bfloat16", True), ("same_row", None, "bfloat16", True),
    ("reference", (500, 256), "float32", False), ("acc", None, "float32", False),
    ("skewed", None, "bfloat16", True), ("one_row", None, "float32", False),
    ("window", None, "bfloat16", True), ("window", None, "acc", False),
] + [(name, None, dtype, sr) for name in ("hot row on half of K", "power law, K=65536")
     for dtype, sr in (("bfloat16", True), ("bfloat16", False), ("float32", False),
                       ("acc", False))])
def test_cuda_rows_add_matches_plain_version_bitwise(cuda_device, name, arg, dtype, sr):
    store, idx, upd, act, dtype = _case(name, arg, dtype)
    s = torch.from_numpy(store).to(cuda_device, TDT[dtype])
    i, u, a = (torch.from_numpy(x).to(cuda_device) for x in (idx, upd, act))
    launches = sparse_rows_add.launches
    got = sparse_rows_add(s.clone(), i, u, a, stochastic_round=sr, seed=11)
    torch.cuda.synchronize()
    assert sparse_rows_add.launches == launches + 1
    want = sparse_rows_add_reference(s.clone(), i, u, a, stochastic_round=sr, seed=11)
    # flattened first: a [len, 1] store from NumPy has stride 0 on its last dim
    assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("name", ["hot row on half of K", "power law, K=65536"])
def test_cuda_rows_add_replays_its_capture_bit_for_bit(cuda_device, name):
    """K4 (bf16, SR) captured in a CUDA graph and replayed twice on the
    same store: each replay equals the plain version bit for bit, so the
    first left the scratch as the second needs it (zero where a call reads
    before it writes)."""
    store, idx, upd, act, dtype = _case(name, None, "bfloat16")
    s = torch.from_numpy(store).to(cuda_device, TDT[dtype])
    i, u, a = (torch.from_numpy(x).to(cuda_device) for x in (idx, upd, act))
    seed = torch.full((), 11, dtype=torch.int64, device=cuda_device)
    want = sparse_rows_add_reference(s.clone(), i, u, a, stochastic_round=True, seed=11)
    work = s.clone()
    sparse_rows_add(work, i, u, a, stochastic_round=True, seed=seed)  # makes the scratch
    torch.cuda.synchronize()
    assert torch.equal(work.view(torch.int16), want.view(torch.int16))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sparse_rows_add(work, i, u, a, stochastic_round=True, seed=seed)
    for _ in range(2):
        work.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(work.view(torch.int16), want.view(torch.int16))
