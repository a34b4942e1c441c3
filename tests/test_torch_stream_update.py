"""The port's high-L sorted-stream update against the JAX package on the CPU:
K5 (``sorted_stream_apply``) and K6 (``sorted_stream_add``) in
``dlrm_yx_tpu_torch/ops/stream_update.py``, ``sparse_update_stream``, the
train step's stream route, the CLI, and the on-device batch generator.

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
hold that version (the one the CUDA kernel is checked against on the card)
to the JAX kernel, run in interpret mode. Everything is held to rtol 1e-5 /
atol 1e-6 in f32, stores included: where each package sorts for itself
(JAX's sort need not be stable) a row's duplicates may add in another
order, which moved stores by at most 2 ulp on these inputs, inside that
tolerance and ten times inside the JAX tests' own for this path (rtol 1e-4
/ atol 1e-5, ``tests/test_stream_update.py``). The card-only cases at the
end hold the CUDA kernels to the plain versions and skip without a card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_yx_tpu.ops.pallas_stream_update as jax_psu
import dlrm_yx_tpu.optim.optimizer as jax_opt
import dlrm_yx_tpu_torch.ops.stream_update as port_su
from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.batch import Batch as JaxBatch
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.train.train_step import make_train_step as jax_make_train_step
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import opt_state_from_jax, params_from_jax
from dlrm_yx_tpu_torch.data.synthetic import (
    RandomDataConfig,
    make_device_random_batches,
    make_random_batches,
)
from dlrm_yx_tpu_torch.models.dlrm import model_groups
from dlrm_yx_tpu_torch.ops.embedding import TableGroup
from dlrm_yx_tpu_torch.ops.stream_update import (
    sorted_stream_add,
    sorted_stream_add_reference,
    sorted_stream_apply,
    sorted_stream_apply_reference,
)
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, sparse_update_stream
from dlrm_yx_tpu_torch.train.train_step import make_train_step

F32 = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rows,k,dups", [
    (3000, 2000, False),
    (2500, 3000, True),
    (jax_psu.BLOCK_ROWS + 1, 7, False),   # a partial second block in JAX
])
def test_sorted_stream_add_plain_matches_jax(rows, k, dups):
    """Mirrors tests/test_stream_update.py::test_sorted_stream_add_matches_scatter
    at small R: sorted ids with duplicates and a tail of dropped sentinels."""
    r = np.random.RandomState(rows + k)
    base = r.randint(0, rows, k)
    if dups:
        base = np.concatenate([base[: k // 2], np.repeat(base[:50], (k - k // 2) // 50)])[:k]
    pos = np.concatenate([np.sort(base), np.full(37, rows + 3)]).astype(np.int32)
    upd = r.randn(len(pos), 128).astype(np.float32)
    store = r.randn(rows, 128).astype(np.float32)
    want = np.asarray(jax_psu.sorted_stream_add(
        jnp.asarray(store), jnp.asarray(pos), jnp.asarray(upd), interpret=True))
    got = sorted_stream_add(_t(store.copy()), _t(pos), _t(upd)).numpy()
    np.testing.assert_allclose(got, want, **F32)
    assert (got != store).any(axis=1).sum() == len(np.unique(base))


@pytest.mark.parametrize("dim,pack", [(128, 1), (64, 2)])
def test_sorted_stream_apply_plain_matches_jax(dim, pack):
    """Mirrors ::test_sorted_stream_apply_multiblock_multichunk: runs across
    the JAX kernel's store blocks and scalar chunks. The JAX store is
    physical [rp, 128] (pack logical rows a row, lane sub-slot h); the port's
    is the same memory as logical [rp * pack, dim] rows."""
    r = np.random.RandomState(7)
    rp = 2 * jax_psu.BLOCK_ROWS_APPLY + 333
    k = 2 * jax_psu.CHUNK + 777
    s_rows = 64
    pos_log = np.sort(np.concatenate([
        r.randint(0, jax_psu.BLOCK_ROWS_APPLY * pack // 2, k - 1000),
        r.randint(0, rp * pack, 1000),
    ])).astype(np.int32)
    seg = r.randint(0, s_rows, k).astype(np.int32)
    w = r.randn(k).astype(np.float32)
    g_log = r.randn(s_rows, dim).astype(np.float32)
    store = r.randn(rp, 128).astype(np.float32)
    chp = jax_psu.CHP

    def padded(a, fill):
        return jnp.asarray(np.concatenate([a, np.full(chp, fill, a.dtype)]))

    want = np.asarray(jax_psu.sorted_stream_apply(
        jnp.asarray(store), padded(pos_log // pack, rp), padded(seg, 0), padded(w, 0),
        padded(pos_log % pack, 0), jnp.asarray(np.tile(g_log, (1, pack))),
        dim=dim, pack=pack, n_live=k, interpret=True))
    # the port's stream ends in 5 dropped sentinels instead of CHP
    pos_p = np.concatenate([pos_log, np.full(5, rp * pack, np.int32)])
    got = sorted_stream_apply(
        _t(store.reshape(rp * pack, dim).copy()), _t(pos_p),
        _t(np.concatenate([seg, np.zeros(5, np.int32)])),
        _t(np.concatenate([w, np.ones(5, np.float32)])), _t(g_log))
    np.testing.assert_allclose(got.numpy().reshape(rp, 128), want, **F32)


def _apply_both(store, pos, seg, w, gtab):
    """K5 of both packages at dim 128 (pack 1): (port's plain version, JAX's
    kernel in interpret mode). JAX's grad table is padded to 8 rows."""
    s_rows = -(-gtab.shape[0] // 8) * 8
    g_pad = np.zeros((s_rows, 128), np.float32)
    g_pad[: gtab.shape[0]] = gtab
    chp, rows = jax_psu.CHP, store.shape[0]

    def padded(a, fill):
        return jnp.asarray(np.concatenate([a, np.full(chp, fill, a.dtype)]))

    want = np.asarray(jax_psu.sorted_stream_apply(
        jnp.asarray(store), padded(pos, rows), padded(seg, 0), padded(w, 0),
        padded(np.zeros_like(pos), 0), jnp.asarray(g_pad), dim=128, pack=1,
        n_live=len(pos), interpret=True))
    launches = sorted_stream_apply.launches
    got = sorted_stream_apply(_t(store.copy()), _t(pos), _t(seg), _t(w), _t(gtab)).numpy()
    assert sorted_stream_apply.launches == launches  # CPU tensors launch nothing
    return got, want


def _weight0_stream(case, seed):
    """(store, pos, seg, w, gtab) with weight-0 occurrences: ``all0`` (every
    run's weights 0), ``mixed`` (runs that mix 0 and nonzero weights) or
    ``row0`` (host padding: a run of 1,000 weight-0 items on row 0 beside
    live lookups)."""
    r = np.random.RandomState(seed)
    rows, s_rows = 700, 40
    if case == "row0":
        # the stable sort puts row 0's 3 real lookups among its padding
        pos = np.concatenate([np.zeros(1003, np.int64), np.sort(r.randint(1, rows, 600))])
        w = np.concatenate([np.zeros(1003), r.randn(600)])
        w[r.choice(1003, 3, replace=False)] = r.randn(3)
    else:
        pos = np.sort(np.concatenate([r.randint(0, rows, 900), np.repeat(r.randint(0, rows, 30),
                                                                        12)]))
        w = r.randn(len(pos))
        if case == "all0":
            w[:] = 0.0
        else:
            w[r.rand(len(pos)) < 0.5] = 0.0
    seg = r.randint(0, s_rows, len(pos))
    store = r.randn(rows, 128).astype(np.float32)
    gtab = r.randn(s_rows, 128).astype(np.float32)
    return store, pos.astype(np.int32), seg.astype(np.int32), w.astype(np.float32), gtab


@pytest.mark.parametrize("case", ["all0", "mixed", "row0"])
def test_sorted_stream_apply_weight0_runs_match_jax(case):
    """Weight-0 occurrences on a finite grad table change nothing, bit for
    bit, in both packages: only the rows with a nonzero weight move."""
    store, pos, seg, w, gtab = _weight0_stream(case, seed=len(case))
    got, want = _apply_both(store, pos, seg, w, gtab)
    np.testing.assert_allclose(got, want, **F32)
    live = np.zeros(store.shape[0], bool)
    live[pos[w != 0]] = True
    np.testing.assert_array_equal(got[~live], store[~live])
    np.testing.assert_array_equal(want[~live], store[~live])
    assert ((got != store).any(axis=1) == live).all()
    if case == "row0":
        assert (pos == 0).sum() == 1003 and live[0]


def test_sorted_stream_apply_nonfinite_grad_rows_under_weight0_match_jax():
    """0 * inf and 0 * NaN are NaN: a grad row holding inf and one holding
    NaN, referenced only by weight-0 occurrences, turn the rows they land on
    to NaN in both packages, in the same places."""
    store, pos, seg, w, gtab = _weight0_stream("mixed", seed=11)
    gtab[3, 17] = np.inf
    gtab[5, 100] = np.nan
    bad = (seg == 3) | (seg == 5)
    w[bad] = 0.0
    got, want = _apply_both(store, pos, seg, w, gtab)
    np.testing.assert_allclose(got, want, equal_nan=True, **F32)
    nan_rows = np.isnan(got).any(axis=1)
    assert nan_rows.any()
    np.testing.assert_array_equal(nan_rows, np.isnan(want).any(axis=1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    hit = np.zeros(store.shape[0], bool)
    hit[pos[bad]] = True
    np.testing.assert_array_equal(nan_rows, hit)


def test_stream_wrappers_reject_bad_inputs():
    store = torch.zeros(64, 8)
    pos = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="f32 store"):
        sorted_stream_add(store.double(), pos, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="pos"):
        sorted_stream_add(store, pos.long(), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="upd"):
        sorted_stream_add(store, pos, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="seg"):
        sorted_stream_apply(store, pos, pos.long(), torch.zeros(4), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="gtab"):
        sorted_stream_apply(store, pos, pos, torch.zeros(4), torch.zeros(3, 4))


# ------------------------------------------------------ sparse_update_stream


class _G:
    """The attributes of a table group that JAX's sparse_update_stream reads."""

    def __init__(self, dim, pack, total_rows):
        self.dim, self.pack, self.size_class, self.total_rows = dim, pack, 1, total_rows


def _stream_case(optname, dim, pack, seed):
    """The inputs of tests/test_stream_update.py::_factored_inputs (with
    duplicate-heavy ids and ~10% padding weights) for both packages."""
    t, b, l, per_table = 3, 8, 5, 64
    total = t * per_table
    r = np.random.RandomState(seed)
    idx = r.randint(0, per_table, (t, b, l)).astype(np.int32) % 7
    gidx = idx + (np.arange(t, dtype=np.int32) * per_table)[:, None, None]
    w = (r.rand(t, b, l) > 0.1).astype(np.float32)
    gp = r.randn(t, b, dim).astype(np.float32)
    rp = (total + pack - 1) // pack + 2
    store = r.randn(rp, 128).astype(np.float32)
    acc = np.abs(r.randn(total + 4)).astype(np.float32) if optname != "sgd" else None
    port_group = TableGroup((0, 1, 2), (per_table,) * 3, dim, (0, 64, 128), total)
    return _G(dim, pack, total), port_group, gidx, w, gp, store, acc


def _count_kernels(monkeypatch):
    """Counts the port's calls of its K5 and K6 wrappers."""
    calls = {"k5": 0, "k6": 0}
    for key, name in (("k5", "sorted_stream_apply"), ("k6", "sorted_stream_add")):
        fn = getattr(port_su, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_su, name, counted)
    return calls


def _both_stream_updates(monkeypatch, optname, dim, pack, seed):
    return _compare_stream_updates(monkeypatch, optname, pack,
                                   _stream_case(optname, dim, pack, seed))


def _compare_stream_updates(monkeypatch, optname, pack, case):
    jg, pg, gidx, w, gp, store, acc = case
    dim = pg.dim
    opt = OptConfig(optname, 0.1)
    want_s, want_a = jax_opt.sparse_update_stream(
        jax_opt.OptConfig(optname, 0.1), jnp.asarray(store),
        None if acc is None else jnp.asarray(acc), jg, jnp.asarray(gidx),
        jnp.asarray(w), jnp.asarray(gp), 0.1, interpret=True)
    calls = _count_kernels(monkeypatch)
    rp = store.shape[0]
    got_s, got_a = sparse_update_stream(
        opt, _t(store.reshape(rp * pack, dim).copy()),
        None if acc is None else _t(acc.copy()), pg, _t(gidx), _t(w), _t(gp), 0.1)
    np.testing.assert_allclose(got_s.numpy().reshape(rp, 128), np.asarray(want_s), **F32)
    assert not np.allclose(got_s.numpy().reshape(rp, 128), store)
    if acc is not None:
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **F32)
    return calls


@pytest.mark.parametrize("optname", ["sgd", "rwsadagrad"])
@pytest.mark.parametrize("dim,pack", [(128, 1), (64, 2), (32, 4)])
def test_sparse_update_stream_matches_jax(monkeypatch, optname, dim, pack):
    """Mirrors tests/test_stream_update.py::test_sparse_update_stream_matches_reference."""
    calls = _both_stream_updates(monkeypatch, optname, dim, pack, seed=3)
    assert calls == {"k5": 1, "k6": 0}


@pytest.mark.parametrize("optname", ["sgd", "rwsadagrad"])
def test_sparse_update_stream_fallback_matches_jax(monkeypatch, optname):
    """Mirrors ::test_sparse_update_stream_fallback_when_gtab_too_big: with the
    grad-table budget at 1 byte in both packages the values are expanded
    before the add, and the port takes K6, not K5."""
    monkeypatch.setattr(jax_psu, "GTAB_MAX_BYTES", 1)
    monkeypatch.setattr(port_su, "GTAB_MAX_BYTES", 1)
    calls = _both_stream_updates(monkeypatch, optname, 64, 2, seed=9)
    assert calls == {"k5": 0, "k6": 1}


@pytest.mark.parametrize("optname", ["sgd", "rwsadagrad"])
def test_sparse_update_stream_host_padding_matches_jax(monkeypatch, optname):
    """A host-random L=12 batch (``--data-generation random``) pads every bag
    with row 0 at weight 0, so each table's row 0 is one long run of mostly
    weight-0 items in the sorted stream; the update matches JAX's."""
    rows, dim, pack = (300, 400), 64, 2
    (batch,) = make_random_batches(RandomDataConfig(
        emb_rows=rows, m_den=4, mini_batch_size=64, num_batches=1,
        num_indices_per_lookup=12, num_indices_per_lookup_fixed=False, seed=8))
    total = sum(rows)
    gidx = batch.indices + np.array([0, rows[0]], np.int32)[:, None, None]
    pad = batch.weights == 0
    assert pad.mean() > 0.3 and (gidx[0][pad[0]] == 0).all()
    assert (gidx == 0).sum() > 100 and (gidx == rows[0]).sum() > 100
    r = np.random.RandomState(2)
    gp = r.randn(2, 64, dim).astype(np.float32)
    store = r.randn((total + pack - 1) // pack + 2, 128).astype(np.float32)
    acc = np.abs(r.randn(total + 4)).astype(np.float32) if optname != "sgd" else None
    group = TableGroup((0, 1), rows, dim, (0, rows[0]), total)
    calls = _compare_stream_updates(
        monkeypatch, optname, pack,
        (_G(dim, pack, total), group, gidx, batch.weights, gp, store, acc))
    assert calls == {"k5": 1, "k6": 0}


def test_gtab_budget_routes_like_jax():
    """The K5-or-K6 rule counts the table as JAX lays it out (128 lanes,
    rows padded to 8): the reference benchmark's 8 tables take K5 at batch
    2048 and K6 past batch 2304, at dim 64 as at dim 128."""
    assert port_su.GTAB_MAX_BYTES == jax_psu.GTAB_MAX_BYTES
    assert port_su.gtab_fits(8 * 2048) and port_su.gtab_fits(8 * 2304)
    assert not port_su.gtab_fits(8 * 2305) and not port_su.gtab_fits(8 * 4096)
    assert port_su.gtab_fits(jax_psu.GTAB_MAX_BYTES // (128 * 4))
    assert not port_su.gtab_fits(jax_psu.GTAB_MAX_BYTES // (128 * 4) + 1)


# ---------------------------------------------------------- the train step

STREAM_MODEL = dict(emb_rows=(300, 400), ln_bot=(4, 8, 64), ln_top=(8, 1),
                    emb_split_threshold=0, loss="bce")


def _stream_batches(rows, n=3, b=16, l=12, seed=5):
    """Variable-length lookups: padding keeps id 0 with weight 0."""
    return make_random_batches(RandomDataConfig(
        emb_rows=rows, m_den=4, mini_batch_size=b, num_batches=n,
        num_indices_per_lookup=l, num_indices_per_lookup_fixed=False,
        round_targets=True, seed=seed))


@pytest.mark.parametrize("optname,impl,dim,gtab_budget", [
    ("sgd", "stream", 64, None),
    ("rwsadagrad", "stream", 64, None),
    ("sgd", "pallas", 64, None),          # SGD's automatic stream route
    ("sgd", "stream", 128, None),
    ("rwsadagrad", "stream", 128, None),
    ("sgd", "pallas", 128, None),
    ("rwsadagrad", "stream", 64, 1),      # K6: the grad table over budget
])
def test_train_step_stream_matches_jax(monkeypatch, optname, impl, dim, gtab_budget):
    """Three train steps of both packages from the same init_dlrm state on a
    small L=12 two-table model in the dense regime."""
    if gtab_budget is not None:
        monkeypatch.setattr(jax_psu, "GTAB_MAX_BYTES", gtab_budget)
        monkeypatch.setattr(port_su, "GTAB_MAX_BYTES", gtab_budget)
    kw = dict(STREAM_MODEL, ln_bot=(4, 8, dim), sparse_update_impl=impl)
    jcfg, pcfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    jp = jax_init_dlrm(jcfg, seed=11)
    js = jax_opt.init_opt_state(jax_opt.OptConfig(optname, 0.1), jp, jax_model_groups(jcfg))
    js = jax.tree.map(lambda a: a + 0.01, js)  # a nonzero starting state
    opt = OptConfig(optname, 0.1)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    ps = opt_state_from_jax(jax.tree.map(np.asarray, js), opt, pcfg, "cpu")
    calls = _count_kernels(monkeypatch)
    jstep = jax_make_train_step(jcfg, jax_opt.OptConfig(optname, 0.1))
    pstep = make_train_step(pcfg, opt, device="cpu")
    jl, pl = [], []
    for i, batch in enumerate(_stream_batches(pcfg.emb_rows)):
        jp, js, loss = jstep(jp, js, JaxBatch(*map(jnp.asarray, batch)), i)
        jl.append(float(loss))
        pp, ps, loss = pstep(pp, ps, batch, i)
        pl.append(float(loss))
    k6 = gtab_budget is not None
    assert calls == {"k5": 3 * (not k6), "k6": 3 * k6}
    np.testing.assert_allclose(pl, jl, **F32)
    for name in ("bot", "top"):
        for (jw, jb), (pw, pb) in zip(jp[name], pp[name]):
            np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **F32)
            np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **F32)
    (g,) = model_groups(pcfg)
    np.testing.assert_allclose(pp["emb"][0].numpy(),
                               np.asarray(jp["emb"][0]).reshape(g.total_rows, g.dim), **F32)
    if optname != "sgd":
        np.testing.assert_allclose(ps["emb"][0].numpy(), np.asarray(js["emb"][0]), **F32)


# ------------------------------------------------------------------ the CLI

CLI_STREAM = [
    "--arch-embedding-size", "300-400", "--arch-sparse-feature-size", "64",
    "--arch-mlp-bot", "4-16-64", "--arch-mlp-top", "8-1", "--emb-split-threshold", "0",
    "--num-batches", "3", "--mini-batch-size", "16", "--num-indices-per-lookup", "12",
    "--loss-function", "bce", "--learning-rate", "0.1", "--round-targets", "True",
    "--sparse-update-impl", "stream", "--print-time",
]


def _losses(text):
    return [float(x) for x in re.findall(r"Finished training it \d+ of epoch \d+, "
                                         r"[\d.]+ ms/it, loss ([\d.]+)", text)]


@pytest.mark.parametrize("optname", ["sgd", "rwsadagrad"])
def test_cli_stream_matches_jax_cli(monkeypatch, capsys, optname):
    calls = _count_kernels(monkeypatch)
    flags = CLI_STREAM + ["--optimizer", optname]
    want = jax_cli_main(flags)
    want_out = capsys.readouterr().out
    got = port_cli.main(flags + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert len(_losses(got_out)) == len(_losses(want_out)) == 3
    np.testing.assert_allclose(_losses(got_out), _losses(want_out), **F32)
    assert calls == {"k5": 3, "k6": 0}
    hint = re.compile(r"duplicate-density hint from first batch: ([\d.]+)")
    assert hint.search(got_out).group(1) == hint.search(want_out).group(1)
    assert set(got) == set(want)
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-6


def test_cli_runs_the_reference_benchmark_flags_at_small_size(monkeypatch, capsys):
    """bench/dlrm_tpu_benchmark.sh's flags (SGD, --sparse-update-impl
    pallas, random-device data, bf16, --print-time) at small tables: SGD's
    dense regime takes K5 on every step."""
    calls = _count_kernels(monkeypatch)
    metrics = port_cli.main([
        "--arch-sparse-feature-size=64", "--arch-embedding-size=3000-3000-3000",
        "--arch-mlp-bot=16-16-64", "--arch-mlp-top=16-16-1", "--arch-interaction-op=dot",
        "--data-generation=random-device", "--num-indices-per-lookup=100",
        "--mini-batch-size=32", "--num-batches=4", "--loss-function=bce",
        "--round-targets=True", "--learning-rate=0.1", "--compute-dtype=bfloat16",
        "--sparse-update-impl=pallas", "--print-freq=2", "--print-time",
        "--emb-split-threshold=1000", "--device", "cpu"])
    out = capsys.readouterr().out
    assert calls == {"k5": 4, "k6": 0}
    assert len(_losses(out)) == 2 and all(np.isfinite(_losses(out)))
    assert "duplicate-density hint from first batch" in out
    assert np.isfinite(metrics["accuracy"])


# ------------------------------------------------------ device batches (CPU)


def _device_batches(**kw):
    args = dict(emb_rows=(10, 1000, 70000), m_den=5, mini_batch_size=64, num_batches=3,
                num_indices_per_lookup=9, device="cpu")
    args.update(kw)
    return make_device_random_batches(**args)


def test_device_batches_shapes_ranges_and_weights():
    batches = _device_batches()
    assert len(batches) == 3 and len(list(batches)) == 3
    rows = np.array([10, 1000, 70000])
    for b in batches:
        assert b.dense.shape == (64, 5) and b.dense.dtype == torch.float32
        assert b.indices.shape == (3, 64, 9) and b.indices.dtype == torch.int32
        assert b.weights.shape == (3, 64, 9) and b.weights.dtype == torch.float32
        assert b.labels.shape == (64, 1) and b.labels.dtype == torch.float32
        assert ((b.dense >= 0) & (b.dense < 1)).all()
        idx = b.indices.numpy()
        assert (idx >= 0).all() and (idx < rows[:, None, None]).all()
        w = b.weights.numpy()
        assert set(np.unique(w)) <= {0.0, 1.0}
        lens = w.sum(-1)
        assert lens.min() >= 1 and lens.max() <= 9
        # a prefix of ones: the first len entries, then zeros
        assert (w == (np.arange(9) < lens[..., None])).all()
        assert set(np.unique(b.labels.numpy())) <= {0.0, 1.0}
    assert len(np.unique(batches[0].indices.numpy()[2])) > 500


def test_device_batches_fixed_length_and_unrounded_labels():
    b = _device_batches(num_indices_per_lookup_fixed=True, round_targets=False)[1]
    assert (b.weights == 1).all()
    assert len(np.unique(b.labels.numpy())) > 2


def test_device_batches_repeat_by_seed_and_differ_by_index():
    a, b = _device_batches(seed=4), _device_batches(seed=4)
    for i in range(3):
        for x, y in zip(a[i], b[i]):
            assert torch.equal(x, y)
    assert not torch.equal(a[0].indices, a[1].indices)
    assert not torch.equal(a[0].dense, _device_batches(seed=5)[0].dense)
    with pytest.raises(IndexError):
        a[3]


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(dim, k, rows, seed):
    r = np.random.RandomState(seed)
    pos = np.sort(r.randint(0, rows, k))
    pos[100:140] = pos[100]  # a long run
    pos = np.sort(np.concatenate([pos, np.full(9, rows + 1)])).astype(np.int32)
    store = r.randn(rows, dim).astype(np.float32)
    return r, pos, store


@pytest.mark.parametrize("dim", [64, 128, 32, 2, 36])
def test_cuda_sorted_stream_apply_matches_plain_version(cuda_device, dim):
    r, pos, store = _card_case(dim, 20000, 5000, dim)
    n = len(pos)
    seg = r.randint(0, 300, n).astype(np.int32)
    w = r.randn(n).astype(np.float32)
    gtab = r.randn(300, dim).astype(np.float32)
    args = [_t(a).to(cuda_device) for a in (pos, seg, w, gtab)]
    s = _t(store).to(cuda_device)
    launches = sorted_stream_apply.launches
    got = sorted_stream_apply(s.clone(), *args)
    torch.cuda.synchronize()
    assert sorted_stream_apply.launches == launches + 1
    want = sorted_stream_apply_reference(s.clone(), *args)
    # a row's duplicates add in k order in the kernel, in atomic order in
    # the plain version's index_add_ on the card
    assert (got - want).abs().max().item() <= 1e-5
    cpu = sorted_stream_apply(_t(store.copy()), *(_t(a) for a in (pos, seg, w, gtab)))
    assert (got.cpu() - cpu).abs().max().item() == 0  # the same order as the CPU's


@pytest.mark.parametrize("dim", [64, 128, 2])
def test_cuda_sorted_stream_add_matches_plain_version(cuda_device, dim):
    r, pos, store = _card_case(dim, 20000, 5000, dim + 1)
    upd = r.randn(len(pos), dim).astype(np.float32)
    p, u, s = (_t(a).to(cuda_device) for a in (pos, upd, store))
    launches = sorted_stream_add.launches
    got = sorted_stream_add(s.clone(), p, u)
    torch.cuda.synchronize()
    assert sorted_stream_add.launches == launches + 1
    want = sorted_stream_add_reference(s.clone(), p, u)
    assert (got - want).abs().max().item() <= 1e-5
    cpu = sorted_stream_add(_t(store.copy()), _t(pos), _t(upd))
    assert (got.cpu() - cpu).abs().max().item() == 0


@pytest.mark.parametrize("case", ["all0", "mixed", "row0"])
def test_cuda_sorted_stream_apply_weight0_traffic(cuda_device, case):
    """The kernel applies only the live occurrences: the same store as the
    plain version on the CPU, bit for bit (no -0.0 in these stores), and a
    non-finite grad row under weight-0 items only turns the same elements
    to NaN."""
    store, pos, seg, w, gtab = _weight0_stream(case, seed=3)
    if case == "mixed":
        gtab[3, 17] = np.inf
        gtab[5, 100] = np.nan
        w[(seg == 3) | (seg == 5)] = 0.0
    cpu = sorted_stream_apply(_t(store.copy()), _t(pos), _t(seg), _t(w), _t(gtab)).numpy()
    got = sorted_stream_apply(_t(store).to(cuda_device),
                              *(_t(a).to(cuda_device) for a in (pos, seg, w, gtab)))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), cpu)
