"""The embedding variants of the port (QR, mixed-dimension and weighted
pooling) against the JAX package on the CPU.

Inputs come from numpy seeds; both packages start from the JAX
``init_dlrm`` params (which the port's ``init_dlrm`` equals bit for bit)
and a nonzero optimizer state carried across with ``convert``. The kernel
routes are forced on small stores by patching ``PALLAS_MIN_STORE_BYTES``
and ``ACC_KERNEL_MIN_BYTES`` (and ``GTAB_MAX_BYTES`` for K6) in both
packages; JAX runs its Pallas kernels in interpret mode. Each train-step
case also counts the kernel calls: the port's per step equal JAX's per
trace (its step is traced once). Tolerances: rtol 1e-5 / atol 1e-6 in
f32, 2e-2 with bf16 compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_yx_tpu.ops.pallas_dense_finish as jax_k3
import dlrm_yx_tpu.ops.pallas_sparse_update as jax_psu
import dlrm_yx_tpu.ops.pallas_stream_update as jax_stream
import dlrm_yx_tpu.optim.optimizer as jax_opt
import dlrm_yx_tpu_torch.ops.stream_update as port_stream
import dlrm_yx_tpu_torch.optim.optimizer as port_opt
from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.batch import Batch as JaxBatch
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.ops import embedding as jemb
from dlrm_yx_tpu.ops import md_embedding as jmd
from dlrm_yx_tpu.ops import qr_embedding as jqr
from dlrm_yx_tpu.train import checkpoint as jax_ckpt
from dlrm_yx_tpu.train.train_step import make_accum_train_step as jax_accum_step
from dlrm_yx_tpu.train.train_step import make_eval_step as jax_eval_step
from dlrm_yx_tpu.train.train_step import make_train_step as jax_train_step
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, init_dlrm_on_device, model_groups
from dlrm_yx_tpu_torch.ops import embedding as pemb
from dlrm_yx_tpu_torch.ops import md_embedding as pmd
from dlrm_yx_tpu_torch.ops import qr_embedding as pqr
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.train import checkpoint as port_ckpt
from dlrm_yx_tpu_torch.train.train_step import (
    make_accum_train_step,
    make_eval_step,
    make_train_step,
)

TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# QR: tables 0 and 3 (3000 and 5000 rows) become quotient tables of 750
# and 1250 rows x 128 (the kernel route's K4, with no sentinel tail) and
# remainder tables of 4 rows (K3); tables 1 and 2 form one small group (K3)
QR = dict(emb_rows=(3000, 40, 60, 5000), ln_bot=(4, 64, 128), ln_top=(64, 1),
          emb_split_threshold=100, loss="bce", interaction_impl="pallas", qr_flag=True)
# MD at D=16 (md_solver, temperature 0.3, rounded): dims 16 (50 rows, small
# group, under the threshold), 8 (300 rows), 2 (100,000 rows: packed
# W=2 big group, K2) and 1 (1,000,000 rows: W=1 big group, K2)
MD_ROWS = (50, 300, 100_000, 1_000_000)
MD = dict(emb_rows=MD_ROWS, ln_bot=(4, 32, 16), ln_top=(32, 1), emb_split_threshold=100,
          loss="bce", md_flag=True)
# weighted pooling at L=1: a small group (K3) and a big one (K2), D=128
WEIGHTED = dict(emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 64, 128), ln_top=(64, 1),
                emb_split_threshold=100, loss="bce", interaction_impl="pallas")
# the stream route (L=12, dim 64 packed 2 to a row: K5, or K6)
STREAM = dict(emb_rows=(300, 400), ln_bot=(4, 16, 64), ln_top=(16, 1),
              emb_split_threshold=0, loss="bce")


def md_dims(rows, d0, temperature=0.3, threshold=200):
    dims = jmd.md_solver(np.array(rows), temperature, d0=d0, round_dim=True)
    return tuple(int(m) if n > threshold else d0 for m, n in zip(dims, rows))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(rows, b, lookups, n, seed):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        idx = np.stack([r.randint(0, m, (b, lookups)) for m in rows]).astype(np.int32)
        idx[0, :5, 0] = idx[0, 0, 0]  # a duplicated row
        idx[-1, 7, 0] = rows[-1] - 1  # the last row of the last table
        w = (r.rand(len(rows), b, lookups) > 0.2).astype(np.float32)
        w[:, :, 0] = 1.0
        out.append(Batch(r.rand(b, 4).astype(np.float32), idx, w,
                         (r.rand(b, 1) > 0.5).astype(np.float32)))
    return out


def _force_routes(monkeypatch, gtab_max=None):
    for mod in (jax_opt, port_opt):
        monkeypatch.setattr(mod, "PALLAS_MIN_STORE_BYTES", 0)
        monkeypatch.setattr(mod, "ACC_KERNEL_MIN_BYTES", 0)
    if gtab_max is not None:
        monkeypatch.setattr(jax_stream, "GTAB_MAX_BYTES", gtab_max)
        monkeypatch.setattr(port_stream, "GTAB_MAX_BYTES", gtab_max)


KERNELS = {  # name: (JAX module, port module)
    "sparse_rows_overwrite": (jax_psu, port_opt),
    "sparse_rows_add": (jax_psu, port_opt),
    # the port's K3 runs through its grouped finish, counted store by store
    # in _count_kernels
    "rwsadagrad_dense_finish": (jax_k3, None),
    "sorted_stream_apply": (jax_stream, port_stream),
    "sorted_stream_add": (jax_stream, port_stream),
}


def _count_kernels(monkeypatch):
    """Counts of each kernel's calls in JAX (at trace time) and the port.
    The port's K3 count is of the stores its grouped finish finishes
    (``finish_dense``: one call a step for every dense-branch store), whose
    calls ``calls["grouped"]`` counts."""
    calls = {"jax": dict.fromkeys(KERNELS, 0), "port": dict.fromkeys(KERNELS, 0),
             "grouped": 0}
    for name, mods in KERNELS.items():
        for side, mod in zip(("jax", "port"), mods):
            if mod is None:
                continue
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _side=side, _name=name, **k):
                calls[_side][_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, counted)
    many = port_opt.rwsadagrad_dense_finish_many

    def grouped(stores, *a, **k):
        calls["port"]["rwsadagrad_dense_finish"] += len(stores)
        calls["grouped"] += 1
        return many(stores, *a, **k)

    monkeypatch.setattr(port_opt, "rwsadagrad_dense_finish_many", grouped)
    return calls


def _assert_trees_close(jax_tree, port_tree, tol):
    want = jax.tree.leaves(_np(jax_tree))
    got = jax.tree.leaves(port_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32).reshape(w.shape), w, **tol)


def _start(kw, optname, seed=3, mutate=None):
    """(JAX params and state, port params and state) from one JAX init; the
    state is nonzero; ``mutate(params)`` edits the JAX params first."""
    jcfg, pcfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    jp = jax_init_dlrm(jcfg, seed=seed)
    if mutate is not None:
        jp = mutate(jp)
    js = jax.tree.map(lambda a: a + 0.01, jax_opt.init_opt_state(
        jax_opt.OptConfig(optname, 0.05), jp, jax_model_groups(jcfg)))
    opt = OptConfig(optname, 0.05)
    pp = params_from_jax(_np(jp), pcfg, "cpu")
    ps = opt_state_from_jax(_np(js), opt, pcfg, "cpu")
    return jcfg, pcfg, opt, (jp, js), (pp, ps)


def _run_both(monkeypatch, kw, optname, lookups=1, b=64, steps=3, mutate=None,
              gtab_max=None):
    """The eval step, then ``steps`` train steps, in both packages from the
    same state. Returns both (params, state, losses, eval predictions), the
    kernel counts and the port's config."""
    _force_routes(monkeypatch, gtab_max)
    jcfg, pcfg, opt, (jp, js), (pp, ps) = _start(kw, optname, mutate=mutate)
    batches = _batches(pcfg.emb_rows, b, lookups, steps, seed=11)
    jeval = jax_eval_step(jcfg)(jp, JaxBatch(*map(jnp.asarray, batches[0])))
    peval = make_eval_step(pcfg, device="cpu")(pp, batches[0])
    calls = _count_kernels(monkeypatch)
    jstep = jax_train_step(jcfg, jax_opt.OptConfig(optname, 0.05))
    pstep = make_train_step(pcfg, opt, device="cpu")
    jl, pl = [], []
    for i, batch in enumerate(batches):
        jp, js, loss = jstep(jp, js, JaxBatch(*map(jnp.asarray, batch)), i)
        jl.append(float(loss))
        pp, ps, loss = pstep(pp, ps, batch, i)
        pl.append(float(loss))
    return ((jp, js, jl, jeval), (pp, ps, pl, peval), calls, pcfg)


def _compare(jax_out, port_out, cfg, tol):
    (jp, js, jl, (jpred, jloss)), (pp, ps, pl, (ppred, ploss)) = jax_out, port_out
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), **tol)
    np.testing.assert_allclose(float(ploss), float(jloss), **tol)
    np.testing.assert_allclose(pl, jl, **tol)
    _assert_trees_close(jp, params_to_jax(pp, cfg), tol)
    _assert_trees_close(js, opt_state_to_jax(ps, cfg), tol)


def _per_step(calls, steps=3):
    """The port's calls per step, which must equal JAX's per trace."""
    assert all(n % steps == 0 for n in calls["port"].values()), calls
    per = {k: n // steps for k, n in calls["port"].items()}
    assert per == calls["jax"], calls
    return per


# ---------------------------------------------------------------- MD


@pytest.mark.parametrize("rows,d0,temperature,round_dim", [
    (DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000).emb_rows, 128, 0.3, True),
    (DLRMConfig.kaggle().emb_rows, 16, 0.3, True),
    (DLRMConfig.kaggle().emb_rows, 16, 0.5, False),
    (MD_ROWS, 16, 0.3, True),
])
def test_md_solver_matches_jax(rows, d0, temperature, round_dim):
    want = jmd.md_solver(np.array(rows), temperature, d0=d0, round_dim=round_dim)
    got = pmd.md_solver(np.array(rows), temperature, d0=d0, round_dim=round_dim)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    budget = pmd.alpha_power_rule(np.sort(np.array(rows)), 0.2, b_budget=1e6)
    np.testing.assert_array_equal(
        budget, jmd.alpha_power_rule(np.sort(np.array(rows)), 0.2, b_budget=1e6))


def test_md_dims_of_the_chip_configs():
    """The dims the card's MD phases rely on: Terabyte-MLPerf (1M cap) puts
    its 8 big tables at dim 4, Kaggle at dim 1, and MD_ROWS gives the
    packed widths 1 and 2."""
    tb = DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000).emb_rows
    dims = md_dims(tb, 128)
    assert {dims[t] for t, n in enumerate(tb) if n > 65536} == {4}
    assert sorted(set(dims)) == [4, 8, 16, 32, 128]
    kg = DLRMConfig.kaggle().emb_rows
    assert {md_dims(kg, 16)[t] for t, n in enumerate(kg) if n > 65536} == {1}
    assert md_dims(MD_ROWS, 16) == (16, 8, 2, 1)


# ---------------------------------------------------------------- QR


@pytest.mark.parametrize("op", ["mult", "add", "concat"])
def test_qr_lookup_and_row_grads_match_jax(op):
    r = np.random.RandomState(["mult", "add", "concat"].index(op))
    spec = dict(table_id=0, rows=50, dim=8, collisions=4, operation=op)
    jspec, pspec = jqr.QRSpec(**spec), pqr.QRSpec(**spec)
    assert (pspec.q_rows, pspec.out_dim) == (jspec.q_rows, jspec.out_dim)
    q, rr = jqr.init_qr(np.random.RandomState(5), jspec)
    pq, pr = pqr.init_qr(np.random.RandomState(5), pspec)
    np.testing.assert_array_equal(pq, q)
    np.testing.assert_array_equal(pr, rr)
    idx = r.randint(0, 50, (6, 3)).astype(np.int32)
    w = (r.rand(6, 3) > 0.3).astype(np.float32)
    g = r.randn(6, pspec.out_dim).astype(np.float32)
    t = torch.from_numpy
    want = jqr.qr_lookup(jnp.asarray(q), jnp.asarray(rr), jspec, jnp.asarray(idx), jnp.asarray(w))
    got = pqr.qr_lookup(t(q), t(rr), pspec, t(idx), t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    (jqi, jgq), (jri, jgr) = jqr.qr_row_grads(jnp.asarray(q), jnp.asarray(rr), jspec,
                                              jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g))
    (pqi, pgq), (pri, pgr) = pqr.qr_row_grads(t(q), t(rr), pspec, t(idx), t(w), t(g))
    np.testing.assert_array_equal(pqi.numpy(), np.asarray(jqi))
    np.testing.assert_array_equal(pri.numpy(), np.asarray(jri))
    np.testing.assert_allclose(pgq.numpy(), np.asarray(jgq), **TOL["float32"])
    np.testing.assert_allclose(pgr.numpy(), np.asarray(jgr), **TOL["float32"])


# --------------------------------------------------- weighted pooling


@pytest.mark.parametrize("dim,l", [(128, 1), (16, 3), (64, 12)])
def test_vw_lookup_and_row_grads_match_jax(dim, l):
    g = pemb.build_table_groups((50, 7, 300), (dim,) * 3)[0]
    jg = jemb.TableGroup(**vars(g))
    r = np.random.RandomState(dim + l)
    store = r.randn(g.total_rows, dim).astype(np.float32)
    vw = r.randn(g.total_rows).astype(np.float32)
    vw[::5] = 0.0
    idx = np.stack([r.randint(0, n, (16, l)) for n in g.rows]).astype(np.int32)
    w = (r.rand(3, 16, l) > 0.3).astype(np.float32)
    gp = r.randn(3, 16, dim).astype(np.float32)
    t = torch.from_numpy
    js = jnp.asarray(jemb.pack_store(store, g))
    want = jemb.lookup_group(js, jg, jnp.asarray(idx), jnp.asarray(w), jnp.asarray(vw))
    got = pemb.lookup_group(t(store), g, t(idx), t(w), t(vw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    ji, jgr = jemb.vw_row_grads(jg, js, jnp.asarray(idx), jnp.asarray(w), jnp.asarray(gp))
    pi, pgr = pemb.vw_row_grads(g, t(store), t(idx), t(w), t(gp))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pgr.numpy(), np.asarray(jgr), rtol=1e-5, atol=1e-5)
    # the row grads carry the v_W factor (packed: JAX's physical rows)
    ji, jfg = jemb.flat_row_grads(jg, jnp.asarray(idx), jnp.asarray(w), jnp.asarray(gp),
                                  jnp.asarray(vw))
    pi, pfg = pemb.flat_row_grads(g, t(idx), t(w), t(gp), t(vw))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    jfg = np.asarray(jfg)
    if g.pack > 1:  # each logical row's lanes of the physical update row
        lanes = (np.asarray(ji) % g.pack)[:, None] * dim + np.arange(dim)
        jfg = np.take_along_axis(jfg, lanes, axis=1)
    np.testing.assert_allclose(pfg.numpy(), jfg, **TOL["float32"])


# ------------------------------------------------------ init and convert


INIT_CASES = {
    "qr mult + fixed pooling": dict(QR, weighted_pooling="fixed"),
    "qr concat": dict(QR, qr_operation="concat", ln_top=(128, 1)),
    "md": dict(MD, emb_dims=md_dims(MD_ROWS, 16)),
    "md + learned pooling": dict(MD, emb_dims=md_dims(MD_ROWS, 16), weighted_pooling="learned"),
    "qr + md": dict(emb_rows=(3000, 40, 600), emb_dims=(16, 16, 4), ln_bot=(4, 16),
                    ln_top=(16, 1), qr_flag=True, qr_threshold=1000, md_flag=True),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_init_dlrm_matches_jax_bit_for_bit(case):
    kw = INIT_CASES[case]
    jcfg, pcfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    want = jax_init_dlrm(jcfg, seed=9)
    got = init_dlrm(pcfg, seed=9, device="cpu")
    assert set(got) == set(want)
    back = params_to_jax(got, pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(_np(want))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(want))):
        np.testing.assert_array_equal(g, w)
    # and back again: the port's tree from JAX's, leaf for leaf
    again = params_from_jax(_np(want), pcfg, "cpu")
    for g, w in zip(jax.tree.leaves(params_to_jax(again, pcfg)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, w)
    for optname in ("adagrad", "rwsadagrad"):
        js = jax_opt.init_opt_state(jax_opt.OptConfig(optname), want, jax_model_groups(jcfg))
        ps = init_opt_state(OptConfig(optname), got, model_groups(pcfg))
        back = opt_state_to_jax(ps, pcfg)
        assert jax.tree.structure(back) == jax.tree.structure(_np(js))
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(js))):
            np.testing.assert_array_equal(g, w)


def test_refusals_match_jax():
    """Learned pooling with QR tables, and QR or MD tables in device init,
    raise in both packages; device init gives ``vw`` ones on real rows."""
    kw = dict(QR, weighted_pooling="learned")
    with pytest.raises(NotImplementedError):
        jax_init_dlrm(JaxConfig.build(**kw))
    with pytest.raises(NotImplementedError, match="learned weighted pooling with QR"):
        init_dlrm(DLRMConfig.build(**kw), device="cpu")
    for kw in (QR, dict(MD, emb_dims=md_dims(MD_ROWS, 16))):
        with pytest.raises(NotImplementedError, match="plain tables only"):
            init_dlrm_on_device(DLRMConfig.build(**kw), device="cpu")
    cfg = DLRMConfig.build(**dict(WEIGHTED, weighted_pooling="learned"))
    vw = init_dlrm_on_device(cfg, device="cpu")["vw"]
    want = init_dlrm(cfg, device="cpu")["vw"]
    for a, b in zip(vw, want):
        assert torch.equal(a, b)


# ------------------------------------------------------- train steps


@pytest.mark.parametrize("optname,cdt,op", [
    ("rwsadagrad", "float32", "mult"),
    ("sgd", "float32", "mult"),
    ("rwsadagrad", "float32", "concat"),
    ("sgd", "float32", "add"),
    ("rwsadagrad", "bfloat16", "mult"),
])
def test_qr_train_steps_match_jax(monkeypatch, optname, cdt, op):
    kw = dict(QR, qr_operation=op, compute_dtype=cdt, sparse_update_impl="pallas")
    if op == "concat":
        kw["ln_top"] = (128, 1)
    jax_out, port_out, calls, cfg = _run_both(monkeypatch, kw, optname)
    _compare(jax_out, port_out, cfg, TOL[cdt])
    per = _per_step(calls)
    # the quotient tables take K4; under RWSAdagrad the small group and the
    # two remainder tables (4 rows each: the dense regime) take K3
    rws = optname == "rwsadagrad"
    assert per["sparse_rows_add"] == 2
    assert per["rwsadagrad_dense_finish"] == 3 * rws
    assert calls["grouped"] == 3 * rws  # the three stores in one call a step
    # the last quotient row (table 3's id 4999 -> q row 1249) never moves:
    # K4 clips it onto row 1248 in both packages (ROADMAP Queue C, fault 4)
    start = np.asarray(jax_init_dlrm(JaxConfig.build(**kw), seed=3)["qr"][1][0])
    q = port_out[0]["qr"][1][0].numpy()
    np.testing.assert_array_equal(q[-1], start[-1])
    assert (q[-2] != start[-2]).any()


@pytest.mark.parametrize("optname,cdt", [
    ("sgd", "float32"), ("rwsadagrad", "float32"), ("rwsadagrad", "bfloat16")])
def test_md_train_steps_match_jax(monkeypatch, optname, cdt):
    kw = dict(MD, emb_dims=md_dims(MD_ROWS, 16), compute_dtype=cdt,
              sparse_update_impl="pallas")
    jax_out, port_out, calls, cfg = _run_both(monkeypatch, kw, optname)
    _compare(jax_out, port_out, cfg, TOL[cdt])
    per = _per_step(calls)
    # the W=1 and W=2 big groups take K2 (the lookup's rows are there); the
    # dim-8 and dim-16 groups take K3 under RWSAdagrad
    assert [g.dim for g in model_groups(cfg)] == [1, 2, 8, 16]
    assert per["sparse_rows_overwrite"] == 2
    assert per["rwsadagrad_dense_finish"] == 2 * (optname == "rwsadagrad")
    assert calls["grouped"] == 3 * (optname == "rwsadagrad")  # both in one call a step
    # the MD projections trained
    start = jax_init_dlrm(JaxConfig.build(**kw), seed=3)["md_proj"]
    assert all((p.numpy() != np.asarray(s)).any()
               for p, s in zip(port_out[0]["md_proj"], start))


def _zero_some_vw(jp):
    """v_W 0 on some rows and negative on others (a learned v_W can go there)."""
    vw = []
    for v in jp["vw"]:
        v = np.array(v)
        v[:40] = 0.0
        v[40:60] = -0.5
        vw.append(jnp.asarray(v))
    return {**jp, "vw": vw}


@pytest.mark.parametrize("pooling,optname,impl,cdt", [
    ("learned", "rwsadagrad", "pallas", "float32"),
    ("learned", "sgd", "pallas", "float32"),
    ("fixed", "rwsadagrad", "pallas", "float32"),
    ("learned", "rwsadagrad", "xla", "bfloat16"),
])
def test_weighted_train_steps_match_jax(monkeypatch, pooling, optname, impl, cdt):
    kw = dict(WEIGHTED, weighted_pooling=pooling, compute_dtype=cdt, sparse_update_impl=impl)
    jax_out, port_out, calls, cfg = _run_both(monkeypatch, kw, optname, mutate=_zero_some_vw)
    _compare(jax_out, port_out, cfg, TOL[cdt])
    per = _per_step(calls)
    assert per["sparse_rows_overwrite"] == int(impl == "pallas")
    vw0 = np.asarray(_zero_some_vw(jax_init_dlrm(JaxConfig.build(**kw), seed=3))["vw"][1])
    moved = port_out[0]["vw"][1].numpy() != vw0
    assert moved.any() == (pooling == "learned")


@pytest.mark.parametrize("pooling,optname,impl,gtab_max", [
    ("learned", "sgd", "pallas", None),       # K5 with w * vw
    ("fixed", "rwsadagrad", "stream", None),  # K5 with RWSAdagrad's momentum
    ("learned", "sgd", "stream", 1),          # K6: the grad table over budget
])
def test_weighted_stream_steps_match_jax(monkeypatch, pooling, optname, impl, gtab_max):
    """The stream route at L=12 with v_W 0 or negative on some rows: K5
    skips weight-0 occurrences, so such rows must still match JAX."""
    kw = dict(STREAM, weighted_pooling=pooling, sparse_update_impl=impl)
    jax_out, port_out, calls, cfg = _run_both(monkeypatch, kw, optname, lookups=12, b=32,
                                              mutate=_zero_some_vw, gtab_max=gtab_max)
    _compare(jax_out, port_out, cfg, TOL["float32"])
    per = _per_step(calls)
    kernel = "sorted_stream_add" if gtab_max else "sorted_stream_apply"
    assert per[kernel] == 1 and sum(per.values()) == 1


@pytest.mark.parametrize("case", ["qr", "learned"])
def test_accum_step_matches_jax(monkeypatch, case):
    kw = (dict(QR, sparse_update_impl="pallas") if case == "qr"
          else dict(WEIGHTED, weighted_pooling="learned", sparse_update_impl="pallas"))
    _force_routes(monkeypatch)
    jcfg, pcfg, opt, (jp, js), (pp, ps) = _start(kw, "rwsadagrad", mutate=(
        None if case == "qr" else _zero_some_vw))
    micro = _batches(pcfg.emb_rows, 64, 1, 4, seed=2)
    stacks = [Batch(*(np.stack(f) for f in zip(*micro[i:i + 2]))) for i in (0, 2)]
    jstep = jax_accum_step(jcfg, jax_opt.OptConfig("rwsadagrad", 0.05), 2)
    pstep = make_accum_train_step(pcfg, opt, 2, device="cpu")
    jl, pl = [], []
    for i, batch in enumerate(stacks):
        jp, js, loss = jstep(jp, js, JaxBatch(*map(jnp.asarray, batch)), i)
        jl.append(float(loss))
        pp, ps, loss = pstep(pp, ps, batch, i)
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, **TOL["float32"])
    _assert_trees_close(jp, params_to_jax(pp, pcfg), TOL["float32"])
    _assert_trees_close(js, opt_state_to_jax(ps, pcfg), TOL["float32"])


# --------------------------------------------------- K2 at any width


@pytest.mark.parametrize("w", [1, 2, 4])
def test_overwrite_at_packed_widths_matches_jax_kernel(w):
    """K2's plain version on a logical [R, w] store against the JAX kernel
    on its packed twin [R / pack, 128] (pack = 128 / w), fed as the JAX
    package's sparse_update feeds it: physical ids, the gathered physical
    rows plus the lane-placed deltas. Duplicates, rows sharing a physical
    row and inactive items included."""
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite

    pack = 128 // w
    r_phys = 64 + 8  # 8 dead physical rows at the end, as a group store has
    r = np.random.RandomState(w)
    store = r.randn(r_phys * pack, w).astype(np.float32)
    k = 300
    idx = r.randint(0, 64 * pack, k).astype(np.int32)
    idx[40:60] = idx[39]
    idx[100:110] = idx[100] // pack * pack + np.arange(10) % pack  # one physical row
    active = (r.rand(k) > 0.2).astype(np.int32)
    delta = r.randn(k, w).astype(np.float32)
    phys = store.reshape(r_phys, 128)
    lanes = (idx % pack)[:, None] * w + np.arange(w)
    delta_p = np.zeros((k, 128), np.float32)
    np.put_along_axis(delta_p, lanes, delta, axis=1)
    want = np.asarray(jax_psu.sparse_rows_overwrite(
        jnp.asarray(phys), jnp.asarray(idx // pack), jnp.asarray(phys[idx // pack] + delta_p),
        jnp.asarray(delta_p), jnp.asarray(active), interpret=True)).reshape(-1, w)
    t = torch.from_numpy
    got = sparse_rows_overwrite(t(store.copy()), t(idx), t(store[idx] + delta), t(delta),
                                t(active)).numpy()
    live = slice(0, 64 * pack)  # JAX parks dead items on its last physical row
    np.testing.assert_array_equal(got[live], want[live])
    np.testing.assert_array_equal(got[64 * pack:], store[64 * pack:])
    assert (got != store).any()


# ------------------------------------------------ the reference fault


def test_k4_on_a_store_without_sentinel_rows_moves_the_last_row_in_both():
    """ROADMAP Queue C, fault 4: a QR quotient table has no sentinel tail,
    and K4 clips active ids to R - 1 - unit in both packages, so an SGD
    update of the last row lands on the row before it (rows 63 and 5 of a
    64-row f32 store, -1 each)."""
    store = np.zeros((64, 128), np.float32)
    idx = np.array([63, 5], np.int32)
    g = np.ones((2, 128), np.float32)
    saved = jax_opt.PALLAS_MIN_STORE_BYTES, port_opt.PALLAS_MIN_STORE_BYTES
    jax_opt.PALLAS_MIN_STORE_BYTES = port_opt.PALLAS_MIN_STORE_BYTES = 0
    try:
        want, _ = jax_opt.sparse_update(jax_opt.OptConfig("sgd", 1.0), jnp.asarray(store), None,
                                        jnp.asarray(idx), jnp.asarray(g), 1.0, 64,
                                        impl="pallas", interpret=True)
        got, _ = port_opt.sparse_update(OptConfig("sgd", 1.0), torch.from_numpy(store.copy()),
                                        None, torch.from_numpy(idx), torch.from_numpy(g), 1.0,
                                        64, impl="pallas", packed=False)
    finally:
        jax_opt.PALLAS_MIN_STORE_BYTES, port_opt.PALLAS_MIN_STORE_BYTES = saved
    want = np.asarray(want)
    for s in (want, got.numpy()):
        assert (s[63] == 0).all() and (s[62] == -1).all() and (s[5] == -1).all()
        assert np.count_nonzero(s.any(axis=1)) == 2
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- checkpoints and CLIs


@pytest.mark.parametrize("case", ["qr + md + fixed pooling", "learned pooling"])
def test_checkpoints_cross_load_with_the_variant_leaves(tmp_path, case):
    if case == "learned pooling":
        kw = dict(MD, emb_dims=md_dims(MD_ROWS, 16), weighted_pooling="learned")
    else:
        kw = dict(INIT_CASES["qr + md"], weighted_pooling="fixed")
    _, pcfg, opt, (jp, js), (pp, ps) = _start(kw, "rwsadagrad", seed=4)
    for t in (x for x in jax.tree.leaves(pp) if x.dtype == torch.float32):
        t.add_(0.25)  # the port's tree now differs from JAX's init
    port_ckpt.save_checkpoint(str(tmp_path / "port"), pp, ps, pcfg, iteration=5,
                              optimizer="rwsadagrad")
    jp2, js2, meta = jax_ckpt.load_checkpoint(str(tmp_path / "port"), jp, js)
    assert meta["iteration"] == 5
    _assert_trees_close(jp2, params_to_jax(pp, pcfg), dict(rtol=0, atol=0))
    _assert_trees_close(js2, opt_state_to_jax(ps, pcfg), dict(rtol=0, atol=0))
    # JAX's own files into fresh port tensors, in place
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jp, js, iteration=7)
    fresh_p = init_dlrm(pcfg, seed=0, device="cpu")
    fresh_s = init_opt_state(opt, fresh_p, model_groups(pcfg))
    port_ckpt.load_checkpoint(str(tmp_path / "jax"), fresh_p, fresh_s)
    _assert_trees_close(jp, params_to_jax(fresh_p, pcfg), dict(rtol=0, atol=0))
    _assert_trees_close(js, opt_state_to_jax(fresh_s, pcfg), dict(rtol=0, atol=0))


CLI_BASE = [
    "--arch-embedding-size", "3000-40-60-5000", "--arch-sparse-feature-size", "16",
    "--arch-mlp-bot", "4-32-16", "--arch-mlp-top", "32-1", "--mini-batch-size", "64",
    "--num-batches", "4", "--loss-function", "bce", "--learning-rate", "0.05",
    "--print-freq", "2", "--emb-split-threshold", "100", "--sparse-update-impl", "pallas",
]


@pytest.mark.parametrize("extra", [
    ["--qr-flag", "--num-indices-per-lookup", "3", "--optimizer", "rwsadagrad"],
    ["--qr-flag", "--qr-operation", "add", "--qr-collisions", "8", "--qr-threshold", "1000",
     "--optimizer", "sgd"],
    ["--md-flag", "--md-round-dims", "--num-indices-per-lookup", "1", "--optimizer",
     "rwsadagrad"],
    ["--md-flag", "--md-temperature", "0.5", "--md-threshold", "50", "--optimizer", "sgd"],
    ["--weighted-pooling", "learned", "--num-indices-per-lookup", "3", "--optimizer",
     "rwsadagrad"],
    ["--weighted-pooling", "fixed", "--optimizer", "sgd", "--inference-only"],
])
def test_cli_variants_match_jax_cli(extra):
    argv = CLI_BASE + extra
    want = jax_cli_main(argv)
    got = port_cli.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["streaming_auc"], want["streaming_auc"], atol=1e-6)
