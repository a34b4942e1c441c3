"""The port's column sharding (``parallel/col_sharded.py``) against the JAX
package's (``dlrm_yx_tpu/parallel/col_sharded.py``): the plan field for
field, the layout, and the train, eval, accumulation and multi-step steps
in gloo worlds of 2 and 4 CPU ranks on meshes 1 x 2, 1 x 4 and 2 x 2
(``torch_sharded_cases``)."""

import jax
import numpy as np
import pytest
import torch

import dlrm_yx_tpu.parallel.col_sharded as jax_col
import dlrm_yx_tpu_torch.parallel.col_sharded as port_col
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.parallel.row_sharded import build_small_store
from torch_hybrid_cases import CONFIG, check_world_case, world_runner
from torch_sharded_cases import (
    PLAN_CONFIGS,
    check_init_matches_jax,
    check_world_of_one,
    plan_fields,
    sharded_cases,
    sharded_meshes,
    world_cases,
)

CASES = sharded_cases("col")
MESHES = sharded_meshes(CASES)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return world_runner(tmp_path_factory, CASES, MESHES)


@pytest.mark.parametrize("mesh,name", world_cases(MESHES))
def test_col_sharded_world_matches_jax(monkeypatch, worlds, mesh, name):
    check_world_case(monkeypatch, worlds(mesh), mesh, name, CASES)


# ------------------------------------------------- plan, layout and init

COL_FIELDS = ("d_local", "total_rows", "store_rows", "store_width")


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("name", ["split", "narrow", "unsplit", "all_small", "dim4"])
def test_col_plan_matches_jax_field_for_field(name, n_model):
    kw = PLAN_CONFIGS[name]
    got = port_col.make_col_plan(DLRMConfig.build(**kw), n_model)
    want = jax_col.make_col_plan(JaxConfig.build(**kw), n_model)
    assert plan_fields(got, COL_FIELDS) == plan_fields(want, COL_FIELDS)


def test_col_plan_rejects_qr_md_and_an_indivisible_dim_as_jax():
    """QR and MD raise JAX's NotImplementedError; a dim that the model axis
    does not divide (48 over 5 ranks) and mixed dims its ValueError."""
    cases = ((CONFIG, 2), (dict(CONFIG, ln_bot=(4, 48)), 5),
             (dict(CONFIG, qr_flag=True, qr_threshold=100), 2),
             (dict(CONFIG, md_flag=True, md_threshold=100, emb_dims=(128, 64, 128, 32, 128)), 2),
             (dict(CONFIG, emb_dims=(128, 128, 64, 128, 128)), 2))
    for kw, n_model in cases[1:]:
        errors = []
        for build, make in ((DLRMConfig.build, port_col.make_col_plan),
                            (JaxConfig.build, jax_col.make_col_plan)):
            with pytest.raises((NotImplementedError, ValueError)) as e:
                make(build(**kw), n_model)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("name", ["split", "dim4"])
def test_col_layout_round_trip_matches_jax(name):
    """build -> the JAX package's packed slices as logical rows; extract
    reads either."""
    kw = PLAN_CONFIGS[name]
    cfg = DLRMConfig.build(**kw)
    plan = port_col.make_col_plan(cfg, 2)
    jplan = jax_col.make_col_plan(JaxConfig.build(**kw), 2)
    rng = np.random.RandomState(0)
    tables = [rng.randn(n, plan.dim).astype(np.float32) for n in cfg.emb_rows]
    big = [tables[t] for t in plan.big_ids]
    emb = port_col.build_col_sharded_emb(plan, big)
    jemb = jax_col.build_col_sharded_emb(jplan, big)
    np.testing.assert_array_equal(emb, jemb.reshape(emb.shape))
    small = None
    if plan.small_group is not None:
        small = build_small_store(plan.small_group, [tables[t] for t in plan.small_group.table_ids])
    for got in (port_col.extract_col_sharded_tables(plan, emb, small),
                port_col.extract_col_sharded_tables(plan, jemb, small),
                port_col.extract_col_sharded_tables(
                    plan, torch.from_numpy(emb),
                    None if small is None else torch.from_numpy(small))):
        for a, b in zip(got, tables):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name,n_model,optname", [
    ("split", 2, "rwsadagrad"), ("narrow", 4, "adagrad"), ("learned", 2, "rwsadagrad"),
    ("unsplit", 4, "sgd")])
def test_col_init_and_layout_of_the_jax_pytrees(name, n_model, optname):
    check_init_matches_jax("col", jax_col, port_col.make_col_plan, jax_col.make_col_plan,
                           port_col.init_col_sharded_params, jax_col.init_col_sharded_params,
                           port_col.col_layouts, PLAN_CONFIGS[name], n_model, optname)


@pytest.mark.parametrize("optname", ["sgd", "adagrad", "rwsadagrad"])
def test_world_of_one_equals_the_single_device_step(monkeypatch, optname):
    """At mesh 1 x 1 (no process group) the column-sharded step is the
    port's single-device step, bit for bit, from the same params."""
    check_world_of_one(monkeypatch, port_col, port_col.ColShardedRunner,
                       port_col.make_col_plan, optname, CASES["rwsadagrad"])


# ---------------------------------------------------------- slice routing

ROUTE_SHAPES = [(128, 1), (128, 2), (128, 4), (96, 2), (64, 2)]


def _route_inputs(dim, n_model, dtype):
    """A column plan of two big tables (4096 and 2000 rows) at ``dim`` over
    ``n_model``, a slice store of ``dtype`` in both layouts, 16 items."""
    kw = dict(emb_rows=(4096, 2000), ln_bot=(4, dim), ln_top=(8, 1), emb_split_threshold=0,
              sparse_update_impl="pallas")
    plan = port_col.make_col_plan(DLRMConfig.build(**kw), n_model)
    jplan = jax_col.make_col_plan(JaxConfig.build(**kw), n_model)
    rng = np.random.RandomState(dim + n_model)
    store = rng.randn(plan.total_rows, plan.d_local).astype(np.float32)
    ids = rng.randint(0, 4096 + 2000, 16).astype(np.int32)
    ids[3] = ids[2]
    g = (rng.randn(16, plan.d_local) * 1e-2).astype(np.float32)
    return kw, plan, jplan, store, ids, g


def _jax_lane_placed(jplan, ids, g):
    """[K, store_width] rows: each grad in its logical row's lane block."""
    pk = jplan.pack
    out = np.zeros((len(ids), jplan.store_width), np.float32)
    for k, (i, row) in enumerate(zip(ids, g)):
        blk = int(i) % pk
        out[k, blk * jplan.d_local:(blk + 1) * jplan.d_local] = row
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,n_model", ROUTE_SHAPES)
def test_slice_update_routes_follow_the_jax_gate(monkeypatch, dim, n_model, dtype):
    """``_sparse_slice_update`` takes the routes JAX's gate
    (``col_sharded.py:195-205``, on its physical layout) gives the same
    shapes: K2 (write-only), K4, or a scatter, call for call, for each
    optimizer with and without the forward's rows; the kernels' gates at 0
    in both packages."""
    import jax.numpy as jnp

    import dlrm_yx_tpu.ops.pallas_sparse_update as jax_psu
    import dlrm_yx_tpu.optim.optimizer as jax_opt
    import dlrm_yx_tpu_torch.optim.optimizer as port_opt
    from dlrm_yx_tpu.optim.optimizer import OptConfig as JaxOpt
    from dlrm_yx_tpu.optim.optimizer import acc_len
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
    from dlrm_yx_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(jax_opt, "PALLAS_MIN_STORE_BYTES", 0)
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    kw, plan, jplan, store, ids, g = _route_inputs(dim, n_model, dtype)
    calls = {"jax": [], "port": []}

    def jax_rec(name):
        def f(arr, *a, **k):
            calls["jax"].append(name)
            return arr
        return f

    monkeypatch.setattr(jax_psu, "sparse_rows_overwrite", jax_rec("K2"))
    monkeypatch.setattr(jax_psu, "sparse_rows_add", jax_rec("K4"))
    for name, attr in (("K2", "sparse_rows_overwrite"), ("K4", "sparse_rows_add")):
        real = getattr(port_col, attr)

        def rec(*a, _real=real, _name=name, **k):
            calls["port"].append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(port_col, attr, rec)
    pdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    mesh = make_mesh(1, 1, "cpu")
    jcfg, pcfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    phys = store.reshape(jplan.store_rows, jplan.store_width)
    for optname in ("sgd", "adagrad", "rwsadagrad"):
        for with_old in (False, True):
            calls["jax"].clear()
            calls["port"].clear()
            old = store[ids] if with_old else None
            jacc = pacc = None
            if optname == "adagrad":
                jacc, pacc = jnp.zeros(phys.shape, jnp.float32), torch.zeros(store.shape)
            elif optname == "rwsadagrad":
                n = acc_len(plan.total_rows)
                jacc, pacc = jnp.zeros((n,), jnp.float32), torch.zeros(n)

            def jax_update(st, acc):
                return jax_col._sparse_slice_update(
                    jplan, jcfg, JaxOpt(optname), st, acc, jnp.asarray(ids),
                    jnp.asarray(_jax_lane_placed(jplan, ids, g)), 0.1,
                    old_rows=None if old is None else jnp.asarray(
                        phys[ids // jplan.pack]))

            # psum over "model" of a one-rank axis
            jax.vmap(jax_update, axis_name="model")(
                jnp.asarray(phys, jdt)[None], None if jacc is None else jacc[None])
            port_col._sparse_slice_update(
                plan, pcfg, OptConfig(optname), mesh, torch.from_numpy(store).to(pdt), pacc,
                torch.from_numpy(ids), torch.from_numpy(g), 0.1,
                None if old is None else torch.from_numpy(old))
            assert calls["port"] == calls["jax"], (optname, with_old)
