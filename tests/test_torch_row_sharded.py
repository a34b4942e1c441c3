"""The port's row sharding (``parallel/row_sharded.py``) against the JAX
package's (``dlrm_yx_tpu/parallel/row_sharded.py``): the plan field for
field, the layout, and the train, eval, accumulation and multi-step steps
in gloo worlds of 2 and 4 CPU ranks on meshes 1 x 2, 1 x 4 and 2 x 2
(``torch_sharded_cases``)."""

import numpy as np
import pytest
import torch

import dlrm_yx_tpu.parallel.row_sharded as jax_row
import dlrm_yx_tpu_torch.parallel.row_sharded as port_row
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu_torch.config import DLRMConfig
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

CASES = sharded_cases("row")
MESHES = sharded_meshes(CASES)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return world_runner(tmp_path_factory, CASES, MESHES)


@pytest.mark.parametrize("mesh,name", world_cases(MESHES))
def test_row_sharded_world_matches_jax(monkeypatch, worlds, mesh, name):
    check_world_case(monkeypatch, worlds(mesh), mesh, name, CASES)


# ------------------------------------------------- plan, layout and init


ROW_FIELDS = ("rows_local", "total_rows", "store_rows", "store_shape", "num_tables")


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("name", ["split", "narrow", "unsplit", "all_small", "dim4"])
def test_row_plan_matches_jax_field_for_field(name, n_model):
    kw = PLAN_CONFIGS[name]
    got = port_row.make_row_plan(DLRMConfig.build(**kw), n_model)
    want = jax_row.make_row_plan(JaxConfig.build(**kw), n_model)
    assert plan_fields(got, ROW_FIELDS) == plan_fields(want, ROW_FIELDS)


@pytest.mark.parametrize("name", ["split", "dim4"])
def test_row_layout_round_trip_matches_jax(name):
    """build -> the JAX package's stores as logical rows; extract reads the
    port's logical stores (numpy or torch) and JAX's physical ones."""
    kw = PLAN_CONFIGS[name]
    cfg = DLRMConfig.build(**kw)
    plan = port_row.make_row_plan(cfg, 4)
    jplan = jax_row.make_row_plan(JaxConfig.build(**kw), 4)
    rng = np.random.RandomState(0)
    tables = [rng.randn(n, plan.dim).astype(np.float32) for n in cfg.emb_rows]
    big = [tables[t] for t in plan.big_ids]
    emb = port_row.build_row_sharded_emb(plan, big)
    jemb = jax_row.build_row_sharded_emb(jplan, big)
    np.testing.assert_array_equal(emb, jemb.reshape(emb.shape))
    small = jsmall = None
    if plan.small_group is not None:
        per = [tables[t] for t in plan.small_group.table_ids]
        small = port_row.build_small_store(plan.small_group, per)
        jsmall = jax_row.build_small_store(jplan.small_group, per)
        np.testing.assert_array_equal(small, jsmall.reshape(small.shape))
    for got in (port_row.extract_row_sharded_tables(plan, emb, small),
                port_row.extract_row_sharded_tables(plan, jemb, jsmall),
                port_row.extract_row_sharded_tables(
                    plan, torch.from_numpy(emb), None if small is None else torch.from_numpy(small))):
        for a, b in zip(got, tables):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name,n_model,optname", [
    ("split", 2, "rwsadagrad"), ("narrow", 4, "adagrad"), ("learned", 2, "rwsadagrad"),
    ("unsplit", 4, "sgd")])
def test_row_init_and_layout_of_the_jax_pytrees(name, n_model, optname):
    check_init_matches_jax("row", jax_row, port_row.make_row_plan, jax_row.make_row_plan,
                           port_row.init_row_sharded_params, jax_row.init_row_sharded_params,
                           port_row.row_layouts, PLAN_CONFIGS[name], n_model, optname)


def test_qr_md_and_mixed_dims_raise_as_jax():
    """QR and MD configs raise JAX's NotImplementedError; tables of two dims
    its ValueError."""
    cases = (dict(CONFIG, qr_flag=True, qr_threshold=100),
             dict(CONFIG, md_flag=True, md_threshold=100, emb_dims=(128, 64, 128, 32, 128)),
             dict(CONFIG, emb_dims=(128, 128, 64, 128, 128)))
    for kw in cases:
        errors = []
        for build, make in ((DLRMConfig.build, port_row.make_row_plan),
                            (JaxConfig.build, jax_row.make_row_plan)):
            with pytest.raises((NotImplementedError, ValueError)) as e:
                make(build(**kw), 2)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("optname", ["sgd", "adagrad", "rwsadagrad"])
def test_world_of_one_equals_the_single_device_step(monkeypatch, optname):
    """At mesh 1 x 1 (no process group) the row-sharded step is the port's
    single-device step, bit for bit, from the same params."""
    check_world_of_one(monkeypatch, port_row, port_row.RowShardedRunner,
                       port_row.make_row_plan, optname, CASES["rwsadagrad"])
