"""The cases of the hybrid-step tests (``test_torch_hybrid.py``,
``test_torch_hybrid_mesh.py``): the port's hybrid (whole-table sharded)
steps in gloo worlds of CPU ranks against the JAX package's
``HybridRunner`` on the same mesh shape (its 8 virtual CPU devices); the
row and column tests (``torch_sharded_cases.py``) run their cases through
the same worlds and the same checks (a case's ``mode``).

Each mesh shape's world runs once (``tests/torch_hybrid_worker.py``, started
as processes outside pytest) and writes every case's losses, tables and
eval predictions; each test holds one case to JAX's at rtol 1e-5 / atol 1e-6.
The kernel routes are forced in both packages by patching
``PALLAS_MIN_STORE_BYTES`` and ``ACC_KERNEL_MIN_BYTES`` to 0 (JAX runs its
Pallas kernels in interpret mode): with ``--sparse-update-impl pallas`` the
big store takes the write-only update (K2) at L=1, the row
read-modify-write (K4) at L=3, the sorted stream (K5) at L=16 with SGD, and
the small store the dense accumulate with the RWSAdagrad finish (K3).
"""

import json

import jax
import numpy as np

import dlrm_yx_tpu.optim.optimizer as jax_opt
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.optim.optimizer import OptConfig as JaxOpt
from dlrm_yx_tpu.parallel.hybrid import HybridRunner as JaxRunner
from dlrm_yx_tpu.parallel.plan import extract_tables as jax_extract_tables
from dlrm_yx_tpu_torch.data.batch import stack_batches
from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
from dlrm_yx_tpu_torch.parallel.multihost import REPO_ROOT, spawn_local

# the JAX CLI's mesh flags (dlrm_yx_tpu/cli.py:100-127)
MESH_FLAGS = ("force-cpu-devices", "distributed", "mesh-data", "mesh-model",
              "shard-mode", "sharder", "allocation")
TOL = dict(rtol=1e-5, atol=1e-6)
SEED, BATCH_SEED = 7, 13
# big tables of 3000 and 3200 rows (size class 1), small ones of 40-60
CONFIG = dict(emb_rows=(40, 3000, 60, 3200, 50), ln_bot=(4, 16, 128), ln_top=(16, 1),
              emb_split_threshold=100, loss="bce")
PATCH = {"PALLAS_MIN_STORE_BYTES": 0, "ACC_KERNEL_MIN_BYTES": 0}
# a nonzero starting optimizer state, the same in both packages (as
# tests/test_torch_training.py starts): from zero, Adagrad's first update is
# lr * g / |g| whatever g's size, so a gradient element that cancels to
# rounding noise moves its weight by the full lr in either direction
ACC0 = 0.01


def _case(name, opt, lookups=1, kind="train", impl="pallas", steps=3, **kw):
    return dict(name=name, opt=opt, lr=0.1, impl=impl, lookups=lookups, batch=32,
                steps=steps, kind=kind, **kw)


CASES = {
    c["name"]: c for c in (
        _case("sgd", "sgd"),                          # K2 on the big store
        _case("adagrad", "adagrad"),                  # K2, the small store's dense branch
        _case("rwsadagrad", "rwsadagrad"),            # K2 and K3
        _case("rwsadagrad_l3", "rwsadagrad", 3),      # K4 (no rows to overwrite) and K3
        _case("sgd_stream", "sgd", 16),               # the sorted stream (K5)
        _case("rwsadagrad_xla", "rwsadagrad", 2, impl="xla"),
        _case("multistep", "rwsadagrad", kind="multistep"),
        _case("accum", "rwsadagrad", kind="accum", steps=2, n_accum=2),
        # bf16 towers: each rank rounds its dense grads to bf16 before the
        # sum, in both packages, so a mesh of two drifts from one of one
        _case("rwsadagrad_bf16", "rwsadagrad",
              config=dict(CONFIG, compute_dtype="bfloat16", interaction_impl="pallas")),
    )
}
# the cases each mesh shape runs (every world adds a few seconds)
MESHES = {
    (1, 2): list(CASES),
    (2, 1): ["sgd", "rwsadagrad", "rwsadagrad_l3", "accum"],
    (2, 2): ["adagrad", "rwsadagrad", "sgd_stream", "multistep", "accum"],
}


def mesh_cases(*meshes):
    return [(m, n) for m in meshes for n in MESHES[m]]


def batches(cfg_rows, case, n=None):
    return make_random_batches(RandomDataConfig(
        emb_rows=cfg_rows, m_den=case.get("config", CONFIG)["ln_bot"][0],
        mini_batch_size=case["batch"],
        num_batches=n or case["steps"] * case.get("n_accum", 1),
        num_indices_per_lookup=case["lookups"], num_indices_per_lookup_fixed=False,
        round_targets=True, seed=BATCH_SEED))


def world_runner(tmp_path_factory, cases=None, meshes=None):
    """mesh -> the npz dict of that mesh shape's world run, started on
    first use (the body of a module-scoped fixture); ``cases`` (name ->
    case) and ``meshes`` (mesh -> case names) default to this module's."""
    cases, meshes = cases or CASES, meshes or MESHES
    done = {}

    def run(mesh):
        if mesh not in done:
            tmp = tmp_path_factory.mktemp(f"world{mesh[0]}x{mesh[1]}")
            spec = dict(mesh=list(mesh), config=CONFIG, seed=SEED, batch_seed=BATCH_SEED,
                        acc0=ACC0, patch=PATCH, cases=[cases[n] for n in meshes[mesh]],
                        out=str(tmp / "out.npz"))
            path = tmp / "spec.json"
            path.write_text(json.dumps(spec))
            spawn_local([f"{REPO_ROOT}/tests/torch_hybrid_worker.py", str(path)],
                        mesh[0] * mesh[1], timeout=240, capture=True)
            with np.load(spec["out"]) as d:
                done[mesh] = dict(d)
        return done[mesh]

    return run


def jax_runner(case, cfg, mesh):
    """(the JAX package's runner of the case's ``mode`` on the mesh shape,
    its tables from its stores)."""
    from dlrm_yx_tpu.parallel.col_sharded import ColShardedRunner, extract_col_sharded_tables
    from dlrm_yx_tpu.parallel.row_sharded import RowShardedRunner, extract_row_sharded_tables

    opt, n_accum = JaxOpt(case["opt"], case["lr"]), case.get("n_accum", 1)
    mode = case.get("mode", "table")
    if mode == "table":
        runner = JaxRunner(cfg, opt, data=mesh[0], model=mesh[1],
                           sharder=case.get("sharder", "greedy"), seed=SEED, n_accum=n_accum)
        return runner, lambda emb, small: jax_extract_tables(runner.plan, cfg, emb, small)
    cls, extract = ((RowShardedRunner, extract_row_sharded_tables) if mode == "row"
                    else (ColShardedRunner, extract_col_sharded_tables))
    runner = cls(cfg, opt, data=mesh[0], model=mesh[1], seed=SEED, n_accum=n_accum)
    return runner, lambda emb, small: extract(runner.plan, emb, small)


def jax_run(monkeypatch, mesh, case):
    """JAX's HybridRunner on the same mesh shape: (losses, tables, eval
    predictions of the first batch)."""
    for name, value in PATCH.items():
        monkeypatch.setattr(jax_opt, name, value)
    cfg = JaxConfig.build(**case.get("config", CONFIG), sparse_update_impl=case["impl"])
    n_accum = case.get("n_accum", 1)
    runner, extract = jax_runner(case, cfg, mesh)
    p, s = runner.params, jax.tree.map(lambda a: a + ACC0, runner.opt_state)
    bs = batches(cfg.emb_rows, case)
    losses = []
    groups = ([stack_batches(bs[i:i + n_accum]) for i in range(0, len(bs), n_accum)]
              if n_accum > 1 else bs)
    for i, b in enumerate(groups):
        p, s, loss = runner.train_step(p, s, runner.prepare_batch(b), i)
        losses.append(float(loss))
    tables = extract(np.asarray(p["emb"]),
                     None if p["emb_small"] is None else np.asarray(p["emb_small"]))
    preds, _ = runner.eval_step(p, runner.prepare_batch(bs[0]))
    extra = {k: np.asarray(p[k]) for k in ("vw", "vw_small", "qr_r") if p.get(k) is not None}
    extra.update({f"md_proj{i}": np.asarray(w) for i, w in enumerate(p.get("md_proj", []))})
    return np.array(losses), tables, np.asarray(preds), extra


def check_case(got, name, want):
    losses, tables, preds, extra = want
    np.testing.assert_allclose(got[f"{name}/losses"], losses, **TOL)
    for t, w in enumerate(tables):
        np.testing.assert_allclose(got[f"{name}/table{t}"], w, **TOL)
    np.testing.assert_allclose(got[f"{name}/preds"], preds, **TOL)
    assert sorted(k[len(name) + 1:] for k in got if k.startswith(f"{name}/") and
                  k[len(name) + 1:] in extra) == sorted(extra)
    for key, w in extra.items():
        np.testing.assert_allclose(got[f"{name}/{key}"], w, **TOL)




def check_world_case(monkeypatch, got, mesh, name, cases=None):
    """One case of a world run held to JAX's run on the same mesh shape;
    a multi-step dispatch (eager on the CPU) also to its steps one by one,
    bit for bit."""
    case = (cases or CASES)[name]
    check_case(got, name, jax_run(monkeypatch, mesh, case))
    if case["kind"] == "multistep":
        np.testing.assert_array_equal(got[f"{name}/losses"], got[f"{name}/single_losses"])
        flat = np.concatenate([got[f"{name}/table{t}"].reshape(-1)
                               for t in range(len(case.get("config", CONFIG)["emb_rows"]))])
        np.testing.assert_array_equal(flat, got[f"{name}/single_tables"])
