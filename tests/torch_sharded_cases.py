"""The cases of the row- and column-sharded step tests
(``test_torch_row_sharded.py``, ``test_torch_col_sharded.py``): the port's
``RowShardedRunner`` / ``ColShardedRunner`` in gloo worlds of CPU ranks
(``tests/torch_hybrid_worker.py``, one world a mesh shape a file) against
the JAX package's runner of the same mode on the same mesh shape, held by
``torch_hybrid_cases.check_world_case`` at rtol 1e-5 / atol 1e-6.

The kernel gates are patched to 0 in both packages (JAX's Pallas kernels
run in interpret mode): at L=1 the big space takes the write-only update
(K2), at L=2 the coalesced row read-modify-write (K4), the small store the
dense accumulate with the RWSAdagrad finish (K3). The model is
``torch_hybrid_cases.CONFIG`` (dim 128: a column slice is 64 wide at M=2,
32 at M=4, packed in JAX), and a dim-16 one where the JAX package packs
the row shards too.
"""

import jax
import numpy as np
import torch

from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.optim.optimizer import OptConfig as JaxOpt
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
from dlrm_yx_tpu_torch.parallel.row_sharded import (
    init_sharded_opt_state,
    tree_from_jax,
    tree_to_jax,
)
from torch_hybrid_cases import CONFIG, _case

# dim 16: JAX packs 8 logical rows to a 128-lane row of a row shard (and 8
# / 4 columns of a slice at M = 2 / 4)
NARROW = dict(CONFIG, ln_bot=(4, 16, 16))


def sharded_cases(mode):
    """name -> case of ``mode`` (row or col)."""
    def case(name, opt, lookups=1, **kw):
        return _case(name, opt, lookups, mode=mode, **kw)

    return {c["name"]: c for c in (
        case("sgd", "sgd"),                                # K2
        case("adagrad", "adagrad"),                        # K2, K4 on the accumulator (col)
        case("rwsadagrad", "rwsadagrad"),                  # K2 and K3
        case("sgd_l2", "sgd", 2),                          # K4 after a coalesce
        case("rwsadagrad_l2", "rwsadagrad", 2),            # K4 and K3
        case("adagrad_l2", "adagrad", 2),
        case("multistep", "rwsadagrad", kind="multistep"),
        case("accum", "rwsadagrad", kind="accum", steps=2, n_accum=2),
        case("fixed_pooling", "rwsadagrad", 2, config=dict(CONFIG, weighted_pooling="fixed")),
        case("learned_pooling", "adagrad", 2,
             config=dict(CONFIG, weighted_pooling="learned")),
        case("accum_learned", "sgd", 2, kind="accum", steps=2, n_accum=2,
             config=dict(CONFIG, weighted_pooling="learned")),
        # every table in the sharded space: dups_in_big, coalesce first
        case("unsplit", "rwsadagrad", config=dict(CONFIG, emb_split_threshold=0)),
        case("narrow", "rwsadagrad", 2, config=NARROW),
        case("narrow_sgd", "sgd", config=NARROW),
    )}


def sharded_meshes(cases):
    """The cases each mesh shape runs (each JAX run compiles its steps: a
    few seconds a case). Every mesh runs SGD, Adagrad and RWSAdagrad at L=1
    (K2) and at L=2 (K4)."""
    return {
        (1, 2): [n for n in cases if n not in ("adagrad_l2", "narrow_sgd")],
        (1, 4): ["sgd", "adagrad_l2", "rwsadagrad", "narrow"],
        (2, 2): ["adagrad", "rwsadagrad_l2", "sgd_l2", "accum"],
    }


def world_cases(meshes):
    return [(m, n) for m in meshes for n in meshes[m]]


# the split model, a packed one, every table in the sharded space (no
# split; all tables under the threshold), tests/test_row_sharded.py's dim-4
# tables (32 logical rows a physical row)
PLAN_CONFIGS = {
    "split": CONFIG,
    "narrow": NARROW,
    "unsplit": dict(CONFIG, emb_split_threshold=0),
    "all_small": dict(CONFIG, emb_split_threshold=10_000),
    "dim4": dict(emb_rows=(50, 58, 66), ln_bot=(4, 8, 4), ln_top=(10, 1)),
    "learned": dict(CONFIG, weighted_pooling="learned"),
}


def group_fields(g):
    return None if g is None else (g.table_ids, g.rows, g.dim, g.row_offsets, g.total_rows,
                                   g.size_class, g.pack)


def plan_fields(plan, extra=()):
    return ({f: getattr(plan, f) for f in ("n_model", "dim", "rows", "row_offsets", "pack",
                                           "big_ids", "dups_in_big") + tuple(extra)}
            | {"small_group": group_fields(plan.small_group),
               "canonical_perm": list(plan.canonical_perm)})


def check_init_matches_jax(mode, jax_mod, make_plan, jax_make_plan, init, jax_init,
                           layouts, kw, n_model, optname):
    """Each model rank's params (and zero optimizer state) equal its part of
    the JAX package's whole pytrees (the same draws), through
    ``tree_from_jax``; ``tree_to_jax`` of the ranks' trees gives JAX's back."""
    cfg, jcfg = DLRMConfig.build(**kw), JaxConfig.build(**kw)
    plan, jplan = make_plan(cfg, n_model), jax_make_plan(jcfg, n_model)
    jp = jax.tree.map(np.asarray, jax_init(jcfg, jplan, seed=5))
    js = jax.tree.map(np.asarray, getattr(jax_mod, f"init_{mode}_sharded_opt_state")(
        JaxOpt(optname), jax_init(jcfg, jplan, seed=5), jplan))
    layout = layouts(plan, OptConfig(optname))
    ranks = []
    for m in range(n_model):
        p = init(cfg, plan, seed=5, model_index=m, device="cpu")
        s = init_sharded_opt_state(OptConfig(optname), p, plan)
        want_p = tree_from_jax(jp, layout["params"], n_model, m, "cpu")
        want_s = tree_from_jax(js, layout["opt_state"], n_model, m, "cpu")
        for got, want in ((p, want_p), (s, want_s)):
            assert jax.tree.structure(got) == jax.tree.structure(want)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert torch.equal(a, b)
        ranks.append((p, s))
    for i, tree in enumerate((jp, js)):
        back = tree_to_jax([r[i] for r in ranks], layout[("params", "opt_state")[i]])
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


def check_world_of_one(monkeypatch, module, runner_cls, make_plan, optname, case):
    """At mesh 1 x 1 (no process group) a runner's step is the port's
    single-device step, bit for bit, from the same params; so are its
    gathered stores and its eval."""
    import dlrm_yx_tpu_torch.optim.optimizer as port_opt
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_eval_step, make_train_step
    from torch_hybrid_cases import PATCH, SEED, batches

    for name, value in PATCH.items():
        monkeypatch.setattr(port_opt, name, value)
    cfg = DLRMConfig.build(**CONFIG, sparse_update_impl="pallas")
    opt = OptConfig(optname, 0.1)
    bs = batches(cfg.emb_rows, case)
    params = init_dlrm(cfg, seed=SEED, device="cpu")
    runner = runner_cls(cfg, opt, 1, 1, device="cpu", params=module.params_from_single_device(
        cfg, make_plan(cfg, 1), params))
    state = init_opt_state(opt, params, model_groups(cfg))
    step = make_train_step(cfg, opt, device="cpu")
    want = [float(step(params, state, b, i)[2]) for i, b in enumerate(bs)]
    got = [float(runner.train_step(runner.params, runner.opt_state, runner.prepare_batch(b),
                                   i)[2]) for i, b in enumerate(bs)]
    assert got == want
    single = runner.single_device_params(runner.params)
    for a, b in zip(single["emb"], params["emb"]):
        assert torch.equal(a, b)
    preds, _ = runner.eval_step(runner.params, runner.prepare_batch(bs[0]))
    want_preds, _ = make_eval_step(cfg, device="cpu")(params, bs[0])
    assert torch.equal(preds, want_preds)
