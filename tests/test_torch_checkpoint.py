"""The port's checkpoints (dlrm_yx_tpu_torch/train/checkpoint.py, the
Trainer's save-on-best and resume) against the JAX package's on the CPU.

Cross-loading: a checkpoint written by either package loads in the other
with equal params and optimizer state (f32 and bf16 stores, SGD, Adagrad,
RWSAdagrad, packed dims), exactly. Resume: ``skip_position``, the
iterations save-on-best fires at, a resumed run's losses (rtol 1e-5 / atol
1e-6 against JAX's resumed run; bit for bit against the port's own
uninterrupted run) and the print / eval boundaries of a resume in the
middle of a dispatch group (the shift the JAX package keeps, its
trainer.py:395) all match.
"""

import json
import os
import re

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import dlrm_yx_tpu.train.trainer as jax_trainer_mod
import dlrm_yx_tpu_torch.train.trainer as port_trainer_mod
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.synthetic import RandomDataConfig as JaxDataConfig
from dlrm_yx_tpu.data.synthetic import make_random_batches as jax_batches
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.optim import optimizer as jax_opt
from dlrm_yx_tpu.train import checkpoint as jax_ckpt
from dlrm_yx_tpu.train.trainer import Trainer as JaxTrainer
from dlrm_yx_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import opt_state_from_jax, params_from_jax, params_to_jax
from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, skip_position
from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig

TOL = dict(rtol=1e-5, atol=1e-6)

# two groups (tables of 40 and 60 rows under the split threshold, 3000 and
# 3200 over it); dim 16 packs 8 rows to a 128-wide physical row in JAX
MODELS = {
    "packed d16": dict(emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 16), ln_top=(8, 1),
                       emb_split_threshold=100, loss="bce"),
    "d128": dict(emb_rows=(40, 300, 90), ln_bot=(4, 128), ln_top=(8, 1),
                 emb_split_threshold=50, loss="bce"),
}


def _jax_trees(kw, optname, seed=3):
    """JAX params and optimizer state, the state moved off zero so that
    every leaf carries its own values."""
    jcfg = JaxConfig.build(**kw)
    params = jax.tree.map(np.asarray, jax_init_dlrm(jcfg, seed=seed))
    state = jax_opt.init_opt_state(jax_opt.OptConfig(optname, 0.1), params,
                                   jax_model_groups(jcfg))
    r = np.random.RandomState(seed)
    state = jax.tree.map(lambda a: np.asarray(a) + r.rand(*np.shape(a)).astype(np.float32),
                         state)
    return jcfg, params, state


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _assert_same_tree(got, want):
    gl, gt = jax.tree.flatten(got)
    wl, wt = jax.tree.flatten(want)
    assert gt == wt and len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _port_trees(cfg, optname, seed=99):
    params = init_dlrm(cfg, seed=seed, device="cpu")
    return params, init_opt_state(OptConfig(optname), params, model_groups(cfg))


CASES = [(m, opt, dt) for m in MODELS for opt in ("sgd", "adagrad", "rwsadagrad")
         for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("model,optname,emb_dtype", CASES)
def test_checkpoints_cross_load(tmp_path, model, optname, emb_dtype):
    kw = dict(MODELS[model], emb_dtype=emb_dtype)
    jcfg, jp, js = _jax_trees(kw, optname)
    cfg = DLRMConfig.build(**kw)
    opt = OptConfig(optname)
    meta = dict(epoch=1, iteration=7, metrics={"accuracy": 0.75}, optimizer=optname)

    # JAX save -> port load, into trees that start elsewhere
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jp, js, **meta)
    pp, ps = _port_trees(cfg, optname)
    ptrs = [t.data_ptr() for t in jax.tree.leaves((pp, ps))]
    pp2, ps2, m = load_checkpoint(str(tmp_path / "jax"), pp, ps)
    assert pp2 is pp and ps2 is ps  # filled in place
    assert ptrs == [t.data_ptr() for t in jax.tree.leaves((pp, ps))]
    assert m["iteration"] == 7 and m["optimizer"] == optname
    want_p = params_from_jax(jp, cfg, "cpu")
    want_s = opt_state_from_jax(js, opt, cfg, "cpu")
    for a, b in zip(jax.tree.leaves((pp, ps)), jax.tree.leaves((want_p, want_s))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)

    # port save -> JAX load: the trees JAX saved, and the same npz arrays
    save_checkpoint(str(tmp_path / "port"), pp, ps, cfg, **meta)
    like_p = jax_init_dlrm(jcfg, seed=1)
    like_s = jax_opt.init_opt_state(jax_opt.OptConfig(optname, 0.1), like_p,
                                    jax_model_groups(jcfg))
    lp, ls, lm = jax_ckpt.load_checkpoint(str(tmp_path / "port"), like_p, like_s)
    _assert_same_tree(lp, jp)
    _assert_same_tree(ls, js)
    assert lm == json.load(open(tmp_path / "jax" / "meta.json"))
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]))
    if emb_dtype == "bfloat16":  # raw 16-bit elements, as np.savez records bf16
        with np.load(tmp_path / "port" / "params.npz") as a:
            stores = [a[f"leaf_{i}"] for i in range(len(a.files))
                      if a[f"leaf_{i}"].dtype == np.dtype("V2")]
        assert len(stores) == len(jp["emb"])
        np.testing.assert_array_equal(stores[0].view(ml_dtypes.bfloat16).astype(np.float32),
                                      np.asarray(jp["emb"][0]).astype(np.float32))


def test_params_to_jax_inverts_params_from_jax():
    kw = dict(MODELS["packed d16"], emb_dtype="bfloat16")
    jcfg, jp, _ = _jax_trees(kw, "sgd")
    back = params_to_jax(params_from_jax(jp, DLRMConfig.build(**kw), "cpu"),
                         DLRMConfig.build(**kw))
    assert back["vw"] is None
    _assert_same_tree({k: back[k] for k in ("bot", "top", "emb")},
                      {k: jp[k] for k in ("bot", "top", "emb")})


def test_load_rejects_a_checkpoint_of_another_model(tmp_path):
    kw = MODELS["packed d16"]
    cfg = DLRMConfig.build(**kw)
    pp, ps = _port_trees(cfg, "adagrad")
    save_checkpoint(str(tmp_path), pp, ps, cfg)
    other = DLRMConfig.build(**dict(kw, emb_dtype="bfloat16"))
    op, os_ = _port_trees(other, "adagrad")
    with pytest.raises(ValueError, match="leaf_"):
        load_checkpoint(str(tmp_path), op, os_)
    sp, ss = _port_trees(cfg, "sgd")
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path), sp, ss)


@pytest.mark.parametrize("meta,n", [({"epoch": 0, "iteration": 3}, 5),
                                    ({"epoch": 0, "iteration": 5}, 5),
                                    ({"epoch": 1, "iteration": 12}, 5),
                                    ({"iteration": 4}, 0), ({}, 7)])
def test_skip_position_matches_jax(meta, n):
    assert skip_position(meta, n) == jax_ckpt.skip_position(meta, n)


# ------------------------------------------------------- trainer resume


def _batches(n, seed=4, b=4):
    kw = dict(emb_rows=DLRMConfig.tiny().emb_rows, m_den=4, mini_batch_size=b, num_batches=n,
              num_indices_per_lookup=2, num_indices_per_lookup_fixed=False,
              round_targets=True, seed=seed)
    return make_random_batches(RandomDataConfig(**kw)), jax_batches(JaxDataConfig(**kw))


def _trainers(optname="rwsadagrad", **tkw):
    tkw = dict(dict(print_freq=1, seed=3, prefetch_depth=0), **tkw)
    port = Trainer(DLRMConfig.tiny(), OptConfig(optname, lr=0.2), TrainerConfig(**tkw),
                   device="cpu")
    jax_tr = JaxTrainer(JaxConfig.tiny(), jax_opt.OptConfig(optname, lr=0.2),
                        JaxTrainerConfig(**tkw))
    return port, jax_tr


def _run(capsys, tr, batches, test_batches):
    capsys.readouterr()
    tr.fit(batches, test_batches)
    out = capsys.readouterr().out
    return {
        "losses": [float(x) for x in re.findall(r"loss ([-+.\deE]+)", out)],
        "printed_at": [int(x) for x in re.findall(r"Finished training it (\d+)", out)],
        "eval_at": [int(x) for x in re.findall(r"Testing at it (\d+)", out)],
    }


@pytest.fixture
def saves(monkeypatch):
    """The iterations each package's save-on-best fires at."""
    got = {"port": [], "jax": []}
    for name, mod in (("port", port_trainer_mod), ("jax", jax_trainer_mod)):
        real = mod.save_checkpoint

        def record(*a, _real=real, _name=name, **k):
            got[_name].append(k["iteration"])
            return _real(*a, **k)

        monkeypatch.setattr(mod, "save_checkpoint", record)
    return got


@pytest.mark.parametrize("m", [1, 2])
def test_save_on_best_and_resume_match_jax(tmp_path, capsys, saves, m):
    """Both packages train 12 batches with an eval every 2 iterations and
    save-on-best; then each resumes from its own checkpoint. The port's
    resumed losses equal its uninterrupted run's from the saved iteration
    on, bit for bit, and JAX's resumed run's at rtol 1e-5 / atol 1e-6."""
    pb, jb = _batches(12)
    ptest, jtest = _batches(3, seed=9)
    runs = {}
    for name in ("port", "jax"):
        tr = _trainers(test_freq=2, steps_per_dispatch=m,
                       save_path=str(tmp_path / name))[name == "jax"]
        runs[name] = _run(capsys, tr, *((pb, lambda: ptest) if name == "port"
                                         else (jb, lambda: jtest)))
        runs[name + " params"] = tr.params
    assert saves["port"] == saves["jax"] and saves["port"]
    np.testing.assert_allclose(runs["port"]["losses"], runs["jax"]["losses"], **TOL)
    saved = saves["port"][-1]
    assert saved < 12  # the resumed runs have steps to take
    for name in ("port", "jax"):
        tr = _trainers(test_freq=2, steps_per_dispatch=m,
                       load_path=str(tmp_path / name))[name == "jax"]
        assert tr.iteration == saved
        runs[name + " resumed"] = _run(capsys, tr, *((pb, lambda: ptest) if name == "port"
                                                     else (jb, lambda: jtest)))
        runs[name + " resumed params"] = tr.params
    got, want = runs["port resumed"], runs["jax resumed"]
    straight = runs["port"]
    after = [i for i, it in enumerate(straight["printed_at"]) if it > saved]
    assert got["printed_at"] == want["printed_at"] == list(range(saved + m, 13, m))
    assert got["printed_at"] == [straight["printed_at"][i] for i in after]
    assert got["eval_at"] == want["eval_at"] == [it for it in straight["eval_at"] if it > saved]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    assert got["losses"] == [straight["losses"][i] for i in after]
    for a, b in zip(jax.tree.leaves(runs["port resumed params"]),
                    jax.tree.leaves(runs["port params"])):
        assert torch.equal(a, b)


def test_resume_in_the_middle_of_a_dispatch_group_shifts_like_jax(tmp_path, capsys):
    """A checkpoint at iteration 3, resumed at 4 steps a dispatch with print
    and eval every 4: groups start at the skip point (its 4-7, 8-11, then a
    tail of single steps), so the boundaries fire at 7 and 11, late, in
    both packages."""
    pb, jb = _batches(13)
    ptest, jtest = _batches(2, seed=9)
    port, jax_tr = _trainers(print_freq=0)
    port.fit(pb[:3])
    jax_tr.fit(jb[:3])
    save_checkpoint(str(tmp_path / "port"), port.params, port.opt_state, port.config,
                    iteration=3, optimizer="rwsadagrad")
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jax_tr.params, jax_tr.opt_state,
                             iteration=3, optimizer="rwsadagrad")
    kw = dict(print_freq=4, test_freq=4, steps_per_dispatch=4)
    port = _trainers(load_path=str(tmp_path / "port"), **kw)[0]
    jax_tr = _trainers(load_path=str(tmp_path / "jax"), **kw)[1]
    got = _run(capsys, port, pb, lambda: ptest)
    want = _run(capsys, jax_tr, jb, lambda: jtest)
    assert got["printed_at"] == want["printed_at"] == [7, 11, 12]
    assert got["eval_at"] == want["eval_at"] == [7, 11, 12]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    assert port.iteration == jax_tr.iteration == 13


def test_resume_rejects_another_optimizer(tmp_path):
    port, _ = _trainers("adagrad")
    save_checkpoint(str(tmp_path), port.params, port.opt_state, port.config,
                    optimizer="adagrad")
    with pytest.raises(ValueError, match="carries adagrad"):
        _trainers("rwsadagrad", load_path=str(tmp_path))


def test_orbax_backend_is_not_ported():
    with pytest.raises(NotImplementedError, match="Orbax is a JAX library"):
        _trainers(ckpt_backend="orbax")


def test_scalar_writer_tags_match_jax(tmp_path, monkeypatch):
    """--tensor-board-filename: the same tags at the same iterations (the
    JSONL fallback of both packages' ScalarWriter)."""
    import dlrm_yx_tpu.utils.logging as jax_log
    import dlrm_yx_tpu_torch.utils.logging as port_log

    for mod in (jax_log, port_log):
        monkeypatch.setattr(mod.ScalarWriter, "__init__", _jsonl_writer)
    pb, jb = _batches(4)
    ptest, jtest = _batches(2, seed=9)
    port, jax_tr = _trainers(test_freq=2, tb_logdir=str(tmp_path / "port"), mlperf_logging=True)
    jax_tr.tcfg.tb_logdir = str(tmp_path / "jax")
    jax_tr.writer = jax_log.ScalarWriter(str(tmp_path / "jax"))
    port.fit(pb, lambda: ptest)
    jax_tr.fit(jb, lambda: jtest)
    rows = {}
    for name, tr in (("port", port), ("jax", jax_tr)):
        tr.writer.close()
        with open(tmp_path / name / "scalars.jsonl") as f:
            rows[name] = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in rows["port"]] == \
        [(r["tag"], r["step"]) for r in rows["jax"]]
    assert {r["tag"] for r in rows["port"]} >= {"Train/Loss", "Test/Acc",
                                               "mlperf-metrics-test/roc_auc"}
    np.testing.assert_allclose([r["value"] for r in rows["port"]],
                               [r["value"] for r in rows["jax"]], **TOL)


def _jsonl_writer(self, logdir):
    os.makedirs(logdir, exist_ok=True)
    self._tb = None
    self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
