"""The port's reference-checkpoint converter (dlrm_yx_tpu_torch.tools.torch_ckpt)
against the JAX package's (dlrm_yx_tpu.tools.torch_ckpt) on the CPU.

(``tests/test_torch_ckpt.py`` is the JAX package's own test of its tool.)
Both converters read and write the same files: a reference ``.pt`` and a
checkpoint directory in the JAX npz layout. Params and optimizer state
come from numpy seeds; every comparison is bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.optim.optimizer import OptConfig as JaxOptConfig
from dlrm_yx_tpu.optim.optimizer import init_opt_state as jax_init_opt_state
from dlrm_yx_tpu.tools import torch_ckpt as jck
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import opt_state_from_jax, params_from_jax
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.tools import torch_ckpt as pck
from dlrm_yx_tpu_torch.train.checkpoint import load_checkpoint

KINDS = {
    # three plain tables at dim 8 (packed in JAX), bot 4-8, top 14-6-1
    "plain": dict(emb_rows=(40, 25, 60), emb_dims=(8, 8, 8), ln_bot=(4, 8), ln_top=(14, 6, 1)),
    # table 0 mixed-dimension (dim 4, up-projected), table 2 QR
    "qr + md": dict(
        emb_rows=(120, 30, 200), emb_dims=(4, 8, 8), ln_bot=(4, 8), ln_top=(14, 6, 1),
        qr_flag=True, qr_threshold=150, qr_collisions=4, md_flag=True, md_threshold=100),
    # table 0 mixed-dimension, learned v_W (QR refuses learned pooling)
    "md + learned pooling": dict(
        emb_rows=(120, 30, 200), emb_dims=(4, 8, 8), ln_bot=(4, 8), ln_top=(14, 6, 1),
        md_flag=True, md_threshold=100, weighted_pooling="learned"),
}
OPTS = ("sgd", "adagrad", "rwsadagrad")
ARCH = ["--arch-embedding-size", "40-25-60", "--arch-sparse-feature-size", "8",
        "--arch-mlp-bot", "4-8", "--arch-mlp-top", "6-1"]


def _random_tree(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: rng.rand(*np.shape(a)).astype(np.float32), tree)


def _jax_model(kind, optname, seed=5):
    """JAX params (their init) and a random (nonzero) optimizer state."""
    cfg = JaxConfig.build(**KINDS[kind])
    params = jax_init_dlrm(cfg, seed=seed)
    opt = JaxOptConfig(optname, 0.1)
    state = _random_tree(jax_init_opt_state(opt, params, jax_model_groups(cfg)), seed + 1)
    return cfg, params, opt, state


def _npz_leaves(path):
    with np.load(path) as d:
        return [d[f"leaf_{i}"] for i in range(len(d.files))]


def _assert_same_dirs(got_dir, want_dir):
    for name in ("params.npz", "opt_state.npz"):
        got, want = _npz_leaves(os.path.join(got_dir, name)), _npz_leaves(
            os.path.join(want_dir, name))
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, (name, i)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} leaf_{i}")
    with open(os.path.join(got_dir, "meta.json")) as f, \
            open(os.path.join(want_dir, "meta.json")) as g:
        assert json.load(f) == json.load(g)


def _assert_same_pt(got_path, want_path):
    got = torch.load(got_path, map_location="cpu", weights_only=False)
    want = torch.load(want_path, map_location="cpu", weights_only=False)
    assert set(got) == set(want)
    for k in want:
        if k == "state_dict":
            assert list(got[k]) == list(want[k])
            for key in want[k]:
                assert torch.equal(got[k][key], want[k][key]), key
        elif k == "opt_state_dict":
            assert got[k]["param_groups"] == want[k]["param_groups"]
            assert set(got[k]["state"]) == set(want[k]["state"])
            for idx, st in want[k]["state"].items():
                assert set(got[k]["state"][idx]) == set(st), idx
                for field, v in st.items():
                    if isinstance(v, torch.Tensor):
                        assert torch.equal(got[k]["state"][idx][field], v), (idx, field)
                    else:
                        assert got[k]["state"][idx][field] == v, (idx, field)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("optname", OPTS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_written_pt_imports_like_jax(tmp_path, kind, optname):
    """A .pt from JAX's exporter: the port's import writes JAX's import's
    checkpoint directory, file for file, and its params are the port's
    params_from_jax of the exported params."""
    jcfg, jp, jopt, jstate = _jax_model(kind, optname)
    pt = str(tmp_path / "ref.pt")
    meta = {"epoch": 1, "iteration": 9, "train_loss": 0.25,
            "metrics": {"accuracy": 0.75, "roc_auc": 0.625}}
    jck.export_torch_checkpoint(pt, jcfg, jp, opt_state=jstate, opt=jopt, meta=meta)
    jck.import_torch_checkpoint(pt, jcfg, str(tmp_path / "jax"), jopt)
    pcfg, popt = DLRMConfig.build(**KINDS[kind]), OptConfig(optname, 0.1)
    got_meta = pck.import_torch_checkpoint(pt, pcfg, str(tmp_path / "port"), popt, device="cpu")
    assert got_meta == {"epoch": 1, "iteration": 9, "metrics": meta["metrics"]}
    _assert_same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    like = init_dlrm(pcfg, seed=0, device="cpu")
    params, _, _ = load_checkpoint(str(tmp_path / "port"), like,
                                   init_opt_state(popt, like, model_groups(pcfg)))
    want = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optname", OPTS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_port_export_writes_jax_export(tmp_path, kind, optname):
    """The port's exporter, from the port's copy of the params and state,
    writes the .pt the JAX exporter writes: keys, state_dict tensors,
    optimizer state and counters."""
    jcfg, jp, jopt, jstate = _jax_model(kind, optname)
    meta = {"epoch": 2, "iteration": 17, "train_loss": 0.5, "metrics": {"accuracy": 0.5}}
    jck.export_torch_checkpoint(str(tmp_path / "jax.pt"), jcfg, jp, opt_state=jstate,
                                opt=jopt, meta=meta, nbatches=10, nbatches_test=2)
    pcfg, popt = DLRMConfig.build(**KINDS[kind]), OptConfig(optname, 0.1)
    params = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), popt, pcfg, "cpu")
    pck.export_torch_checkpoint(str(tmp_path / "port.pt"), pcfg, params, opt_state=state,
                                opt=popt, meta=meta, nbatches=10, nbatches_test=2)
    _assert_same_pt(str(tmp_path / "port.pt"), str(tmp_path / "jax.pt"))
    # without an optimizer state both write a zero one
    jck.export_torch_checkpoint(str(tmp_path / "jax0.pt"), jcfg, jp, opt=jopt)
    pck.export_torch_checkpoint(str(tmp_path / "port0.pt"), pcfg, params, opt=popt)
    _assert_same_pt(str(tmp_path / "port0.pt"), str(tmp_path / "jax0.pt"))


@pytest.mark.parametrize("kind", ["qr + md", "md + learned pooling"])
def test_state_dict_round_trip_of_the_variants(kind):
    pcfg = DLRMConfig.build(**KINDS[kind])
    params = init_dlrm(pcfg, seed=3, device="cpu")
    for v in params["vw"] or ():
        v.mul_(torch.rand(v.shape, generator=torch.Generator().manual_seed(1)))
    sd = pck.state_dict_from_params(params, pcfg)
    back = pck.params_from_state_dict(sd, pcfg, "cpu")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert torch.equal(a, b)
    jcfg = JaxConfig.build(**KINDS[kind])
    want = jck.state_dict_from_params(jax.tree.map(np.asarray, jax_init_dlrm(jcfg, seed=3)),
                                      jcfg)
    assert sorted(sd) == sorted(want)


def test_adagrad_import_of_a_rwsadagrad_pt_raises_like_jax(tmp_path):
    jcfg, jp, jopt, jstate = _jax_model("plain", "rwsadagrad")
    pt = str(tmp_path / "rws.pt")
    jck.export_torch_checkpoint(pt, jcfg, jp, opt_state=jstate, opt=jopt)
    with pytest.raises(ValueError, match="row-wise 'momentum'"):
        jck.import_torch_checkpoint(pt, jcfg, str(tmp_path / "j"), JaxOptConfig("adagrad", 0.1))
    with pytest.raises(ValueError, match="row-wise 'momentum'"):
        pck.import_torch_checkpoint(pt, DLRMConfig.build(**KINDS["plain"]), str(tmp_path / "p"),
                                    OptConfig("adagrad", 0.1), device="cpu")


@pytest.mark.parametrize("optname", ["sgd", "rwsadagrad"])
def test_main_both_ways_like_jax(tmp_path, optname):
    """The converters' command lines: import a JAX-written .pt (rows capped
    by --max-ind-range), then export the directory again; both packages'
    files are the same."""
    cap = ["--max-ind-range", "30"]
    kw = dict(KINDS["plain"], emb_rows=(30, 25, 30))
    jcfg = JaxConfig.build(**kw)
    jp = jax_init_dlrm(jcfg, seed=2)
    jopt = JaxOptConfig(optname, 0.1)
    jstate = _random_tree(jax_init_opt_state(jopt, jp, jax_model_groups(jcfg)), 4)
    pt = str(tmp_path / "in.pt")
    jck.export_torch_checkpoint(pt, jcfg, jp, opt_state=jstate, opt=jopt,
                                meta={"epoch": 0, "iteration": 3})
    flags = ["--optimizer", optname] + ARCH + cap
    for pkg, main in (("jax", jck.main), ("port", pck.main)):
        main(["--import-pt", pt, "--ckpt-dir", str(tmp_path / pkg)] + flags)
        main(["--export-pt", str(tmp_path / f"{pkg}.pt"), "--ckpt-dir", str(tmp_path / pkg)]
             + flags)
    _assert_same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    _assert_same_pt(str(tmp_path / "port.pt"), str(tmp_path / "jax.pt"))


def test_main_help_and_refusals():
    with pytest.raises(SystemExit) as e:
        pck.main(["--help"])
    assert e.value.code == 0
    with pytest.raises(SystemExit, match="--ckpt-dir is required"):
        pck.main(ARCH)
    with pytest.raises(SystemExit, match="exactly one of"):
        pck.main(["--ckpt-dir", "d"] + ARCH)
