"""Model export and the diagnostics of the port (dlrm_yx_tpu_torch.export,
``--save-onnx``, ``--collect-execution-graph`` / ``--plot-compute-graph``,
``--enable-profiling``) on the CPU.

An exported program, saved and reloaded, gives the live forward's
predictions bit for bit (the same operators on the same inputs); with the
fused interaction it calls the custom operator, whose CPU implementation is
the plain version. The diagnostics leave the run's results as they are:
a run with a flag ends with the metrics of the same run without it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.export import export_inference as jax_export_inference
from dlrm_yx_tpu.export import load_exported as jax_load_exported
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import params_from_jax
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.export import collect_execution_graph, export_inference, load_exported
from dlrm_yx_tpu_torch.models.dlrm import forward, init_dlrm, model_groups
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.train.checkpoint import load_checkpoint
from dlrm_yx_tpu_torch.train.train_step import make_train_step
from dlrm_yx_tpu_torch.utils.profiling import TRACE_FILE

PHASES = ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp", "loss_compute",
          "backward", "optimizer")
SERVE = dict(emb_rows=(100, 200, 1000, 37), ln_bot=(13, 64, 128), ln_top=(64, 1),
             emb_split_threshold=150, loss="bce")
MODELS = {
    "plain": dict(SERVE, interaction_impl="xla"),
    "fused interaction": dict(SERVE, interaction_impl="pallas"),
    "fused interaction, bf16": dict(SERVE, interaction_impl="pallas", compute_dtype="bfloat16"),
    "qr + md": dict(emb_rows=(3000, 40, 60, 5000), emb_dims=(8, 16, 16, 16), ln_bot=(4, 16),
                    ln_top=(16, 1), emb_split_threshold=100, loss="bce", qr_flag=True,
                    qr_threshold=4000, md_flag=True, md_threshold=2000),
    "learned pooling, L=3": dict(SERVE, weighted_pooling="learned"),
}
ARCH = ["--arch-embedding-size=300-40-500", "--arch-mlp-bot=4-8-2",
        "--arch-mlp-top=11-8-1", "--arch-sparse-feature-size=2",
        "--mini-batch-size=8", "--num-batches=4", "--loss-function=bce",
        "--round-targets=True", "--test-freq=4", "--optimizer=rwsadagrad", "--device", "cpu"]


def _batch(cfg, b, l, seed=3):
    r = np.random.RandomState(seed)
    return Batch(r.rand(b, cfg.ln_bot[0]).astype(np.float32),
                 np.stack([r.randint(0, n, (b, l)) for n in cfg.emb_rows]).astype(np.int32),
                 r.rand(cfg.num_tables, b, l).astype(np.float32),
                 (r.rand(b, 1) > 0.5).astype(np.float32))


def _live(params, cfg, b):
    with torch.no_grad():
        return forward(params, cfg, model_groups(cfg), *(torch.from_numpy(x) for x in b[:3]))


@pytest.mark.parametrize("model", list(MODELS))
def test_export_reload_and_run_equals_the_live_forward(tmp_path, model):
    cfg = DLRMConfig.build(**MODELS[model])
    params = init_dlrm(cfg, seed=4, device="cpu")
    l = 3 if "L=3" in model else 1
    path = str(tmp_path / "m.pt2")
    export_inference(params, cfg, _batch(cfg, 64, l, seed=1), path)
    with open(path + ".json") as f:
        side = json.load(f)
    assert side == {"dense": [64, cfg.ln_bot[0]], "indices": [cfg.num_tables, 64, l],
                    "weights": [cfg.num_tables, 64, l], "platforms": ["cpu"]}
    program = load_exported(path)
    assert program.example_inputs is None  # the file holds no parameters
    fused = [n for n in program.graph.nodes
             if "dlrm_yx_tpu_torch.fused_interaction" in str(n.target)]
    assert len(fused) == (1 if "fused" in model else 0)
    b = _batch(cfg, 64, l, seed=2)
    got = program.module()(params, *(torch.from_numpy(x) for x in b[:3]))
    assert torch.equal(got, _live(params, cfg, b))


def test_exported_program_matches_jax_export(tmp_path):
    """Both packages' exported programs, reloaded, on the same params and
    batch: rtol 1e-5 / atol 1e-6 (f32 sums in other orders)."""
    kw = MODELS["plain"]
    jcfg, cfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    jp = jax_init_dlrm(jcfg, seed=6)
    b = _batch(cfg, 64, 1, seed=7)
    jax_export_inference(jp, jcfg, b, str(tmp_path / "m.stablehlo"))
    want = np.asarray(jax_load_exported(str(tmp_path / "m.stablehlo")).call(
        jp, *(jnp.asarray(x) for x in b[:3])))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    export_inference(params, cfg, b, str(tmp_path / "m.pt2"))
    got = load_exported(str(tmp_path / "m.pt2")).module()(
        params, *(torch.from_numpy(x) for x in b[:3]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_save_onnx_writes_the_program_of_the_trained_model(tmp_path):
    ck = str(tmp_path / "ck")
    port_cli.main(ARCH + [f"--save-model={ck}", "--save-onnx"])
    path = os.path.join(ck, "dlrm_torch.pt2")
    assert os.path.getsize(path) > 0 and os.path.exists(path + ".json")
    args = port_cli.build_parser().parse_args(ARCH)
    cfg = port_cli.config_from_args(args, ARCH)
    like = init_dlrm(cfg, seed=0, device="cpu")
    opt = OptConfig("rwsadagrad", 0.01)
    params, _, _ = load_checkpoint(ck, like, init_opt_state(opt, like, model_groups(cfg)))
    b = _batch(cfg, 8, 10, seed=9)
    got = load_exported(path).module()(params, *(torch.from_numpy(x) for x in b[:3]))
    assert torch.equal(got, _live(params, cfg, b))


def test_collect_execution_graph_writes_its_artifacts(tmp_path):
    cfg = DLRMConfig.build(**MODELS["fused interaction"])
    opt = OptConfig("rwsadagrad", 0.01)
    params = init_dlrm(cfg, seed=2, device="cpu")
    state = init_opt_state(opt, params, model_groups(cfg))
    arts = collect_execution_graph(make_train_step(cfg, opt, device="cpu"),
                                   (params, state, _batch(cfg, 64, 1), 0), str(tmp_path), "step")
    assert set(arts) == {"execution_trace", "kernels"}
    with open(arts["execution_trace"]) as f:
        et = json.load(f)
    names = {n["name"] for n in et["nodes"]}
    assert set(PHASES) <= names
    assert "dlrm_yx_tpu_torch::fused_interaction" in names
    with open(arts["kernels"]) as f:
        assert "embedding_lookup" in f.read()


def _final_params(run):
    trainer = run["trainer"]
    return [t.clone() for t in jax.tree.leaves(trainer.params)]


def _run(monkeypatch, flags):
    made = {}

    class Kept(port_cli.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made["trainer"] = self

    monkeypatch.setattr(port_cli, "Trainer", Kept)
    made["metrics"] = port_cli.main(flags)
    return made


@pytest.mark.parametrize("flag", ["--collect-execution-graph", "--plot-compute-graph",
                                  "--enable-profiling"])
def test_diagnostic_flags_write_their_files_and_leave_the_run_alone(monkeypatch, tmp_path,
                                                                     flag):
    out = str(tmp_path / "prof")
    base = _run(monkeypatch, ARCH)
    run = _run(monkeypatch, ARCH + [flag, f"--profile-out-dir={out}"])
    assert run["metrics"] == base["metrics"]
    for a, b in zip(_final_params(run), _final_params(base)):
        assert torch.equal(a, b)
    if flag == "--enable-profiling":
        with open(os.path.join(out, TRACE_FILE)) as f:
            text = f.read()
        assert all(f'"{p}"' in text for p in PHASES)
    else:
        assert sorted(os.listdir(out)) == ["train_step.et.json", "train_step.kernels.txt"]
        with open(os.path.join(out, "train_step.et.json")) as f:
            names = {n["name"] for n in json.load(f)["nodes"]}
        assert set(PHASES) <= names
