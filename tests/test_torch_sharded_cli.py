"""The port's CLI with ``--shard-mode row`` and ``col`` on a mesh against
the JAX CLI: training on 2 and 4 CPU ranks (``--force-cpu-devices``; JAX
simulates the devices in one process), a checkpoint written by the port's
runner resumed by the JAX CLI (``load_checkpoint``, then the runner's
``reshard``) against the JAX CLI's uninterrupted run, ``--save-onnx`` and
quantized serving from a runner, and the diagnostic flags with a mesh:
``--collect-execution-graph`` writes its artifact and trains on in both,
``--debug-mode`` fails in both with a TypeError (R10, ROADMAP Queue C).
Losses are compared as the CLIs print them (6 decimals)."""

import os

import numpy as np
import pytest
import torch

from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.export import load_exported
from dlrm_yx_tpu_torch.models.dlrm import forward, model_groups
from dlrm_yx_tpu_torch.train.checkpoint import read_leaves
from test_torch_hybrid_cli import _losses, _same_run

# four tables, two of them over the split threshold, dim 4 (a row shard
# packs 32 rows to JAX's 128-lane row; a column slice is 2 or 1 wide)
MODEL = ["--arch-embedding-size=300-40-500-120", "--arch-mlp-bot=4-8-4",
         "--arch-mlp-top=14-8-1", "--arch-sparse-feature-size=4",
         "--emb-split-threshold=100", "--mini-batch-size=16", "--loss-function=bce",
         "--round-targets=True", "--optimizer=rwsadagrad", "--learning-rate=0.1",
         "--print-freq=1", "--test-freq=4"]
MESHES = {2: ["--mesh-model=2"], 4: ["--mesh-data=2", "--mesh-model=2"]}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["row", "col"])
def test_sharded_cli_matches_jax_cli(capfd, mode, n):
    """--shard-mode row|col on 2 ranks (mesh 1 x 2) and 4 (2 x 2): the same
    printed losses, eval metrics and mesh line as the JAX CLI."""
    flags = MODEL + ["--num-batches=4", f"--shard-mode={mode}"] + MESHES[n]
    want = jax_cli_main(flags)
    want_out = capfd.readouterr().out
    got = port_cli.main(flags + [f"--force-cpu-devices={n}"])
    got_out = capfd.readouterr().out
    _same_run(got, want, got_out, want_out, 4)
    line = f"{mode}-sharded mesh {{'data': {n // 2}, 'model': 2}}\n"
    assert line in got_out and line in want_out


@pytest.mark.parametrize("mode", ["row", "col"])
def test_checkpoint_of_a_runner_resumes_in_jax(tmp_path, capfd, mode):
    """The port's runner saves at iteration 4 (the JAX CLI's checkpoint leaf
    for leaf, within rtol 1e-5 / atol 1e-6); the JAX CLI loads it,
    reshards it and trains on to iteration 8: its losses and metrics are
    its uninterrupted run's. The port's runner serves JAX's checkpoint as
    the JAX CLI serves it."""
    flags = MODEL + [f"--shard-mode={mode}"] + MESHES[2]
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli_main(flags + ["--num-batches=4", f"--save-model={jck}"])
    port_cli.main(flags + ["--num-batches=4", f"--save-model={pck}", "--force-cpu-devices=2"])
    for name in ("params", "opt_state"):
        got, want = read_leaves(pck, name), read_leaves(jck, name)
        assert [a.shape for a in got] == [a.shape for a in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    capfd.readouterr()
    whole = jax_cli_main(flags + ["--num-batches=8"])
    whole_out = capfd.readouterr().out
    resumed = jax_cli_main(flags + ["--num-batches=8", f"--load-model={pck}"])
    resumed_out = capfd.readouterr().out
    assert "Resumed checkpoint at epoch 0 iteration 4" in resumed_out
    assert set(resumed) == set(whole) and resumed["accuracy"] == whole["accuracy"]
    assert abs(resumed["streaming_auc"] - whole["streaming_auc"]) <= 1e-6
    np.testing.assert_allclose(_losses(resumed_out), _losses(whole_out)[4:], rtol=0,
                               atol=1e-6 + 1e-12)
    serve = flags + ["--num-batches=4", f"--load-model={jck}", "--inference-only"]
    want = jax_cli_main(serve)
    got = port_cli.main(serve + ["--force-cpu-devices=2"])
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6


@pytest.mark.parametrize("mode", ["row", "col"])
def test_export_and_quantized_serving_from_a_runner(tmp_path, mode):
    """--save-onnx from a row or column runner exports the single-device
    forward on the gathered tables (reloaded, equal to it bit for bit);
    --inference-only --quantize-emb-with-bit 8 from the runner's checkpoint
    gives the JAX CLI's metrics."""
    flags = MODEL + ["--num-batches=4", f"--shard-mode={mode}"] + MESHES[2]
    ck = str(tmp_path / "ck")
    port_cli.main(flags + [f"--save-model={ck}", "--save-onnx", "--force-cpu-devices=2"])
    args = port_cli.build_parser().parse_args(MODEL)
    cfg = port_cli.config_from_args(args, MODEL)
    leaves = read_leaves(ck, "params")
    nb = len(cfg.ln_bot) - 1
    bot, emb, emb_small, top = (leaves[:2 * nb], leaves[2 * nb], leaves[2 * nb + 1],
                                leaves[2 * nb + 2:])
    if mode == "row":
        from dlrm_yx_tpu_torch.parallel.row_sharded import (
            extract_row_sharded_tables as extract,
            make_row_plan as make_plan,
        )
    else:
        from dlrm_yx_tpu_torch.parallel.col_sharded import (
            extract_col_sharded_tables as extract,
            make_col_plan as make_plan,
        )
    tables = extract(make_plan(cfg, 2), emb, emb_small)
    stores = []
    for g in model_groups(cfg):
        store = np.zeros((g.total_rows, g.dim), np.float32)
        for t, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            store[off: off + n] = tables[t]
        stores.append(torch.from_numpy(store))

    def pairs(ls):
        return [(torch.from_numpy(ls[i]), torch.from_numpy(ls[i + 1]))
                for i in range(0, len(ls), 2)]

    params = {"bot": pairs(bot), "top": pairs(top), "emb": stores, "vw": None}
    _, test = port_cli.make_data(args, cfg, train=False)
    b = test[0]
    dense, idx, w = (torch.from_numpy(np.asarray(x)) for x in (b.dense, b.indices, b.weights))
    program = load_exported(os.path.join(ck, "dlrm_torch.pt2")).module()
    assert torch.equal(program(params, dense, idx, w),
                       forward(params, cfg, model_groups(cfg), dense, idx, w))
    serve = flags + [f"--load-model={ck}", "--inference-only", "--quantize-emb-with-bit=8"]
    want = jax_cli_main(serve)
    got = port_cli.main(serve + ["--force-cpu-devices=2"])
    assert got == want


@pytest.mark.parametrize("mode", ["table", "row", "col"])
def test_collect_execution_graph_with_a_mesh_trains_on_in_both(tmp_path, capfd, mode):
    """--collect-execution-graph with a mesh: the JAX CLI writes the sharded
    step's lowered module, the port the execution trace of one eager
    sharded step (each rank its own); both print the artifact line and
    train on from the same state."""
    flags = MODEL + ["--num-batches=4", f"--shard-mode={mode}",
                     "--collect-execution-graph"] + MESHES[2]
    want = jax_cli_main(flags + [f"--profile-out-dir={tmp_path / 'jax'}"])
    want_out = capfd.readouterr().out
    got = port_cli.main(flags + [f"--profile-out-dir={tmp_path / 'port'}",
                                 "--force-cpu-devices=2"])
    got_out = capfd.readouterr().out
    _same_run(got, want, got_out, want_out, 4)
    assert os.path.exists(tmp_path / "jax" / "hybrid_step.stablehlo.txt")
    for name in ("hybrid_step", "hybrid_step.rank1"):
        assert os.path.getsize(tmp_path / "port" / f"{name}.et.json") > 0
        assert os.path.getsize(tmp_path / "port" / f"{name}.kernels.txt") > 0
    assert "execution graph artifacts: {" in got_out and "execution graph artifacts: {" in want_out


@pytest.mark.parametrize("mode", ["table", "row", "col"])
def test_debug_mode_with_a_mesh_fails_as_in_jax(capfd, mode):
    """R10 (ROADMAP Queue C): --debug-mode with a mesh reads the runner's
    sharded ``emb`` as single-device group stores, and the reshape raises a
    TypeError after the runner is built, in the JAX CLI and in each of the
    port's ranks (tables 200-300-40 of dim 16, split at 100 rows)."""
    flags = ["--arch-embedding-size=200-300-40", "--arch-sparse-feature-size=16",
             "--arch-mlp-bot=4-16", "--arch-mlp-top=8-1", "--mini-batch-size=8",
             "--num-batches=2", "--emb-split-threshold=100", "--debug-mode",
             f"--shard-mode={mode}", "--mesh-model=2"]
    with pytest.raises(TypeError, match="cannot reshape array of shape"):
        jax_cli_main(flags + ["--force-cpu-devices=2"])
    want_out = capfd.readouterr().out
    with pytest.raises(RuntimeError, match="exited with code 1"):
        port_cli.main(flags + ["--force-cpu-devices=2"])
    got = capfd.readouterr()
    assert "TypeError: cannot reshape array of shape" in got.err + got.out
    assert f"{mode}-sharded mesh" in got.out and f"{mode}-sharded mesh" in want_out
    assert "initial parameters (weights and bias):" in got.out
