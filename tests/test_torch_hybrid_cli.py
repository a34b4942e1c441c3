"""The port's CLI on the hybrid (whole-table sharded) path against the JAX
CLI: ``--force-cpu-devices N`` (N gloo CPU ranks on this host; JAX
simulates N devices in one process), two processes started with
``--distributed`` and the launcher's env vars, ``--sharder input
--allocation``, the mesh flags at their single-device values (a mesh only
for --mesh-data > 1 or --mesh-model > 1, as in JAX), ``--save-onnx`` and
checkpoints from a runner (row and column sharding:
``test_torch_sharded_cli.py``).

The JAX CLI runs in the test process on its 8 virtual CPU devices; the
port's ranks are processes (``parallel.multihost.spawn_local``), which
print through the test's file descriptors. Losses are compared as the
CLIs print them (6 decimals: one unit of the last digit apart at most)."""

import json
import os
import re

import numpy as np
import pytest
import torch

from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.export import load_exported
from dlrm_yx_tpu_torch.models.dlrm import forward, model_groups
from dlrm_yx_tpu_torch.parallel.multihost import spawn_local
from dlrm_yx_tpu_torch.parallel.plan import extract_tables, make_plan
from dlrm_yx_tpu_torch.train.checkpoint import read_leaves
from torch_hybrid_cases import MESH_FLAGS

# tests/test_trainer.py:378's model (four tables of 40-500 rows, dim 2)
MESH = ["--arch-embedding-size=300-40-500-120", "--arch-mlp-bot=4-8-2",
        "--arch-mlp-top=17-8-1", "--arch-sparse-feature-size=2",
        "--mini-batch-size=16", "--num-batches=4", "--loss-function=bce",
        "--round-targets=True", "--optimizer=rwsadagrad", "--test-freq=4",
        "--print-freq=1"]
# tests/test_multihost_cli.py's model
COMMON = ["--arch-embedding-size=40-50-30-60", "--arch-sparse-feature-size=4",
          "--arch-mlp-bot=4-8-4", "--arch-mlp-top=14-8-1", "--data-generation=random",
          "--mini-batch-size=8", "--num-batches=6", "--print-freq=1",
          "--loss-function=bce", "--round-targets=True", "--numpy-rand-seed=123",
          "--optimizer=rwsadagrad", "--learning-rate=0.1"]
# tests/test_torch_quantized_cli.py's model, trained
TINY = ["--arch-embedding-size=300-40-500", "--arch-mlp-bot=4-8-2",
        "--arch-mlp-top=11-8-1", "--arch-sparse-feature-size=2",
        "--mini-batch-size=64", "--num-batches=4", "--loss-function=bce",
        "--round-targets=True", "--test-freq=4"]
LOSS_RE = re.compile(r"it (\d+) of epoch \d+, [\d.]+ ms/it, loss ([\d.]+)")
PRINTED = 1e-6  # one unit of the 6th decimal


def _losses(out: str):
    return [float(m.group(2)) for m in LOSS_RE.finditer(out)]


def _same_run(got, want, got_out, want_out, n):
    assert set(got) == set(want)
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6
    gl, wl = _losses(got_out), _losses(want_out)
    assert len(gl) == len(wl) == n
    np.testing.assert_allclose(gl, wl, rtol=0, atol=PRINTED + 1e-12)


def test_force_cpu_devices_mesh_matches_jax_cli(capfd):
    """--force-cpu-devices 4 --mesh-data 2 --mesh-model 2 --sharder greedy
    (tests/test_trainer.py:378's run): the same losses and metrics."""
    flags = MESH + ["--mesh-data=2", "--mesh-model=2", "--sharder=greedy",
                    "--force-cpu-devices=4"]
    want = jax_cli_main(flags)
    want_out = capfd.readouterr().out
    got = port_cli.main(flags)
    got_out = capfd.readouterr().out
    assert "table-sharded mesh {'data': 2, 'model': 2}, sharder=greedy" in got_out
    assert "multihost: process 0/4, 4 global devices" in got_out
    _same_run(got, want, got_out, want_out, 4)


@pytest.mark.parametrize("extra,prints", [(["--mlperf-grad-accum-iter=2"], 2),
                                          (["--print-freq=2"], 2)])
def test_trainer_dispatch_on_a_mesh_matches_jax_cli(capfd, extra, prints):
    """The Trainer on a runner: gradient accumulation (the runner's
    accumulation step) and multi-step dispatch (two steps a call at
    --print-freq 2) on a 1 x 2 mesh, as the JAX CLI runs them."""
    flags = [f for f in MESH if f not in ("--print-freq=1", "--test-freq=4")] + extra + [
        "--test-freq=2", "--mesh-model=2", "--force-cpu-devices=2"]
    want = jax_cli_main(flags)
    want_out = capfd.readouterr().out
    got = port_cli.main(flags)
    got_out = capfd.readouterr().out
    _same_run(got, want, got_out, want_out, prints)


def test_two_distributed_processes_match_jax_cli(capfd):
    """Two port processes, ``--device cpu --distributed --mesh-model 2``
    with RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (the counterpart of
    tests/test_multihost_cli.py): rank 0 prints the JAX CLI's losses, rank
    1 prints none."""
    want = jax_cli_main(COMMON + ["--mesh-data=1", "--mesh-model=2", "--shard-mode=table"])
    want_out = capfd.readouterr().out
    outs = spawn_local(["-m", "dlrm_yx_tpu_torch.cli", "--device", "cpu", "--distributed",
                        "--mesh-data=1", "--mesh-model=2", "--shard-mode=table"] + COMMON,
                       2, timeout=240, capture=True)
    assert "multihost: process 0/2, 2 global devices" in outs[0]
    assert _losses(outs[1]) == [] and "Testing at it" not in outs[1]
    assert "Testing at it 6 of epoch 0" in outs[0]
    np.testing.assert_allclose(_losses(outs[0]), _losses(want_out), rtol=0,
                               atol=PRINTED + 1e-12)
    assert len(_losses(outs[0])) == 6
    acc = re.search(r"Testing at it 6 of epoch 0: accuracy ([\d.]+)%", outs[0]).group(1)
    assert float(acc) / 100 == pytest.approx(want["accuracy"], abs=5e-6)


def test_input_sharder_with_allocation_matches_jax_cli(capfd):
    flags = MESH + ["--mesh-model=2", "--sharder=input", "--allocation=1-0-0,1",
                    "--force-cpu-devices=2"]
    want = jax_cli_main(flags)
    want_out = capfd.readouterr().out
    got = port_cli.main(flags)
    got_out = capfd.readouterr().out
    assert "sharder=input" in got_out
    _same_run(got, want, got_out, want_out, 4)


@pytest.fixture(scope="module")
def plain_run():
    return port_cli.main(TINY + ["--device", "cpu"])


@pytest.mark.parametrize("extra", [
    ["--mesh-data", "1"], ["--mesh-model", "1"], ["--mesh-model", "0"],
    ["--shard-mode", "table"], ["--sharder", "naive"], ["--distributed"],
])
def test_single_device_mesh_values_run_as_in_jax(monkeypatch, plain_run, extra):
    """The mesh flags at values that ask for no mesh (and --distributed
    with no multi-process env) run on one device, as the JAX CLI does."""
    for name in ("NUM_PROCESSES", "WORLD_SIZE", "PMI_SIZE", "OMPI_COMM_WORLD_SIZE",
                 "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    got = port_cli.main(TINY + extra + ["--device", "cpu"])
    assert got == plain_run
    want = jax_cli_main(TINY + extra)
    assert set(got) == set(want) and got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6


def test_mesh_flags_keep_the_jax_types_and_defaults():
    from dlrm_yx_tpu.cli import build_parser as jax_build_parser

    flags = ["--force-cpu-devices", "3", "--distributed", "--mesh-data", "2",
             "--mesh-model", "4", "--shard-mode", "col", "--sharder", "greedy",
             "--allocation", "0-1"]
    for argv in ([], flags):
        jax_args = vars(jax_build_parser().parse_args(argv))
        port_args = vars(port_cli.build_parser().parse_args(argv))
        for flag in MESH_FLAGS:
            key = flag.replace("-", "_")
            assert port_args[key] == jax_args[key] and \
                type(port_args[key]) is type(jax_args[key]), flag
    with pytest.raises(SystemExit):
        port_cli.build_parser().parse_args(["--shard-mode", "diagonal"])


def _single_device_params(cfg, ck, sharder, n_model):
    """The params a hybrid checkpoint holds, in the single-device layout."""
    leaves = read_leaves(ck, "params")
    nb, nt = len(cfg.ln_bot) - 1, len(cfg.ln_top) - 1
    bot, emb, emb_small, top = (leaves[:2 * nb], leaves[2 * nb], leaves[2 * nb + 1],
                                leaves[2 * nb + 2:])
    assert len(top) == 2 * nt
    tables = extract_tables(make_plan(cfg, n_model, sharder), cfg, emb, emb_small)
    stores = []
    for g in model_groups(cfg):
        store = np.zeros((g.total_rows, g.dim), np.float32)
        for t, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            store[off: off + n] = tables[t]
        stores.append(torch.from_numpy(store))

    def pairs(ls):
        return [(torch.from_numpy(ls[i]), torch.from_numpy(ls[i + 1]))
                for i in range(0, len(ls), 2)]

    return {"bot": pairs(bot), "top": pairs(top), "emb": stores, "vw": None}


def test_checkpoints_and_export_from_a_runner_match_jax(tmp_path, capfd):
    """--save-model and --save-onnx on a 1 x 2 mesh: the checkpoint holds
    the JAX CLI's hybrid pytree (leaf for leaf, within rtol 1e-5 / atol
    1e-6); the exported program, reloaded, equals the single-device
    forward on the gathered params bit for bit; and the port's runner
    serves JAX's checkpoint as the JAX CLI serves it."""
    mesh = ["--mesh-model=2", "--sharder=naive", "--optimizer=rwsadagrad"]
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli_main(TINY + mesh + [f"--save-model={jck}"])
    port_cli.main(TINY + mesh + [f"--save-model={pck}", "--save-onnx",
                                 "--force-cpu-devices=2"])
    for name in ("params", "opt_state"):
        got, want = read_leaves(pck, name), read_leaves(jck, name)
        assert [a.shape for a in got] == [a.shape for a in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with open(os.path.join(jck, "meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(pck, "meta.json")) as f:
        pmeta = json.load(f)
    assert pmeta["iteration"] == jmeta["iteration"] and pmeta["optimizer"] == "rwsadagrad"

    args = port_cli.build_parser().parse_args(TINY)
    cfg = port_cli.config_from_args(args, TINY)
    params = _single_device_params(cfg, pck, "naive", 2)
    _, test = port_cli.make_data(args, cfg, train=False)
    b = test[0]
    dense, idx, w = (torch.from_numpy(np.asarray(x)) for x in (b.dense, b.indices, b.weights))
    program = load_exported(os.path.join(pck, "dlrm_torch.pt2")).module()
    got = program(params, dense, idx, w)
    want = forward(params, cfg, model_groups(cfg), dense, idx, w)
    assert torch.equal(got, want)

    capfd.readouterr()
    serve = TINY + mesh + [f"--load-model={jck}", "--inference-only"]
    want = jax_cli_main(serve)
    got = port_cli.main(serve + ["--force-cpu-devices=2"])
    assert "Resumed checkpoint at epoch 0 iteration 4" in capfd.readouterr().out
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6


def test_hybrid_checkpoint_rejects_another_layout(tmp_path, capfd):
    """A single-device checkpoint does not load into a runner: its leaves
    are not the hybrid pytree's (the ranks fail, and the launcher with
    them)."""
    ck = str(tmp_path / "single")
    port_cli.main(TINY + [f"--save-model={ck}", "--device", "cpu"])
    capfd.readouterr()
    with pytest.raises(RuntimeError, match="exited with code 1"):
        port_cli.main(TINY + ["--mesh-model=2", f"--load-model={ck}", "--inference-only",
                              "--force-cpu-devices=2"])
    assert "params.npz holds 11 leaves, the run has 12" in capfd.readouterr().err


def test_quantized_serving_from_a_runner_matches_jax_cli(tmp_path):
    ck = str(tmp_path / "ck")
    port_cli.main(TINY + ["--mesh-model=2", f"--save-model={ck}", "--force-cpu-devices=2"])
    serve = TINY + ["--mesh-model=2", f"--load-model={ck}", "--inference-only",
                    "--quantize-emb-with-bit=8", "--quantize-mlp-with-bit=8"]
    want = jax_cli_main(serve)
    got = port_cli.main(serve + ["--force-cpu-devices=2"])
    assert got == want



@pytest.mark.parametrize("extra", [["--qr-flag", "--qr-threshold=100"],
                                   ["--md-flag", "--md-round-dims", "--md-threshold=100"],
                                   ["--weighted-pooling=learned"]])
def test_variant_flags_on_a_mesh_match_jax_cli(tmp_path, capfd, extra):
    """The embedding variants on a 1 x 2 mesh through both CLIs: the same
    losses and metrics, and checkpoints leaf for leaf (``qr_r``,
    ``md_proj``, ``vw`` / ``vw_small`` among them)."""
    flags = MESH + extra + ["--mesh-model=2"]
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_cli_main(flags + [f"--save-model={jck}"])
    want_out = capfd.readouterr().out
    got = port_cli.main(flags + [f"--save-model={pck}", "--force-cpu-devices=2"])
    got_out = capfd.readouterr().out
    _same_run(got, want, got_out, want_out, 4)
    for name in ("params", "opt_state"):
        g, w = read_leaves(pck, name), read_leaves(jck, name)
        assert [a.shape for a in g] == [a.shape for a in w]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
