"""The port's serving path (dlrm_yx_tpu_torch) against the JAX package.

Both packages get the same parameters (the JAX ``init_dlrm`` carried across
with ``params_from_jax``, or each package's own ``init_dlrm`` from one seed)
and the same numpy batches; the JAX side runs the Pallas interaction in
interpret mode, as its own tests do. Everything here runs on the CPU.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.synthetic import RandomDataConfig as JaxRandomDataConfig
from dlrm_yx_tpu.data.synthetic import make_random_batches as jax_make_random_batches
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.train.train_step import make_eval_step as jax_make_eval_step
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import params_from_jax
from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
from dlrm_yx_tpu_torch.models.dlrm import (
    DLRM,
    init_dlrm,
    init_dlrm_on_device,
    model_groups,
)
from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
from dlrm_yx_tpu_torch.train.train_step import make_eval_step
from dlrm_yx_tpu_torch.utils.device import resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
# both size classes occur: tables of 100 and 37 rows form the small group
SMALL = dict(emb_rows=(100, 200, 1000, 37), ln_bot=(13, 64, 128),
             ln_top=(64, 1), emb_split_threshold=150, loss="bce")
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _configs(**kw):
    return JaxConfig.build(**kw), DLRMConfig.build(**kw)


def _batches(cfg, b, l, n=2, seed=5):
    dc = JaxRandomDataConfig(emb_rows=cfg.emb_rows, m_den=cfg.ln_bot[0],
                             mini_batch_size=b, num_batches=n,
                             num_indices_per_lookup=l, seed=seed)
    return jax_make_random_batches(dc)


def _np_params(params):
    return jax.tree.map(np.asarray, params)


def _compare_eval(jcfg, pcfg, b, l, tol):
    jp = jax_init_dlrm(jcfg, seed=3)
    pp = params_from_jax(_np_params(jp), pcfg, "cpu")
    jstep = jax_make_eval_step(jcfg)
    pstep = make_eval_step(pcfg, "cpu")
    launches = fused_interaction.launches
    for batch in _batches(jcfg, b, l):
        jpred, jloss = jstep(jp, jax.tree.map(jnp.asarray, batch))
        ppred, ploss = pstep(pp, batch)
        assert ppred.shape == (b, 1) and ppred.dtype == torch.float32
        np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), **tol)
        np.testing.assert_allclose(float(ploss), float(jloss), **tol)
    assert fused_interaction.launches == launches


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [1, 3])
def test_eval_step_matches_jax(cdt, l):
    jcfg, pcfg = _configs(**SMALL, compute_dtype=cdt, interaction_impl="pallas")
    assert len(model_groups(pcfg)) == 2
    _compare_eval(jcfg, pcfg, 128, l, TOL[cdt])


def test_tiny_packed_config_carries_across():
    """dim 2 packs 64 logical rows per 128-lane row in the JAX store."""
    jcfg, pcfg = JaxConfig.tiny(), DLRMConfig.tiny()
    assert model_groups(pcfg)[0].pack == 64
    _compare_eval(jcfg, pcfg, 8, 2, TOL["float32"])


@pytest.mark.parametrize(
    "kw",
    [SMALL,
     # a table above the port's 65536-row draw chunk, packed dim 8
     dict(emb_rows=(70001, 5, 300), ln_bot=(4, 8), ln_top=(16, 1))],
)
def test_init_dlrm_matches_jax_draws(kw):
    jcfg, pcfg = _configs(**kw)
    jp = _np_params(jax_init_dlrm(jcfg, seed=11))
    pp = init_dlrm(pcfg, seed=11, device="cpu")
    for name in ("bot", "top"):
        for (jw, jb), (pw, pb) in zip(jp[name], pp[name]):
            np.testing.assert_array_equal(pw.numpy(), jw)
            np.testing.assert_array_equal(pb.numpy(), jb)
    for js, ps, g in zip(jp["emb"], pp["emb"], model_groups(pcfg)):
        np.testing.assert_array_equal(ps.numpy(), js.reshape(g.total_rows, g.dim))


def test_init_on_device_distribution():
    """Other values than init_dlrm, the same distribution: each table within
    +-1/sqrt(rows), padding and sentinel rows zero, dense params as drawn by
    the JAX package's init_dlrm_on_device."""
    _, pcfg = _configs(**SMALL)
    pp = init_dlrm_on_device(pcfg, seed=2, device="cpu")
    for g, store in zip(model_groups(pcfg), pp["emb"]):
        live = torch.zeros(g.total_rows, dtype=torch.bool)
        for n, off in zip(g.rows, g.row_offsets):
            block = store[off : off + n]
            assert block.abs().max() <= np.sqrt(1.0 / n)
            assert block.abs().max() > 0.5 * np.sqrt(1.0 / n)
            live[off : off + n] = True
        assert not store[~live].any()
    rng = np.random.RandomState(2)
    w0 = rng.normal(0.0, np.sqrt(2.0 / (64 + 13)), size=(13, 64)).astype(np.float32)
    np.testing.assert_array_equal(pp["bot"][0][0].numpy(), w0)


def test_init_on_device_draws_bf16_stores_in_blocks(monkeypatch):
    """Tables are drawn in f32 blocks (a few rows here) and cast into the
    store: a bf16 store equals the f32 one rounded, block edges included."""
    import dataclasses

    import dlrm_yx_tpu_torch.models.dlrm as port_dlrm

    monkeypatch.setattr(port_dlrm, "_DEVICE_CHUNK_ROWS", 7)
    _, pcfg = _configs(**SMALL)
    f32 = init_dlrm_on_device(pcfg, seed=4, device="cpu")
    b16 = init_dlrm_on_device(dataclasses.replace(pcfg, emb_dtype="bfloat16"), seed=4,
                              device="cpu")
    for a, b in zip(f32["emb"], b16["emb"]):
        assert b.dtype == torch.bfloat16 and a.dtype == torch.float32
        assert torch.equal(b, a.bfloat16())


def test_dlrm_module_owns_params():
    _, pcfg = _configs(**SMALL, interaction_impl="pallas")
    params = init_dlrm(pcfg, seed=1, device="cpu")
    model = DLRM(pcfg, params)
    n = len(pcfg.ln_bot) - 1 + len(pcfg.ln_top) - 1
    assert len(list(model.parameters())) == 2 * n + len(params["emb"])
    assert all(not s.requires_grad for s in model.emb)
    batch = make_random_batches(RandomDataConfig(
        emb_rows=pcfg.emb_rows, m_den=13, mini_batch_size=64, num_batches=1))[0]
    with torch.inference_mode():
        logits = model(*(torch.from_numpy(a) for a in batch[:3]))
    pred, _ = make_eval_step(pcfg, "cpu")(params, batch)
    torch.testing.assert_close(torch.sigmoid(logits), pred)


@pytest.mark.parametrize("l,fixed,dist", [(1, False, "uniform"), (3, True, "uniform"),
                                          (4, False, "gaussian")])
def test_random_batches_match_jax(l, fixed, dist):
    kw = dict(emb_rows=(50, 7, 300), m_den=5, mini_batch_size=16, num_batches=2,
              num_indices_per_lookup=l, num_indices_per_lookup_fixed=fixed,
              dist=dist, rand_data_max=40.0, seed=9)
    for jb, pb in zip(jax_make_random_batches(JaxRandomDataConfig(**kw)),
                      make_random_batches(RandomDataConfig(**kw))):
        for ja, pa in zip(jb, pb):
            np.testing.assert_array_equal(pa, ja)


CLI_FLAGS = [
    "--arch-embedding-size", "100-200-1000-37", "--arch-sparse-feature-size", "128",
    "--arch-mlp-bot", "13-64-128", "--arch-mlp-top", "64-1",
    "--emb-split-threshold", "150", "--num-batches", "2",
    "--num-indices-per-lookup", "1", "--loss-function", "bce",
    "--inference-only", "--interaction-impl", "pallas",
    "--compute-dtype", "float32", "--mini-batch-size", "128",
]


@pytest.mark.parametrize("mlperf", [False, True])
def test_cli_inference_matches_jax_cli(mlperf):
    flags = CLI_FLAGS + (["--mlperf-logging"] if mlperf else [])
    want = jax_cli_main(flags)
    got = port_cli.main(flags + ["--device", "cpu"])
    assert set(got) == set(want)
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6
    if mlperf:
        assert abs(got["roc_auc"] - want["roc_auc"]) <= 1e-6


@pytest.mark.parametrize(
    "extra",
    [["--mesh-data", "2", "--shard-mode", "row"],
     ["--distributed", "--mesh-model", "2", "--shard-mode", "col"],
     ["--shard-mode", "row", "--mesh-model", "2"],
     ["--sharder", "greedy", "--mesh-model", "2", "--shard-mode", "col"]],
)
def test_cli_rejects_unported_flags(extra):
    """Every mesh flag is ported: row and column sharding (--shard-mode
    row|col with a mesh) serve on two gloo ranks with the JAX CLI's metrics
    (more in tests/test_torch_sharded_cli.py)."""
    want = jax_cli_main(CLI_FLAGS + extra)
    got = port_cli.main(CLI_FLAGS + ["--device", "cpu", "--force-cpu-devices", "2"] + extra)
    assert set(got) == set(want) and got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6


def test_cli_without_inference_only_is_not_ported():
    """Training is ported (tests/test_torch_training.py, with
    --no-write-only-update and --stochastic-rounding; multi-step dispatch
    and gradient accumulation in tests/test_torch_trainer.py; checkpoints
    in tests/test_torch_checkpoint.py; table sharding in
    tests/test_torch_hybrid_cli.py), row sharding among its options: two
    gloo ranks train with the JAX CLI's metrics."""
    flags = [f for f in CLI_FLAGS if f != "--inference-only"] + [
        "--mesh-model", "2", "--shard-mode", "row"]
    want = jax_cli_main(flags)
    got = port_cli.main(flags + ["--device", "cpu", "--force-cpu-devices", "2"])
    assert set(got) == set(want) and got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6


def test_cuda_asked_for_and_absent_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        port_cli.main(CLI_FLAGS)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((REPO / "dlrm_yx_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "dlrm_yx_tpu"), (path, mod)
