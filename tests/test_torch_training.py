"""The port's training path (dlrm_yx_tpu_torch: make_train_step, Trainer.fit,
cli) against the JAX package on the CPU.

Both packages start from the JAX ``init_dlrm`` params and ``init_opt_state``
(carried across with ``params_from_jax`` / ``opt_state_from_jax``) and
take the same numpy batches. The JAX train step donates its inputs, so its
outputs are rebound; the port updates in place, so its inputs are its own
copies. The kernel routes are forced on small stores by patching
``PALLAS_MIN_STORE_BYTES`` (and, for K4 on the 1-D momentum,
``ACC_KERNEL_MIN_BYTES``) in both packages; JAX runs its Pallas kernels in
interpret mode, which skips stochastic rounding, so the port's SR runs are
held to JAX's nearest-even runs within bf16 rounding.
"""

import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_yx_tpu.optim.optimizer as jax_opt
import dlrm_yx_tpu_torch.optim.optimizer as port_opt
from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.batch import Batch
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.ops.pallas_interaction import fused_interaction as jax_fused
from dlrm_yx_tpu.train.train_step import make_train_step as jax_make_train_step
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import opt_state_from_jax, params_from_jax
from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.train.train_step import make_train_step
from test_torch_optim import assert_within_one_bf16_ulp

TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# big tables of 3000 and 3200 rows (size class 1, the K2 route) and small
# ones of 40 and 60 (size class 0, the dense branch and K3)
TWO_GROUPS = dict(emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 64, 128),
                  ln_top=(64, 1), emb_split_threshold=100, loss="bce",
                  interaction_impl="pallas")


def _batches(rows, b, n=3, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        idx = np.stack([r.randint(0, m, (b, 1)) for m in rows]).astype(np.int32)
        idx[1, :6, 0] = idx[1, 0, 0]  # a duplicate-heavy row of a big table
        out.append(Batch(r.rand(b, 4).astype(np.float32), idx,
                         np.ones((len(rows), b, 1), np.float32),
                         (r.rand(b, 1) > 0.5).astype(np.float32)))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run_both(monkeypatch, optname, impl, cdt="float32", hint=-1.0, dim=128, b=64,
              steps=3, **cfg_kw):
    """``steps`` steps of each package from the same state (config
    overrides in cfg_kw); returns both (params, state, losses) and how
    often the port called K2, K3 and K4."""
    for mod in (jax_opt, port_opt):
        monkeypatch.setattr(mod, "PALLAS_MIN_STORE_BYTES", 0)
        monkeypatch.setattr(mod, "ACC_KERNEL_MIN_BYTES", 0)
    kw = dict(TWO_GROUPS, ln_bot=(4, 64, dim), sparse_update_impl=impl,
              compute_dtype=cdt, dup_density_hint=hint, **cfg_kw)
    jcfg, pcfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    jp = jax_init_dlrm(jcfg, seed=3)
    js = jax_opt.init_opt_state(jax_opt.OptConfig(optname, 0.05), jp, jax_model_groups(jcfg))
    # a nonzero starting state, the same in both packages
    js = jax.tree.map(lambda a: a + 0.01, js)
    opt = OptConfig(optname, 0.05)
    pp = params_from_jax(_np(jp), pcfg, "cpu")
    ps = opt_state_from_jax(_np(js), opt, pcfg, "cpu")
    calls = {"k2": 0, "k3": 0, "k4": 0}
    # K3: the train step finishes its dense-branch stores in one grouped call
    for name, attr in (("k2", "sparse_rows_overwrite"), ("k3", "rwsadagrad_dense_finish_many"),
                       ("k4", "sparse_rows_add")):
        fn = getattr(port_opt, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(port_opt, attr, counted)
    jstep = jax_make_train_step(jcfg, jax_opt.OptConfig(optname, 0.05))
    pstep = make_train_step(pcfg, opt, device="cpu")
    jl, pl = [], []
    for i, batch in enumerate(_batches(pcfg.emb_rows, b, n=steps)):
        jp, js, loss = jstep(jp, js, Batch(*map(jnp.asarray, batch)), i)
        jl.append(float(loss))
        pp, ps, loss = pstep(pp, ps, batch, i)
        pl.append(float(loss))
    return (jp, js, jl), (pp, ps, pl), calls, pcfg


def _compare(jax_out, port_out, cfg, tol, store_check=None):
    """Losses, MLPs, stores and optimizer state at ``tol``; the stores with
    ``store_check(got, want)`` instead when one is given."""
    (jp, js, jl), (pp, ps, pl) = jax_out, port_out
    np.testing.assert_allclose(pl, jl, **tol)
    for name in ("bot", "top"):
        for (jw, jb), (pw, pb) in zip(jp[name], pp[name]):
            np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **tol)
            np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **tol)
    for js_, ps_, g in zip(jp["emb"], pp["emb"], model_groups(cfg)):
        want = np.asarray(js_.astype(jnp.float32)).reshape(g.total_rows, g.dim)
        if store_check is None:
            np.testing.assert_allclose(ps_.float().numpy(), want, **tol)
        else:
            store_check(ps_.float().numpy(), want)
    if ps:
        for name in ("bot", "top"):
            for (jw, jb), (pw, pb) in zip(js["dense"][name], ps["dense"][name]):
                np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **tol)
                np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **tol)
        for ja, pa in zip(js["emb"], ps["emb"]):
            np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **tol)


@pytest.mark.parametrize("optname,impl,hint,dim", [
    ("rwsadagrad", "xla", -1.0, 128),
    ("rwsadagrad", "pallas", -1.0, 128),   # K2 after coalescing, K3
    ("rwsadagrad", "pallas", 0.99, 128),   # K2 with per-occurrence momentum
    ("rwsadagrad", "pallas", -1.0, 64),    # packed groups in JAX
    ("sgd", "xla", -1.0, 128),
    ("sgd", "pallas", -1.0, 128),
])
def test_train_step_matches_jax(monkeypatch, optname, impl, hint, dim):
    jax_out, port_out, calls, cfg = _run_both(monkeypatch, optname, impl, hint=hint,
                                              dim=dim)
    _compare(jax_out, port_out, cfg, TOL["float32"])
    pallas = impl == "pallas"
    # the 1-D momentum of the big group takes K4 (ACC_KERNEL_MIN_BYTES is 0)
    assert calls == {"k2": 3 * pallas, "k3": 3 * (pallas and optname == "rwsadagrad"),
                     "k4": 3 * (pallas and optname == "rwsadagrad")}
    # gradients reached the bottom MLP (through the fused interaction at dim 128)
    w0 = port_out[0]["bot"][0][0]
    assert not np.allclose(w0.numpy(), np.asarray(jax_init_dlrm(
        JaxConfig.build(**dict(TWO_GROUPS, ln_bot=(4, 64, dim))), seed=3)["bot"][0][0]))


def test_train_step_bf16_matches_jax(monkeypatch):
    jax_out, port_out, calls, cfg = _run_both(monkeypatch, "rwsadagrad", "pallas",
                                              cdt="bfloat16")
    _compare(jax_out, port_out, cfg, TOL["bfloat16"])
    assert calls == {"k2": 3, "k3": 3, "k4": 3}


@pytest.mark.parametrize("variant", ["bf16 store", "no write-only update", "adagrad"])
def test_train_step_k4_routes_match_jax(monkeypatch, variant):
    """Three steps through K4: a bf16 big store (``emb_dtype``; the small
    group's bf16 store takes K3), an f32 store with ``write_only_update``
    off, and Adagrad on the kernel route (K4 on its per-element
    accumulator, K2 on the store). The 1-D momentum takes K4 too. bf16
    stores are held to one bf16 ulp (torch and XLA sum the f32 updates in
    other orders before the rounding), everything else to TOL."""
    optname = "adagrad" if variant == "adagrad" else "rwsadagrad"
    kw = ({"emb_dtype": "bfloat16"} if variant == "bf16 store"
          else {"write_only_update": False} if variant == "no write-only update" else {})
    jax_out, port_out, calls, cfg = _run_both(monkeypatch, optname, "pallas", **kw)
    bf16 = variant == "bf16 store"
    _compare(jax_out, port_out, cfg, TOL["float32"],
             assert_within_one_bf16_ulp if bf16 else None)
    assert port_out[0]["emb"][1].dtype == (torch.bfloat16 if bf16 else torch.float32)
    if variant == "adagrad":
        assert calls == {"k2": 3, "k3": 0, "k4": 3}
    else:  # the big store and its momentum
        assert calls == {"k2": 0, "k3": 3, "k4": 6}


def test_train_step_stochastic_rounding_matches_jax_within_rounding(monkeypatch):
    """SR on a bf16 big store against JAX's nearest-even (its interpret mode
    skips SR). After one step from the same state every element is within
    one bf16 ulp of JAX's, some differ, and no untouched row changed; after
    three steps the run is held to the JAX bf16 tests' own tolerance
    (stores rtol 0.02 / atol 0.05, the rest TOL['bfloat16'])."""
    jax_out, port_out, calls, cfg = _run_both(
        monkeypatch, "rwsadagrad", "pallas", steps=1, emb_dtype="bfloat16",
        stochastic_rounding=True)
    g = model_groups(cfg)[1]
    got = port_out[0]["emb"][1].float().numpy()
    want = np.asarray(jax_out[0]["emb"][1].astype(jnp.float32)).reshape(g.total_rows, g.dim)
    assert_within_one_bf16_ulp(got, want)
    assert 0 < (got != want).sum() < 0.5 * (got != 0).sum()
    start = np.asarray(jax_init_dlrm(JaxConfig.build(**dict(
        TWO_GROUPS, emb_dtype="bfloat16")), seed=3)["emb"][1].astype(jnp.float32))
    untouched = (want == start.reshape(want.shape)).all(axis=1)
    np.testing.assert_array_equal(got[untouched], want[untouched])
    assert calls == {"k2": 0, "k3": 1, "k4": 2}
    jax_out, port_out, calls, cfg = _run_both(
        monkeypatch, "rwsadagrad", "pallas", emb_dtype="bfloat16", stochastic_rounding=True)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0.02, atol=0.05)

    _compare(jax_out, port_out, cfg, TOL["bfloat16"], close)


@pytest.mark.parametrize("itself", [False, True])
@pytest.mark.parametrize("cdt", [jnp.float32, jnp.bfloat16])
def test_fused_interaction_backward_matches_jax_grad(itself, cdt):
    r = np.random.RandomState(int(itself))
    x = r.randn(64, 128).astype(np.float32)
    ly = r.randn(64, 5, 128).astype(np.float32)
    tdt = torch.float32 if cdt == jnp.float32 else torch.bfloat16
    out_w = r.randn(64, 128 + (21 if itself else 15)).astype(np.float32)

    def jax_loss(x, ly):
        return jnp.sum(jax_fused(x, ly, itself, cdt, 64, True) * out_w)

    gx, gly = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(ly))
    xt = torch.tensor(x, requires_grad=True)
    lt = torch.tensor(ly, requires_grad=True)
    (fused_interaction(xt, lt, itself, tdt) * torch.from_numpy(out_w)).sum().backward()
    assert xt.grad.abs().max() > 0 and lt.grad.abs().max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL["float32"])
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gly), **TOL["float32"])


def test_golden_tiny_losses():
    """tests/test_train.py::test_golden_regression's run, by the port."""
    cfg = DLRMConfig.tiny()
    params = init_dlrm(cfg, seed=123, device="cpu")
    batches = make_random_batches(RandomDataConfig(
        emb_rows=cfg.emb_rows, m_den=cfg.ln_bot[0], mini_batch_size=2, num_batches=3,
        num_indices_per_lookup=2, num_indices_per_lookup_fixed=False,
        round_targets=True, seed=123))
    opt = OptConfig(name="sgd", lr=0.1)
    state = init_opt_state(opt, params, model_groups(cfg))
    step = make_train_step(cfg, opt, device="cpu")
    losses = []
    for it, b in enumerate(batches):
        params, state, loss = step(params, state, b, it)
        losses.append(round(float(loss), 6))
    golden = pathlib.Path(__file__).with_name("golden_tiny.json")
    np.testing.assert_allclose(losses, json.loads(golden.read_text())["losses"], rtol=1e-5)


CLI_TRAIN = [
    "--arch-embedding-size", "40-3000-60-3200", "--arch-sparse-feature-size", "128",
    "--arch-mlp-bot", "4-64-128", "--arch-mlp-top", "64-1",
    "--emb-split-threshold", "100", "--num-batches", "3", "--mini-batch-size", "64",
    "--num-indices-per-lookup", "1", "--loss-function", "bce",
    "--interaction-impl", "pallas", "--optimizer", "rwsadagrad",
    "--learning-rate", "0.05", "--sparse-update-impl", "pallas", "--nepochs", "2",
    "--lr-num-warmup-steps", "2", "--lr-decay-start-step", "3",
    "--lr-num-decay-steps", "2", "--mlperf-logging", "--test-freq", "2",
]


def _losses(text):
    return [float(x) for x in re.findall(r"Finished training it \d+ of epoch \d+, "
                                         r"[\d.]+ ms/it, loss ([\d.]+)", text)]


def test_cli_training_matches_jax_cli(monkeypatch, capsys):
    monkeypatch.setattr(jax_opt, "PALLAS_MIN_STORE_BYTES", 0)
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    want = jax_cli_main(CLI_TRAIN)
    want_losses = _losses(capsys.readouterr().out)
    got = port_cli.main(CLI_TRAIN + ["--device", "cpu"])
    got_losses = _losses(capsys.readouterr().out)
    assert len(got_losses) == len(want_losses) == 6
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-6, key


@pytest.mark.parametrize("extra,tol", [
    (["--no-write-only-update"], 1e-5),
    (["--emb-dtype", "bfloat16"], 1e-5),
    # JAX's interpret mode skips SR: the port's SR losses against its
    # nearest-even ones, at the bf16 tolerance
    (["--emb-dtype", "bfloat16", "--stochastic-rounding"], 2e-2),
])
def test_cli_k4_flags_match_jax_cli(monkeypatch, capsys, extra, tol):
    """The CLI flags whose route is K4, on the big tables of CLI_TRAIN."""
    monkeypatch.setattr(jax_opt, "PALLAS_MIN_STORE_BYTES", 0)
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    want = jax_cli_main(CLI_TRAIN + extra)
    want_losses = _losses(capsys.readouterr().out)
    launched = []
    monkeypatch.setattr(port_opt, "sparse_rows_add",
                        lambda *a, _f=port_opt.sparse_rows_add: launched.append(1) or _f(*a))
    got = port_cli.main(CLI_TRAIN + extra + ["--device", "cpu"])
    got_losses = _losses(capsys.readouterr().out)
    assert len(got_losses) == len(want_losses) == 6
    assert len(launched) == 6  # one per step: the big group's store
    np.testing.assert_allclose(got_losses, want_losses, rtol=tol)
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= max(1e-6, tol), key


def test_cli_training_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        port_cli.main(CLI_TRAIN)


def test_training_after_serving_in_one_process():
    """Static index vectors cached by an eval step (made under inference
    mode) must serve a later train step's autograd."""
    flags = CLI_TRAIN + ["--device", "cpu", "--nepochs", "1"]
    port_cli.main(flags + ["--inference-only"])
    metrics = port_cli.main(flags)
    assert np.isfinite(metrics["roc_auc"])
