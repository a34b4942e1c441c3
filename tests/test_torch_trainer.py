"""The port's Trainer with multi-step dispatch, the prefetch thread and
gradient accumulation (dlrm_yx_tpu_torch/train/trainer.py, train_step.py)
against the JAX package's on the CPU, where the port runs the same step
bodies eagerly that it captures in CUDA graphs on the card.

Both packages draw the same params (``init_dlrm`` from one seed) and the
same numpy batches (their ``make_random_batches``, one draw sequence).
Multi-step dispatch must give the port's own single-step loop bit for bit;
against JAX everything is held at rtol 1e-5 / atol 1e-6.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_yx_tpu.optim.optimizer as jax_opt
import dlrm_yx_tpu_torch.optim.optimizer as port_opt
from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.batch import Batch as JaxBatch
from dlrm_yx_tpu.data.synthetic import RandomDataConfig as JaxDataConfig
from dlrm_yx_tpu.data.synthetic import make_random_batches as jax_batches
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.optim.lr_policy import LRPolicy as JaxLRPolicy
from dlrm_yx_tpu.train.train_step import make_accum_train_step as jax_accum_step
from dlrm_yx_tpu.train.trainer import Trainer as JaxTrainer
from dlrm_yx_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import opt_state_from_jax, params_from_jax
from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
from dlrm_yx_tpu_torch.models.dlrm import model_groups
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
from dlrm_yx_tpu_torch.train.train_step import make_accum_train_step
from dlrm_yx_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    _auto_steps_per_dispatch,
    _group_microbatches,
    _prefetch_thread,
)
from torch_hybrid_cases import MESH_FLAGS

TOL = dict(rtol=1e-5, atol=1e-6)
POLICY = dict(base_lr=0.2, num_warmup_steps=3, decay_start_step=5, num_decay_steps=4)


def _data(cfg, n, seed=4, b=4):
    kw = dict(emb_rows=cfg.emb_rows, m_den=cfg.ln_bot[0], mini_batch_size=b, num_batches=n,
              num_indices_per_lookup=2, num_indices_per_lookup_fixed=False,
              round_targets=True, seed=seed)
    return make_random_batches(RandomDataConfig(**kw)), jax_batches(JaxDataConfig(**kw))


def _port_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _port_tensors(t)


def _assert_bit_equal(a, b):
    ta, tb = list(_port_tensors(a)), list(_port_tensors(b))
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert torch.equal(x.detach(), y.detach())


def _assert_matches_jax(jparams, jstate, pparams, pstate, cfg):
    for name in ("bot", "top"):
        for (jw, jb), (pw, pb) in zip(jparams[name], pparams[name]):
            np.testing.assert_allclose(pw.detach().numpy(), np.asarray(jw), **TOL)
            np.testing.assert_allclose(pb.detach().numpy(), np.asarray(jb), **TOL)
    for js, ps, g in zip(jparams["emb"], pparams["emb"], model_groups(cfg)):
        want = np.asarray(js.astype(jnp.float32)).reshape(g.total_rows, g.dim)
        np.testing.assert_allclose(ps.float().numpy(), want, **TOL)
    if pstate:
        for name in ("bot", "top"):
            for (jw, jb), (pw, pb) in zip(jstate["dense"][name], pstate["dense"][name]):
                np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **TOL)
                np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **TOL)
        for ja, pa in zip(jstate["emb"], pstate["emb"]):
            np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **TOL)


def _port_trainer(cfg, optname, m, depth, accum=1, batches=None, print_freq=4):
    tcfg = TrainerConfig(print_freq=print_freq, seed=3, steps_per_dispatch=m,
                         prefetch_depth=depth, grad_accum_iter=accum)
    tr = Trainer(cfg, OptConfig(optname, lr=0.2), tcfg, lr_policy=LRPolicy(**POLICY),
                 device="cpu")
    tr.fit(batches)
    return tr


def _jax_trainer(optname, m, depth, accum=1, batches=None, print_freq=4):
    tcfg = JaxTrainerConfig(print_freq=print_freq, seed=3, steps_per_dispatch=m,
                            prefetch_depth=depth, grad_accum_iter=accum)
    tr = JaxTrainer(JaxConfig.tiny(), jax_opt.OptConfig(optname, lr=0.2), tcfg,
                    lr_policy=JaxLRPolicy(**POLICY))
    tr.fit(batches)
    return tr


@pytest.fixture(scope="module")
def multistep_runs():
    """The port at steps_per_dispatch 4 / prefetch 2 and 1 / 0, and JAX at
    4 / 2, over 11 batches: 2 groups of 4 and a tail of 3 single steps,
    with an LR schedule that varies inside the dispatches."""
    cfg = DLRMConfig.tiny()
    port_b, jax_b = _data(cfg, 11)
    return (cfg, _port_trainer(cfg, "rwsadagrad", 4, 2, batches=port_b),
            _port_trainer(cfg, "rwsadagrad", 1, 0, batches=port_b),
            _jax_trainer("rwsadagrad", 4, 2, batches=jax_b))


def test_multistep_trainer_bit_equal_to_single_steps(multistep_runs):
    _, multi, single, _ = multistep_runs
    assert multi.msteps == 4 and multi.multi_step is not None
    assert single.msteps == 1 and single.multi_step is None
    assert multi.iteration == single.iteration == 11
    _assert_bit_equal(multi.params, single.params)
    _assert_bit_equal(multi.opt_state, single.opt_state)


def test_multistep_trainer_matches_jax(multistep_runs):
    cfg, multi, _, jax_tr = multistep_runs
    assert jax_tr.msteps == 4 and jax_tr.iteration == multi.iteration == 11
    _assert_matches_jax(jax_tr.params, jax_tr.opt_state, multi.params, multi.opt_state, cfg)


def _accum_case(optname):
    """The two-group model of tests/test_torch_training.py, with the kernel
    routes forced: the big group's store takes the row read-modify-write
    kernel (no write-only update under accumulation), RWSAdagrad's small
    group the dense finish."""
    kw = dict(emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 16, 128), ln_top=(64, 1),
              emb_split_threshold=100, loss="bce", sparse_update_impl="pallas")
    r = np.random.RandomState(2)
    stacks = []
    for _ in range(3):  # three accumulated steps of two micro-batches of 32
        idx = np.stack([r.randint(0, m, (2, 32, 1)) for m in kw["emb_rows"]], 1)
        idx[:, 1, :5, 0] = idx[0, 1, 0, 0]  # one row in both micro-batches
        stacks.append(JaxBatch(r.rand(2, 32, 4).astype(np.float32), idx.astype(np.int32),
                               np.ones((2, 4, 32, 1), np.float32),
                               (r.rand(2, 32, 1) > 0.5).astype(np.float32)))
    return JaxConfig.build(**kw), DLRMConfig.build(**kw), stacks


@pytest.mark.parametrize("optname", ["sgd", "rwsadagrad"])
def test_accum_step_matches_jax(monkeypatch, optname):
    for mod in (jax_opt, port_opt):
        monkeypatch.setattr(mod, "PALLAS_MIN_STORE_BYTES", 0)
    jcfg, pcfg, stacks = _accum_case(optname)
    jp = jax_init_dlrm(jcfg, seed=3)
    js = jax.tree.map(lambda a: a + 0.01, jax_opt.init_opt_state(
        jax_opt.OptConfig(optname, 0.05), jp, jax_model_groups(jcfg)))
    opt = OptConfig(optname, 0.05)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    ps = opt_state_from_jax(jax.tree.map(np.asarray, js), opt, pcfg, "cpu")
    pol = dict(base_lr=0.05, num_warmup_steps=4)
    jstep = jax_accum_step(jcfg, jax_opt.OptConfig(optname, 0.05), 2, JaxLRPolicy(**pol))
    pstep = make_accum_train_step(pcfg, opt, 2, LRPolicy(**pol), device="cpu")
    assert pstep.graph_step.capture is False  # eager on the CPU
    calls = []
    for name in ("rwsadagrad_dense_finish_many", "sparse_rows_add", "sparse_rows_overwrite"):
        monkeypatch.setattr(port_opt, name, lambda *a, _f=getattr(port_opt, name), _n=name:
                            calls.append(_n) or _f(*a))
    jl, pl = [], []
    for i, batch in enumerate(stacks):
        jp, js, loss = jstep(jp, js, JaxBatch(*map(jnp.asarray, batch)), i)
        jl.append(float(loss))
        pp, ps, loss = pstep(pp, ps, batch, i)
        assert loss.shape == ()
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, **TOL)
    _assert_matches_jax(jp, js, pp, ps, pcfg)
    rws = optname == "rwsadagrad"
    # K3: one grouped finish a step
    assert sorted(calls) == ["rwsadagrad_dense_finish_many"] * 3 * rws + ["sparse_rows_add"] * 3


@pytest.mark.parametrize("optname", ["sgd", "rwsadagrad"])
def test_accum_trainer_matches_jax(optname):
    """grad_accum_iter 2 over 7 batches (3 steps, the last batch dropped),
    with the LR schedule: multi-step is off, as in JAX."""
    cfg = DLRMConfig.tiny()
    port_b, jax_b = _data(cfg, 7, seed=6)
    got = _port_trainer(cfg, optname, 0, 2, accum=2, batches=port_b, print_freq=1)
    want = _jax_trainer(optname, 0, 2, accum=2, batches=jax_b, print_freq=1)
    assert got.msteps == want.msteps == 1 and got.multi_step is None
    assert got.iteration == want.iteration == 3
    _assert_matches_jax(want.params, want.opt_state, got.params, got.opt_state, cfg)


def test_auto_steps_per_dispatch_policy(capsys):
    """The cases of tests/test_trainer.py's policy test, and the warning."""
    assert _auto_steps_per_dispatch(TrainerConfig(print_freq=64, test_freq=0)) == 16
    assert _auto_steps_per_dispatch(TrainerConfig(print_freq=64, test_freq=128)) == 16
    assert _auto_steps_per_dispatch(TrainerConfig(print_freq=4, test_freq=0)) == 4
    assert _auto_steps_per_dispatch(TrainerConfig(print_freq=3, test_freq=0)) == 1
    assert _auto_steps_per_dispatch(TrainerConfig(print_freq=64, test_freq=24)) == 8
    capsys.readouterr()
    assert _auto_steps_per_dispatch(TrainerConfig(print_freq=3, steps_per_dispatch=7)) == 7
    assert "does not divide print_freq 3" in capsys.readouterr().out


def test_prefetch_thread_exits_on_early_stop():
    """An early stop breaks out of the batch stream with the staging queue
    full: the producer thread must end, not block on its last put."""
    cfg = DLRMConfig.tiny()
    tcfg = TrainerConfig(print_freq=0, seed=3, test_freq=2, prefetch_depth=2,
                         steps_per_dispatch=1, mlperf_acc_threshold=1e-9)
    tr = Trainer(cfg, OptConfig("sgd", lr=0.1), tcfg, device="cpu")
    before = {t.ident for t in threading.enumerate()}
    batches, _ = _data(cfg, 40)
    tr.fit(batches, test_batches=lambda: iter(batches[:2]))
    assert tr.iteration < 40  # the early stop fired mid-stream
    deadline = time.time() + 10.0
    while time.time() < deadline:
        leftover = [t for t in threading.enumerate()
                    if t.ident not in before and t.daemon and t.is_alive()]
        if not leftover:
            break
        time.sleep(0.2)
    assert not leftover, f"prefetch worker still alive: {leftover}"


def test_prefetch_thread_raises_the_producers_error():
    def gen():
        yield 1
        raise KeyError("producer")

    got = []
    with pytest.raises(KeyError, match="producer"):
        for x in _prefetch_thread(gen(), 2):
            got.append(x)
    assert got == [1]


@pytest.mark.parametrize("device", [torch.device("cuda", 3), torch.device("cpu"), None])
def test_prefetch_thread_stages_on_the_trainers_card(monkeypatch, device):
    """The worker makes the trainer's card its current device before it
    stages anything (a new thread starts on card 0); the card itself is
    monkeypatched, so none is needed."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda dev: calls.append((dev, threading.current_thread().name)))

    def gen():
        calls.append(("batch", threading.current_thread().name))
        yield 1

    assert list(_prefetch_thread(gen(), 2, device)) == [1]
    worker = calls[-1][1]
    assert worker != threading.current_thread().name
    want = [(device, worker)] if device is not None and device.type == "cuda" else []
    assert calls == want + [("batch", worker)]


def test_group_microbatches_stacks_and_drops_the_tail():
    cfg = DLRMConfig.tiny()
    batches, _ = _data(cfg, 5)
    groups = list(_group_microbatches(iter(batches), 2))
    assert len(groups) == 2
    np.testing.assert_array_equal(groups[1].indices[0], batches[2].indices)
    assert groups[0].dense.shape == (2,) + batches[0].dense.shape


CLI = [
    "--arch-embedding-size", "40-3000", "--arch-sparse-feature-size", "16",
    "--arch-mlp-bot", "4-16", "--arch-mlp-top", "8-1", "--mini-batch-size", "32",
    "--num-batches", "9", "--num-indices-per-lookup", "2", "--optimizer", "rwsadagrad",
    "--sparse-update-impl", "pallas", "--emb-split-threshold", "100",
    "--loss-function", "bce", "--learning-rate", "0.05", "--print-freq", "4",
    "--lr-num-warmup-steps", "3", "--mlperf-logging",
]


@pytest.mark.parametrize("extra", [["--steps-per-dispatch", "4", "--prefetch-depth", "2"],
                                   ["--mlperf-grad-accum-iter", "2"]])
def test_cli_dispatch_flags_match_jax_cli(capsys, extra):
    want = jax_cli_main(CLI + extra)
    want_out = capsys.readouterr().out
    got = port_cli.main(CLI + extra + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-5, key
    for out in (want_out, got_out):
        assert out.count("Finished training it") == (1 if "--mlperf-grad-accum-iter" in extra
                                                     else 2)


def test_cli_dispatch_flags_keep_the_jax_defaults():
    from dlrm_yx_tpu.cli import build_parser as jax_build_parser

    jax_args = jax_build_parser().parse_args([])
    port_args = port_cli.build_parser().parse_args([])
    for dest in ("steps_per_dispatch", "prefetch_depth", "mlperf_grad_accum_iter"):
        assert getattr(port_args, dest) == getattr(jax_args, dest), dest
        assert dest.replace("_", "-") not in MESH_FLAGS
    assert (port_args.steps_per_dispatch, port_args.prefetch_depth,
            port_args.mlperf_grad_accum_iter) == (0, 2, 1)
