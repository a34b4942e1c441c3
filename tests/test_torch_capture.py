"""What a CUDA-graph capture of the port's steps relies on, checked on the CPU
(dlrm_yx_tpu_torch/train/capture.py, data/batch.py, and the lr and seed
that K3 and K4 read from device memory).

A captured step reads its lr and stochastic-rounding seed from device
tensors that the host refills before each replay. These tests hold a step
driven by such tensors to the step driven by a Python float and int, bit
for bit, on the kernels' plain versions (what the CPU runs) and on whole
train steps; and the multi-step body, run eagerly here, to the same steps
one at a time. The card-only cases at the end capture and replay.
"""

import numpy as np
import pytest
import torch

import dlrm_yx_tpu_torch.optim.optimizer as port_opt
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import (
    Batch,
    copy_batch,
    empty_like_batch,
    signature,
    stack_batches,
)
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
from dlrm_yx_tpu_torch.ops.dense_finish import (
    rwsadagrad_dense_finish,
    rwsadagrad_dense_finish_reference,
)
from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add, sr_bits
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.train.capture import GraphStep, launch_counters
from dlrm_yx_tpu_torch.train.train_step import (
    make_eval_step,
    make_multistep_train_step,
    make_train_step,
    train_body,
)

# big tables of 3000 and 3200 rows, small ones of 40 and 60
TWO_GROUPS = dict(emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 16, 128), ln_top=(64, 1),
                  emb_split_threshold=100, loss="bce", sparse_update_impl="pallas")
POLICY = LRPolicy(base_lr=0.05, num_warmup_steps=8)


def _batches(rows, n, b=32, l=1, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        idx = np.stack([r.randint(0, m, (b, l)) for m in rows]).astype(np.int32)
        idx[1, :5, 0] = idx[1, 0, 0]  # a duplicated row of a big table
        w = (r.rand(len(rows), b, l) > 0.3).astype(np.float32) if l > 1 else \
            np.ones((len(rows), b, l), np.float32)
        out.append(Batch(r.rand(b, 4).astype(np.float32), idx, w,
                         (r.rand(b, 1) > 0.5).astype(np.float32)))
    return out


def _state(cfg, opt, device="cpu"):
    params = init_dlrm(cfg, seed=3, device=device)
    state = init_opt_state(opt, params, model_groups(cfg))
    for t in _tensors(state):
        t.fill_(0.01)
    return params, state


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def _assert_bit_equal(a, b):
    ta, tb = list(_tensors(a)), list(_tensors(b))
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x.detach(), y.detach())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_finish_tensor_lr_equals_float_lr(dtype):
    r = np.random.RandomState(1)
    store = torch.from_numpy(r.randn(300, 16).astype(np.float32)).to(dtype)
    acc = torch.from_numpy(r.rand(400).astype(np.float32))
    g = torch.from_numpy(r.randn(300, 16).astype(np.float32))
    g[::3] = 0
    lr = float(np.float32(0.0123))
    want = rwsadagrad_dense_finish(store.clone(), acc.clone(), g, lr, 16, 1e-10)
    got = rwsadagrad_dense_finish(store.clone(), acc.clone(), g, torch.tensor(lr), 16, 1e-10)
    ref = rwsadagrad_dense_finish_reference(store.clone(), acc.clone(), g,
                                            torch.tensor(lr), 16, 1e-10)
    for w, x, y in zip(want, got, ref):
        assert torch.equal(w, x) and torch.equal(w, y)
    with pytest.raises(ValueError, match="0-dim f32"):
        rwsadagrad_dense_finish(store.clone(), acc.clone(), g, torch.tensor([lr]), 16, 1e-10)


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5, 123456789])
def test_sparse_rows_add_tensor_seed_equals_int_seed(seed):
    """K4's plain version with SR on a bf16 store: the seed as a 0-dim
    int64 tensor draws the bits of the int, and rounds the same."""
    r = np.random.RandomState(2)
    items = torch.arange(300)
    assert torch.equal(sr_bits(seed, items, 16), sr_bits(torch.tensor(seed), items, 16))
    store = torch.from_numpy(r.randn(512, 16).astype(np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(r.randint(0, 400, 300).astype(np.int32))
    idx[10:20] = idx[9]
    upd = torch.from_numpy(r.randn(300, 16).astype(np.float32)) * 1e-2
    active = torch.ones(300, dtype=torch.int32)
    want = sparse_rows_add(store.clone(), idx, upd, active, True, seed)
    got = sparse_rows_add(store.clone(), idx, upd, active, True, torch.tensor(seed))
    assert torch.equal(want.view(torch.int16), got.view(torch.int16))
    other = sparse_rows_add(store.clone(), idx, upd, active, True, seed + 1)
    assert not torch.equal(want.view(torch.int16), other.view(torch.int16))


CASES = {  # name -> (config overrides, optimizer, L)
    "rwsadagrad pallas (K2, K3, K4 on the momentum)": ({}, "rwsadagrad", 1),
    "bf16 store with SR (K4, K3)": (dict(emb_dtype="bfloat16", stochastic_rounding=True),
                                   "rwsadagrad", 1),
    "adagrad, no write-only update (K4)": (dict(write_only_update=False), "adagrad", 1),
    "L=12 sgd stream (K5)": (dict(emb_split_threshold=0, sparse_update_impl="stream"),
                             "sgd", 12),
    "L=12 rwsadagrad stream (K5)": (dict(emb_split_threshold=0, sparse_update_impl="stream"),
                                    "rwsadagrad", 12),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_scalars_step_equals_float_step(monkeypatch, case):
    """Three steps of the train body driven by 0-dim lr and seed tensors
    against make_train_step's float lr and int seed, with the kernel
    routes forced on small stores: bit for bit."""
    for name in ("PALLAS_MIN_STORE_BYTES", "ACC_KERNEL_MIN_BYTES"):
        monkeypatch.setattr(port_opt, name, 0)
    kw, optname, l = CASES[case]
    cfg = DLRMConfig.build(**{**TWO_GROUPS, **kw})
    opt = OptConfig(optname, 0.05)
    batches = _batches(cfg.emb_rows, 3, l=l)
    p1, s1 = _state(cfg, opt)
    p2, s2 = _state(cfg, opt)
    step = make_train_step(cfg, opt, POLICY, device="cpu")
    body = train_body(cfg, opt)
    for i, b in enumerate(batches):
        _, _, want = step(p1, s1, b, i)
        got = body(p2, s2, Batch(*map(torch.from_numpy, b)),
                   torch.tensor(POLICY(i), dtype=torch.float32), torch.tensor(i))
        assert torch.equal(want, got)
    _assert_bit_equal(p1, p2)
    _assert_bit_equal(s1, s2)


def test_multistep_body_equals_single_steps():
    """make_multistep_train_step (eager on the CPU: the body the card
    captures) over 2 dispatches of 3 steps, against 6 single steps, with an
    LR schedule that moves inside each dispatch: bit for bit, losses too."""
    cfg = DLRMConfig.build(**TWO_GROUPS)
    opt = OptConfig("rwsadagrad", 0.05)
    batches = _batches(cfg.emb_rows, 6)
    p1, s1 = _state(cfg, opt)
    p2, s2 = _state(cfg, opt)
    single = make_train_step(cfg, opt, POLICY, device="cpu")
    multi = make_multistep_train_step(cfg, opt, 3, POLICY, device="cpu")
    assert multi.graph_step.capture is False
    want = torch.stack([single(p1, s1, b, i)[2] for i, b in enumerate(batches)])
    got = torch.cat([multi(p2, s2, stack_batches(batches[j:j + 3]), j)[2] for j in (0, 3)])
    assert torch.equal(want, got)
    _assert_bit_equal(p1, p2)
    _assert_bit_equal(s1, s2)


def test_eval_step_on_the_cpu_runs_eagerly():
    cfg = DLRMConfig.build(**TWO_GROUPS)
    params = init_dlrm(cfg, seed=3, device="cpu")
    b = _batches(cfg.emb_rows, 1)[0]
    step = make_eval_step(cfg, "cpu")
    assert step.graph_step.capture is False
    preds, loss = step(params, b)
    assert preds.shape == (32, 1) and loss.shape == ()
    again, _ = step(params, b)
    assert torch.equal(preds, again)


def test_capture_needs_a_cuda_device():
    cfg = DLRMConfig.build(**TWO_GROUPS)
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        make_multistep_train_step(cfg, OptConfig("sgd", 0.1), 2, device="cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        GraphStep(lambda *a: None, 1, float, torch.device("cpu"), capture=True)


def test_launch_counters_name_every_kernel_wrapper():
    assert sorted(launch_counters()) == sorted([
        "fused_interaction", "sparse_rows_overwrite", "rwsadagrad_dense_finish",
        "rwsadagrad_dense_finish_many", "sorted_stream_apply", "sorted_stream_add",
        "sparse_rows_add", "coalesce_segments", "coalesce_finish", "cross_net"])
    assert all(isinstance(f.launches, int) for f in launch_counters().values())


def test_batch_stacking_and_static_buffers():
    batches = _batches((40, 3000), 3)
    host = stack_batches(batches)
    assert signature(host) == ((3, 32, 4), (3, 2, 32, 1), (3, 2, 32, 1), (3, 32, 1))
    dev = stack_batches([Batch(*map(torch.from_numpy, b)) for b in batches])
    assert all(torch.equal(torch.from_numpy(h), d) for h, d in zip(host, dev))
    buf = empty_like_batch(host, torch.device("cpu"))
    assert [t.dtype for t in buf] == [torch.float32, torch.int32, torch.float32,
                                      torch.float32]
    copy_batch(buf, host)
    assert all(torch.equal(torch.from_numpy(h), t) for h, t in zip(host, buf))
    copy_batch(buf, dev)
    with pytest.raises(ValueError, match="buffer of"):
        copy_batch(buf, stack_batches(batches[:2]))


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", list(CASES))
def test_cuda_captured_steps_equal_eager_steps(cuda_device, monkeypatch, case):
    """Two dispatches of 3 steps after the warm-up dispatch, replayed from a
    CUDA graph, against 9 eager steps from the same state: bit for bit
    (deterministic algorithms, so index_add_ adds in a fixed order), and
    each replay counts its kernels' launches."""
    for name in ("PALLAS_MIN_STORE_BYTES", "ACC_KERNEL_MIN_BYTES"):
        monkeypatch.setattr(port_opt, name, 0)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    kw, optname, l = CASES[case]
    cfg = DLRMConfig.build(**{**TWO_GROUPS, **kw})
    opt = OptConfig(optname, 0.05)
    batches = _batches(cfg.emb_rows, 9, b=64, l=l)
    torch.use_deterministic_algorithms(True)
    try:
        p1, s1 = _state(cfg, opt, cuda_device)
        p2, s2 = _state(cfg, opt, cuda_device)
        counters = launch_counters()

        def launched(run):
            before = {n: f.launches for n, f in counters.items()}
            out = run()
            return out, {n: f.launches - before[n] for n, f in counters.items()}

        single = make_train_step(cfg, opt, POLICY, cuda_device)
        want, eager_launches = launched(lambda: torch.stack(
            [single(p1, s1, b, i)[2] for i, b in enumerate(batches)]))
        multi = make_multistep_train_step(cfg, opt, 3, POLICY, cuda_device)
        got, replay_launches = launched(lambda: torch.cat(
            [multi(p2, s2, stack_batches(batches[j:j + 3]), j)[2] for j in (0, 3, 6)]))
        assert replay_launches == eager_launches
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(want, got)
    _assert_bit_equal(p1, p2)
    _assert_bit_equal(s1, s2)
