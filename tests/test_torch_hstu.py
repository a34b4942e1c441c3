"""HSTU in the port (``models/hstu.py``, ``ops/hstu_attention.py``, the
sampled softmax and the step of ``train/train_step.py``) against the plain
reference ``plain_hstu`` on the CPU, and the paths that refuse it.

The small model: d 32, H 2, dqk = dv 16, 2 blocks, histories of at most 64
events, 200 items, 4 negatives a position, 192 tokens a batch in query
blocks of 64 (the largest power of two up to 1,024 that divides 192: the
tiled attention's band and triangles at every block), in float32 compute. The file imports no JAX: its card case runs on the chip
with ``python -m pytest --noconftest tests/test_torch_hstu.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import plain_hstu as plain
from dlrm_yx_tpu_torch import cli
from dlrm_yx_tpu_torch.config import HSTUConfig
from dlrm_yx_tpu_torch.data.batch import stack_batches, to_device
from dlrm_yx_tpu_torch.data.synthetic import history_times, make_sequence_batches, seq_batch
from dlrm_yx_tpu_torch.export import export_inference
from dlrm_yx_tpu_torch.models.dlrm import dense_leaves, nest_dense
from dlrm_yx_tpu_torch.models.hstu import hstu_embeddings, hstu_outputs, init_hstu, step_context
from dlrm_yx_tpu_torch.ops.hstu_attention import (
    hstu_attention,
    jagged_context,
    time_buckets,
    token_positions,
)
from dlrm_yx_tpu_torch.ops.quantized import make_fully_quantized_eval_step, make_quantized_eval_step
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_adamw_state, store_state
from dlrm_yx_tpu_torch.parallel.col_sharded import ColShardedRunner
from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner
from dlrm_yx_tpu_torch.parallel.row_sharded import RowShardedRunner
from dlrm_yx_tpu_torch.train import capture
from dlrm_yx_tpu_torch.train.trainer import HstuRunner, Trainer, TrainerConfig
from dlrm_yx_tpu_torch.train import train_step
from dlrm_yx_tpu_torch.train.train_step import HSTU_ADAMW as ADAM
from dlrm_yx_tpu_torch.train.train_step import hstu_train_body, sampled_softmax
from dlrm_yx_tpu_torch.utils.profiling import counter_deltas, counters

SMALL = HSTUConfig(num_items=200, embedding_dim=32, num_heads=2, attention_dim=16,
                   linear_dim=16, num_blocks=2, max_seq_len=64, num_negatives=4,
                   tokens_per_batch=192, max_sequences=24, compute_dtype="float32")
OPT = OptConfig(name="rwsadagrad", lr=0.005)


@pytest.fixture(autouse=True)
def small_softmax_chunks(monkeypatch):
    """Chunks of 50 positions, so the sampled softmax crosses chunk edges."""
    monkeypatch.setattr(train_step, "SOFTMAX_CHUNK", 50)
# histories of 1 and of the longest length, across block boundaries
LENGTHS = (1, 64, 30, 1, 33, 63)


def _batch(lengths=LENGTHS, seed=0, cfg=SMALL):
    r = np.random.RandomState(seed)
    t = sum(lengths)
    gaps = np.exp(r.normal(np.log(60.0), 2.0, t)).astype(np.int64)
    times = history_times(gaps, np.asarray(lengths))
    return seq_batch(r.randint(0, cfg.num_items, t), times, np.asarray(lengths),
                     r.randint(0, cfg.num_items, (t, cfg.num_negatives)), cfg.max_sequences)


def _params(seed=0, cfg=SMALL):
    """The port's params with the table's items only (no spare row), as
    the plain reference takes them."""
    p = init_hstu(cfg, seed=seed, device="cpu")
    p["items"] = p["items"][:cfg.num_items].clone()
    # nonzero output biases, so their gradients are checked against something
    for blk in p["hstu_blocks"]:
        blk[2].normal_(0.0, 0.02, generator=torch.Generator().manual_seed(seed))
    return p


def _port_grads(params, cfg, b):
    """(loss, the gradients of ``plain.leaves``' order) from the port's
    forward (autograd through the blocks) and its hand-written sampled
    softmax, the table's row gradients added into a dense one."""
    d, t = cfg.embedding_dim, cfg.tokens_per_batch
    db = to_device(b, torch.device("cpu"))
    ids = db.ids.long()
    rows_in = params["items"][ids].clone().requires_grad_()
    leaves = [p.detach().requires_grad_() for p in dense_leaves(params)]
    u = hstu_embeddings({**params, **nest_dense(params, leaves)}, cfg, rows_in,
                        token_positions(db.offsets, t), step_context(cfg, db.offsets, db.times))
    rg = torch.empty((t, cfg.num_negatives + 1, d))
    loss, g_u = sampled_softmax(cfg, params["items"], u.detach(), db, rg)
    g = torch.autograd.grad(u, leaves + [rows_in], g_u)
    table = torch.zeros_like(params["items"]).index_add_(0, ids, g[-1])
    cand = torch.cat([db.positives.long()[:, None], db.negatives.long()], 1).reshape(-1)
    table.index_add_(0, cand, rg.reshape(-1, d))
    return loss, list(g[:-1]) + [table]


def test_loss_and_every_gradient_match_the_plain_reference():
    params, b = _params(), _batch()
    loss, grads = _port_grads(params, SMALL, b)
    want_loss = plain.loss_of(params, SMALL, b)
    # f32 on both sides, the sums in another order (blocks, chunks): a few ulps
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    ref = [p.detach().requires_grad_() for p in plain.leaves(params)]
    p2 = {"items": ref[-1], "hstu_pos": [ref[0]],
          "hstu_blocks": [tuple(ref[1 + 5 * i: 6 + 5 * i]) for i in range(SMALL.num_blocks)]}
    want = torch.autograd.grad(plain.loss_of(p2, SMALL, b), ref)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        # f32 gradients through two blocks of sums in another order: the
        # worst element within 1e-5 of the leaf's largest
        scale = float(w.abs().max())
        assert scale > 0
        assert float((got - w).abs().max()) <= 1e-5 * scale


def test_steps_under_adamw_and_rowwise_adagrad_match_the_plain_reference():
    cfg = SMALL
    batches = [_batch(seed=s) for s in range(3)]
    params = _params(seed=1)
    want_losses, _, want = plain.train(params, cfg, batches, OPT.lr, OPT.eps, ADAM.lr,
                                       ADAM.betas, ADAM.eps)
    got_params = {"items": params["items"].clone(), "hstu_pos": [params["hstu_pos"][0].clone()],
                  "hstu_blocks": [tuple(t.clone() for t in blk) for blk in params["hstu_blocks"]]}
    runner = HstuRunner(cfg, OPT, device="cpu")
    with torch.no_grad():
        for dst, src in zip(plain.leaves(runner.params), plain.leaves(got_params)):
            dst[:src.shape[0]].copy_(src)
    step = runner.make_multi_step(1)
    losses = []
    for i, b in enumerate(batches):
        _, _, loss = step(runner.params, runner.opt_state, stack_batches([b]), i)
        losses.append(float(loss[0]))
    # f32 sums in another order, then three steps whose AdamW updates move
    # every entry by about the lr: changes within 1e-4 of the largest
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert torch.all(runner.params["items"][cfg.num_items:] == 0)  # the spare rows
    for got, w, p0 in zip(plain.leaves(runner.params), plain.leaves(want),
                          plain.leaves(got_params)):
        got = got[:w.shape[0]]
        change = w - p0
        assert float(change.abs().max()) > 0
        assert float(((got - p0) - change).abs().max()) <= 1e-4 * float(change.abs().max())


@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("lengths", [LENGTHS, (64, 64, 64), (1,) * 64 + (64, 64)],
                         ids=["mixed", "longest", "ones"])
def test_tiled_attention_matches_the_whole_history_at_block_edges(block, lengths):
    cfg = dataclasses.replace(SMALL, max_sequences=80)
    b = _batch(lengths, cfg=cfg)
    t = cfg.tokens_per_batch
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn((t, 2, 16), generator=g, requires_grad=True) for _ in range(2))
    v = torch.randn((t, 2, 16), generator=g, requires_grad=True)
    pos_w = torch.randn(2 * 64 - 1, generator=g).mul_(0.3).requires_grad_()
    time_w = torch.randn(129, generator=g).mul_(0.3).requires_grad_()
    off, times = torch.as_tensor(b.offsets), torch.as_tensor(b.times)
    ctx = jagged_context(off, times, 64, 128, block)
    got = hstu_attention(q, k, v, pos_w, time_w, ctx)
    want = plain.attention(q.reshape(t, -1), k.reshape(t, -1), v, pos_w, time_w, times,
                           plain.histories(b), cfg).reshape(t, 2, 16)
    # f32, one product a block against one a history: a few ulps of the output
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    cot = torch.randn(got.shape, generator=g)
    gg = torch.autograd.grad(got, (q, k, v, pos_w, time_w), cot)
    gw = torch.autograd.grad(want, (q, k, v, pos_w, time_w), cot)
    for a, w in zip(gg, gw):
        # the bias tables' gradients sum every score: within 1e-5 of the largest
        assert float((a - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-6)


def test_an_event_moves_no_output_before_it():
    params, b = _params(), _batch()
    j, end = 80, 95  # an event of the third history, [65, 95)
    moved = b._replace(ids=b.ids.copy(), times=b.times.copy())
    moved.ids[j] = (moved.ids[j] + 7) % SMALL.num_items
    moved.times[j:end] += 5000  # its time and its history's later ones

    def outs(x):
        return hstu_outputs(params, SMALL, *(torch.as_tensor(a) for a in (x.ids, x.offsets,
                                                                          x.times)))

    before, after = outs(b), outs(moved)
    assert torch.equal(before[:j], after[:j])
    assert torch.equal(before[end:], after[end:])  # the later histories
    assert not torch.equal(before[j], after[j])


def test_a_history_whose_time_falls_is_refused():
    times = np.array([0, 5, 3, 0, 1])
    with pytest.raises(ValueError, match="timestamps"):
        seq_batch(np.arange(5), times, np.array([3, 2]), np.zeros((5, 4), np.int64), 24)
    seq_batch(np.arange(5), np.array([0, 5, 9, 0, 1]), np.array([3, 2]),
              np.zeros((5, 4), np.int64), 24)


@pytest.mark.parametrize("tokens, block", [(32768, 1024), (192, 64), (1000, 8), (3, 1)])
def test_the_attention_block_is_the_widest_that_divides_the_tokens(tokens, block):
    assert dataclasses.replace(SMALL, tokens_per_batch=tokens).attn_block == block


def test_time_buckets_at_small_and_large_gaps():
    dt = torch.tensor([0, 1, -1, 2, 3, 10, 3600, 10**9, 2**62], dtype=torch.int64)
    want = [0, 0, 0, 2, 3, 7, 27, 68, 128]
    assert time_buckets(dt, 128).tolist() == want
    assert plain.bucket(dt, 128).tolist() == want


def test_a_negative_equal_to_its_positive_is_masked():
    params, b = _params(), _batch()
    neg = b.negatives.copy()
    sup = np.nonzero(b.weights)[0][:5]
    neg[sup, 1] = b.positives[sup]
    masked = b._replace(negatives=neg)
    db = to_device(masked, torch.device("cpu"))
    u = hstu_outputs(params, SMALL, db.ids, db.offsets, db.times).detach()
    rg = torch.empty((SMALL.tokens_per_batch, SMALL.num_negatives + 1, SMALL.embedding_dim))
    loss, _ = sampled_softmax(SMALL, params["items"], u, db, rg)
    assert float(loss) == pytest.approx(float(plain.loss_of(params, SMALL, masked)), rel=1e-6)
    assert torch.all(rg[torch.as_tensor(sup), 2] == 0)  # column 0 is the positive
    assert torch.all(rg[torch.as_tensor(sup), 1] != 0)


def test_trainer_fit_counts_the_steps_scores_and_negatives():
    batches = make_sequence_batches(SMALL, 4, seed=5)
    trainer = Trainer(SMALL, OPT, TrainerConfig(print_freq=2), device="cpu")
    before = counters()
    trainer.fit(batches)
    c = counter_deltas(before, counters())
    assert trainer.msteps == 2 and trainer.iteration == 4
    assert c["hstu.tokens"] == 4 * SMALL.tokens_per_batch
    lengths = [np.diff(b.offsets) for b in batches]
    live = sum(int((l * (l + 1) // 2).sum()) for l in lengths) * 2 * 2
    assert c["hstu.live_scores"] == live
    assert c["hstu.live_scores"] + c["hstu.pad_scores"] == 4 * 2 * 2 * 192 * 128
    assert c["hstu.sequences"] == sum(int((l > 0).sum()) for l in lengths)
    assert c["sampled_softmax.negatives"] == 4 * sum(int(b.weights.sum()) for b in batches)
    assert c["sparse_update.overwrite"] == 4


def test_the_cli_trains_it_and_refuses_what_it_has_not(capsys):
    flags = ["--device", "cpu", "--model", "hstu", "--hstu-num-items", "200",
             "--hstu-embedding-dim", "32", "--hstu-num-heads", "2", "--hstu-attention-dim", "16",
             "--hstu-linear-dim", "16", "--hstu-num-blocks", "2", "--hstu-max-seq-len", "64",
             "--hstu-num-negatives", "4", "--hstu-tokens-per-batch", "192",
             "--hstu-max-sequences", "24",
             "--optimizer", "rwsadagrad", "--learning-rate", "0.005",
             "--num-batches", "4", "--print-freq", "2"]
    assert cli.main(flags) == {"iterations": 4}
    assert "Finished training it 4" in capsys.readouterr().out
    for extra in (["--inference-only"], ["--save-onnx"], ["--debug-mode"],
                  ["--mlperf-grad-accum-iter", "2"], ["--data-generation", "random-device"],
                  ["--save-model", "x"]):
        with pytest.raises(NotImplementedError, match="HSTU"):
            cli.main(flags + extra)
    with pytest.raises(NotImplementedError, match="HSTU"):
        cli.main(flags + ["--mesh-model", "2"])


def test_export_quantized_serving_and_the_mesh_runners_refuse_it(tmp_path):
    params = init_hstu(SMALL, seed=0, device="cpu")
    for make in (lambda: export_inference(params, SMALL, None, str(tmp_path / "m.pt2")),
                 lambda: make_fully_quantized_eval_step(SMALL, [], [], device="cpu"),
                 lambda: make_quantized_eval_step(SMALL, [], [], device="cpu"),
                 lambda: HybridRunner(SMALL, OPT, device="cpu"),
                 lambda: RowShardedRunner(SMALL, OPT, device="cpu"),
                 lambda: ColShardedRunner(SMALL, OPT, device="cpu"),
                 lambda: HstuRunner(SMALL, OPT, device="cpu").eval_step(None, None),
                 lambda: HstuRunner(SMALL, OPT, device="cpu").save_checkpoint(
                     str(tmp_path / "ck"), params, {})):
        with pytest.raises(NotImplementedError, match="HSTU"):
            make()
    assert not (tmp_path / "m.pt2").exists()


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_the_step_needs_rowwise_adagrad(name):
    with pytest.raises(ValueError, match="row-wise Adagrad"):
        hstu_train_body(SMALL, OptConfig(name=name, lr=0.005))


def test_the_captured_step_matches_the_eager_step():
    """Four steps of the bf16 model, eager and as graph replays: the first
    loss (a forward with no atomics) bit for bit, the later losses and the
    state within bf16's reach (the backward's atomic adds, the positions'
    and the time bias's, add in no fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")

    cfg = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    batches = make_sequence_batches(cfg, 4, seed=7)
    dev = torch.device("cuda")
    runs = []
    for cap in (False, True):
        params = init_hstu(cfg, seed=0, device=dev)
        state = {"items": store_state(OPT, params["items"]), **init_adamw_state(params)}
        step = capture.one_step(hstu_train_body(cfg, OPT), lambda i: OPT.lr, dev, capture=cap)
        losses = [step(params, state, b, i)[2] for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        runs.append((torch.stack(losses).cpu(), [p.cpu() for p in plain.leaves(params)]))
    if runs[1][0].shape[0] == 4:
        # warm-up, then capture + replay, then two replays
        assert step.graph_step.replays() == 3
    assert torch.equal(runs[0][0][0], runs[1][0][0])
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-3, atol=0)
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-4)
