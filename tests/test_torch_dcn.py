"""DLRM-DCNv2 in the port (the ``dcn`` interaction, fixed multi-hot bags,
exact row-wise Adagrad) against the plain reference ``plain_dlrm_dcn`` on
the CPU, and the paths that refuse it.

The small model: five tables of hotness [3, 1, 12, 2, 100] (repeated ids
in a bag), D = 16, two cross layers of rank 8, B = 64, in float32 compute.
Two of the tables are big (a group store on the kernel route, forced onto
it by lowering ``PALLAS_MIN_STORE_BYTES`` and ``ACC_KERNEL_MIN_BYTES``:
coalesce first, then K2's write-only update and K4 on the row momentum,
each in its plain CPU version), three small (the dense branch and K3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import dlrm_yx_tpu_torch.optim.optimizer as port_opt
import plain_dlrm_dcn as plain
from dlrm_yx_tpu_torch import cli
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.export import export_inference
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, lookup_all_groups, model_groups
from dlrm_yx_tpu_torch.ops import dcn
from dlrm_yx_tpu_torch.ops.dcn import cross_net, cross_net_autograd
from dlrm_yx_tpu_torch.ops.quantized import make_fully_quantized_eval_step, make_quantized_eval_step
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.parallel.col_sharded import ColShardedRunner
from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner
from dlrm_yx_tpu_torch.parallel.row_sharded import RowShardedRunner
from dlrm_yx_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dlrm_yx_tpu_torch.train.train_step import make_train_step
from dlrm_yx_tpu_torch.utils.profiling import counter_deltas, counters

ROWS = (40, 30000, 60, 32000, 50)
HOT = (3, 1, 12, 2, 100)
B = 64
SMALL = DLRMConfig.build(emb_rows=ROWS, ln_bot=(13, 32, 16), ln_top=(32, 16, 1),
                         interaction="dcn", dcn_num_layers=2, dcn_low_rank_dim=8,
                         multi_hot_sizes=HOT, emb_split_threshold=100, loss="bce",
                         sparse_update_impl="pallas", exact_row_momentum=True)
OPT = OptConfig(name="rwsadagrad", lr=0.05)


def _batches(n=3, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = np.concatenate([r.randint(0, m, (h, B)) for m, h in zip(ROWS, HOT)])
        ids[3:15, :4] = 7  # table 2: one id repeated through a bag
        out.append(Batch(r.rand(B, 13).astype(np.float32), ids.astype(np.int32)[:, :, None],
                         np.ones((sum(HOT), 1, 1), np.float32),
                         (r.rand(B, 1) < 0.3).astype(np.float32)))
    return out


def _bags(batch):
    """The batch as the reference takes it: per table its [B, h] ids."""
    ids = torch.as_tensor(batch.indices)[:, :, 0].long()
    return [s.T.contiguous() for s in torch.split(ids, HOT, dim=0)]


def _plain_params(params, cfg=SMALL):
    """The port's params as the reference's: each table cut from its store."""
    tables = {}
    for g, store in zip(model_groups(cfg), params["emb"]):
        for t, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            tables[t] = store[off:off + n].detach().clone()
    clone = lambda tree: [tuple(p.detach().clone() for p in layer) for layer in tree]  # noqa: E731
    return {"bot": clone(params["bot"]), "top": clone(params["top"]),
            "dcn": clone(params["dcn"]), "tables": [tables[t] for t in range(len(ROWS))]}


def test_cross_network_forward_and_gradients_match_the_reference():
    """f32 on both sides: the same products in another association (the
    port's matmuls are the reference's), so rtol 1e-5, a few ulps of the
    terms summed; atol 1e-6 for entries that cancel near zero."""
    plain.exact_f32()
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(32, 48, generator=g)
    layers = [(torch.randn(48, 8, generator=g) * 0.2, torch.randn(8, 48, generator=g) * 0.2,
               torch.randn(48, generator=g) * 0.1) for _ in range(3)]
    leaves = [x0] + [p for layer in layers for p in layer]
    outs = []
    for fn in (lambda x, ls: cross_net(x, ls, torch.float32), plain.cross):
        ps = [p.clone().requires_grad_() for p in leaves]
        y = fn(ps[0], [tuple(ps[1 + 3 * i: 4 + 3 * i]) for i in range(3)])
        outs.append([y.detach()] + list(torch.autograd.grad((y * y.detach().cos()).sum(), ps)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _cross_leaves(layers, width, rank=8, batch=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn(batch, width, generator=g)
    return [x0] + [p for _ in range(layers) for p in (
        torch.randn(width, rank, generator=g) * 0.2, torch.randn(rank, width, generator=g) * 0.2,
        torch.randn(width, generator=g) * 0.1)]


def _cross_outputs(fn, leaves, compute_dtype):
    ps = [p.clone().requires_grad_() for p in leaves]
    n = (len(ps) - 1) // 3
    y = fn(ps[0], [tuple(ps[1 + 3 * i: 4 + 3 * i]) for i in range(n)], compute_dtype)
    return [y.detach()] + list(torch.autograd.grad((y * y.detach().cos()).sum(), ps))


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("width", [48, 44])
def test_the_bf16_function_matches_autograd_through_the_formula(layers, width):
    """bf16 compute on the CPU: ``_CrossNet`` (K8's plain version between
    the products) against autograd through the formula. The same products
    of the same operands, the same roundings: the output bit for bit, and
    V's and W's gradients too; x0's gradient (its terms summed in another
    order) and b's (summed by bands) to f32's rtol, 1.3e-6, with f32's atol
    1e-5 for entries that cancel. The plain version takes any width (44 is
    no multiple of 8)."""
    leaves = _cross_leaves(layers, width)
    got = _cross_outputs(cross_net, leaves, torch.bfloat16)
    want = _cross_outputs(cross_net_autograd, leaves, torch.bfloat16)
    assert torch.equal(got[0], want[0])
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        if i % 3 in (1, 2):  # a layer's V and W
            assert torch.equal(a, b), i
        torch.testing.assert_close(a, b, rtol=1.3e-6, atol=1e-5)


def test_the_routes_count_and_f32_keeps_autograd():
    """A bf16 call on the CPU counts ``dcn.plain`` once and launches
    nothing; an f32 call takes the formula in autograd and counts neither
    route."""
    leaves = _cross_leaves(2, 48)
    layers = [tuple(leaves[1 + 3 * i: 4 + 3 * i]) for i in range(2)]
    launches = cross_net.launches
    before = counters()
    cross_net(leaves[0], layers, torch.bfloat16)
    assert counter_deltas(before, counters()).get("dcn.plain") == 1
    before = counters()
    got = cross_net(leaves[0], layers, torch.float32)
    moved = counter_deltas(before, counters())
    assert "dcn.plain" not in moved and "dcn.kernel" not in moved
    assert torch.equal(got, cross_net_autograd(leaves[0], layers, torch.float32))
    assert cross_net.launches == launches


def test_the_bias_gradient_is_summed_by_bands_in_order():
    """``bias_grad_reference`` sums each band's rows from zero in row
    order, then runs of bands in band order: equal to a plain loop in that
    order bit for bit, and to ``sum(0)`` to f32's rounding; at the cell's
    shape a band is 27 rows (304 bands of 432 threads)."""
    t = torch.randn(203, 24, generator=torch.Generator().manual_seed(3))
    rows = 10
    bands = [torch.zeros(24) for _ in range(21)]
    for r in range(203):
        bands[r // rows] = bands[r // rows] + t[r]
    per = -(-21 // dcn.BIAS_GROUPS)
    runs = [torch.zeros(24) for _ in range(dcn.BIAS_GROUPS)]
    for k, band in enumerate(bands):
        runs[k // per] = runs[k // per] + band
    want = runs[0]
    for run in runs[1:]:
        want = want + run
    got = dcn.bias_grad_reference(t, rows)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, t.sum(0), rtol=1e-5, atol=1e-5)
    assert dcn.band_rows(8192, 3456) == 27 and dcn.band_rows(64, 96) == 1


@pytest.mark.parametrize("bad", ["transposed", "width", "f64"])
def test_the_kernel_route_refuses_what_it_cannot_take(bad):
    leaves = _cross_leaves(1, 48 if bad != "width" else 44)
    x0 = {"transposed": leaves[0].t().contiguous().t(), "width": leaves[0],
          "f64": leaves[0].double()}[bad]
    with pytest.raises(ValueError, match="K8 takes"):
        dcn._check_kernel_input(x0, [tuple(leaves[1:4])])


def test_a_bf16_step_takes_the_plain_route_once():
    """The bf16 DLRM-DCNv2 train step on the CPU: one cross network a step,
    through ``_CrossNet``'s plain version; finite loss."""
    cfg = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    params = init_dlrm(cfg, seed=1, device="cpu")
    state = init_opt_state(OPT, params, model_groups(cfg))
    step = make_train_step(cfg, OPT, device="cpu")
    before = counters()
    for it, batch in enumerate(_batches(2)):
        _, _, loss = step(params, state, batch, it)
        assert np.isfinite(float(loss))
    moved = counter_deltas(before, counters())
    assert moved["dcn.plain"] == 2 and "dcn.kernel" not in moved


def test_bag_lookup_sums_like_embedding_bag_with_repeats():
    """Each table's pooled vector equals ``EmbeddingBag(mode="sum")`` of
    its bag, repeated ids counted each time: sums of the same f32 rows in
    another order, so atol 2e-6, the f32 round-off of a bag of 100 rows of
    |x| <= 1 / sqrt(40) (6e-8 of a sum of |x| up to 16), rtol 1e-6."""
    params = init_dlrm(SMALL, seed=3, device="cpu")
    batch = _batches(1)[0]
    groups = model_groups(SMALL)
    pooled = lookup_all_groups(params, groups, torch.as_tensor(batch.indices),
                               torch.as_tensor(batch.weights), hotness=HOT)
    want = plain.pooled(_plain_params(params)["tables"], _bags(batch))
    for g, p in zip(groups, pooled):
        for i, t in enumerate(g.table_ids):
            torch.testing.assert_close(p[i], want[:, t], rtol=1e-6, atol=2e-6)


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    monkeypatch.setattr(port_opt, "ACC_KERNEL_MIN_BYTES", 0)


def test_three_steps_of_exact_rowwise_adagrad_match_the_reference(kernel_route, monkeypatch):
    """Three steps on both sides from the same weights. Tolerances: the
    losses rtol 1e-5 (f32 sums in another order). Every leaf atol 1e-4,
    1/500 of one step: Adagrad moves each entry by up to lr = 0.05 a step
    whatever its gradient's size, so a wrong sign, a lost step or a wrong
    momentum is off by ~1e-2 or more; f32 round-off in the order of the
    sums, divided through ``g / sqrt(a)`` where an entry's gradients nearly
    cancel, reads up to 1e-5 (the cross layers; tables 2e-6) over seeds
    0-4."""
    plain.exact_f32()
    params = init_dlrm(SMALL, seed=5, device="cpu")
    ref = _plain_params(params)
    state, ref_state = init_opt_state(OPT, params, model_groups(SMALL)), plain.init_state(ref)
    step = make_train_step(SMALL, OPT, device="cpu")
    k4_widths = []
    real_k4 = port_opt.sparse_rows_add
    monkeypatch.setattr(port_opt, "sparse_rows_add",
                        lambda store, *a, **k: k4_widths.append(store.shape[1]) or real_k4(
                            store, *a, **k))
    before = counters()
    for it, batch in enumerate(_batches(3)):
        _, _, loss = step(params, state, batch, it)
        want = plain.train_step(ref, ref_state, (torch.as_tensor(batch.dense), _bags(batch),
                                                 torch.as_tensor(batch.labels).reshape(-1)),
                                OPT.lr, OPT.eps)
        assert float(loss) == pytest.approx(want, rel=1e-5)
    moved = counter_deltas(before, counters())
    assert moved["sparse_update.overwrite"] == 3 and moved["sparse_update.dense_k3"] == 3
    assert k4_widths == [1, 1, 1]  # K4 on the row momentum viewed [len, 1]
    got = _plain_params(params)
    for k in ("bot", "dcn", "top"):
        for a, b in zip(got[k], ref[k]):
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=0, atol=1e-4)
    for x, y in zip(got["tables"], ref["tables"]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-4)


def test_a_step_counts_every_bag_item_and_no_padding():
    params = init_dlrm(SMALL, seed=1, device="cpu")
    state = init_opt_state(OPT, params, model_groups(SMALL))
    step = make_train_step(SMALL, OPT, device="cpu")
    before = counters()
    step(params, state, _batches(1)[0], 0)
    moved = counter_deltas(before, counters())
    assert moved["lookup.items"] == B * sum(HOT) and "lookup.pad_items" not in moved


def test_the_padded_layout_counts_its_padding():
    """The padded [T, B, L] layout reads no weights on the host: one item a
    bag counts as live and the other L - 1 slots as padding."""
    params = init_dlrm(SMALL, seed=1, device="cpu")
    t, l = len(ROWS), 4
    before = counters()
    lookup_all_groups(params, model_groups(SMALL), torch.zeros(t, B, l, dtype=torch.int32),
                      torch.ones(t, B, l))
    moved = counter_deltas(before, counters())
    assert moved["lookup.items"] == t * B and moved["lookup.pad_items"] == t * B * (l - 1)


@pytest.mark.parametrize("exact", [False, True])
def test_exact_row_momentum_never_takes_the_stream_route(kernel_route, exact):
    """A padded high-L batch in the stream route's dense regime: RWSAdagrad
    takes K5/K6 with per-occurrence momentum, and never under
    ``exact_row_momentum``."""
    cfg = DLRMConfig.build(emb_rows=(3000, 3200), ln_bot=(4, 128), ln_top=(64, 1),
                           emb_split_threshold=100, loss="bce", sparse_update_impl="stream",
                           exact_row_momentum=exact)
    r = np.random.RandomState(0)
    batch = Batch(r.rand(256, 4).astype(np.float32),
                  r.randint(0, 3000, (2, 256, 100)).astype(np.int32),
                  np.ones((2, 256, 100), np.float32), np.ones((256, 1), np.float32))
    params = init_dlrm(cfg, seed=0, device="cpu")
    state = init_opt_state(OPT, params, model_groups(cfg))
    before = counters()
    make_train_step(cfg, OPT, device="cpu")(params, state, batch, 0)
    moved = counter_deltas(before, counters())
    assert ("sparse_update.stream" in moved) is not exact


def test_cli_trains_the_small_model_from_the_flags():
    out = cli.main([
        "--device", "cpu", "--data-generation=random",
        "--arch-embedding-size=" + "-".join(map(str, ROWS)), "--arch-sparse-feature-size=16",
        "--arch-mlp-bot=13-32-16", "--arch-mlp-top=16-1", "--arch-interaction-op=dcn",
        "--dcn-num-layers=2", "--dcn-low-rank-dim=8",
        "--multi-hot-sizes=" + "-".join(map(str, HOT)), "--optimizer=rwsadagrad",
        "--exact-row-momentum", "--sparse-update-impl=pallas", "--emb-split-threshold=100",
        "--mini-batch-size=64", "--num-batches=6", "--print-freq=3", "--loss-function=bce",
        "--learning-rate=0.005"])
    assert np.isfinite(out["streaming_auc"]) and 0.0 <= out["accuracy"] <= 1.0
    batch = cli.make_data(cli.build_parser().parse_args(
        ["--arch-embedding-size=" + "-".join(map(str, ROWS)), "--mini-batch-size=8",
         "--num-batches=1", "--multi-hot-sizes=" + "-".join(map(str, HOT)),
         "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-32-16"]), SMALL)[0][0]
    assert batch.indices.shape == (sum(HOT), 8, 1)
    slots = np.asarray(SMALL.slot_tables)
    assert all((batch.indices[slots == t] < n).all() for t, n in enumerate(ROWS))


def test_the_width_check_rejects_a_wrong_top_input():
    kw = dict(emb_rows=ROWS, ln_bot=(13, 32, 16), interaction="dcn", multi_hot_sizes=HOT)
    assert DLRMConfig(ln_top=(96, 1), **kw).ln_top[0] == (len(ROWS) + 1) * 16
    with pytest.raises(ValueError, match="ln_top"):
        DLRMConfig(ln_top=(95, 1), **kw)
    with pytest.raises(ValueError, match="multi-hot sizes"):
        DLRMConfig(ln_top=(96, 1), **dict(kw, multi_hot_sizes=HOT[:-1]))


def test_checkpoints_round_trip_the_cross_layers_and_their_state(tmp_path):
    params = init_dlrm(SMALL, seed=2, device="cpu")
    state = init_opt_state(OPT, params, model_groups(SMALL))
    make_train_step(SMALL, OPT, device="cpu")(params, state, _batches(1)[0], 0)
    save_checkpoint(str(tmp_path), params, state, SMALL, optimizer="rwsadagrad")
    params2 = init_dlrm(SMALL, seed=9, device="cpu")
    state2 = init_opt_state(OPT, params2, model_groups(SMALL))
    load_checkpoint(str(tmp_path), params2, state2)
    assert len(params2["dcn"]) == 2 and float(state["dcn"][0][0].abs().sum()) > 0
    for a, b in ((params, params2), (state, state2)):
        for x, y in zip(a["dcn"], b["dcn"]):
            for p, q in zip(x, y):
                assert torch.equal(p, q)
    assert all(torch.equal(p, q) for p, q in zip(params["emb"], params2["emb"]))


@pytest.mark.parametrize("cfg", [SMALL, DLRMConfig.build(
    emb_rows=ROWS, ln_bot=(13, 32, 16), ln_top=(16, 1), interaction="dcn"),
    DLRMConfig.build(emb_rows=ROWS, ln_bot=(13, 32, 16), ln_top=(16, 1), multi_hot_sizes=HOT)],
    ids=["dcn-bags", "dcn", "bags"])
def test_export_quantized_serving_and_the_mesh_runners_refuse_it(cfg, tmp_path):
    params = init_dlrm(cfg, seed=0, device="cpu")
    groups = model_groups(cfg)
    for make in (lambda: export_inference(params, cfg, _batches(1)[0], str(tmp_path / "m.pt2")),
                 lambda: make_fully_quantized_eval_step(cfg, groups, [], device="cpu"),
                 lambda: make_quantized_eval_step(cfg, groups, [], device="cpu"),
                 lambda: HybridRunner(cfg, OPT, device="cpu"),
                 lambda: RowShardedRunner(cfg, OPT, device="cpu"),
                 lambda: ColShardedRunner(cfg, OPT, device="cpu")):
        with pytest.raises(NotImplementedError, match="DLRM-DCNv2"):
            make()
    assert not (tmp_path / "m.pt2").exists()
