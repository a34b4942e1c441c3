"""K7 (``csrc/coalesce_rows.cu``, ``ops/coalesce.py``): the coalesce-first
update's segment sums (K7a) and finish (K7b), and RWSAdagrad's write-only
route through them (``optim.optimizer._coalesced_overwrite``: sort, K7a,
K4, K7b, K2).

On the CPU the route's plain form (segment sums, the accumulator, the
finish) gives the stores and momenta of the torch route it replaced
(``coalesce_rows`` with the gathered rows carried by representative, the
momentum and finish on every item, K2) bit for bit, in the bag layout (the
items' rows read from the pooled cotangent) and the L=1 layout. The card
cases hold K7a and the whole route to the plain versions; they skip
without a card. Imports no JAX: ``python -m pytest --noconftest
tests/test_torch_coalesce_kernel.py`` runs them on the card.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dlrm_yx_tpu_torch.optim.optimizer as port_opt
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
from dlrm_yx_tpu_torch.ops import coalesce
from dlrm_yx_tpu_torch.ops.coalesce import (
    CHUNK,
    coalesce_finish,
    coalesce_rows,
    coalesce_rows_reference,
    coalesce_segments,
    coalesce_segments_reference,
)
from dlrm_yx_tpu_torch.ops.embedding import BagRowGrads, bag_row_grads, bag_slots
from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len, init_opt_state
from dlrm_yx_tpu_torch.train.train_step import make_train_step
from dlrm_yx_tpu_torch.utils.profiling import counter_deltas, counters

ROOT = Path(__file__).resolve().parents[1]
OPT = OptConfig(name="rwsadagrad", lr=0.05)
U24 = 2.0 ** -24  # f32's unit round-off

# DLRM-DCNv2's big tables (benchmark/configs/mlperf-dlrmv2-dcn-tb-25m.json):
# raw rows, hotness; ids rank r ~ r^-1.15 over the raw rows, then % 25M
DCN_BIG = ((40_000_000, 3), (40_000_000, 7), (3_067_956, 3), (405_282, 8),
           (40_000_000, 12), (40_000_000, 100), (40_000_000, 27), (590_152, 10))
DCN_CAP = 25_000_000


def dcn_step_ids(batch: int, seed: int = 0):
    """(ids [S, batch] int64 store rows, owner [S]): one step of the
    DLRM-DCNv2 cell's big-store bag items at ``batch`` samples, each table's
    ids drawn on their own from the cell's law and placed at the table's
    row offset in one store."""
    rng = np.random.RandomState(seed)
    ids, owner, off = [], [], 0
    for t, (raw, h) in enumerate(DCN_BIG):
        u = rng.random_sample((h, batch))
        r = (1.0 - u * (1.0 - float(raw) ** -0.15)) ** (1.0 / -0.15)
        ids.append((np.minimum(r.astype(np.int64) - 1, raw - 1) % min(raw, DCN_CAP)) + off)
        owner += [t] * h
        off += min(raw, DCN_CAP)
    return np.concatenate(ids), np.array(owner, np.int32), off


def torch_route(store, acc, flat_idx, flat_g, old_rows, lr, sentinel, impl="pallas"):
    """The coalesce-first write-only update as the optimizer took it
    before K7: the plain coalesce with the gathered rows by representative,
    the momentum and the finish on every item, K2; in place."""
    flat_idx, flat_g, old_rows = coalesce_rows_reference(flat_idx, flat_g, sentinel,
                                                         aux=old_rows)
    active = (flat_idx < sentinel).to(torch.int32)
    safe = torch.where(active > 0, flat_idx, sentinel)
    mom_inc = ((flat_g * flat_g).sum(dim=-1) / store.shape[1]) * active
    port_opt._acc_update_1d(acc, flat_idx, mom_inc, active, sentinel, impl)
    denom = port_opt._take_fill(acc, safe, 1.0, sentinel).sqrt() + OPT.eps
    delta = -lr * flat_g / denom[:, None]
    sparse_rows_overwrite(store, flat_idx, old_rows + delta, delta, active)
    return store, acc


def _case(layout: str, ids: str, dim: int = 128, seed: int = 0):
    """(store [R, dim], acc, flat_idx [K], grads, old_rows [K, dim],
    sentinel): a store of 40,000 rows (past the dense regime's 8 K rows)
    and K = 2,048 items, the gathered
    rows the store's own; ``layout`` "bag" gives the grads as a
    ``BagRowGrads`` over 8 slots of 256 samples, "l1" as a [K, dim] tensor
    with 64 sentinel items of zero gradient at the end."""
    rng = np.random.RandomState(seed)
    rows, k = 40_000, 2048
    if ids == "power law":
        u = rng.random_sample(k)
        idx = ((1.0 - u * (1.0 - 4e6 ** -0.15)) ** (1.0 / -0.15)).astype(np.int64) % (rows - 16)
    elif ids == "one row on 90%":
        idx = rng.randint(0, rows - 16, k)
        idx[rng.random_sample(k) < 0.9] = 77
    else:
        idx = rng.randint(0, rows - 16, k)
    store = torch.from_numpy(rng.uniform(-0.05, 0.05, (rows, dim)).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(0, 0.1, acc_len(rows)).astype(np.float32))
    flat_idx = torch.from_numpy(idx)
    if layout == "bag":
        table = torch.from_numpy(rng.normal(0, 1e-3, (4 * 256, dim)).astype(np.float32))
        owner = torch.from_numpy(rng.randint(0, 4, 8).astype(np.int32))
        grads = BagRowGrads(table, owner, 256)
    else:
        grads = torch.from_numpy(rng.normal(0, 1e-3, (k, dim)).astype(np.float32))
        flat_idx[-64:] = rows
        grads[-64:] = 0.0
    old_rows = store[flat_idx.clamp(max=rows - 1)].clone()
    old_rows[flat_idx >= rows] = 0.0
    return store, acc, flat_idx, grads, old_rows, rows


# ------------------------------------------------------------- the CPU


def test_bag_row_grads_expand_as_the_cotangent_taken_back_to_the_items():
    """``BagRowGrads.expand`` and ``rows`` give item s * B + b the row of
    its slot's table and its sample."""
    rng = np.random.RandomState(0)
    g_pooled = torch.from_numpy(rng.randn(3, 5, 4).astype(np.float32))
    owner = (0, 0, 2, 1, 2)
    grads = BagRowGrads(g_pooled.reshape(15, 4), torch.tensor(owner, dtype=torch.int32), 5)
    want = torch.stack([g_pooled[owner[k // 5], k % 5] for k in range(25)])
    assert torch.equal(grads.expand(), want)
    assert torch.equal(grads.table[grads.rows(torch.arange(25))], want)


def test_bag_row_grads_unexpanded_gives_the_same_rows():
    cfg = DLRMConfig.build(emb_rows=(40, 30000, 60), ln_bot=(13, 16), ln_top=(32, 1),
                           interaction="dcn", dcn_num_layers=1, dcn_low_rank_dim=4,
                           multi_hot_sizes=(3, 2, 5), emb_split_threshold=100)
    bags = bag_slots(model_groups(cfg), cfg.multi_hot_sizes)
    rng = np.random.RandomState(1)
    indices = torch.from_numpy(rng.randint(0, 40, (10, 6, 1)).astype(np.int32))
    for gi, b in enumerate(bags):
        g_pooled = torch.from_numpy(rng.randn(len(b.sizes), 6, 16).astype(np.float32))
        ids, flat = bag_row_grads(b, indices, g_pooled)
        ids2, lazy = bag_row_grads(b, indices, g_pooled, expand=False)
        assert torch.equal(ids, ids2) and torch.equal(lazy.expand(), flat)


@pytest.mark.parametrize("ids", ["power law", "one row on 90%", "uniform"])
@pytest.mark.parametrize("layout", ["bag", "l1"])
def test_plain_segments_are_the_plain_coalesce(layout, ids):
    """K7a's plain version: the plain coalesce's ids and sums bit for bit
    (its rows read through the bag map), each segment's first item, the
    segment count and RWSAdagrad's increments."""
    _, _, flat_idx, grads, _, sentinel = _case(layout, ids)
    expanded = grads.expand() if layout == "bag" else grads
    want_ids, want_sums = coalesce_rows(flat_idx, expanded, sentinel)
    seg = coalesce_segments(flat_idx, grads, sentinel, mdim=128)
    assert torch.equal(seg.ids, want_ids) and torch.equal(seg.sums, want_sums)
    distinct = torch.unique(flat_idx)
    n = distinct.numel()
    assert int(seg.count) == n
    first = [int((flat_idx == i).nonzero()[0]) for i in distinct]
    assert seg.rep[:n].tolist() == first and not seg.rep[n:].any()
    live = (want_ids < sentinel).float()
    assert torch.equal(seg.inc, (want_sums * want_sums).sum(-1) / 128 * live)


@pytest.mark.parametrize("lr", ["float", "tensor"])
@pytest.mark.parametrize("acc_route", ["k4", "scatter"])
@pytest.mark.parametrize("ids", ["power law", "one row on 90%"])
@pytest.mark.parametrize("layout", ["bag", "l1"])
def test_route_plain_form_equals_the_torch_route_bitwise(monkeypatch, layout, ids, acc_route,
                                                         lr):
    """``sparse_update`` on the kernel route with coalesce-first momentum
    and the gathered rows takes ``_coalesced_overwrite``, whose plain form
    gives the torch route's store and momentum bit for bit."""
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    if acc_route == "k4":
        monkeypatch.setattr(port_opt, "ACC_KERNEL_MIN_BYTES", 0)
    store, acc, flat_idx, grads, old_rows, sentinel = _case(layout, ids)
    lr_v = OPT.lr if lr == "float" else torch.tensor(OPT.lr)
    want_s, want_a = torch_route(store.clone(), acc.clone(), flat_idx,
                                 grads.expand() if layout == "bag" else grads, old_rows, lr_v,
                                 sentinel)
    calls = []
    real = port_opt._coalesced_overwrite
    monkeypatch.setattr(port_opt, "_coalesced_overwrite",
                        lambda *a: calls.append(1) or real(*a))
    got_s, got_a = port_opt.sparse_update(OPT, store.clone(), acc.clone(), flat_idx, grads, lr_v,
                                          sentinel, impl="pallas", exact_momentum=True,
                                          old_rows=old_rows)
    assert calls == [1]
    assert torch.equal(got_s, want_s) and torch.equal(got_a, want_a)
    assert not torch.equal(got_s, store)


def test_other_routes_take_the_expanded_rows(monkeypatch):
    """A bag batch's unexpanded rows on a route that does not read them in
    place (Adagrad's coalesce-first route) give that route's result for the
    expanded rows."""
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    store, _, flat_idx, grads, old_rows, sentinel = _case("bag", "power law")
    opt = OptConfig(name="adagrad", lr=0.05)
    acc = torch.full_like(store, 0.01)
    want = port_opt.sparse_update(opt, store.clone(), acc.clone(), flat_idx, grads.expand(),
                                  0.05, sentinel, impl="pallas", exact_momentum=True,
                                  old_rows=old_rows)
    got = port_opt.sparse_update(opt, store.clone(), acc.clone(), flat_idx, grads, 0.05,
                                 sentinel, impl="pallas", exact_momentum=True, old_rows=old_rows)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _dcn_config():
    return DLRMConfig.build(emb_rows=(40, 30000, 60, 32000, 50), ln_bot=(13, 32, 16),
                            ln_top=(32, 16, 1), interaction="dcn", dcn_num_layers=2,
                            dcn_low_rank_dim=8, multi_hot_sizes=(3, 1, 12, 2, 100),
                            emb_split_threshold=100, loss="bce", sparse_update_impl="pallas",
                            exact_row_momentum=True)


L1_ROWS = (40, 30000, 60, 32000)


def _l1_config(**kw):
    return DLRMConfig.build(emb_rows=L1_ROWS, ln_bot=(13, 16), ln_top=(26, 16, 1),
                            emb_split_threshold=100, loss="bce", sparse_update_impl="pallas",
                            **kw)


def _batches(cfg, n, seed=0, b=64):
    """Random batches of the bag layout (DLRM-DCNv2) or the L=1 layout, one
    id repeated through the first slots' first samples."""
    r = np.random.RandomState(seed)
    rows, hot = cfg.emb_rows, cfg.multi_hot_sizes or (1,) * len(cfg.emb_rows)
    out = []
    for _ in range(n):
        ids = np.concatenate([r.randint(0, m, (h, b)) for m, h in zip(rows, hot)])
        ids[: ids.shape[0] // 2, :8] = 7
        w = np.ones((ids.shape[0], 1 if cfg.multi_hot_sizes else b, 1), np.float32)
        out.append(Batch(r.rand(b, 13).astype(np.float32), ids.astype(np.int32)[:, :, None], w,
                         (r.rand(b, 1) < 0.3).astype(np.float32)))
    return out


@pytest.mark.parametrize("model", ["bag", "l1"])
def test_train_steps_through_the_route_equal_the_torch_route_bitwise(monkeypatch, model):
    """Three train steps of a small DLRM-DCNv2 (bag layout) or dot model
    (L=1) with exact row momentum on the kernel route: through
    ``_coalesced_overwrite`` and through the torch route in its place,
    every leaf and every momentum bit for bit."""
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    monkeypatch.setattr(port_opt, "ACC_KERNEL_MIN_BYTES", 0)
    cfg = _dcn_config() if model == "bag" else _l1_config(exact_row_momentum=True)
    batches = _batches(cfg, 3)
    results = []
    real = port_opt._coalesced_overwrite
    for route in ("k7", "torch"):
        if route == "torch":
            def old(opt, store, acc, flat_idx, flat_g, lr, sentinel, impl, old_rows):
                flat_g = flat_g.expand() if isinstance(flat_g, BagRowGrads) else flat_g
                return torch_route(store, acc, flat_idx, flat_g, old_rows, lr, sentinel, impl)
            monkeypatch.setattr(port_opt, "_coalesced_overwrite", old)
        else:
            monkeypatch.setattr(port_opt, "_coalesced_overwrite", real)
        params = init_dlrm(cfg, seed=5, device="cpu")
        state = init_opt_state(OPT, params, model_groups(cfg))
        step = make_train_step(cfg, OPT, device="cpu")
        before = counters()
        for it, batch in enumerate(batches):
            step(params, state, batch, it)
        moved = counter_deltas(before, counters())
        if route == "k7":
            assert moved["sparse_update.overwrite"] == 3
        assert "coalesce.kernel" not in moved  # the CPU runs the plain versions
        results.append((params, state))
    (p1, s1), (p2, s2) = results
    flat = lambda tree: [t for t in _tensors(tree)]  # noqa: E731
    for a, b in zip(flat(p1) + flat(s1), flat(p2) + flat(s2)):
        assert torch.equal(a, b)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def test_an_sgd_step_never_coalesces(monkeypatch):
    """The dot model's SGD step (the benchmark's dot cells) never reaches
    K7a: the control of the DLRM-DCNv2 cell."""
    monkeypatch.setattr(port_opt, "PALLAS_MIN_STORE_BYTES", 0)
    cfg = _l1_config()
    calls = []
    real = port_opt.coalesce_segments
    monkeypatch.setattr(port_opt, "coalesce_segments", lambda *a, **k: calls.append(1) or real(
        *a, **k))
    params = init_dlrm(cfg, seed=0, device="cpu")
    make_train_step(cfg, OptConfig("sgd", 0.1), device="cpu")(params, {}, _batches(cfg, 1)[0], 0)
    assert calls == []


def test_the_kernels_names_and_chunk():
    """Every kernel of ``csrc/coalesce_rows.cu`` is named ``coalesce_rows_*``
    and none holds ``row_plan`` or ``dense_finish`` (the patterns of the
    rooflines that read K2, K4 and K3), and ``coalesce.CHUNK`` is the
    source's chunk."""
    src = (ROOT / "dlrm_yx_tpu_torch" / "csrc" / "coalesce_rows.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    code = re.sub(r"__launch_bounds__\([^)]*\)", "", code)
    names = re.findall(r"__global__[^(]*?(\w+)\s*\(", code)
    assert sorted(names) == ["coalesce_rows_combine", "coalesce_rows_count",
                             "coalesce_rows_finish", "coalesce_rows_scan", "coalesce_rows_sum"]
    for n in names:
        assert "row_plan" not in n and "dense_finish" not in n
    assert re.search(r"constexpr int kChunk = (\d+);", src).group(1) == str(CHUNK)


def test_counters_report_no_coalesce_counts_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the counters of a process that has no card")
    _, _, flat_idx, grads, _, sentinel = _case("l1", "power law")
    coalesce_segments(flat_idx, grads, sentinel)
    snap = counters()
    assert all(snap.get(n, 0) == 0 for n in coalesce.COALESCE_COUNTS)
    assert coalesce.coalesce_counts() == {}


@pytest.mark.parametrize("what", ["empty", "2-D ids", "rows"])
def test_segments_refuse_what_they_cannot_take(what):
    idx = torch.zeros(4, dtype=torch.int64)
    g = torch.zeros(4, 8)
    if what == "empty":
        idx, g = idx[:0], g[:0]
    elif what == "2-D ids":
        idx = idx.view(2, 2)
    else:
        g = g[:3]
    with pytest.raises(ValueError):
        coalesce_segments(idx, g, 10)


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_items(name: str, dim: int):
    """(flat_idx [K] int64, grads (tensor or BagRowGrads), sentinel) on the
    CPU: the cases K7a is held to."""
    rng = np.random.RandomState(3)
    if name == "DLRM-DCNv2 step, B=1024":
        ids, owner, rows = dcn_step_ids(1024)
        table = torch.from_numpy(rng.normal(0, 1e-3, (len(DCN_BIG) * 1024, dim)).astype(
            np.float32))
        return (torch.from_numpy(ids.reshape(-1)),
                BagRowGrads(table, torch.from_numpy(owner), 1024), rows)
    k = {"K=1": 1, "K not a multiple of the chunk": 3 * CHUNK + 77}.get(name, 20 * CHUNK)
    rows = 1 << 20
    if name == "one row on 90% of K":
        idx = rng.randint(0, rows, k)
        idx[rng.random_sample(k) < 0.9] = 12345
    elif name == "runs across every chunk boundary":
        # runs of CHUNK + 1 items: each chunk's first item continues a run
        idx = np.repeat(rng.choice(rows, k // (CHUNK + 1) + 1, replace=False), CHUNK + 1)[:k]
    elif name == "all sentinel":
        idx = np.full(k, rows)
    else:
        idx = rng.randint(0, 64, k)
    shape = (k,) if dim == 1 else (k, dim)
    g = torch.from_numpy(rng.normal(0, 1.0, shape).astype(np.float32))
    return torch.from_numpy(idx.astype(np.int64)), g, rows


def _segment_bounds(flat_idx, grads, seg_ref):
    """Per segment: (whether it lies in one chunk of the sorted items, the
    float64 exact sum, the bound of K7a's chunked order
    (CHUNK + ceil(n / CHUNK)) * 2^-24 * sum |g| and of a sum in any order
    (n - 1) * 2^-24 * sum |g|, elementwise; n the segment's items)."""
    s_idx, order = torch.sort(flat_idx, stable=True)
    g = grads.table[grads.rows(order)] if isinstance(grads, BagRowGrads) else grads[order]
    g = g.double().reshape(g.shape[0], -1)
    new = torch.cat([torch.ones(1, dtype=torch.bool), s_idx[1:] != s_idx[:-1]])
    seg = torch.cumsum(new.long(), 0) - 1
    n_seg = int(seg[-1]) + 1
    start = torch.nonzero(new).squeeze(1)
    size = torch.diff(torch.cat([start, torch.tensor([s_idx.numel()])]))
    one_chunk = start // CHUNK == (start + size - 1) // CHUNK
    exact = torch.zeros(n_seg, g.shape[1], dtype=torch.float64).index_add_(0, seg, g)
    absum = torch.zeros(n_seg, g.shape[1], dtype=torch.float64).index_add_(0, seg, g.abs())
    steps = CHUNK + torch.ceil(size.double() / CHUNK)
    return (one_chunk, exact, steps[:, None] * U24 * absum,
            (size.double() - 1)[:, None] * U24 * absum)


def _inc_bound(exact, e):
    """The bound of sum(s^2) / dim for sums s within e of ``exact``
    elementwise: |s^2 - x^2| <= 2 |x| e + e^2, and the f32 sum of dim
    squares within (dim + 1) * 2^-24 of their sum, twice over."""
    d = exact.shape[1]
    return ((2 * exact.abs() * e + e * e).sum(1) + 2 * (d + 1) * U24 * (exact * exact).sum(1)) / d


CARD_CASES = ["DLRM-DCNv2 step, B=1024", "one row on 90% of K",
              "runs across every chunk boundary", "all sentinel", "K=1",
              "K not a multiple of the chunk", "few rows"]


@pytest.mark.parametrize("dim", [1, 4, 64, 128])
@pytest.mark.parametrize("name", CARD_CASES)
def test_cuda_segments_match_the_plain_version(cuda_device, name, dim):
    """K7a against its plain version on the CPU: ids, first items and the
    segment count equal; a segment inside one chunk of the sorted items
    summed bit for bit (both add 0 + g_0 + g_1 + ... in occurrence order);
    every other within (CHUNK + ceil(n / CHUNK)) * 2^-24 * sum |g| of the
    float64 sum (n the segment's items); the increments within the bound
    carried through sum(g^2); two calls bit for bit; the zero tail."""
    if name == "DLRM-DCNv2 step, B=1024" and dim == 1:
        pytest.skip("a bag batch's rows are 2-D")
    flat_idx, grads, sentinel = _card_items(name, dim)
    mdim = None if dim == 1 else dim
    ref = coalesce_segments_reference(flat_idx, grads, sentinel, mdim)
    dev = lambda g: (BagRowGrads(g.table.to(cuda_device), g.owner.to(cuda_device), g.batch)  # noqa
                     if isinstance(g, BagRowGrads) else g.to(cuda_device))
    i_d, g_d = flat_idx.to(cuda_device), dev(grads)
    launches = coalesce_segments.launches
    before = counters()
    seg = coalesce_segments(i_d, g_d, sentinel, mdim)
    again = coalesce_segments(i_d, g_d, sentinel, mdim)
    torch.cuda.synchronize()
    assert coalesce_segments.launches == launches + 2
    moved = counter_deltas(before, counters())
    assert moved["coalesce.kernel"] == 2
    n = int(ref.count)
    assert int(seg.count) == n
    assert moved.get("coalesce.rows", 0) == 2 * int((ref.ids[:n] < sentinel).sum())
    assert torch.equal(seg.ids.cpu(), ref.ids) and torch.equal(seg.rep.cpu(), ref.rep)
    for a, b in zip(seg, again):
        if a is not None:
            assert torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
    got = seg.sums.cpu().reshape(seg.sums.shape[0], -1)
    want = ref.sums.reshape(ref.sums.shape[0], -1)
    one_chunk, exact, bound, _ = _segment_bounds(flat_idx, grads, ref)
    assert torch.equal(got[:n][one_chunk], want[:n][one_chunk])
    assert ((got[:n].double() - exact).abs() <= bound).all()
    assert not got[n:].any()  # the zero tail
    if mdim is not None:
        live = ref.ids[:n] < sentinel
        exact_inc = (exact * exact).sum(1) / dim * live
        assert ((seg.inc.cpu()[:n].double() - exact_inc).abs() <= _inc_bound(exact, bound)).all()
        assert not seg.inc.cpu()[n:].any()


def test_cuda_coalesce_rows_takes_the_kernel_and_keeps_its_contract(cuda_device):
    """``coalesce_rows`` on CUDA f32 rows: K7a, with the plain version's
    outputs (ids, sums, the rows carried by representative, zeros after
    the last segment)."""
    flat_idx, g, sentinel = _card_items("few rows", 128)
    aux = torch.randn(64, 8)[flat_idx]
    want = coalesce_rows_reference(flat_idx, g, sentinel, aux)
    launches = coalesce_segments.launches
    got = coalesce_rows(flat_idx.to(cuda_device), g.to(cuda_device), sentinel,
                        aux.to(cuda_device))
    torch.cuda.synchronize()
    assert coalesce_segments.launches == launches + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["DLRM-DCNv2 step, B=1024", "one row on 90% of K"])
def test_cuda_route_matches_the_torch_route(cuda_device, monkeypatch, name):
    """The whole route on the card (sort, K7a, K4, K7b, K2) against the
    torch route on the card: the store at f32's rtol 1e-5 / atol 1e-6, the
    momentum within K7a's bound carried through sum(g^2) (the torch
    route's atomic sums add their own, bounded the same way); a capture of
    the route replays it bit for bit."""
    monkeypatch.setattr(port_opt, "ACC_KERNEL_MIN_BYTES", 0)
    flat_idx, grads, _ = _card_items(name, 128)
    if isinstance(grads, torch.Tensor):
        grads = grads * 1e-3
    # the ids renumbered densely in their order: the same runs, a small store
    _, dense = np.unique(flat_idx.numpy(), return_inverse=True)
    flat_idx = torch.from_numpy(dense.reshape(-1).astype(np.int64))
    rng = np.random.RandomState(4)
    rows = int(flat_idx.max()) + 17
    store = torch.from_numpy(rng.uniform(-0.05, 0.05, (rows, 128)).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(0, 0.1, acc_len(rows)).astype(np.float32))
    s_d, a_d = store.to(cuda_device), acc.to(cuda_device)
    i_d = flat_idx.to(cuda_device)
    g_d = (BagRowGrads(grads.table.to(cuda_device), grads.owner.to(cuda_device), grads.batch)
           if isinstance(grads, BagRowGrads) else grads.to(cuda_device))
    old = s_d.index_select(0, i_d)
    lr = torch.tensor(OPT.lr, device=cuda_device)
    want_s, want_a = torch_route(s_d.clone(), a_d.clone(), i_d,
                                 g_d.expand() if isinstance(g_d, BagRowGrads) else g_d, old,
                                 lr, rows)
    got_s, got_a = port_opt._coalesced_overwrite(OPT, s_d.clone(), a_d.clone(), i_d, g_d, lr,
                                                 rows, "pallas", old)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-6)
    ref = coalesce_segments_reference(flat_idx, grads, rows, 128)
    n = int(ref.count)
    _, exact, e, e_torch = _segment_bounds(flat_idx, grads, ref)
    ids = ref.ids[:n]
    exact_acc = acc[ids].double() + (exact * exact).sum(1) / 128
    got = got_a.cpu()[ids].double()
    # K7's momentum to the exact one; the torch route's, whose atomic sums
    # add in any order, within its own bound besides
    assert ((got - exact_acc).abs() <= _inc_bound(exact, e) + 2 * U24 * got).all()
    gap = (got - want_a.cpu()[ids].double()).abs()
    assert (gap <= _inc_bound(exact, e) + _inc_bound(exact, e_torch) + 4 * U24 * got).all()
    untouched = torch.ones(acc.shape[0], dtype=torch.bool)
    untouched[ids] = False
    assert torch.equal(got_a.cpu()[untouched], acc[untouched])
    # captured and replayed: the same bits as the eager call
    work_s, work_a = s_d.clone(), a_d.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        port_opt._coalesced_overwrite(OPT, work_s, work_a, i_d, g_d, lr, rows, "pallas", old)
    for _ in range(2):
        work_s.copy_(s_d)
        work_a.copy_(a_d)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(work_s, got_s) and torch.equal(work_a, got_a)


def test_cuda_finish_matches_its_plain_version(cuda_device):
    """K7b on K7a's segments against its plain version run on the card on
    the same inputs: the same f32 operations in the same order (IEEE
    division and square root), so the live places bit for bit. (The plain
    version on the CPU differs by up to 2 ulps in delta: torch's CPU
    arithmetic is not the card's.)"""
    flat_idx, grads, rows = _card_items("DLRM-DCNv2 step, B=1024", 128)
    dev_g = BagRowGrads(grads.table.to(cuda_device), grads.owner.to(cuda_device), grads.batch)
    seg = coalesce_segments(flat_idx.to(cuda_device), dev_g, rows, 128, zero_tail=True)
    acc = torch.rand(acc_len(rows), device=cuda_device)
    old = torch.randn(flat_idx.shape[0], 128, device=cuda_device)
    want_new, want_delta = coalesce.coalesce_finish_reference(
        acc, coalesce.Segments(*(t.clone() for t in seg)), old, OPT.lr, OPT.eps, rows)
    launches = coalesce_finish.launches
    new, delta = coalesce_finish(acc, seg, old, OPT.lr, OPT.eps, rows)
    torch.cuda.synchronize()
    assert coalesce_finish.launches == launches + 1
    n = int(seg.count)
    assert torch.equal(new[:n], want_new[:n]) and torch.equal(delta[:n], want_delta[:n])
    assert math.isfinite(float(new[:n].abs().max()))
