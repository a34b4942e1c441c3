"""Times the port's K1, K3, K4, K5 and K6 kernels of one or more checkouts
on one NVIDIA card, in turns, each against its plain PyTorch version, and
the captured train steps whose K3 work changes between checkouts.

    python3 compare_kernels.py [--only row_plan|coalesce] [REPO ...]

Each REPO is the root of a checkout of this repository (default: this
one); its ``dlrm_yx_tpu_torch`` builds its own kernels into its own
``build/``. With checkouts A, B, ... the runs go A, B, ..., then back
(two: A, B, B, A; three: A, B, C, C, B, A), each in a process of its own,
so all are timed on one card in one call. Every run
prints one JSON line (``{"repo": ..., "cases": {name: {"ms", "plain_ms",
"rel_err", ...}}}``) and the script ends with the card's name and power
limit. Cases, at the main path's shapes:

  * K1 at the serving shape (B=2048, S=26, D=128), bf16 and f32 compute,
    also called eagerly (``eager_ms``: CUDA events around 200 wrapper calls
    in a row, the host's cost of a call included);
  * K5 on the reference L=100 benchmark's store (8 x 1M rows x 64 f32)
    with one device batch's sorted occurrences (batch 2048, SGD's
    weights), and on the same batch with every weight-0 id sent to its
    table's row 0, as host batches (``--data-generation random``) pad;
  * K6 on the same store with a batch-4096 device batch's update rows;
  * K3 on the Terabyte-MLPerf small group's store [121,232, 128] (f32 and
    bf16) with one batch's coalesced gradient, on every small group of the
    two mixed-dimension models (dims 1 to 128) and on every group of the
    processed model (dims 64 to 512), warm and cold (``cold_ms``: the L2
    flushed before each call, chip_smoke.py's cold timer);
  * K3 on the stores that one eager train step of the MD, QR and processed
    models finishes with it (recorded from the checkout's own step): in
    one grouped launch where the checkout has one, and one launch a store,
    warm and cold;
  * K4 on the capacity config's bf16 store [53,942,848, 128] with one
    batch's 16,384 ids, SR off and on (held to its plain version bit for
    bit; the plain version syncs, so only the kernel is timed);
  * the row plan (``--only row_plan`` runs these alone): K2 at the
    training shape (chip_smoke.py phase a's ids), on one step's items of
    the benchmark's ``tb25m-train-zipf`` and ``tb25m-train-uniform`` cells
    (their rows spread over a store of 2^24 rows) and with a hot row on
    half of K at the variants' and the column slices' shapes, warm and
    cold, beside its plain version, ``index_add_`` and its bound, held to
    the plain version run on the CPU bit for bit, with the device time of
    each of its kernels on the cells' steps; K4 with the same hot row on the
    column slices;
  * K7 (``--only coalesce`` runs these alone; a checkout without K7 prints
    none): on one step's big-store bag items of the DLRM-DCNv2 cell
    (``chip_smoke.dcn_step_items``: the benchmark's generator, K =
    1,392,640), K7a + K7b (the sort, the segment sums from the pooled
    cotangent, the finish) against the torch passes they replace (the
    cotangent expanded, the plain coalesce with the gathered rows, the
    momentum and the finish on every item), and the whole route (with K4
    and K2) against the torch route, each pair in turns (K7, torch, torch,
    K7), with K7's least bytes (``8 K + 8 dim U + 8 U``) as its bound and
    the device time of each K7 kernel;
  * the captured N=16 L=1 train step (``make_multistep_train_step``) of the
    plain, MD and QR Terabyte-MLPerf models and of the processed model
    (its first batch), ms a step over CUDA events, with K3's launches a
    step; in a checkout with the grouped finish, also the processed step
    with its stores finished one at a time (a zero-fill, a scatter and a
    launch a store, in the order of a checkout before it), in turns; then each step under torch.profiler (``chip_smoke.profile_step``),
    its device time a step by kind of kernel (``STEP_KINDS``: K3, the
    zero-fills, the scatters, the rest) and in all.

A checkout whose K3 reads its lr, and K4 its SR step, from device memory
gets them as device scalars, as its train step passes them; an older one
gets a float and an int, as its train step passed them.

Kernel times are CUDA-graph replays of ``REPS`` wrapper calls, median of
``SAMPLES`` replays (K3's: 20 calls, 50 replays), CUDA events
(``chip_smoke.device_time_ms`` of this script's checkout). Needs a card;
exits 1 without one.
"""

import functools
import json
import os
import subprocess
import sys

REPS, SAMPLES = 5, 15
TOL = {"K1": 1e-5, "K3": 1e-6, "K5": 1e-6, "K6": 1e-6}  # max |kernel - plain| / max |plain|
# the captured steps' kernels by kind (names as torch 2.x gives them)
STEP_KINDS = {"K3": "dense_finish", "zero-fill": "fillfunctor",
              "scatter": "indexfunc|index_add|scatter|index_put|indexing_backward"}


HERE = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def smoke():
    """This script's chip_smoke.py (its timers, shapes and model flags),
    whichever checkout is timed: its functions import the timed checkout's
    ``dlrm_yx_tpu_torch``, first on ``sys.path``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_time_ms(fn, cold=False, reps=REPS, samples=SAMPLES):
    return smoke().device_time_ms(fn, reps, samples, cold=cold)


def finish_time_ms(fn, cold=False):
    """K3's time with chip_smoke.py's own counts: its calls take a few µs,
    where 5 replays of 5 calls leave the cold difference noisy."""
    return device_time_ms(fn, cold, reps=20, samples=50)


def eager_ms(fn, calls=200):
    """ms a call of ``calls`` eager calls between two CUDA events (after a
    warm-up): the wrapper's host cost shows where it exceeds the kernel's."""
    import torch

    for _ in range(10):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls


def by_kind(per_kernel):
    """Device ms a step of each of STEP_KINDS, of the other kernels and of
    all, from ``chip_smoke.profile_step``'s ms a step by kernel name."""
    import re

    out, seen = {}, set()
    for kind, pattern in STEP_KINDS.items():
        names = [k for k in per_kernel if k not in seen and re.search(pattern, k.lower())]
        seen.update(names)
        out[kind] = sum(per_kernel[k] for k in names)
    out["other"] = sum(v for k, v in per_kernel.items() if k not in seen)
    out["busy"] = sum(per_kernel.values())
    return out


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def run_one(repo, only=None):
    """One checkout's cases, in this process (``only="row_plan"``: the row
    plan's alone)."""
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    if only in ("row_plan", "coalesce"):
        cases = {}
        if only == "row_plan":
            row_plan_cases(cases, torch.Generator(device="cuda").manual_seed(1))
        else:
            coalesce_cases(cases)
        print(json.dumps({"repo": repo, "device": torch.cuda.get_device_name(0),
                          "cases": cases}), flush=True)
        return

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.synthetic import make_device_random_batches
    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.embedding import global_row_ids
    from dlrm_yx_tpu_torch.ops.fused_interaction import (
        fused_interaction,
        fused_interaction_reference,
    )
    from dlrm_yx_tpu_torch.ops.stream_update import (
        sorted_stream_add,
        sorted_stream_add_reference,
        sorted_stream_apply,
        sorted_stream_apply_reference,
    )
    from dlrm_yx_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    cases = {}

    def case(name, kernel, plain, fresh, tol):
        got, want = kernel(fresh()), plain(fresh())
        torch.cuda.synchronize()
        err = rel_err(got, want)
        if not err <= tol:
            raise SystemExit(f"{repo} {name}: relative error {err} > {tol}")
        held = fresh()
        cases[name] = {"rel_err": err, "ms": device_time_ms(lambda: kernel(held)),
                       "plain_ms": device_time_ms(lambda: plain(held))}
        return got

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2048, 128, device="cuda", generator=gen)
    ly = torch.randn(2048, 26, 128, device="cuda", generator=gen)
    for name, cdt in (("K1 bf16", torch.bfloat16), ("K1 f32", torch.float32)):
        case(name, lambda _, c=cdt: fused_interaction(x, ly, False, c),
             lambda _, c=cdt: fused_interaction_reference(x, ly, False, c), lambda: None,
             TOL["K1"])
        cases[name]["eager_ms"] = eager_ms(lambda c=cdt: fused_interaction(x, ly, False, c))
    del x, ly

    rows = [1_000_000] * 8
    cfg = DLRMConfig.build(emb_rows=rows, ln_bot=(512, 512, 64), ln_top=(1024, 1024, 1024, 1))
    (group,) = model_groups(cfg)
    store = torch.rand(group.total_rows, group.dim, device="cuda", generator=gen) - 0.5
    b = make_device_random_batches(rows, 512, 2048, 1, 100, seed=21, device="cuda")[0]
    gidx = global_row_ids(group, b.indices)
    offs = torch.tensor(group.row_offsets, device="cuda", dtype=gidx.dtype)[:, None, None]
    gtab = torch.randn(8 * 2048, 64, device="cuda", generator=gen) * 1e-2
    for name, ids in (("K5 benchmark stream", gidx),
                      ("K5 row-0 padding", torch.where(b.weights != 0, gidx, offs))):
        pos, perm = torch.sort(ids.reshape(-1), stable=True)
        seg = torch.div(perm, 100, rounding_mode="floor").to(torch.int32)
        w = -0.1 * b.weights.reshape(-1)[perm]
        got = case(name, lambda s: sorted_stream_apply(s, pos, seg, w, gtab),
                   lambda s: sorted_stream_apply_reference(s, pos, seg, w, gtab),
                   store.clone, TOL["K5"])
        live_rows = int(torch.unique_consecutive(pos[w != 0]).numel())
        changed = int((got != store).any(dim=1).sum())
        cases[name].update(live_rows=live_rows, changed_rows=changed, k=pos.numel(),
                           row0_run=int((pos == pos[0]).sum()))
        del got
    del gtab
    b = make_device_random_batches(rows, 512, 4096, 1, 100, seed=22, device="cuda")[0]
    pos, _ = torch.sort(global_row_ids(group, b.indices).reshape(-1), stable=True)
    upd = torch.randn(pos.numel(), 64, device="cuda", generator=gen) * 1e-2
    case("K6 batch 4096", lambda s: sorted_stream_add(s, pos, upd),
         lambda s: sorted_stream_add_reference(s, pos, upd), store.clone, TOL["K6"])
    del store, upd, pos, b
    torch.cuda.empty_cache()
    finish_cases(repo, cases, gen)
    torch.cuda.empty_cache()
    step_cases(repo, cases)
    row_update_cases(repo, cases, gen)
    print(json.dumps({"repo": repo, "device": torch.cuda.get_device_name(0), "cases": cases}),
          flush=True)


def uniform_ids(group, gen, batch=2048):
    """One batch's global row ids of a group [tables x batch], int32."""
    import torch

    offs = torch.tensor(group.row_offsets, device="cuda")[:, None]
    n = torch.tensor(group.rows, device="cuda", dtype=torch.float64)[:, None]
    u = torch.rand(group.num_tables, batch, device="cuda", dtype=torch.float64, generator=gen)
    return (offs + (u * n).long()).reshape(-1).int()


def finish_cases(repo, cases, gen):
    """K3 on single stores (the main shape, the MD small groups, the
    processed groups), warm and cold, each held to its plain version."""
    import torch

    import dlrm_yx_tpu_torch.ops.dense_finish as dense_finish
    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    cs = smoke()
    on_device = hasattr(dense_finish, "device_lr")
    lr = torch.full((), 0.01, device="cuda") if on_device else 0.01
    small, _ = cs.terabyte_groups()
    ids = uniform_ids(small, gen)
    shapes = [("K3 f32", small, ids, torch.float32), ("K3 bf16", small, ids, torch.bfloat16)]
    shapes += [(f"K3 {what}", group, ids, torch.float32)
               for what, group, ids in cs.variant_finish_shapes(cs.terabyte_rows(), gen)[0]]
    for name, group, ids, dtype in shapes:
        r, d = group.total_rows, group.dim
        g = torch.zeros(r, d, device="cuda")
        g.index_add_(0, ids.long(), torch.randn(ids.numel(), d, device="cuda", generator=gen))
        acc = torch.rand(acc_len(r), device="cuda", generator=gen)
        store = (torch.rand(r, d, device="cuda", generator=gen) - 0.5).to(dtype)
        got = dense_finish.rwsadagrad_dense_finish(store.clone(), acc.clone(), g, lr, d, 1e-10)[0]
        want = dense_finish.rwsadagrad_dense_finish_reference(store.clone(), acc.clone(), g, 0.01,
                                                              d, 1e-10)[0]
        torch.cuda.synchronize()
        err = rel_err(got, want)
        # bf16: the two sum g * g in other orders, and may round one ulp apart
        tol = TOL["K3"] if dtype == torch.float32 else 8e-3
        if not err <= tol:
            raise SystemExit(f"{repo} {name}: relative error {err} > {tol}")

        def call():
            dense_finish.rwsadagrad_dense_finish(store, acc, g, lr, d, 1e-10)

        nbytes, touched = cs.finish_bytes(store, g)
        cases[name] = {"shape": [r, d], "touched": touched, "rel_err": err,
                       "ms": finish_time_ms(call), "cold_ms": finish_time_ms(call, cold=True),
                       "plain_ms": device_time_ms(
                           lambda: dense_finish.rwsadagrad_dense_finish_reference(
                               store, acc, g, 0.01, d, 1e-10)),
                       "bound_ms": cs.bound_ms(nbytes, 0)[0]}


def step_cases(repo, cases):
    """The MD, QR and processed steps' K3 stores (one grouped launch where
    the checkout has one, and one launch a store), then the captured N=16
    train steps of the plain, MD, QR and processed models with K3's
    launches a step (with the grouped finish, also the processed step with
    a finish a store: ``store_at_a_time``), each profiled by kind."""
    import torch

    import dlrm_yx_tpu_torch.ops.dense_finish as dense_finish
    from dlrm_yx_tpu_torch.data.batch import stack_batches, to_device
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
    from dlrm_yx_tpu_torch.train import train_step
    from dlrm_yx_tpu_torch.train.train_step import make_multistep_train_step

    cs = smoke()
    rws = OptConfig("rwsadagrad", cs.LR)
    lr = torch.full((), cs.LR, device="cuda")
    rows = cs.terabyte_rows()
    first = cs.write_processed_dataset()
    models = {"plain": cs.config_of(cs.terabyte_argv(rows) + [
                  "--optimizer", "rwsadagrad", "--sparse-update-impl", "pallas"]),
              "MD": cs.config_of(cs.md_terabyte_argv(rows)),
              "QR": cs.config_of(cs.qr_terabyte_argv(rows)),
              "processed": cs.config_of(cs.processed_argv())}
    steps = {}
    for name, cfg in models.items():
        init = init_dlrm_on_device if name == "plain" else init_dlrm
        params = init(cfg, seed=0, device="cuda")
        state = init_opt_state(rws, params, model_groups(cfg))
        batch = (to_device(first, torch.device("cuda")) if name == "processed"
                 else cs.drawn_batches(cfg, 1, seed=4)[0])
        if name != "plain":
            items = cs.record_finish_stores(cfg, rws, params, state, batch)
            fns = {"one launch a store": lambda items=items: [
                dense_finish.rwsadagrad_dense_finish(s, a, g, lr, s.shape[1], 1e-10)
                for s, a, g in items]}
            if hasattr(dense_finish, "rwsadagrad_dense_finish_many"):
                fns["grouped"] = lambda items=items: dense_finish.rwsadagrad_dense_finish_many(
                    items, lr, 1e-10)
            for how, fn in fns.items():
                cases[f"K3 {name} step's stores, {how}"] = {
                    "stores": len(items), "ms": finish_time_ms(fn),
                    "cold_ms": finish_time_ms(fn, cold=True)}
            del items
        step = make_multistep_train_step(cfg, rws, cs.N_DISPATCH)
        fn = cs.train_step_fn(step, params, state, stack_batches([batch] * cs.N_DISPATCH))
        steps[name] = (fn, params, state)
        if name == "processed" and hasattr(train_step, "finish_dense"):
            # the same step with its stores finished in the order of a
            # checkout before the grouped finish, timed in turns with it
            steps["processed, a store at a time"] = (store_at_a_time(cs.train_step_fn(
                make_multistep_train_step(cfg, rws, cs.N_DISPATCH), params, state,
                stack_batches([batch] * cs.N_DISPATCH))), params, state)
    launches = {}
    for name, (fn, _, _) in steps.items():
        before = dense_finish.rwsadagrad_dense_finish.launches
        for _ in range(3):  # warm-up, capture + replay, replay
            fn()
        torch.cuda.synchronize()
        launches[name] = (dense_finish.rwsadagrad_dense_finish.launches - before) / (
            3 * cs.N_DISPATCH)
    times = cs.time_in_turns({name: fn for name, (fn, _, _) in steps.items()}, cs.check_loss)
    for name, ts in times.items():
        cases[f"captured N={cs.N_DISPATCH} {name} step"] = {
            "ms_a_step": [t / cs.N_DISPATCH for t in ts], "k3_launches_a_step": launches[name]}
    for name, (fn, _, _) in steps.items():
        per_kernel = cs.profile_step(fn, f"captured N={cs.N_DISPATCH} {name}", (),
                                     steps=cs.N_DISPATCH)
        cases[f"captured N={cs.N_DISPATCH} {name} step"]["device_ms_a_step"] = by_kind(per_kernel)
    del steps
    torch.cuda.empty_cache()


def store_at_a_time(fn):
    """``fn`` (a train step's call) with the step's grouped finish cut into
    one ``finish_dense`` call a store, as a checkout before the grouped
    finish ran it: a zero-fill, a scatter and a K3 launch a store, with
    this checkout's kernel. Patched around every call (only the calls up to
    the capture read it)."""
    from dlrm_yx_tpu_torch.train import train_step

    grouped = train_step.finish_dense

    def one_by_one(collected, lr, eps):
        for item in collected:
            grouped([item], lr, eps)

    def call():
        train_step.finish_dense = one_by_one
        try:
            return fn()
        finally:
            train_step.finish_dense = grouped

    return call


def row_update_cases(repo, cases, gen):
    """K4, called as this checkout's train step calls it."""
    import torch

    import dlrm_yx_tpu_torch.ops.dense_finish as dense_finish
    import dlrm_yx_tpu_torch.ops.sparse_rows_add as rows_add
    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.models.dlrm import model_groups

    on_device = hasattr(dense_finish, "device_lr")
    _, big = model_groups(DLRMConfig.terabyte_mlperf(max_ind_range=10_000_000))
    store = torch.empty(big.total_rows, big.dim, dtype=torch.bfloat16, device="cuda").uniform_(
        -0.5, 0.5, generator=gen)
    ids = uniform_ids(big, gen)
    upd = torch.randn(ids.numel(), big.dim, device="cuda", generator=gen) * 1e-2
    active = torch.ones(ids.numel(), dtype=torch.int32, device="cuda")
    seed = torch.full((), 7, dtype=torch.int64, device="cuda") if on_device else 7
    for sr in (False, True):
        got = rows_add.sparse_rows_add(store.clone(), ids, upd, active, sr, seed)
        want = rows_add.sparse_rows_add_reference(store.clone(), ids, upd, active, sr, 7)
        equal = torch.equal(got.view(torch.int16), want.view(torch.int16))
        del got, want
        if not equal:
            raise SystemExit(f"{repo} K4 SR={sr}: the kernel and its plain version differ")
        cases[f"K4 capacity bf16{', SR' if sr else ''}"] = {
            "bit_equal": equal, "ms": device_time_ms(
                lambda: rows_add.sparse_rows_add(store, ids, upd, active, sr, seed))}


ZIPF_BIG_TABLES = (0, 9, 10, 11, 19, 20, 21, 22)  # the 25M-cap model's tables past 65,536 rows
SPREAD_ROWS = 1 << 24


def cell_step_ids(traffic, seed):
    """One step's K2 items of a ``tb25m-train-*`` cell (the benchmark's own
    generator and configuration; 8 big tables x 2048), their distinct rows
    spread at random over SPREAD_ROWS rows: the same duplicates, in a store
    about an eighth the size of the cell's big group."""
    import numpy as np
    import torch

    from benchmark.generate import make_batches

    conf = json.load(open(os.path.join(HERE, "benchmark/configs/mlperf-dlrm-tb-25m.json")))
    mix = json.load(open(os.path.join(HERE, f"benchmark/traffic/{traffic}.json")))
    (b,) = make_batches(mix, conf["raw_rows"], 25_000_000, 2048, 1, seed)
    ids = b[1][list(ZIPF_BIG_TABLES), :, 0].astype(np.int64)
    ids = (ids + np.arange(len(ZIPF_BIG_TABLES))[:, None] * 25_000_000).reshape(-1)
    uniq, inv = np.unique(ids, return_inverse=True)
    rows = np.random.default_rng(seed).choice(SPREAD_ROWS, size=uniq.size, replace=False)
    return torch.from_numpy(rows[inv].astype(np.int32)).cuda()


def k2_needs(ids, active, w):
    """(bytes, operations) K2 needs for these items (chip_smoke.py phase
    a's count): ids and flags read; each unique row's new values read and
    the row written; each duplicate's delta read, its row read and
    written once; one add an element of a duplicate."""
    import torch

    _, counts = torch.unique(ids[active > 0].long(), return_counts=True)
    n_once = int((counts == 1).sum())
    dup = counts[counts > 1]
    row = 4 * w
    return (8 * ids.numel() + 2 * row * n_once + row * int(dup.sum()) + 2 * row * dup.numel(),
            w * int(dup.sum()))


def row_plan_cases(cases, gen):
    """K2 (and K4 on the column slices) at the row plan's shapes; see the
    module's docstring."""
    import torch

    from dlrm_yx_tpu_torch.ops import sparse_rows_add as rows_add
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import (
        CLIP_MARGIN,
        sparse_rows_overwrite,
        sparse_rows_overwrite_reference,
    )

    cs = smoke()

    def hot(rows, k):
        ids = torch.randint(0, rows - CLIP_MARGIN - 1, (k,), device="cuda", generator=gen,
                            dtype=torch.int32)
        ids[::2] = ids[0]
        return ids

    _, big = cs.terabyte_groups()
    train_ids = cs.batch_rows(big, gen)
    shapes = [  # (case, rows, width, ids, active)
        ("K2 training shape", big.total_rows, big.dim, train_ids,
         (torch.rand(train_ids.numel(), device="cuda", generator=gen) > 0.2).int()),
        ("K2 tb25m-train-zipf step", SPREAD_ROWS + CLIP_MARGIN + 1, 128,
         cell_step_ids("train-zipf", 1), None),
        ("K2 tb25m-train-uniform step", SPREAD_ROWS + CLIP_MARGIN + 1, 128,
         cell_step_ids("train-uniform", 1), None),
        ("K2 W=1 [33,719,296, 1] K=1,024, hot row", 33_719_296, 1, hot(33_719_296, 1024), None),
        ("K2 W=2 [6,990,848, 2], hot row", 6_990_848, 2, hot(6_990_848, 16384), None),
        ("K2 W=4 [6,990,848, 4], hot row", 6_990_848, 4, hot(6_990_848, 16384), None),
        ("K2 column slice [6,989,304, 64], hot row", 6_989_304, 64, hot(6_989_304, 16384), None),
        ("K2 column slice [6,989,320, 32], hot row", 6_989_320, 32, hot(6_989_320, 16384), None),
    ]
    for name, rows, w, ids, active in shapes:
        if active is None:
            active = torch.ones(ids.numel(), dtype=torch.int32, device="cuda")
        store = torch.rand(rows, w, device="cuda", generator=gen) - 0.5
        delta = torch.randn(ids.numel(), w, device="cuda", generator=gen) * 1e-2
        new_vals = store[ids.long()] + delta
        got = sparse_rows_overwrite(store.clone(), ids, new_vals, delta, active)
        uniq, inv = torch.unique(ids.long(), return_inverse=True)
        want = torch.cat([store[uniq], store.new_zeros(CLIP_MARGIN + 1, w)]).cpu()
        sparse_rows_overwrite_reference(want, inv.int().cpu(), new_vals.cpu(), delta.cpu(),
                                        active.cpu())
        equal = torch.equal(got[uniq].cpu().view(torch.int32),
                            want[:uniq.numel()].view(torch.int32))
        del got, want
        if not equal:
            raise SystemExit(f"{name}: the kernel and its plain version on the CPU differ")
        nbytes, flops = k2_needs(ids, active, w)

        def fn(store=store, ids=ids, new_vals=new_vals, delta=delta, active=active):
            sparse_rows_overwrite(store, ids, new_vals, delta, active)

        masked, ids64 = delta * active[:, None], ids.long()
        case = cases[name] = {
            "k": ids.numel(), "bit_equal": equal, "ms": device_time_ms(fn),
            "cold_ms": device_time_ms(fn, cold=True),
            "plain_ms": device_time_ms(lambda: sparse_rows_overwrite_reference(
                store, ids, new_vals, delta, active)),
            "library_ms": device_time_ms(lambda: store.index_add_(0, ids64, masked)),
            "bound_ms": cs.bound_ms(nbytes, flops)[0]}
        if name.endswith("step"):
            per_kernel = cs.profile_step(fn, name, ())
            case["kernels_ms"] = {k[:80]: v for k, v in per_kernel.items() if "row_plan" in k}
        if name.startswith("K2 column slice"):
            upd = delta.clone()
            k4 = cases[name.replace("K2", "K4", 1) + ", f32"] = {
                "ms": device_time_ms(lambda: rows_add.sparse_rows_add(store, ids, upd, active)),
                "cold_ms": device_time_ms(
                    lambda: rows_add.sparse_rows_add(store, ids, upd, active), cold=True)}
            # ids and flags read, each item's update row read, each touched
            # row read and written once
            n_rows = int(torch.unique(ids[active > 0]).numel())
            live = int((active > 0).sum())
            k4["bound_ms"] = cs.bound_ms(8 * ids.numel() + 4 * w * (live + 2 * n_rows),
                                         w * live)[0]
            del upd
        del store, delta, new_vals, masked, ids64
        torch.cuda.empty_cache()


def coalesce_cases(cases):
    """K7 against the torch passes it replaces; see the module's docstring."""
    import torch

    try:
        from dlrm_yx_tpu_torch.ops.coalesce import (
            coalesce_finish,
            coalesce_rows_reference,
            coalesce_segments,
        )
    except ImportError:  # a checkout without K7
        return
    from dlrm_yx_tpu_torch.optim import optimizer as opt_mod
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len

    cs = smoke()
    flat_idx, grads, rows = cs.dcn_step_items(1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    store = torch.rand(rows, 128, device="cuda", generator=gen) * 0.1 - 0.05
    acc = torch.rand(acc_len(rows), device="cuda", generator=gen) * 0.1
    old = store.index_select(0, flat_idx)
    lr = torch.tensor(0.005, device="cuda")
    opt = OptConfig("rwsadagrad", 0.005)
    k, d = flat_idx.numel(), 128
    u = int(torch.unique(flat_idx).numel())

    def k7():
        seg = coalesce_segments(flat_idx, grads, rows, mdim=d, zero_tail=False)
        coalesce_finish(acc, seg, old, lr, opt.eps, rows)

    def torch_span():
        ids, sg, old_rep = coalesce_rows_reference(flat_idx, grads.expand(), rows, aux=old)
        active = (ids < rows).to(torch.int32)
        safe = torch.where(active > 0, ids, rows)
        _ = ((sg * sg).sum(dim=-1) / d) * active
        denom = opt_mod._take_fill(acc, safe, 1.0, rows).sqrt() + opt.eps
        delta = -lr * sg / denom[:, None]
        _ = old_rep + delta

    def k7_route():
        opt_mod._coalesced_overwrite(opt, store, acc, flat_idx, grads, lr, rows, "pallas", old)

    def torch_route():
        cs.torch_coalesce_route(store, acc, flat_idx, grads.expand(), old, lr, rows)

    k7_bytes = 8 * k + 8 * d * u + 8 * u
    # K2: ids and flags, each row's new values read and the row written; K4:
    # ids and flags, each row's increment read, its momentum read and written
    route_bytes = k7_bytes + (8 * k + 2 * 4 * d * u) + (8 * k + 3 * 4 * u)
    for name, fns, nbytes in (("K7a + K7b vs the torch passes", (k7, torch_span), k7_bytes),
                              ("K7 route vs the torch route", (k7_route, torch_route),
                               route_bytes)):
        a, b = fns
        times = {"k7": [], "torch": []}
        for side, fn in (("k7", a), ("torch", b), ("torch", b), ("k7", a)):
            times[side].append(device_time_ms(fn))
            torch.cuda.empty_cache()
        cases[name] = {"k": k, "rows": u, "ms": times["k7"], "torch_ms": times["torch"],
                       "bound_bytes": nbytes, "bound_ms": cs.bound_ms(nbytes, 0)[0]}
    per_kernel = cs.profile_step(k7_route, "K7 route", ())
    cases["K7 route vs the torch route"]["kernels_ms"] = {
        kname[:80]: v for kname, v in per_kernel.items()
        if "coalesce_rows" in kname or "row_plan" in kname or "sort" in kname.lower()}


def main():
    args = sys.argv[1:]
    only = None
    if args[:1] == ["--only"]:
        only, args = args[1], args[2:]
    if args[:1] == ["--one"]:
        return run_one(args[1], only)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this needs the card", flush=True)
        sys.exit(1)
    repos = args or [os.path.dirname(os.path.abspath(__file__))]
    order = repos if len(repos) == 1 else repos + repos[::-1]
    for repo in order:
        subprocess.run([sys.executable, os.path.abspath(__file__)]
                       + (["--only", only] if only else []) + ["--one", repo], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
