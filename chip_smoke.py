"""Smoke run of the PyTorch/CUDA port (dlrm_yx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure prints FAIL, exits non-zero and prints
no result):
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: every kernel under dlrm_yx_tpu_torch/csrc, compiled with nvcc;
  3. kernel: K1 (fused interaction) against its plain PyTorch version on the
     card at the serving path's shapes, with its time, the plain version's
     and the least time the card could take (the bound);
  a. kernel: K2 (sparse_rows_overwrite) and K3 (rwsadagrad_dense_finish)
     against their plain versions at the training path's shapes, with the
     same numbers and, for K2, one PyTorch call's (``index_add_``); then K2
     on more traffic (TRAFFIC: all rows unique, a hot row on half of K, all
     K on one row, a skewed stream, no active item, K=1, K=32,768), each
     against the plain version run on the CPU over the touched rows (where
     ``index_add_`` adds in item order, as the kernel does), with its time;
  f. kernel: K5 (sorted_stream_apply) and K6 (sorted_stream_add) against
     their plain versions on the reference benchmark's store (8 x 1M rows
     x 64 f32) with one device batch's sorted occurrences (K5 at batch 2048,
     K6 at batch 4096, the shapes their paths give them), with the same
     numbers and, for K6, ``index_add_``'s; then K5 on the same batch with
     every weight-0 id on its table's row 0 (as host batches pad), with
     every weight 0, with non-finite grad rows under weight-0 items only
     (the NaN rows must match), and on a store with -0.0 elements (the
     elements that keep -0.0 are counted, not failed); and one K5 call
     captured in a CUDA graph and replayed on a fresh stream, against the
     eager call bit for bit;
  4. serve: ``dlrm_yx_tpu_torch.cli.main --inference-only`` on the full-width
     Terabyte-MLPerf DLRM (26 tables capped at 1M rows, dim 128, batch 2048,
     bf16, --interaction-impl pallas), with the launch counts set to 0 just
     before and read just after;
  b. train: the training main path, ``cli.main`` without --inference-only on
     the same model (rwsadagrad, --sparse-update-impl pallas, a few
     batches, then an eval), with the launch counts set to 0 just before
     and read just after: K2 and K3 once per step, K1 once per step and eval
     batch; finite losses; the touched rows of the big store changed;
  g. train-l100: the reference benchmark's command line
     (bench/dlrm_tpu_benchmark.sh: 8 tables of 1M rows x 64, L=100, batch
     2048, SGD, --sparse-update-impl pallas, random-device data) through
     ``cli.main``, a few steps and an eval: K5 once per step, nothing else;
     finite losses; the big store changed where live lookups touched it;
  h. train-l100: the same model with RWSAdagrad, --sparse-update-impl stream
     and batch 4096, whose grad table is over the K5 budget: K6 once per
     step, nothing else;
  5. reference: the eval step on the card against the same step on the CPU
     (the kernels' plain versions) on a small model;
  c. reference: three train steps on the card against the CPU on a small
     two-group model, routed through K2 and K3;
  i. reference: the same on a small L=100 model through K5, and through K6
     with the grad-table budget at 1 byte;
  6. throughput: the eval step at full width, CUDA-event timed, with the
     fused kernel and with the plain interaction, in turns;
  d. throughput: the train step at full width, CUDA-event timed over 20
     steps after warm-up, with either interaction, in turns;
  j. throughput: the L=100 train step at batch 2048, SGD pallas (the
     benchmark) and RWSAdagrad stream, in turns;
  7. profile: a torch.profiler window over the serving step: device busy
     share and the kernels that take the time;
  e. profile: a torch.profiler window over the train step;
  k. profile: the same over both L=100 steps, with the device time by kind
     of kernel (K5, sort, gather, scatter, GEMM);
  l. kernel: K4 (sparse_rows_add) against its plain version, bit for bit, at
     the capacity config's shapes (bench/capacity_demo.py: Terabyte-MLPerf
     capped at 10M rows, bf16 stores): its bf16 big store [53,942,848, 128]
     with one batch's 16,384 ids, SR off and on; the f32 1-D momentum of that
     group viewed as [len, 1]; and the 1M-capped f32 store of phase a (the
     --no-write-only-update route), with ``index_add_`` on the f32 routes;
     then the bf16 store with SR on phase a's traffic and on items that
     all share one 8-row unit, bit for bit, each with its time;
  m. train-bf16: phase b's CLI run with --emb-dtype bfloat16
     --stochastic-rounding: K4 and K3 once per step, K1 per step and eval
     batch, K2 never; no big-store row that no live lookup touched changed
     by a single bit;
  n. capacity: the bench/capacity_demo.py analog through make_train_step
     (device init of the 13.8 GB bf16 store, RWSAdagrad lr 0.01, bf16
     compute, the uniform-stream density hint, B=2048, L=1): K4 twice and K3
     once per step (the big store and its 206 MiB momentum), then timed with
     SR off and on in turns;
  o. reference: three train steps on the card against the CPU on phase c's
     model with both K4 gates at 0: a bf16 store with SR off and on, f32
     with write_only_update off, and Adagrad on the kernel route;
  p. profile: the capacity step, with the device time by kind of kernel;
  q. ops: the device operations (kernels, memsets, copies) of one K2 and
     one K4 wrapper call at each main-path shape, counted with
     torch.profiler (at most 5, no sort), and of one K1 call (bf16 and f32:
     one kernel) and one K5 call (at most 5, no sort, no host sync).
Then a JSON line of the kernels (launches from the path each kernel serves:
K1-K3 phase b, K5 phase g, K6 phase h, K4 phase m), nvidia-smi's line, and
the result line.

Bound: bytes each input read once and each output written once over
3.35 TB/s, or operations over the card's peak for their type (67 TFLOP/s
f32 outside the tensor cores), whichever is larger (H100 SXM data sheet).
Where the work depends on the data (K2's duplicates and inactive items,
K3's untouched rows, the distinct rows K6 and K4 update and those K5
updates with a nonzero weight), the bytes are those this run's inputs need.
"""

import json
import statistics
import subprocess
import sys
import time

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
N_SERVE_BATCHES = 4
N_TRAIN_BATCHES = 4  # the training run's steps; its eval takes as many batches
BATCH = 2048
LR = 0.01


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_time_ms(fn, reps=20, samples=50):
    """Median device time of one fn() call: fn is captured ``reps`` times
    into a CUDA graph, and each of ``samples`` replays is timed with CUDA
    events, so the host's per-call overhead is not in the number."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def bound_ms(nbytes, flops):
    """The least time for the work: bytes over HBM's rate or f32 operations
    over the f32 rate, whichever is larger, and which of the two it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def interaction_bound_ms(b, s, d, p):
    return bound_ms(4 * (b * d + b * s * d + b * (d + p)), 2 * b * p * d)


def check_interaction_kernel():
    """Phase 3: K1 against its plain version; returns the serving shape's row."""
    import torch

    from dlrm_yx_tpu_torch.ops.fused_interaction import (
        fused_interaction,
        fused_interaction_reference,
        num_pairs,
    )

    cases = [  # (B, S, D, interact_itself, compute dtype); the first is the serving shape
        (BATCH, 26, 128, False, torch.bfloat16),
        (BATCH, 26, 128, False, torch.float32),   # the f32 register route (F = 27, D = 128)
        (128, 26, 128, True, torch.float32),
        (128, 7, 128, True, torch.float32),       # the f32 tiles
        (128, 2, 256, False, torch.float32),
        (128, 9, 128, True, torch.bfloat16),
    ]
    tol = 1e-5  # max |kernel - plain| over max |plain|: both sum in f32, in other orders
    row = None
    for b, s, d, itself, cdt in cases:
        gen = torch.Generator(device="cuda").manual_seed(b + s + d)
        x = torch.randn(b, d, device="cuda", generator=gen)
        ly = torch.randn(b, s, d, device="cuda", generator=gen)
        got = fused_interaction(x, ly, itself, cdt)
        want = fused_interaction_reference(x, ly, itself, cdt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if got.shape != want.shape or not rel <= tol or not torch.equal(got[:, :d], x):
            fail(f"fused_interaction {b}x{s}x{d} itself={itself} {cdt}: "
                 f"max abs err {err}, relative {rel} > {tol}")
        ms = device_time_ms(lambda: fused_interaction(x, ly, itself, cdt))
        plain_ms = device_time_ms(lambda: fused_interaction_reference(x, ly, itself, cdt))
        bound_ms, bound_by = interaction_bound_ms(b, s, d, num_pairs(s + 1, itself))
        say("kernel", f"fused_interaction B={b} S={s} D={d} itself={itself} {cdt}: "
                      f"max_abs_err {err:.3e} (relative {rel:.3e} <= {tol}), "
                      f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
                      f"bound {bound_ms:.5f} ms ({bound_by})")
        if row is None:
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
    return row


def serve_main_path(rows):
    """Phase 4: the CLI serving run; returns the kernels' launch counts."""
    import math

    from dlrm_yx_tpu_torch import cli

    argv = terabyte_argv(rows) + ["--num-batches", str(N_SERVE_BATCHES), "--inference-only"]
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    metrics = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    for key in ("accuracy", "roc_auc", "streaming_auc"):
        if not math.isfinite(metrics[key]):
            fail(f"serving metric {key} = {metrics[key]} is not finite")
    want = only(fused_interaction=N_SERVE_BATCHES)
    if launches != want:
        fail(f"serving run launched {launches}, want {want}")
    say("serve", f"cli --inference-only, 26 tables <=1M rows x 128, B={BATCH}, bf16, "
                 f"pallas interaction: {N_SERVE_BATCHES} batches in {seconds:.1f} s "
                 f"(host init and data included); accuracy {metrics['accuracy']:.6f}, "
                 f"roc_auc {metrics['roc_auc']:.6f}, streaming_auc "
                 f"{metrics['streaming_auc']:.6f}; launches {launches}")
    return launches


def check_against_cpu():
    """Phase 5: the eval step on the card (kernel) vs on the CPU (plain)."""
    import torch

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm
    from dlrm_yx_tpu_torch.train.train_step import make_eval_step

    # bf16: the card's tensor-core GEMM and the CPU's upcast GEMM sum in
    # other orders, and a bf16 rounding of an activation can flip on that
    tols = {"float32": 1e-5, "bfloat16": 2e-2}
    for cdt, tol in tols.items():
        cfg = DLRMConfig.build(
            emb_rows=(100, 200, 1000, 37), ln_bot=(13, 64, 128), ln_top=(64, 1),
            emb_split_threshold=150, loss="bce", compute_dtype=cdt,
            interaction_impl="pallas",
        )
        batch = make_random_batches(RandomDataConfig(
            emb_rows=cfg.emb_rows, m_den=13, mini_batch_size=128, num_batches=1,
        ))[0]
        cpu_params = init_dlrm(cfg, seed=7, device="cpu")
        gpu_params = init_dlrm(cfg, seed=7, device="cuda")
        p_cpu, l_cpu = make_eval_step(cfg, "cpu")(cpu_params, batch)
        p_gpu, l_gpu = make_eval_step(cfg, "cuda")(gpu_params, batch)
        err = (p_gpu.cpu() - p_cpu).abs().max().item()
        lerr = abs(l_gpu.item() - l_cpu.item())
        if not (err <= tol and lerr <= tol * max(1.0, abs(l_cpu.item()))):
            fail(f"eval step on the card vs the CPU ({cdt}): preds {err}, loss {lerr} > {tol}")
        say("reference", f"eval step card vs CPU, {cdt}: max |pred diff| {err:.3e}, "
                         f"|loss diff| {lerr:.3e} (tol {tol})")


def serving_throughput(rows):
    """Phase 6: eval steps at full width on device-drawn params and batch."""
    import dataclasses
    import math

    import torch

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.batch import Batch
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device
    from dlrm_yx_tpu_torch.train.train_step import make_eval_step

    cfg = DLRMConfig.build(
        emb_rows=rows, ln_bot=(13, 512, 256, 128), ln_top=(1024, 1024, 512, 256, 1),
        loss="bce", compute_dtype="bfloat16", interaction_impl="pallas",
    )
    params = init_dlrm_on_device(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_t = torch.tensor(rows, device="cuda", dtype=torch.float32)[:, None, None]
    batch = Batch(
        torch.rand(BATCH, 13, device="cuda", generator=gen),
        (torch.rand(len(rows), BATCH, 1, device="cuda", generator=gen) * rows_t).int(),
        torch.ones(len(rows), BATCH, 1, device="cuda"),
        (torch.rand(BATCH, 1, device="cuda", generator=gen) > 0.5).float(),
    )
    steps = {impl: make_eval_step(dataclasses.replace(cfg, interaction_impl=impl))
             for impl in ("pallas", "xla")}

    def check(impl, out):
        preds, loss = out
        if not math.isfinite(loss.item()) or not torch.isfinite(preds).all():
            fail(f"serving step ({impl}) gave non-finite output")

    times = time_in_turns({impl: (lambda s=s: s(params, batch)) for impl, s in steps.items()},
                          check)
    for impl, ts in times.items():
        ms = statistics.mean(ts)
        say("throughput", f"eval step, interaction {impl}: {ms:.4f} ms/step "
                          f"({BATCH / ms * 1e3:.0f} examples/s; runs {ts})")
    return steps["pallas"], params, batch


def profile_step(run_once, what, phases):
    """Phases 7 and e: where a step's device time goes. Returns the device
    ms per step of each kernel by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run_once()
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type.name == "CUDA" and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    say("profile", f"{n} {what} steps under torch.profiler: wall {wall_ms:.4f} ms/step, "
                   f"kernels busy {device_ms:.4f} ms/step "
                   f"(device idle share {max(0.0, 1 - device_ms / wall_ms):.3f})")
    for name in phases:
        host = sum(e.cpu_time_total for e in avgs
                   if e.key == name and e.device_type.name == "CPU")
        span = sum(e.self_device_time_total for e in avgs
                   if e.key == name and e.device_type.name == "CUDA")
        say("profile", f"  phase {name}: host {host / 1e3 / n:.5f} ms/step, "
                       f"device span {span / 1e3 / n:.5f} ms/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        say("profile", f"  kernel {e.self_device_time_total / 1e3 / n:.5f} ms/step "
                       f"x{e.count // n} {e.key[:90]}")
    return {e.key: e.self_device_time_total / 1e3 / n for e in kernels}


def terabyte_groups():
    """The Terabyte-MLPerf model's (small, big) table groups at 1M rows."""
    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.models.dlrm import model_groups

    small, big = model_groups(DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000))
    assert small.size_class == 0 and big.size_class == 1
    return small, big


TRAFFIC = ("all rows unique", "a hot row on half of K", "all K on one row",
           "skewed: 30% of K on 10 rows", "no active item", "K=1", "K=32768 (B=4096)")
TRAFFIC_REPS = 5  # graph replays of 5 calls: the one-row cases take ms a call


def traffic(group, gen, case):
    """(ids [K] int32, active [K] int32) on the card: one of TRAFFIC, or
    "one 8-row unit", over the group's live rows."""
    import torch

    if case == "K=32768 (B=4096)":
        ids = batch_rows(group, gen, 2 * BATCH, repeats=False)
    else:
        ids = batch_rows(group, gen, repeats=False)
    k = ids.numel()
    active = torch.ones(k, dtype=torch.int32, device="cuda")
    if case == "all rows unique":
        ids = torch.randperm(group.total_rows - 8, device="cuda", generator=gen)[:k].int()
    elif case == "a hot row on half of K":
        ids[::2] = ids[0]
    elif case == "all K on one row":
        ids[:] = ids[0]
    elif case == "skewed: 30% of K on 10 rows":
        hot = ids[torch.randint(0, 10, (k,), device="cuda", generator=gen)]
        ids = torch.where(torch.rand(k, device="cuda", generator=gen) < 0.3, hot, ids)
    elif case == "no active item":
        active.zero_()
    elif case == "K=1":
        ids, active = ids[:1].clone(), active[:1].clone()
    elif case == "one 8-row unit":
        ids = ids[0] // 8 * 8 + torch.randint(0, 8, (k,), device="cuda", generator=gen,
                                              dtype=torch.int32)
    return ids, active


def overwrite_plain_on_cpu(store, ids, new_vals, delta, active):
    """(rows, their values): K2's plain version run on the CPU, where
    index_add_ adds a row's duplicates in item order, over a copy of just
    the rows that the items name (and the sentinel margin)."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import (
        CLIP_MARGIN,
        sparse_rows_overwrite_reference,
    )

    rows, inv = torch.unique(ids.long(), return_inverse=True)
    sub = torch.cat([store[rows], store.new_zeros(CLIP_MARGIN + 1, store.shape[1])]).cpu()
    sparse_rows_overwrite_reference(sub, inv.int().cpu(), new_vals.cpu(), delta.cpu(),
                                    active.cpu())
    return rows, sub[:rows.numel()].to("cuda")


def check_overwrite_traffic(big, store, gen, tol):
    """Phase a, K2 on TRAFFIC: the kernel against its plain version on the
    CPU, the rows that no item names untouched, and the wrapper's time."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite

    r, w = store.shape
    for case in TRAFFIC:
        ids, active = traffic(big, gen, case)
        k = ids.numel()
        delta = torch.randn(k, w, device="cuda", generator=gen) * 1e-2
        new_vals = store[ids.long()] + delta
        got = sparse_rows_overwrite(store.clone(), ids, new_vals, delta, active)
        torch.cuda.synchronize()
        rows, want = overwrite_plain_on_cpu(store, ids, new_vals, delta, active)
        err = (got[rows] - want).abs().max().item()
        named = torch.zeros(r, dtype=torch.bool, device="cuda")
        named[rows] = True
        stray = int(((got != store).any(dim=1) & ~named).sum().item())
        del got
        if not err <= tol or stray:
            fail(f"sparse_rows_overwrite, {case}: max abs err {err} > {tol} against the plain "
                 f"version on the CPU, or {stray} rows that no item names changed")
        ms = device_time_ms(lambda: sparse_rows_overwrite(store, ids, new_vals, delta, active),
                            reps=TRAFFIC_REPS, samples=TRAFFIC_REPS)
        say("kernel", f"  sparse_rows_overwrite, {case}: K={k}, {int(active.sum())} active on "
                      f"{rows.numel()} rows: max_abs_err {err:.3e} against the plain version "
                      f"on the CPU (tol {tol}); wrapper {ms:.5f} ms")


def check_overwrite_kernel(big):
    """Phase a, K2: on a store of the big group's shape, one batch's K items
    (8 tables x 2048) with a run of forced duplicates and ~20% inactive,
    then on TRAFFIC."""
    import numpy as np
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import (
        sparse_rows_overwrite,
        sparse_rows_overwrite_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(11)
    r, w, k = big.total_rows, big.dim, big.num_tables * BATCH
    store = torch.rand(r, w, device="cuda", generator=gen) - 0.5
    idx = (torch.rand(k, device="cuda", generator=gen) * (r - 8)).int()
    idx[1000:1016] = idx[999]
    active = (torch.rand(k, device="cuda", generator=gen) > 0.2).int()
    delta = torch.randn(k, w, device="cuda", generator=gen) * 1e-2
    new_vals = store[idx.long()] + delta
    got = sparse_rows_overwrite(store.clone(), idx, new_vals, delta, active)
    want = sparse_rows_overwrite_reference(store.clone(), idx, new_vals, delta, active)
    torch.cuda.synchronize()
    # duplicates add in item order in the kernel, in atomic order in the
    # plain version's index_add_
    tol = 1e-6
    err = (got - want).abs().max().item()
    changed = (got != store).any(dim=1).sum().item()
    del got, want
    ids = idx.cpu().numpy()[active.cpu().numpy() > 0]
    _, counts = np.unique(ids, return_counts=True)
    n_once, n_dup_rows = int((counts == 1).sum()), int((counts > 1).sum())
    n_dup_items = int(counts[counts > 1].sum())
    if not err <= tol or changed != n_once + n_dup_rows:
        fail(f"sparse_rows_overwrite: max abs err {err} > {tol}, or {changed} rows "
             f"changed for {n_once + n_dup_rows} live rows")
    ms = device_time_ms(lambda: sparse_rows_overwrite(store, idx, new_vals, delta, active))
    plain_ms = device_time_ms(
        lambda: sparse_rows_overwrite_reference(store, idx, new_vals, delta, active))
    masked, idx64 = delta * active[:, None], idx.long()
    library_ms = device_time_ms(lambda: store.index_add_(0, idx64, masked))
    # ids and flags read; each unique row's new values read and the row
    # written; each duplicate's delta read, its row read and written once
    row = 4 * w
    nbytes = 8 * k + 2 * row * n_once + row * n_dup_items + 2 * row * n_dup_rows
    bound, by = bound_ms(nbytes, w * n_dup_items)
    say("kernel", f"sparse_rows_overwrite store [{r}, {w}] f32, K={k} ({n_once} unique "
                  f"live rows, {n_dup_items} items on {n_dup_rows} duplicated rows, "
                  f"{k - len(ids)} inactive): max_abs_err {err:.3e} (tol {tol}), "
                  f"wrapper (plan + apply + tail, CUDA graph) {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, index_add_ {library_ms:.5f} ms, bound {bound:.5f} ms "
                  f"({by}, {nbytes} B)")
    del masked, idx64
    check_overwrite_traffic(big, store, gen, tol)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


def check_finish_kernel(small):
    """Phase a, K3: the small group's store, f32 and bf16, a padded
    accumulator, and the coalesced gradient of one batch (18 tables x
    2048 uniform ids); returns the f32 row (the training path's store)."""
    import torch

    from dlrm_yx_tpu_torch.ops.dense_finish import (
        rwsadagrad_dense_finish,
        rwsadagrad_dense_finish_reference,
    )
    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    gen = torch.Generator(device="cuda").manual_seed(12)
    r, w = small.total_rows, small.dim
    offs = torch.tensor(small.row_offsets, device="cuda")[:, None]
    n = torch.tensor(small.rows, device="cuda", dtype=torch.float32)[:, None]
    ids = (offs + (torch.rand(small.num_tables, BATCH, device="cuda", generator=gen)
                   * n).long()).reshape(-1)
    dense_g = torch.zeros(r, w, device="cuda")
    dense_g.index_add_(0, ids, torch.randn(ids.numel(), w, device="cuda", generator=gen))
    touched = int((dense_g != 0).any(dim=1).sum().item())
    acc = torch.rand(acc_len(r), device="cuda", generator=gen)
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        store = (torch.rand(r, w, device="cuda", generator=gen) - 0.5).to(dtype)
        got_s, got_a = rwsadagrad_dense_finish(store.clone(), acc.clone(), dense_g, LR, w,
                                               1e-10)
        want_s, want_a = rwsadagrad_dense_finish_reference(store.clone(), acc.clone(),
                                                           dense_g, LR, w, 1e-10)
        torch.cuda.synchronize()
        # both sum g*g in f32 in other orders; a bf16 store may then round
        # one ulp apart (2^-8 of the value)
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
        err = (got_s.float() - want_s.float()).abs().max().item()
        aerr = (got_a - want_a).abs().max().item()
        if not (err <= tol and aerr <= 1e-6 and torch.equal(got_a[r:], acc[r:])):
            fail(f"rwsadagrad_dense_finish {dtype}: store err {err} > {tol} or acc err "
                 f"{aerr} > 1e-6, or the accumulator's padding changed")
        ms = device_time_ms(lambda: rwsadagrad_dense_finish(store, acc, dense_g, LR, w, 1e-10))
        plain_ms = device_time_ms(
            lambda: rwsadagrad_dense_finish_reference(store, acc, dense_g, LR, w, 1e-10))
        # the gradient read whole; each touched row's store read and
        # written and its accumulator entry read and written
        esize = store.element_size()
        nbytes = 4 * r * w + touched * (2 * esize * w + 8)
        bound, by = bound_ms(nbytes, touched * 5 * w)
        say("kernel", f"rwsadagrad_dense_finish store [{r}, {w}] {dtype}, acc "
                      f"{acc.numel()}, {touched} rows touched: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}), acc err {aerr:.3e}, kernel {ms:.5f} ms, plain "
                      f"{plain_ms:.5f} ms, bound {bound:.5f} ms ({by}, {nbytes} B)")
        if row is None:
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by,
                   # no single PyTorch call does a row-wise Adagrad step
                   "library_ms": None}
    return row


def terabyte_argv(rows):
    return [
        "--arch-embedding-size", "-".join(map(str, rows)),
        "--arch-sparse-feature-size", "128",
        "--arch-mlp-bot", "13-512-256-128",
        "--arch-mlp-top", "1024-1024-512-256-1",
        "--data-generation", "random", "--mini-batch-size", str(BATCH),
        "--num-indices-per-lookup", "1", "--loss-function", "bce",
        "--compute-dtype", "bfloat16", "--interaction-impl", "pallas",
        "--mlperf-logging",
    ]


def launch_counters():
    from dlrm_yx_tpu_torch.ops.dense_finish import rwsadagrad_dense_finish
    from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
    from dlrm_yx_tpu_torch.ops.stream_update import sorted_stream_add, sorted_stream_apply

    return {"fused_interaction": fused_interaction,
            "sparse_rows_overwrite": sparse_rows_overwrite,
            "rwsadagrad_dense_finish": rwsadagrad_dense_finish,
            "sorted_stream_apply": sorted_stream_apply,
            "sorted_stream_add": sorted_stream_add,
            "sparse_rows_add": sparse_rows_add}


def only(**launched):
    """A launch-count dict: the named kernels' counts, every other kernel 0."""
    return {name: launched.get(name, 0) for name in launch_counters()}


def cli_training_run(phase, what, argv, n_steps, want, big_index):
    """A CLI training run (``cli.main`` without --inference-only: n_steps
    steps, then an eval of as many batches), with the launch counts set to
    0 just before and read just after. Fails unless the kernels launched as
    ``want`` says, the losses and eval metrics are finite, and the big
    store changed where it should, bit for bit: every row that a live
    (nonzero-weight) lookup of the first batch touched changed, and no row
    that no live lookup touched (once the loss saturates, a later step's
    samples may have an exactly zero gradient). Returns the launch counts."""
    import contextlib
    import io
    import math
    import re

    import torch

    from dlrm_yx_tpu_torch import cli

    made = []

    class Recorded(cli.Trainer):
        """The CLI's Trainer, keeping the big store as it was before the
        run and the batches it trained on."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.big_before = self.params["emb"][big_index].clone()
            made.append(self)

        def fit(self, train, test):
            self.trained_on = train
            return super().fit(train, test)

    counters = launch_counters()
    out = io.StringIO()
    cli.Trainer = Recorded
    try:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            metrics = cli.main(argv)
        seconds = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        cli.Trainer = Recorded.__base__
    text = out.getvalue()
    losses = [float(x) for x in re.findall(r"loss ([-+.\deE]+|nan|inf)", text)]
    for line in text.splitlines():
        if not line.startswith(":::MLLOG"):
            say(phase, f"  cli: {line}")
    if launches != want:
        fail(f"{what}: launched {launches}, want {want}")
    if len(losses) != n_steps or not all(map(math.isfinite, losses)):
        fail(f"{what}: losses {losses}, want {n_steps} finite values")
    # the eval always gives accuracy and streaming_auc; roc_auc with --mlperf-logging
    keys = ("accuracy", "streaming_auc") + ("roc_auc",) * ("--mlperf-logging" in argv)
    for key in keys:
        if not math.isfinite(metrics.get(key, math.nan)):
            fail(f"{what}: post-training metric {key} = {metrics.get(key)} is missing or "
                 f"not finite")
    trainer = made[0]
    group = trainer.groups[big_index]
    tables = torch.tensor(group.table_ids, device="cuda")
    offs = torch.tensor(group.row_offsets, device="cuda")[:, None, None]
    live = [torch.zeros(group.total_rows, dtype=torch.bool, device="cuda") for _ in range(2)]
    for i, b in enumerate(trainer.trained_on):  # device batches are drawn again, the same
        idx = torch.as_tensor(b.indices, device="cuda")[tables].long() + offs
        ids = idx[torch.as_tensor(b.weights, device="cuda")[tables] != 0]
        for m in live[: 1 + (i == 0)]:
            m[ids] = True
    any_live, first_live = live
    changed = (bits(trainer.params["emb"][big_index]) != bits(trainer.big_before)).any(dim=1)
    if (changed & ~any_live).any() or (first_live & ~changed).any():
        fail(f"{what}: {int(changed.sum())} big-store rows changed, "
             f"{int((changed & ~any_live).sum())} of them untouched by a live lookup; "
             f"{int((first_live & ~changed).sum())} of the first batch's "
             f"{int(first_live.sum())} live rows did not change")
    shown = {k: round(v, 6) for k, v in metrics.items() if isinstance(v, float)}
    say(phase, f"{what}: {n_steps} steps + {n_steps} eval batches in {seconds:.1f} s "
               f"(host init and data included); losses {losses}; eval {shown}; "
               f"{int(changed.sum())} big-store rows changed, all {int(first_live.sum())} "
               f"live rows of the first batch among them, and none of the rows that no "
               f"live lookup touched ({int(any_live.sum())} rows were); launches {launches}")
    return launches


def bits(t):
    """The bit patterns of an f32 or bf16 tensor, as integers."""
    import torch

    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def train_main_path(rows, big_index):
    """Phase b: the CLI training run at L=1; returns the launch counts."""
    argv = terabyte_argv(rows) + [
        "--num-batches", str(N_TRAIN_BATCHES), "--optimizer", "rwsadagrad",
        "--learning-rate", str(LR), "--sparse-update-impl", "pallas",
        "--print-freq", "1",
    ]
    want = only(fused_interaction=2 * N_TRAIN_BATCHES, sparse_rows_overwrite=N_TRAIN_BATCHES,
                rwsadagrad_dense_finish=N_TRAIN_BATCHES)
    return cli_training_run(
        "train", f"cli training, 26 tables <=1M rows x 128, B={BATCH}, L=1, bf16, "
                 "rwsadagrad, sparse-update pallas, pallas interaction",
        argv, N_TRAIN_BATCHES, want, big_index)


def check_train_against_cpu():
    """Phase c: three train steps on the card (K2, K3) vs the CPU (their
    plain versions) on a small two-group model, from the same state."""
    import numpy as np
    import torch

    import dlrm_yx_tpu_torch.optim.optimizer as optimizer
    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    cfg = DLRMConfig.build(
        emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 64, 128), ln_top=(64, 1),
        emb_split_threshold=100, loss="bce", interaction_impl="pallas",
        sparse_update_impl="pallas",
    )
    batches = make_random_batches(RandomDataConfig(
        emb_rows=cfg.emb_rows, m_den=4, mini_batch_size=64, num_batches=3, seed=5))
    for b in batches:
        b.indices[1, :6, 0] = b.indices[1, 0, 0]  # a duplicated row
    opt = optimizer.OptConfig("rwsadagrad", 0.05)
    counters = launch_counters()
    out = {}
    saved = optimizer.PALLAS_MIN_STORE_BYTES
    optimizer.PALLAS_MIN_STORE_BYTES = 0  # route the small big group to K2
    try:
        for dev in ("cpu", "cuda"):
            params = init_dlrm(cfg, seed=7, device=dev)
            state = optimizer.init_opt_state(opt, params, model_groups(cfg))
            for t in [state["emb"][0], state["emb"][1]] + [
                    a for k in ("bot", "top") for pair in state["dense"][k] for a in pair]:
                t.fill_(0.01)
            before = {n: c.launches for n, c in counters.items()}
            step = make_train_step(cfg, opt, device=dev)
            losses = []
            for i, b in enumerate(batches):
                params, state, loss = step(params, state, b, i)
                losses.append(float(loss))
            ran = {n: c.launches - before[n] for n, c in counters.items()}
            out[dev] = (np.array(losses), params, state, ran)
    finally:
        optimizer.PALLAS_MIN_STORE_BYTES = saved
    if out["cuda"][3] != only(fused_interaction=3, sparse_rows_overwrite=3,
                              rwsadagrad_dense_finish=3):
        fail(f"train step on the card launched {out['cuda'][3]}: want each kernel 3 times")
    # the card's GEMMs, reductions and index_add_ atomics sum in other
    # orders than the CPU
    rtol, atol = 1e-4, 1e-6
    (lc, pc, sc, _), (lg, pg, sg, _) = out["cpu"], out["cuda"]
    pairs = [("losses", torch.from_numpy(lc), torch.from_numpy(lg))]
    pairs += [(f"store {i}", a, b.cpu()) for i, (a, b) in enumerate(zip(pc["emb"], pg["emb"]))]
    pairs += [(f"acc {i}", a, b.cpu()) for i, (a, b) in enumerate(zip(sc["emb"], sg["emb"]))]
    pairs += [(f"{k} W{i}", a[0], b[0].detach().cpu())
              for k in ("bot", "top") for i, (a, b) in enumerate(zip(pc[k], pg[k]))]
    worst = max((a.detach() - b).abs().max().item() for _, a, b in pairs)
    for name, a, b in pairs:
        if not torch.allclose(b, a.detach(), rtol=rtol, atol=atol):
            fail(f"train step card vs CPU: {name} differs beyond rtol {rtol} atol {atol}: "
                 f"max {(a.detach() - b).abs().max().item()}")
    say("reference", f"3 train steps card vs CPU (rwsadagrad, K2 + K3 routes, f32): losses "
                     f"{lg.tolist()}, max |diff| over losses, stores, accumulators and "
                     f"MLP weights {worst:.3e} (rtol {rtol}, atol {atol})")


def full_train_step(rows):
    """The full-width train step on device-drawn params and batch, one per
    interaction impl, and the state they share."""
    import dataclasses

    import torch

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.batch import Batch
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import (
        OptConfig,
        init_opt_state,
        uniform_stream_density,
    )
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    cfg = DLRMConfig.build(
        emb_rows=rows, ln_bot=(13, 512, 256, 128), ln_top=(1024, 1024, 512, 256, 1),
        loss="bce", compute_dtype="bfloat16", sparse_update_impl="pallas",
    )
    # the JAX bench's duplicate-density hint for a uniform stream (about
    # 0.999 over these tables: per-occurrence momentum on the big group)
    cfg = dataclasses.replace(cfg, dup_density_hint=uniform_stream_density(
        cfg.emb_rows, cfg.emb_split_threshold, BATCH))
    params = init_dlrm_on_device(cfg, seed=0)
    opt = OptConfig("rwsadagrad", LR)
    state = init_opt_state(opt, params, model_groups(cfg))
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows_t = torch.tensor(rows, device="cuda", dtype=torch.float32)[:, None, None]
    batch = Batch(
        torch.rand(BATCH, 13, device="cuda", generator=gen),
        (torch.rand(len(rows), BATCH, 1, device="cuda", generator=gen) * rows_t).int(),
        torch.ones(len(rows), BATCH, 1, device="cuda"),
        (torch.rand(BATCH, 1, device="cuda", generator=gen) > 0.5).float(),
    )
    steps = {impl: make_train_step(dataclasses.replace(cfg, interaction_impl=impl), opt)
             for impl in ("pallas", "xla")}
    return steps, params, state, batch, cfg.dup_density_hint


def time_in_turns(fns, check, n=20):
    """Each fn of ``fns`` (name -> fn()) warmed up 5 times, then timed over
    ``n`` calls with CUDA events in turns (first, second, second, first);
    ``check(name, out)`` sees each window's last output. Returns name ->
    [ms per call of each window]."""
    def window(name, calls):
        ms, out = events_ms(fns[name], calls)
        check(name, out)
        return ms

    for name in fns:
        window(name, 5)  # warm-up
    first, second = fns
    times = {first: [], second: []}
    for name in (first, second, second, first):
        times[name].append(window(name, n))
    return times


def events_ms(fn, calls):
    """(ms per call of ``calls`` calls of fn between two CUDA events, the
    last call's output)."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        out = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls, out


def train_step_fn(step, params, state, batch):
    """A train step as a function of nothing: the iteration counts up."""
    it = iter(range(10**9))
    return lambda: step(params, state, batch, next(it))


def check_loss(name, out):
    import math

    if not math.isfinite(out[2].item()):
        fail(f"train step ({name}) gave a non-finite loss")


def train_throughput(steps, params, state, batch, hint):
    """Phase d: train steps at full width, CUDA-event timed, in turns."""
    times = time_in_turns({impl: train_step_fn(s, params, state, batch)
                           for impl, s in steps.items()}, check_loss)
    for impl, ts in times.items():
        ms = statistics.mean(ts)
        say("throughput", f"train step (rwsadagrad, bf16, sparse-update pallas, density "
                          f"hint {hint:.4f}), interaction {impl}: {ms:.4f} ms/step "
                          f"({BATCH / ms * 1e3:.0f} examples/s; runs {ts})")


# ------------------------------------------- the high-L sorted-stream path

L100 = 100         # the reference benchmark's lookups per bag
BIG_BATCH = 4096   # past batch 2304 its grad table is over GTAB_MAX_BYTES: K6
N_L100_STEPS = 4   # the benchmark CLI run's steps; its eval takes as many batches
N_BIG_STEPS = 3    # the batch-4096 RWSAdagrad run's steps


def benchmark_argv():
    """bench/dlrm_tpu_benchmark.sh (the reference's dlrm_s_benchmark.sh:20-59)
    for the port's CLI: 8 tables of 1M rows x 64, bot 512-512-64, top
    1024-1024-1024-1, dot, L=100, batch 2048, SGD lr 0.1, bf16,
    --sparse-update-impl pallas, batches drawn on the device."""
    return [
        "--arch-sparse-feature-size=64",
        "--arch-embedding-size=" + "-".join(["1000000"] * 8),
        "--arch-mlp-bot=512-512-64", "--arch-mlp-top=1024-1024-1024-1",
        "--arch-interaction-op=dot", "--data-generation=random-device",
        f"--num-indices-per-lookup={L100}", f"--mini-batch-size={BATCH}",
        "--num-batches=100", "--loss-function=bce", "--round-targets=True",
        "--learning-rate=0.1", "--compute-dtype=bfloat16",
        "--sparse-update-impl=pallas", "--print-freq=10", "--print-time",
    ]


def benchmark_config():
    from dlrm_yx_tpu_torch import cli

    return cli.config_from_args(cli.build_parser().parse_args(benchmark_argv()))


def benchmark_batch(cfg, batch, seed):
    from dlrm_yx_tpu_torch.data.synthetic import make_device_random_batches

    return make_device_random_batches(cfg.emb_rows, cfg.ln_bot[0], batch, 1, L100,
                                      seed=seed, device="cuda")[0]


def sorted_occurrences(gidx, weights):
    """Occurrences [T, B, L] sorted by row as sparse_update_stream sorts
    them: (pos, seg, w, distinct rows)."""
    import torch

    pos, perm = torch.sort(gidx.reshape(-1), stable=True)
    seg = torch.div(perm, L100, rounding_mode="floor").to(torch.int32)
    return pos, seg, weights.reshape(-1)[perm], int(torch.unique_consecutive(pos).numel())


def check_stream_kernels(cfg):
    """Phase f: K5 and K6 against their plain versions on the benchmark's
    store (8 x 1M rows x 64 f32) with the occurrences of one device batch
    each, sorted: K5 at batch 2048 with SGD's weights (-lr * w) and a grad
    table of the pooled shape, K6 at batch 4096 (its path's shape) with
    expanded update rows. Returns their rows of the kernels line."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.embedding import global_row_ids
    from dlrm_yx_tpu_torch.ops.stream_update import (
        sorted_stream_add,
        sorted_stream_add_reference,
        sorted_stream_apply,
        sorted_stream_apply_reference,
    )
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, sparse_update_stream

    (group,) = model_groups(cfg)
    gen = torch.Generator(device="cuda").manual_seed(13)
    r, d = group.total_rows, group.dim
    store = torch.rand(r, d, device="cuda", generator=gen) - 0.5
    # a row's duplicates add in k order in the kernel, in atomic order in the
    # plain version's index_add_: held relative to the largest value
    tol = 1e-6

    def compare(name, got, want, live_rows):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        changed = int((got != store).any(dim=1).sum())
        if not rel <= tol or changed != live_rows:
            fail(f"{name}: max abs err {err}, relative {rel} > {tol}, or {changed} rows "
                 f"changed for {live_rows} rows with a nonzero update")
        return err, rel

    b = benchmark_batch(cfg, BATCH, seed=21)
    gidx = global_row_ids(group, b.indices)
    pos, seg, w, n_rows = sorted_occurrences(gidx, b.weights)
    k = pos.numel()
    gtab = torch.randn(group.num_tables * BATCH, d, device="cuda", generator=gen) * 1e-2
    w_eff = -0.1 * w
    live_rows = int(torch.unique_consecutive(pos[w != 0]).numel())
    err, rel = compare("sorted_stream_apply", sorted_stream_apply(store.clone(), pos, seg, w_eff, gtab),
                       sorted_stream_apply_reference(store.clone(), pos, seg, w_eff, gtab),
                       live_rows)
    ms = device_time_ms(lambda: sorted_stream_apply(store, pos, seg, w_eff, gtab))
    plain_ms = device_time_ms(lambda: sorted_stream_apply_reference(store, pos, seg, w_eff, gtab))
    vals, pos64 = w_eff[:, None] * gtab[seg.long()], pos.long()
    expanded_ms = device_time_ms(lambda: store.index_add_(0, pos64, vals))
    del vals
    g_pooled = gtab.reshape(group.num_tables, BATCH, d)

    def update():
        sparse_update_stream(OptConfig("sgd", 0.1), store, None, group, gidx, b.weights,
                             g_pooled, 0.1)

    events_ms(update, 5)  # warm-up
    update_ms = [events_ms(update, 20)[0] for _ in range(2)]
    # each row with a nonzero weight read and written once (a weight-0 row
    # keeps its value on this finite table); pos, seg and w read; the table read
    nbytes = 2 * 4 * d * live_rows + 12 * k + 4 * gtab.numel()
    bound, by = bound_ms(nbytes, 2 * d * int((w != 0).sum()))
    say("kernel", f"sorted_stream_apply store [{r}, {d}] f32, K={k} sorted occurrences on "
                  f"{n_rows} distinct rows ({live_rows} with a nonzero weight), grad table "
                  f"{tuple(gtab.shape)}: max_abs_err {err:.3e} (relative {rel:.3e} <= {tol}), "
                  f"kernel {ms:.5f} ms (the wrapper: flags, count, compaction, walk), plain "
                  f"{plain_ms:.5f} ms, index_add_ of the pre-expanded rows {expanded_ms:.5f} ms "
                  f"(reference only), bound {bound:.5f} ms ({by}, {nbytes} B); the whole SGD "
                  f"update (sort, segment ids, weights, K5; CUDA events, host launches "
                  f"included) {statistics.mean(update_ms):.5f} ms (runs {update_ms})")
    k5 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
          "bound_by": by, "library_ms": None}
    del g_pooled, pos64
    check_stream_apply_traffic(group, store, b, gidx, gtab, compare)
    check_stream_apply_capture(store, pos, seg, w_eff, gtab)
    del pos, seg, w, w_eff, gtab, gidx, b

    store = torch.rand(r, d, device="cuda", generator=gen) - 0.5  # K5's timing moved it
    b = benchmark_batch(cfg, BIG_BATCH, seed=22)
    pos, _, _, n_rows = sorted_occurrences(global_row_ids(group, b.indices), b.weights)
    k = pos.numel()
    upd = torch.randn(k, d, device="cuda", generator=gen) * 1e-2
    err, rel = compare("sorted_stream_add", sorted_stream_add(store.clone(), pos, upd),
                       sorted_stream_add_reference(store.clone(), pos, upd), n_rows)
    ms = device_time_ms(lambda: sorted_stream_add(store, pos, upd))
    plain_ms = device_time_ms(lambda: sorted_stream_add_reference(store, pos, upd))
    pos64 = pos.long()
    library_ms = device_time_ms(lambda: store.index_add_(0, pos64, upd))
    nbytes = 2 * 4 * d * n_rows + 4 * k + 4 * d * k
    bound, by = bound_ms(nbytes, d * k)
    say("kernel", f"sorted_stream_add store [{r}, {d}] f32, K={k} sorted update rows on "
                  f"{n_rows} distinct rows: max_abs_err {err:.3e} (relative {rel:.3e} <= "
                  f"{tol}), kernel {ms:.5f} ms (the wrapper launches only the kernel), plain "
                  f"{plain_ms:.5f} ms, index_add_ {library_ms:.5f} ms, bound {bound:.5f} ms "
                  f"({by}, {nbytes} B)")
    k6 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
          "bound_by": by, "library_ms": library_ms}
    return k5, k6


def check_stream_apply_traffic(group, store, b, gidx, gtab, compare):
    """Phase f, K5 on more traffic from the benchmark batch, each against its
    plain version with its time: (i) every weight-0 id sent to its table's
    row 0, as host batches pad (one run of ~100k items a table); (ii) every
    weight 0; (iii) a grad row holding inf and one holding NaN, referenced
    only by weight-0 items: 0 * inf is NaN, and the NaN rows must match;
    (iv) a store with -0.0 elements: the elements that keep -0.0 where the
    plain version's +0.0 add makes +0.0 are counted, not failed."""
    import torch

    from dlrm_yx_tpu_torch.ops.stream_update import (
        sorted_stream_apply,
        sorted_stream_apply_reference,
    )

    offs = torch.tensor(group.row_offsets, device="cuda", dtype=gidx.dtype)[:, None, None]
    padded = torch.where(b.weights != 0, gidx, offs)
    pos, seg, w, _ = sorted_occurrences(padded, b.weights)
    w_eff = -0.1 * w
    live_rows = int(torch.unique_consecutive(pos[w != 0]).numel())
    run0 = int((pos == pos[0]).sum())

    def timed(what, w_use, g_use, rows):
        err, rel = compare(f"sorted_stream_apply ({what})",
                           sorted_stream_apply(store.clone(), pos, seg, w_use, g_use),
                           sorted_stream_apply_reference(store.clone(), pos, seg, w_use, g_use),
                           rows)
        ms = device_time_ms(lambda: sorted_stream_apply(store, pos, seg, w_use, g_use), reps=5,
                            samples=10)
        plain_ms = device_time_ms(
            lambda: sorted_stream_apply_reference(store, pos, seg, w_use, g_use), reps=5,
            samples=10)
        return err, rel, ms, plain_ms

    err, rel, ms, plain_ms = timed("row-0 padding", w_eff, gtab, live_rows)
    say("kernel", f"sorted_stream_apply, the benchmark batch with every weight-0 id on its "
                  f"table's row 0 (row 0 of table 0: a run of {run0} items): max_abs_err "
                  f"{err:.3e} (relative {rel:.3e}), {live_rows} rows changed, kernel {ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms")
    err, rel, ms, plain_ms = timed("every weight 0", torch.zeros_like(w_eff), gtab, 0)
    say("kernel", f"sorted_stream_apply, every weight 0: max_abs_err {err:.3e}, no row changed, "
                  f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms")

    # (iii) two grad rows that only weight-0 items reference turn non-finite
    dead = seg[w == 0]
    bad_segs = dead[:1].tolist() + dead[dead != dead[0]][:1].tolist()
    bad = torch.isin(seg, torch.tensor(bad_segs, device="cuda", dtype=seg.dtype))
    w_bad = torch.where(bad, 0.0, w_eff)
    g_bad = gtab.clone()
    g_bad[bad_segs[0], 0] = float("inf")
    g_bad[bad_segs[1], 5] = float("nan")
    got = sorted_stream_apply(store.clone(), pos, seg, w_bad, g_bad)
    want = sorted_stream_apply_reference(store.clone(), pos, seg, w_bad, g_bad)
    torch.cuda.synchronize()
    nan_rows = got.isnan().any(dim=1)
    want_rows = torch.zeros_like(nan_rows)
    want_rows[pos[bad].long()] = True
    finite = ~want.isnan()
    err = (got[finite] - want[finite]).abs().max().item()
    if (not torch.equal(got.isnan(), want.isnan()) or not torch.equal(nan_rows, want_rows)
            or not err <= 1e-6 * want[finite].abs().max().item()):
        fail(f"sorted_stream_apply with non-finite grad rows under weight-0 items: "
             f"{int(nan_rows.sum())} NaN rows against the plain version's "
             f"{int(want.isnan().any(dim=1).sum())} and the {int(want_rows.sum())} rows those "
             f"items name; max abs err elsewhere {err}")
    say("kernel", f"sorted_stream_apply, grad rows {bad_segs} holding inf and NaN, referenced "
                  f"by {int(bad.sum())} weight-0 items only: {int(nan_rows.sum())} NaN rows, the "
                  f"same elements as the plain version's; max_abs_err elsewhere {err:.3e}")
    del got, want, g_bad, w_bad, nan_rows, want_rows, finite

    # (iv) -0.0 elements of the store
    neg = store.clone()
    gen = torch.Generator(device="cuda").manual_seed(17)
    neg[torch.rand(neg.shape, device="cuda", generator=gen) < 0.3] = -0.0
    got = sorted_stream_apply(neg.clone(), pos, seg, w_eff, gtab)
    want = sorted_stream_apply_reference(neg.clone(), pos, seg, w_eff, gtab)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 1e-6 * want.abs().max().item():
        fail(f"sorted_stream_apply on a store with -0.0 elements: max abs err {err}")
    kept = int(((got == 0) & got.signbit() & ~want.signbit()).sum())
    plain_kept = int(((want == 0) & want.signbit()).sum())
    say("kernel", f"sorted_stream_apply, store with {int(((neg == 0) & neg.signbit()).sum())} "
                  f"-0.0 elements: max_abs_err {err:.3e}; {kept} elements keep -0.0 where the "
                  f"plain version (and the JAX kernel) add +0.0 from a weight-0 item and make "
                  f"+0.0 (recorded, not a fault: ROADMAP Queue C); the plain version keeps "
                  f"{plain_kept}")


def check_stream_apply_capture(store, pos, seg, w_eff, gtab):
    """Phase f: one K5 call captured in a CUDA graph and replayed on a fresh
    stream gives the eager call's store, bit for bit (the live count stays
    on the device; the wrapper's scratch was made by an earlier call)."""
    import torch

    from dlrm_yx_tpu_torch.ops.stream_update import sorted_stream_apply

    eager = sorted_stream_apply(store.clone(), pos, seg, w_eff, gtab)
    target = store.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sorted_stream_apply(target, pos, seg, w_eff, gtab)
    target.copy_(store)
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(fresh):
        graph.replay()
    fresh.synchronize()
    if not torch.equal(bits(target), bits(eager)):
        fail("sorted_stream_apply: a CUDA-graph replay on a fresh stream differs from the "
             "eager call")
    say("kernel", "sorted_stream_apply: one call captured in a CUDA graph, replayed on a fresh "
                  "stream: the same store as the eager call, bit for bit")


def benchmark_main_path():
    """Phase g: the reference benchmark's command line through the port's
    CLI, a few steps and an eval: K5 once per step, nothing else."""
    argv = benchmark_argv() + ["--num-batches", str(N_L100_STEPS), "--print-freq", "1"]
    return cli_training_run(
        "train-l100", f"cli bench/dlrm_tpu_benchmark.sh flags, 8 tables x 1M rows x 64, "
                      f"B={BATCH}, L={L100}, bf16, sgd, sparse-update pallas, random-device",
        argv, N_L100_STEPS, only(sorted_stream_apply=N_L100_STEPS), big_index=0)


def big_batch_main_path():
    """Phase h: the same model with RWSAdagrad and --sparse-update-impl
    stream at batch 4096, whose grad table is over GTAB_MAX_BYTES: K6 once
    per step, nothing else."""
    argv = benchmark_argv() + [
        "--num-batches", str(N_BIG_STEPS), "--print-freq", "1",
        "--mini-batch-size", str(BIG_BATCH), "--optimizer", "rwsadagrad",
        "--learning-rate", str(LR), "--sparse-update-impl", "stream"]
    return cli_training_run(
        "train-l100", f"cli, the same model, B={BIG_BATCH}, L={L100}, bf16, rwsadagrad, "
                      "sparse-update stream, random-device",
        argv, N_BIG_STEPS, only(sorted_stream_add=N_BIG_STEPS), big_index=0)


def check_stream_train_against_cpu():
    """Phase i: three train steps on the card vs the CPU (the kernels' plain
    versions) from the same state, on a small L=100 model in the dense
    regime (RWSAdagrad, --sparse-update-impl stream): through K5, then
    through K6 with the grad-table budget at 1 byte."""
    import numpy as np
    import torch

    import dlrm_yx_tpu_torch.ops.stream_update as stream_update
    import dlrm_yx_tpu_torch.optim.optimizer as optimizer
    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    cfg = DLRMConfig.build(
        emb_rows=(3000, 4000), ln_bot=(16, 64, 64), ln_top=(64, 1), emb_split_threshold=0,
        loss="bce", sparse_update_impl="stream",
    )
    batches = make_random_batches(RandomDataConfig(
        emb_rows=cfg.emb_rows, m_den=16, mini_batch_size=64, num_batches=3,
        num_indices_per_lookup=L100, num_indices_per_lookup_fixed=False, seed=6))
    opt = optimizer.OptConfig("rwsadagrad", 0.05)
    counters = launch_counters()
    saved = stream_update.GTAB_MAX_BYTES
    for budget, kernel in ((saved, "sorted_stream_apply"), (1, "sorted_stream_add")):
        out = {}
        stream_update.GTAB_MAX_BYTES = budget
        try:
            for dev in ("cpu", "cuda"):
                params = init_dlrm(cfg, seed=7, device=dev)
                state = optimizer.init_opt_state(opt, params, model_groups(cfg))
                for t in [state["emb"][0]] + [
                        a for k in ("bot", "top") for pair in state["dense"][k] for a in pair]:
                    t.fill_(0.01)
                before = {n: c.launches for n, c in counters.items()}
                step = make_train_step(cfg, opt, device=dev)
                losses = []
                for i, b in enumerate(batches):
                    params, state, loss = step(params, state, b, i)
                    losses.append(float(loss))
                ran = {n: c.launches - before[n] for n, c in counters.items()}
                out[dev] = (np.array(losses), params, state, ran)
        finally:
            stream_update.GTAB_MAX_BYTES = saved
        if out["cuda"][3] != only(**{kernel: 3}):
            fail(f"L={L100} train step on the card launched {out['cuda'][3]}: want {kernel} 3 times")
        # the card's GEMMs, reductions and index_add_ atomics sum in other
        # orders than the CPU
        rtol, atol = 1e-4, 1e-6
        (lc, pc, sc, _), (lg, pg, sg, _) = out["cpu"], out["cuda"]
        pairs = [("losses", torch.from_numpy(lc), torch.from_numpy(lg)),
                 ("store", pc["emb"][0], pg["emb"][0].cpu()),
                 ("acc", sc["emb"][0], sg["emb"][0].cpu())]
        pairs += [(f"{k} W{i}", a[0], b[0].detach().cpu())
                  for k in ("bot", "top") for i, (a, b) in enumerate(zip(pc[k], pg[k]))]
        for name, a, b in pairs:
            if not torch.allclose(b, a.detach(), rtol=rtol, atol=atol):
                fail(f"L={L100} train step card vs CPU ({kernel}): {name} differs beyond rtol "
                     f"{rtol} atol {atol}: max {(a.detach() - b).abs().max().item()}")
        worst = max((a.detach() - b).abs().max().item() for _, a, b in pairs)
        say("reference", f"3 train steps card vs CPU, L={L100} (rwsadagrad, stream, {kernel}, "
                         f"f32): losses {lg.tolist()}, max |diff| over losses, store, "
                         f"accumulator and MLP weights {worst:.3e} (rtol {rtol}, atol {atol})")


def l100_train_steps():
    """The benchmark's train step at batch 2048 on device-drawn params and
    batch: SGD with --sparse-update-impl pallas (K5), and RWSAdagrad lr 0.01
    with --sparse-update-impl stream (K5, per-occurrence momentum); each as a
    function of nothing, with params of its own (drawn alike): SGD at lr 0.1
    on params that RWSAdagrad's first steps have moved can diverge."""
    import dataclasses

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    cfg = benchmark_config()
    batch = benchmark_batch(cfg, BATCH, seed=3)
    sgd, rws = OptConfig("sgd", 0.1), OptConfig("rwsadagrad", LR)
    rws_params = init_dlrm_on_device(cfg, seed=0)
    return {
        "sgd pallas": train_step_fn(make_train_step(cfg, sgd), init_dlrm_on_device(cfg, seed=0),
                                    {}, batch),
        "rwsadagrad stream": train_step_fn(
            make_train_step(dataclasses.replace(cfg, sparse_update_impl="stream"), rws),
            rws_params, init_opt_state(rws, rws_params, model_groups(cfg)), batch),
    }


def l100_throughput(steps):
    """Phase j: both L=100 steps, CUDA-event timed, in turns."""
    for name, ts in time_in_turns(steps, check_loss).items():
        ms = statistics.mean(ts)
        say("throughput", f"L={L100} train step, 8 x 1M x 64, B={BATCH}, bf16, {name}: "
                          f"{ms:.4f} ms/step ({BATCH / ms * 1e3:.0f} examples/s; runs {ts})")


# kernels of the L=100 step by what they do (names as torch 2.x and cuBLAS give them)
KERNEL_KINDS = {
    "K5 sorted_stream_apply": "sorted_stream_apply",
    "sort (cub radix)": "radix|sort",
    "gather (index_select)": "indexselect|index_select|gather",
    "scatter (index_add_, index_put_)": "indexfunc|index_add|scatter|index_put",
    "GEMM": "gemm|nvjet|xmma|cutlass|cublas",
    "elementwise and reductions": "elementwise|reduce",
}


def profile_by_kind(per_kernel, kinds=None):
    import re

    seen = set()
    for kind, pattern in (kinds or KERNEL_KINDS).items():
        names = [k for k in per_kernel if k not in seen and re.search(pattern, k.lower())]
        seen.update(names)
        say("profile", f"  {kind}: {sum(per_kernel[k] for k in names):.5f} ms/step "
                       f"({len(names)} kernel names)")
    rest = sum(v for k, v in per_kernel.items() if k not in seen)
    say("profile", f"  other kernels: {rest:.5f} ms/step")


# ------------------------------------- bf16 stores, SR and the capacity config

CAPACITY_ROWS = 10_000_000  # bench/capacity_demo.py's max_ind_range
K4_CHUNK_ROWS = 1 << 20     # rows compared at a time (no full-size temporaries)

# kernels of the capacity step by what they do (names as torch 2.x gives them)
CAPACITY_KINDS = {
    "K4 sparse_rows_add (row_plan)": "row_plan",
    "K3 rwsadagrad_dense_finish": "dense_finish",
    "sort (cub radix)": "radix|sort",
    "gather (index_select)": "indexselect|index_select|gather",
    "scatter (index_add_, index_put_)": "indexfunc|index_add|scatter|index_put",
    "GEMM": "gemm|nvjet|xmma|cutlass|cublas",
    "elementwise and reductions": "elementwise|reduce",
}


def capacity_config():
    """bench/capacity_demo.py's setting: Terabyte-MLPerf with tables capped
    at 10M rows, bf16 table storage and compute, --sparse-update-impl
    pallas, and the duplicate-density hint of a uniform stream."""
    import dataclasses

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.optim.optimizer import uniform_stream_density

    cfg = dataclasses.replace(
        DLRMConfig.terabyte_mlperf(max_ind_range=CAPACITY_ROWS), compute_dtype="bfloat16",
        sparse_update_impl="pallas", emb_dtype="bfloat16")
    return dataclasses.replace(cfg, dup_density_hint=uniform_stream_density(
        cfg.emb_rows, cfg.emb_split_threshold, BATCH))


def same_bits(a, b):
    """(a and b equal bit for bit, max |a - b|), compared in row chunks."""
    equal, err = True, 0.0
    for r0 in range(0, a.shape[0], K4_CHUNK_ROWS):
        x, y = a[r0:r0 + K4_CHUNK_ROWS], b[r0:r0 + K4_CHUNK_ROWS]
        equal = equal and bool((bits(x) == bits(y)).all())
        err = max(err, (x.float() - y.float()).abs().max().item())
    return equal, err


def batch_rows(group, gen, batch=BATCH, repeats=True):
    """One batch's global row ids of a group, [tables x batch], uniform in
    each table, with (``repeats``) a run of 16 repeats (15 occurrences in
    the JAX kernel's serialized tail)."""
    import torch

    offs = torch.tensor(group.row_offsets, device="cuda")[:, None]
    n = torch.tensor(group.rows, device="cuda", dtype=torch.float64)[:, None]
    u = torch.rand(group.num_tables, batch, device="cuda", dtype=torch.float64, generator=gen)
    ids = (offs + (u * n).long()).reshape(-1)
    if repeats:
        ids[1000:1016] = ids[999]
    return ids.int()


def check_rows_add_traffic(group, store, gen):
    """Phase l, K4 with SR on the capacity bf16 store, on TRAFFIC and on
    items that all share one 8-row unit (each flagged but the first): the
    kernel against its plain version, bit for bit, and the wrapper's time."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add, sparse_rows_add_reference

    for case in TRAFFIC + ("one 8-row unit",):
        ids, active = traffic(group, gen, case)
        k = ids.numel()
        upd = torch.randn(k, store.shape[1], device="cuda", generator=gen) * 1e-2
        got = sparse_rows_add(store.clone(), ids, upd, active, True, seed=7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse_rows_add_reference(store, ids, upd, active, True, seed=7)
        plain_s = time.perf_counter() - t0
        equal, err = same_bits(got, store)
        del got
        if not equal:
            fail(f"sparse_rows_add, {case}: kernel and plain version differ (max abs err {err})")
        ms = device_time_ms(lambda: sparse_rows_add(store, ids, upd, active, True, seed=7),
                            reps=TRAFFIC_REPS, samples=TRAFFIC_REPS)
        rows = torch.unique(ids.long()).numel()
        say("kernel", f"  sparse_rows_add bf16 store, SR, {case}: K={k}, {int(active.sum())} "
                      f"active on {rows} rows: bit-equal to the plain version ({plain_s:.1f} s "
                      f"of host time); wrapper {ms:.5f} ms")


def check_rows_add_kernel(cap_big, big):
    """Phase l: K4 against its plain version, bit for bit, on the capacity
    group's bf16 store (SR off, then on), its f32 1-D momentum viewed as
    [len, 1], and the 1M-capped group's f32 store, each with one batch's
    ids; returns the bf16 store's row of the kernels line (the capacity
    step's main K4 launch)."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_add import (
        sparse_rows_add,
        sparse_rows_add_reference,
    )
    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    gen = torch.Generator(device="cuda").manual_seed(14)
    row = None
    cases = [  # (what, group, rows, dim, dtype, SR)
        ("capacity bf16 store", cap_big, cap_big.total_rows, cap_big.dim, torch.bfloat16, False),
        ("capacity bf16 store, SR", cap_big, cap_big.total_rows, cap_big.dim, torch.bfloat16,
         True),
        ("capacity f32 1-D momentum as [len, 1]", cap_big, acc_len(cap_big.total_rows), 1,
         torch.float32, False),
        ("1M-capped f32 store (--no-write-only-update)", big, big.total_rows, big.dim,
         torch.float32, False),
    ]
    store = None
    for what, group, r, d, dtype, sr in cases:
        if store is None or store.shape != (r, d) or store.dtype != dtype:
            store = None
            torch.cuda.empty_cache()
            store = torch.empty(r, d, dtype=dtype, device="cuda").uniform_(
                -0.5, 0.5, generator=gen)
        ids = batch_rows(group, gen)
        k = ids.numel()
        active = torch.ones(k, dtype=torch.int32, device="cuda")
        upd = torch.randn(k, d, device="cuda", generator=gen) * 1e-2
        if d == 1:
            upd = upd.abs()  # momentum increments are g^2 means
        uniq = torch.unique(ids.long())
        before = store.index_select(0, uniq)
        got = sparse_rows_add(store.clone(), ids, upd, active, sr, seed=7)
        torch.cuda.synchronize()
        sparse_rows_add_reference(store, ids, upd, active, sr, seed=7)
        equal, err = same_bits(got, store)
        moved = bool((bits(got.index_select(0, uniq)) != bits(before)).any(dim=1).all())
        del got
        if not equal or not moved:
            fail(f"sparse_rows_add {what}: kernel and plain version differ (max abs err "
                 f"{err}), or a touched row kept its value")
        ms = device_time_ms(lambda: sparse_rows_add(store, ids, upd, active, sr, seed=7))
        sparse_rows_add_reference(store, ids, upd, active, sr, seed=7)  # warm-up
        plain_ms = events_ms(
            lambda: sparse_rows_add_reference(store, ids, upd, active, sr, seed=7), 10)[0]
        library_ms = None
        if dtype == torch.float32:  # a bf16 index_add_ rounds the update first
            ids64 = ids.long()
            library_ms = device_time_ms(lambda: store.index_add_(0, ids64, upd))
        # ids and flags read, the update rows read, each distinct row read
        # and written once; one add an element an occurrence
        n_rows = uniq.numel()
        nbytes = 8 * k + 4 * d * k + 2 * store.element_size() * d * n_rows
        bound, by = bound_ms(nbytes, d * k)
        say("kernel", f"sparse_rows_add {what} [{r}, {d}] {dtype}, K={k} on {n_rows} distinct "
                      f"rows: bit-equal to the plain version (max_abs_err {err:.3e}), every "
                      f"touched row changed; wrapper (plan + apply + tail, CUDA graph) {ms:.5f} ms, "
                      f"plain {plain_ms:.5f} ms (CUDA events over 10 calls, host sync "
                      f"included), index_add_ "
                      f"{'none' if library_ms is None else f'{library_ms:.5f} ms'}, bound "
                      f"{bound:.5f} ms ({by}, {nbytes} B)")
        if row is None:
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "library_ms": library_ms}
        if sr:
            check_rows_add_traffic(group, store, gen)
    del store
    torch.cuda.empty_cache()
    return row


def count_device_ops(big, cap_big):
    """Phase q: the device operations (kernels, memsets, copies) of one
    wrapper call at each main-path shape of K2 and K4, counted with
    torch.profiler; fails above 5 or on a sort. Runs after every timing:
    a profiler session can slow later host launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    gen = torch.Generator(device="cuda").manual_seed(15)
    cases = [  # (what, group, rows, dim, dtype, SR); K2 on the first
        ("sparse_rows_overwrite 1M-capped f32 store", big, big.total_rows, big.dim,
         torch.float32, False),
        ("sparse_rows_add capacity bf16 store, SR", cap_big, cap_big.total_rows, cap_big.dim,
         torch.bfloat16, True),
        ("sparse_rows_add capacity f32 1-D momentum as [len, 1]", cap_big,
         acc_len(cap_big.total_rows), 1, torch.float32, False),
        ("sparse_rows_add 1M-capped f32 store", big, big.total_rows, big.dim, torch.float32,
         False),
    ]
    counts = {}
    for what, group, r, d, dtype, sr in cases:
        store = torch.zeros(r, d, dtype=dtype, device="cuda")
        ids = batch_rows(group, gen)
        k = ids.numel()
        active = torch.ones(k, dtype=torch.int32, device="cuda")
        upd = torch.randn(k, d, device="cuda", generator=gen) * 1e-2
        if what.startswith("sparse_rows_overwrite"):
            new_vals = store[ids.long()] + upd
            fn = lambda: sparse_rows_overwrite(store, ids, new_vals, upd, active)  # noqa: E731
        else:
            fn = lambda: sparse_rows_add(store, ids, upd, active, sr, seed=7)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        del store
        torch.cuda.empty_cache()
        sorts = [n for n in names if "sort" in n.lower() or "radix" in n.lower()]
        if not names or len(names) > 5 or sorts:
            fail(f"{what}: one call ran {len(names)} device operations {names} (want 1 to 5, "
                 f"no sort)")
        counts[what.split()[0]] = max(counts.get(what.split()[0], 0), len(names))
        say("ops", f"{what} [{r}, {d}], K={k}: {len(names)} device operations in one call "
                   f"({', '.join(n.split('(')[0] for n in names)})")
    return counts


def count_k1_k5_ops(bench_cfg):
    """Phase q: the device operations of one K1 call at the serving shape
    (bf16 and f32) and of one K5 call at the benchmark's shape, and the host
    synchronisations inside them, counted with torch.profiler: K1 one
    kernel; K5 at most 5 operations (its flags, count, compaction and walk),
    no sort and no synchronising runtime call but the one that ends the
    window (a sync would also have broken phase f's CUDA-graph capture)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.embedding import global_row_ids
    from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
    from dlrm_yx_tpu_torch.ops.stream_update import sorted_stream_apply

    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(BATCH, 128, device="cuda", generator=gen)
    ly = torch.randn(BATCH, 26, 128, device="cuda", generator=gen)
    (group,) = model_groups(bench_cfg)
    store = torch.zeros(group.total_rows, group.dim, device="cuda")
    b = benchmark_batch(bench_cfg, BATCH, seed=23)
    pos, seg, w, _ = sorted_occurrences(global_row_ids(group, b.indices), b.weights)
    gtab = torch.randn(group.num_tables * BATCH, group.dim, device="cuda", generator=gen)
    w_eff = -0.1 * w
    cases = [
        ("fused_interaction bf16", f"[{BATCH}, 26, 128]", 1,
         lambda: fused_interaction(x, ly, False, torch.bfloat16)),
        ("fused_interaction f32", f"[{BATCH}, 26, 128]", 1,
         lambda: fused_interaction(x, ly, False, torch.float32)),
        ("sorted_stream_apply", f"store [{group.total_rows}, {group.dim}], K={pos.numel()}", 5,
         lambda: sorted_stream_apply(store, pos, seg, w_eff, gtab)),
    ]
    def window(fn):
        """(device operations, synchronising runtime calls) of a profiled
        fn() that ends in torch.cuda.synchronize()."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        return ([e.name for e in events if e.device_type.name == "CUDA"],
                [e.name for e in events
                 if e.device_type.name == "CPU" and "Synchronize" in e.name])

    _, empty_syncs = window(lambda: None)  # the window's own synchronisations
    for what, shape, most, fn in cases:
        fn()
        torch.cuda.synchronize()
        names, syncs = window(fn)
        ours = [n for n in names if what.split()[0] in n]
        # a torch sort's kernels (cub radix sort); K5's own names hold "sorted"
        sorts = [n for n in names
                 if n not in ours and ("sort" in n.lower() or "radix" in n.lower())]
        inside = len(syncs) - len(empty_syncs)
        if not ours or len(names) > most or sorts or inside > 0:
            fail(f"{what}: one call ran {len(names)} device operations {names} and "
                 f"{inside} synchronising calls beyond an empty window's {empty_syncs} (want 1 "
                 f"to {most} operations, no sort, no synchronisation)")
        short = (n.replace("(anonymous namespace)::", "").split("(")[0] for n in names)
        say("ops", f"{what} {shape}: {len(names)} device operations in one call "
                   f"({', '.join(short)}), no sort, no host "
                   f"synchronisation ({len(syncs)} synchronising calls, as an empty window)")
    del store, x, ly, gtab
    torch.cuda.empty_cache()


def train_bf16_sr_main_path(rows, big_index):
    """Phase m: phase b's CLI training run with bf16 stores and stochastic
    rounding: K4 (the big store; its 28 MB momentum stays on the scatter)
    and K3 once per step, K1 per step and eval batch, K2 never."""
    argv = terabyte_argv(rows) + [
        "--num-batches", str(N_TRAIN_BATCHES), "--optimizer", "rwsadagrad",
        "--learning-rate", str(LR), "--sparse-update-impl", "pallas",
        "--print-freq", "1", "--emb-dtype", "bfloat16", "--stochastic-rounding",
    ]
    want = only(fused_interaction=2 * N_TRAIN_BATCHES, sparse_rows_add=N_TRAIN_BATCHES,
                rwsadagrad_dense_finish=N_TRAIN_BATCHES)
    return cli_training_run(
        "train-bf16", f"cli training, 26 tables <=1M rows x 128 in bf16, B={BATCH}, L=1, "
                      "bf16 compute, rwsadagrad, sparse-update pallas, stochastic rounding, "
                      "pallas interaction",
        argv, N_TRAIN_BATCHES, want, big_index)


def capacity_steps():
    """Phase n: the bench/capacity_demo.py analog's train step, SR off and
    on, on device-drawn stores and batch; checks each step's launches (K4
    twice, K3 once) and returns the steps as functions of nothing."""
    import dataclasses

    import torch

    from dlrm_yx_tpu_torch.data.batch import Batch
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    cfg = capacity_config()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_dlrm_on_device(cfg, seed=123)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    stores = sum(e.numel() * e.element_size() for e in params["emb"])
    opt = OptConfig("rwsadagrad", LR)
    state = init_opt_state(opt, params, model_groups(cfg))
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows_t = torch.tensor(cfg.emb_rows, device="cuda", dtype=torch.float64)[:, None, None]
    u = torch.rand(cfg.num_tables, BATCH, 1, device="cuda", dtype=torch.float64, generator=gen)
    batch = Batch(
        torch.rand(BATCH, 13, device="cuda", generator=gen),
        (u * rows_t).int(),
        torch.ones(cfg.num_tables, BATCH, 1, device="cuda"),
        (torch.rand(BATCH, 1, device="cuda", generator=gen) > 0.5).float(),
    )
    steps = {
        name: train_step_fn(make_train_step(dataclasses.replace(cfg, stochastic_rounding=sr),
                                            opt), params, state, batch)
        for name, sr in (("sr off", False), ("sr on", True))
    }
    counters = launch_counters()
    want = only(sparse_rows_add=2, rwsadagrad_dense_finish=1)
    for name, fn in steps.items():
        for c in counters.values():
            c.launches = 0
        check_loss(name, fn())
        launches = {n: c.launches for n, c in counters.items()}
        if launches != want:
            fail(f"capacity train step ({name}) launched {launches}, want {want}")
    say("capacity", f"Terabyte-MLPerf <=10M rows ({sum(cfg.emb_rows)} rows, groups "
                    f"{[g.total_rows for g in model_groups(cfg)]}), bf16 stores of {stores} B "
                    f"drawn on the card in {init_s:.2f} s (peak {peak} B above what was "
                    f"allocated before); one step each with SR off and on launched {want}")
    return steps


def capacity_throughput(steps):
    """Phase n: the capacity steps, CUDA-event timed, in turns."""
    for name, ts in time_in_turns(steps, check_loss).items():
        ms = statistics.mean(ts)
        say("throughput", f"capacity train step (Terabyte-MLPerf <=10M rows, bf16 stores and "
                          f"compute, rwsadagrad, sparse-update pallas), {name}: {ms:.4f} "
                          f"ms/step ({BATCH / ms * 1e3:.0f} examples/s; runs {ts})")


def within_one_bf16_ulp(got, want):
    """|got - want| at most one bf16 ulp of the larger magnitude, element
    by element (exact where both are 0)."""
    import torch

    m = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(m), torch.frexp(m).exponent - 8)
    return bool(((got - want).abs() <= torch.where(got == want, 0.0, ulp)).all())


def check_k4_train_against_cpu():
    """Phase o: three train steps on the card (K4) against the CPU (its
    plain version) on phase c's two-group model with PALLAS_MIN_STORE_BYTES
    and ACC_KERNEL_MIN_BYTES at 0: a bf16 store with SR off and on, f32 with
    write_only_update off, and Adagrad on the kernel route."""
    import dataclasses

    import numpy as np
    import torch

    import dlrm_yx_tpu_torch.optim.optimizer as optimizer
    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    base = DLRMConfig.build(
        emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 64, 128), ln_top=(64, 1),
        emb_split_threshold=100, loss="bce", interaction_impl="pallas",
        sparse_update_impl="pallas",
    )
    batches = make_random_batches(RandomDataConfig(
        emb_rows=base.emb_rows, m_den=4, mini_batch_size=64, num_batches=3, seed=8))
    for b in batches:
        b.indices[1, :6, 0] = b.indices[1, 0, 0]  # a duplicated row
    rws = only(fused_interaction=3, sparse_rows_add=6, rwsadagrad_dense_finish=3)
    cases = {  # the big store and its momentum take K4; Adagrad's store takes K2
        "bf16 store": (dataclasses.replace(base, emb_dtype="bfloat16"), "rwsadagrad", rws),
        "bf16 store, SR": (dataclasses.replace(base, emb_dtype="bfloat16",
                                               stochastic_rounding=True), "rwsadagrad", rws),
        "f32, write-only update off": (dataclasses.replace(base, write_only_update=False),
                                       "rwsadagrad", rws),
        "adagrad, f32": (base, "adagrad", only(fused_interaction=3, sparse_rows_overwrite=3,
                                                sparse_rows_add=3)),
    }
    counters = launch_counters()
    rtol, atol = 1e-5, 1e-6
    saved = optimizer.PALLAS_MIN_STORE_BYTES, optimizer.ACC_KERNEL_MIN_BYTES
    optimizer.PALLAS_MIN_STORE_BYTES = optimizer.ACC_KERNEL_MIN_BYTES = 0
    try:
        for what, (cfg, optname, want) in cases.items():
            opt = optimizer.OptConfig(optname, 0.05)
            out = {}
            for dev in ("cpu", "cuda"):
                params = init_dlrm(cfg, seed=7, device=dev)
                state = optimizer.init_opt_state(opt, params, model_groups(cfg))
                for t in state["emb"] + [a for k in ("bot", "top")
                                         for pair in state["dense"][k] for a in pair]:
                    t.fill_(0.01)
                before = {n: c.launches for n, c in counters.items()}
                step = make_train_step(cfg, opt, device=dev)
                losses = []
                for i, b in enumerate(batches):
                    params, state, loss = step(params, state, b, i)
                    losses.append(float(loss))
                ran = {n: c.launches - before[n] for n, c in counters.items()}
                out[dev] = (np.array(losses), params, state, ran)
            if out["cuda"][3] != want:
                fail(f"K4 train step ({what}) on the card launched {out['cuda'][3]}, want {want}")
            (lc, pc, sc, _), (lg, pg, sg, _) = out["cpu"], out["cuda"]
            f32 = [("losses", torch.from_numpy(lc), torch.from_numpy(lg))]
            f32 += [(f"acc {i}", a, b.cpu()) for i, (a, b) in enumerate(zip(sc["emb"], sg["emb"]))]
            f32 += [(f"{k} W{i}", a[0].detach(), b[0].detach().cpu())
                    for k in ("bot", "top") for i, (a, b) in enumerate(zip(pc[k], pg[k]))]
            stores = [(f"store {i}", a, b.cpu()) for i, (a, b) in enumerate(zip(pc["emb"],
                                                                                pg["emb"]))]
            for name, a, b in stores:
                ok = (within_one_bf16_ulp(b.float(), a.float()) if a.dtype == torch.bfloat16
                      else torch.allclose(b, a, rtol=rtol, atol=atol))
                if not ok:
                    fail(f"K4 train step ({what}) card vs CPU: {name} differs beyond "
                         f"{'one bf16 ulp' if a.dtype == torch.bfloat16 else 'rtol/atol'}: "
                         f"max {(a.float() - b.float()).abs().max().item()}")
            for name, a, b in f32:
                if not torch.allclose(b, a, rtol=rtol, atol=atol):
                    fail(f"K4 train step ({what}) card vs CPU: {name} differs beyond rtol "
                         f"{rtol} atol {atol}: max {(a - b).abs().max().item()}")
            n_diff = sum(int((bits(a) != bits(b)).sum()) for _, a, b in stores)
            worst = max((a.float() - b.float()).abs().max().item() for _, a, b in stores + f32)
            say("reference", f"3 train steps card vs CPU ({what}, K4 launches "
                             f"{want['sparse_rows_add']}): losses {lg.tolist()}, max |diff| "
                             f"{worst:.3e}; {n_diff} store elements not bit-equal (stores "
                             f"within one bf16 ulp or rtol {rtol} atol {atol}, the rest rtol "
                             f"{rtol} atol {atol})")
    finally:
        optimizer.PALLAS_MIN_STORE_BYTES, optimizer.ACC_KERNEL_MIN_BYTES = saved


def main():
    import re

    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs the card")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", f"{kind}, count {count}, torch {torch.__version__} CUDA "
                  f"{torch.version.cuda}; nvidia-smi: {smi}")

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.ops import _build
    from dlrm_yx_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # TF32 off for the plain versions' f32 products

    # 2. build
    seconds = _build.build()
    say("build", f"kernels {list(_build.kernel_names())} built in {seconds:.1f} s")
    for name, log in _build.build_logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        say("build", f"  {name}: {len(regs)} kernel instances, at most {max(regs, default=0)} "
                     f"registers and {max(spills, default=0)} bytes of spill stores a thread "
                     f"(ptxas)")

    # 3, a, f, l. kernels against their plain versions
    k1 = check_interaction_kernel()
    small, big = terabyte_groups()
    k2 = check_overwrite_kernel(big)
    k3 = check_finish_kernel(small)
    bench_cfg = benchmark_config()
    k5, k6 = check_stream_kernels(bench_cfg)
    from dlrm_yx_tpu_torch.models.dlrm import model_groups

    _, cap_big = model_groups(capacity_config())
    k4 = check_rows_add_kernel(cap_big, big)

    # 4, b, g, h, m. the main paths: serving, training at L=1, the L=100
    # benchmark (K5), its batch-4096 RWSAdagrad run (K6) and training on
    # bf16 stores with stochastic rounding (K4)
    rows = DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000).emb_rows
    serve_main_path(rows)
    launches = train_main_path(rows, big_index=1)
    l100_launches = benchmark_main_path()
    big_launches = big_batch_main_path()
    bf16_launches = train_bf16_sr_main_path(rows, big_index=1)

    # 5, c, i, o. the eval and train steps against the CPU on a small input
    check_against_cpu()
    check_train_against_cpu()
    check_stream_train_against_cpu()
    check_k4_train_against_cpu()

    # 6, d, j, n. serving and training throughput, then 7, e, k, p. where
    # their device time goes: every timing runs before the first profiler
    # session, whose tracing can linger and slow the host's launches
    step, params, batch = serving_throughput(rows)
    steps, tparams, state, tbatch, hint = full_train_step(rows)
    train_throughput(steps, tparams, state, tbatch, hint)
    l100_steps = l100_train_steps()
    l100_throughput(l100_steps)
    cap_steps = capacity_steps()
    capacity_throughput(cap_steps)
    profile_step(lambda: step(params, batch), "serving",
                 ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp"))
    train_phases = ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp",
                    "loss_compute", "backward", "optimizer")
    per_kernel = profile_step(train_step_fn(steps["pallas"], tparams, state, tbatch),
                              "train (pallas interaction)", train_phases)
    for name, pattern in (("K2 sparse_rows_overwrite (row_plan)", "row_plan"),
                          ("K3 rwsadagrad_dense_finish", "dense_finish")):
        ms = sum(v for k, v in per_kernel.items() if pattern in k)
        say("profile", f"  {name} kernels: {ms:.5f} ms/step of device time")
    for name, fn in l100_steps.items():
        profile_by_kind(profile_step(fn, f"L={L100} train ({name})", train_phases))
    per_kernel = profile_step(cap_steps["sr off"], "capacity train (sr off)", train_phases)
    profile_by_kind(per_kernel, CAPACITY_KINDS)
    for name, ms in per_kernel.items():
        if "row_plan" in name:  # K4's kernels, once a step each for the store and the momentum
            say("profile", f"  K4 kernel: {ms:.5f} ms/step {name[:90]}")

    # q. device operations per wrapper call
    count_device_ops(big, cap_big)
    count_k1_k5_ops(bench_cfg)

    sources = {
        "fused_interaction": ("dlrm_yx_tpu/ops/pallas_interaction.py:84", k1, launches,
                              "no single call computes bmm + tril + concat"),
        "sparse_rows_overwrite": ("dlrm_yx_tpu/ops/pallas_sparse_update.py:505", k2,
                                  launches, None),
        "rwsadagrad_dense_finish": ("dlrm_yx_tpu/ops/pallas_dense_finish.py:119", k3,
                                    launches, "no single call does a row-wise Adagrad step"),
        "sorted_stream_apply": ("dlrm_yx_tpu/ops/pallas_stream_update.py:257", k5,
                                l100_launches, "no single call expands and adds"),
        "sorted_stream_add": ("dlrm_yx_tpu/ops/pallas_stream_update.py:343", k6,
                              big_launches, None),
        "sparse_rows_add": ("dlrm_yx_tpu/ops/pallas_sparse_update.py:293", k4,
                            bf16_launches, "index_add_ with a bf16 store rounds the update "
                                           "before adding: another function"),
    }
    kernels = []
    for name, (replaces, row, path_launches, no_library) in sources.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"dlrm_yx_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
        if no_library:
            say("kernel", f"{name}: library_ms null ({no_library})")
    say("done", f"chip_smoke.py wall time {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
