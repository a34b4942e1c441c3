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
     same numbers and, for K2, one PyTorch call's (``index_add_``);
  4. serve: ``dlrm_yx_tpu_torch.cli.main --inference-only`` on the full-width
     Terabyte-MLPerf DLRM (26 tables capped at 1M rows, dim 128, batch 2048,
     bf16, --interaction-impl pallas), with the launch counts set to 0 just
     before and read just after;
  b. train: the training main path, ``cli.main`` without --inference-only on
     the same model (rwsadagrad, --sparse-update-impl pallas, a few
     batches, then an eval), with the launch counts set to 0 just before
     and read just after: K2 and K3 once per step, K1 once per step and eval
     batch; finite losses; the touched rows of the big store changed;
  5. reference: the eval step on the card against the same step on the CPU
     (the kernels' plain versions) on a small model;
  c. reference: three train steps on the card against the CPU on a small
     two-group model, routed through K2 and K3;
  6. throughput: the eval step at full width, CUDA-event timed, with the
     fused kernel and with the plain interaction, in turns;
  d. throughput: the train step at full width, CUDA-event timed over 20
     steps after warm-up, with either interaction, in turns;
  7. profile: a torch.profiler window over the serving step: device busy
     share and the kernels that take the time;
  e. profile: a torch.profiler window over the train step.
Then a JSON line of the kernels, nvidia-smi's line, and the result line.

Bound: bytes each input read once and each output written once over
3.35 TB/s, or operations over the card's peak for their type (67 TFLOP/s
f32 outside the tensor cores), whichever is larger (H100 SXM data sheet).
Where the work depends on the data (K2's duplicates and inactive items,
K3's untouched rows), the bytes are those this run's inputs need.
"""

import json
import statistics
import subprocess
import sys
import time

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
        (BATCH, 26, 128, False, torch.float32),
        (128, 7, 128, True, torch.float32),
        (128, 2, 256, False, torch.float32),
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
    want = {"fused_interaction": N_SERVE_BATCHES, "sparse_rows_overwrite": 0,
            "rwsadagrad_dense_finish": 0}
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

    def run(impl, n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            preds, loss = steps[impl](params, batch)
        e1.record()
        e1.synchronize()
        if not math.isfinite(loss.item()) or not torch.isfinite(preds).all():
            fail(f"serving step ({impl}) gave non-finite output")
        return e0.elapsed_time(e1) / n

    for impl in steps:
        run(impl, 5)  # warm-up
    times = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        times[impl].append(run(impl, 20))
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


def check_overwrite_kernel(big):
    """Phase a, K2: on a store of the big group's shape, one batch's K items
    (8 tables x 2048) with a run of forced duplicates and ~20% inactive."""
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
                  f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, index_add_ "
                  f"{library_ms:.5f} ms, bound {bound:.5f} ms ({by}, {nbytes} B)")
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
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite

    return {"fused_interaction": fused_interaction,
            "sparse_rows_overwrite": sparse_rows_overwrite,
            "rwsadagrad_dense_finish": rwsadagrad_dense_finish}


def train_main_path(rows, big_index):
    """Phase b: the CLI training run; returns each kernel's launch count."""
    import contextlib
    import io
    import math
    import re

    import numpy as np
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

    argv = terabyte_argv(rows) + [
        "--num-batches", str(N_TRAIN_BATCHES), "--optimizer", "rwsadagrad",
        "--learning-rate", str(LR), "--sparse-update-impl", "pallas",
        "--print-freq", "1",
    ]
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
            say("train", f"  cli: {line}")
    want = {"fused_interaction": 2 * N_TRAIN_BATCHES,
            "sparse_rows_overwrite": N_TRAIN_BATCHES,
            "rwsadagrad_dense_finish": N_TRAIN_BATCHES}
    if launches != want:
        fail(f"training run launched {launches}, want {want}")
    if len(losses) != N_TRAIN_BATCHES or not all(map(math.isfinite, losses)):
        fail(f"training losses {losses}: want {N_TRAIN_BATCHES} finite values")
    for key in ("accuracy", "roc_auc", "streaming_auc"):
        if not math.isfinite(metrics[key]):
            fail(f"post-training metric {key} = {metrics[key]} is not finite")
    trainer = made[0]
    group = trainer.groups[big_index]
    ids = np.concatenate([
        (b.indices[list(group.table_ids), :, 0]
         + np.array(group.row_offsets)[:, None]).ravel() for b in trainer.trained_on])
    ids = torch.from_numpy(np.unique(ids)).cuda()
    after = trainer.params["emb"][big_index]
    moved = (after[ids] != trainer.big_before[ids]).any(dim=1)
    untouched = torch.ones(after.shape[0], dtype=torch.bool, device="cuda")
    untouched[ids] = False
    still = torch.equal(after[untouched], trainer.big_before[untouched])
    if not moved.all().item() or not still:
        fail(f"big store: {int(moved.sum())} of {ids.numel()} touched rows changed, "
             f"untouched rows unchanged: {still}")
    say("train", f"cli training, 26 tables <=1M rows x 128, B={BATCH}, bf16, rwsadagrad, "
                 f"sparse-update pallas, pallas interaction: {N_TRAIN_BATCHES} steps + "
                 f"{N_TRAIN_BATCHES} eval batches in {seconds:.1f} s (host init and "
                 f"data included); losses {losses}; eval accuracy "
                 f"{metrics['accuracy']:.6f}, roc_auc {metrics['roc_auc']:.6f}; all "
                 f"{ids.numel()} touched big-store rows changed, the rest did not; "
                 f"launches {launches}")
    return launches


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
    if out["cuda"][3] != {"fused_interaction": 3, "sparse_rows_overwrite": 3,
                          "rwsadagrad_dense_finish": 3}:
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


def train_throughput(steps, params, state, batch, hint):
    """Phase d: train steps at full width, CUDA-event timed, in turns."""
    import math

    import torch

    it = [0]

    def run(impl, n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            _, _, loss = steps[impl](params, state, batch, it[0])
            it[0] += 1
        e1.record()
        e1.synchronize()
        if not math.isfinite(loss.item()):
            fail(f"train step ({impl}) gave a non-finite loss")
        return e0.elapsed_time(e1) / n

    for impl in steps:
        run(impl, 5)  # warm-up
    times = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        times[impl].append(run(impl, 20))
    for impl, ts in times.items():
        ms = statistics.mean(ts)
        say("throughput", f"train step (rwsadagrad, bf16, sparse-update pallas, density "
                          f"hint {hint:.4f}), interaction {impl}: {ms:.4f} ms/step "
                          f"({BATCH / ms * 1e3:.0f} examples/s; runs {ts})")


def main():
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"  {name}: {line.strip()}")

    # 3, a. kernels against their plain versions
    k1 = check_interaction_kernel()
    small, big = terabyte_groups()
    k2 = check_overwrite_kernel(big)
    k3 = check_finish_kernel(small)

    # 4, b. the main paths: serving, then training
    rows = DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000).emb_rows
    serve_main_path(rows)
    launches = train_main_path(rows, big_index=1)

    # 5, c. the eval and train steps against the CPU on a small input
    check_against_cpu()
    check_train_against_cpu()

    # 6, d. serving and training throughput, then 7, e. where their device
    # time goes: every timing runs before the first profiler session, whose
    # tracing can linger and slow the host's launches
    step, params, batch = serving_throughput(rows)
    steps, tparams, state, tbatch, hint = full_train_step(rows)
    train_throughput(steps, tparams, state, tbatch, hint)
    profile_step(lambda: step(params, batch), "serving",
                 ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp"))
    it = iter(range(10**6))
    per_kernel = profile_step(
        lambda: steps["pallas"](tparams, state, tbatch, next(it)),
        "train (pallas interaction)",
        ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp", "loss_compute",
         "backward", "optimizer"))
    for name in ("sparse_rows_overwrite", "dense_finish"):
        ms = sum(v for k, v in per_kernel.items() if name in k)
        say("profile", f"  {name} kernels: {ms:.5f} ms/step of device time")

    sources = {
        "fused_interaction": ("dlrm_yx_tpu/ops/pallas_interaction.py:84", k1,
                              "no single call computes bmm + tril + concat"),
        "sparse_rows_overwrite": ("dlrm_yx_tpu/ops/pallas_sparse_update.py:505", k2, None),
        "rwsadagrad_dense_finish": ("dlrm_yx_tpu/ops/pallas_dense_finish.py:119", k3,
                                    "no single call does a row-wise Adagrad step"),
    }
    kernels = []
    for name, (replaces, row, no_library) in sources.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"dlrm_yx_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
        if no_library:
            say("kernel", f"{name}: library_ms null ({no_library})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
