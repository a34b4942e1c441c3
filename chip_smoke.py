"""Smoke run of the PyTorch/CUDA port (dlrm_yx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero and prints no result):
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: every kernel under dlrm_yx_tpu_torch/csrc, compiled with nvcc;
  3. kernel: each kernel against its plain PyTorch version on the card at
     the serving path's shapes, with its time, the plain version's and the
     least time the card could take (the bound);
  4. serve: the main path — ``dlrm_yx_tpu_torch.cli.main --inference-only``
     on the full-width Terabyte-MLPerf DLRM (26 tables capped at 1M rows,
     dim 128, batch 2048, bf16, --interaction-impl pallas), with every
     kernel's launch count set to 0 just before and read just after;
  5. reference: the eval step on the card against the same step on the CPU
     (the kernels' plain versions) on a small model;
  6. throughput: the eval step at full width, CUDA-event timed, with the
     fused kernel and with the plain interaction, in turns;
  7. profile: a torch.profiler window over the serving step: device busy
     share and the kernels that take the time.
Then a JSON line of the kernels, nvidia-smi's line, and the result line.

Bound: bytes each input read once and each output written once over
3.35 TB/s, or operations over the card's peak for their type (67 TFLOP/s
f32 outside the tensor cores), whichever is larger (H100 SXM data sheet).
"""

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
N_SERVE_BATCHES = 4
BATCH = 2048


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


def interaction_bound_ms(b, s, d, p):
    nbytes = 4 * (b * d + b * s * d + b * (d + p))
    flops = 2 * b * p * d
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


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
    """Phase 4: the CLI serving run; returns the kernel's launch count."""
    import math

    from dlrm_yx_tpu_torch import cli
    from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction

    argv = [
        "--arch-embedding-size", "-".join(map(str, rows)),
        "--arch-sparse-feature-size", "128",
        "--arch-mlp-bot", "13-512-256-128",
        "--arch-mlp-top", "1024-1024-512-256-1",
        "--data-generation", "random", "--mini-batch-size", str(BATCH),
        "--num-batches", str(N_SERVE_BATCHES), "--num-indices-per-lookup", "1",
        "--loss-function", "bce", "--compute-dtype", "bfloat16",
        "--interaction-impl", "pallas", "--inference-only", "--mlperf-logging",
    ]
    fused_interaction.launches = 0
    t0 = time.perf_counter()
    metrics = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = fused_interaction.launches
    for key in ("accuracy", "roc_auc", "streaming_auc"):
        if not math.isfinite(metrics[key]):
            fail(f"serving metric {key} = {metrics[key]} is not finite")
    if launches != N_SERVE_BATCHES:
        fail(f"fused_interaction launched {launches} times for {N_SERVE_BATCHES} batches")
    say("serve", f"cli --inference-only, 26 tables <=1M rows x 128, B={BATCH}, bf16, "
                 f"pallas interaction: {N_SERVE_BATCHES} batches in {seconds:.1f} s "
                 f"(host init and data included); accuracy {metrics['accuracy']:.6f}, "
                 f"roc_auc {metrics['roc_auc']:.6f}, streaming_auc "
                 f"{metrics['streaming_auc']:.6f}; fused_interaction launches {launches}")
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


def profile_step(step, params, batch):
    """Phase 7: where the serving step's device time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step(params, batch)
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type.name == "CUDA" and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    say("profile", f"{n} serving steps under torch.profiler: wall {wall_ms:.4f} ms/step, "
                   f"kernels busy {device_ms:.4f} ms/step "
                   f"(device idle share {max(0.0, 1 - device_ms / wall_ms):.3f})")
    for name in ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp"):
        host = sum(e.cpu_time_total for e in avgs
                   if e.key == name and e.device_type.name == "CPU")
        span = sum(e.self_device_time_total for e in avgs
                   if e.key == name and e.device_type.name == "CUDA")
        say("profile", f"  phase {name}: host {host / 1e3 / n:.5f} ms/step, "
                       f"device span {span / 1e3 / n:.5f} ms/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        say("profile", f"  kernel {e.self_device_time_total / 1e3 / n:.5f} ms/step "
                       f"x{e.count // n} {e.key[:90]}")


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

    # 3. kernels against their plain versions
    k1 = check_interaction_kernel()

    # 4. the main path
    rows = DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000).emb_rows
    launches = serve_main_path(rows)

    # 5. the eval step against the CPU on a small input
    check_against_cpu()

    # 6, 7. serving throughput and where its device time goes
    step, params, batch = serving_throughput(rows)
    profile_step(step, params, batch)

    kernels = [{
        "name": "fused_interaction",
        "route": "cuda",
        "source": "dlrm_yx_tpu_torch/csrc/fused_interaction.cu",
        "replaces": "dlrm_yx_tpu/ops/pallas_interaction.py:84",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes bmm + tril + concat
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
