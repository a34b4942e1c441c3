"""Smoke run of the PyTorch/CUDA port (dlrm_yx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure prints FAIL, exits non-zero and prints
no result):
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: every kernel under dlrm_yx_tpu_torch/csrc, compiled with nvcc;
  3. kernel: K1 (fused interaction) against its plain PyTorch version on the
     card at the serving path's shapes, with its time, the plain version's
     and the least time the card could take (the bound); each kernel's
     main row is also timed cold (``device_time_ms(cold=True)``: a 128 MiB
     write before each call empties the L2), and a cold reading below its
     bound fails the phase (the byte count is wrong or work was skipped);
  a. kernel: K2 (sparse_rows_overwrite) and K3 (rwsadagrad_dense_finish)
     against their plain versions at the training path's shapes, with the
     same numbers and, for K2, one PyTorch call's (``index_add_``); K3 timed
     warm and cold, its cold reading held to the bound; then K3 on a store
     of each width of FINISH_ROUTE_DIMS (every route of the kernel: lane
     groups of 1 to 16 lanes, a warp per row), f32 and bf16, one launch a
     store and in grouped launches (rwsadagrad_dense_finish_many: 48
     stores in one launch, 70 in two), untouched rows bit-identical, the
     launches counted; then K2
     on more traffic (TRAFFIC: all rows unique, a hot row on half of K, all
     K on one row, a skewed stream, no active item, K=1, K=32,768), each
     against the plain version run on the CPU over the touched rows (where
     ``index_add_`` adds in item order, as the kernel does), with its time;
     then K7 (``ops/coalesce.py``) on one step's big-store bag items of the
     DLRM-DCNv2 cell (the benchmark's generator): RWSAdagrad's
     coalesce-first route (sort, K7a, K4, K7b, K2) against the torch route
     it replaced, K7a twice bit for bit, its counts; then K8
     (``ops/dcn.py``) at the DLRM-DCNv2 cell's cross network (B 8,192, N
     3,456, rank 512, 3 layers, bf16): each kernel bit for bit with its
     plain version on the card, the kernel route against the plain torch
     path (output bit for bit, gradients to f32's rtol), two calls bit for
     bit, ``dcn.kernel`` once a call, each kernel's time against its bound
     and the network's forward and backward on both routes
     (``python3 chip_smoke.py --phase k8`` runs phases 1, 2 and this alone);
     then phase hstu (``check_hstu``): the HSTU cell's tiled attention at its
     shapes against its plain version on the card, forward and backward,
     timed, and the coalesce-first row update at width 512 on ~4.26M
     mostly distinct items against exact row-wise Adagrad in torch ops,
     timed (``python3 chip_smoke.py --phase hstu`` runs phases 1, 2 and this
     alone);
  f. kernel: K5 (sorted_stream_apply) and K6 (sorted_stream_add) against
     their plain versions on the reference benchmark's store (8 x 1M rows
     x 64 f32) with one device batch's sorted occurrences (K5 at batch 2048,
     K6 at batch 4096, the shapes their paths give them), with the same
     numbers and, for K6, ``index_add_``'s; then K5 on the same batch with
     every weight-0 id on its table's row 0 (as host batches pad), with
     every weight 0, with non-finite grad rows under weight-0 items only
     (the NaN rows must match), on a store with -0.0 elements (the
     elements that keep -0.0 are counted, not failed), and with learned
     pooling's weights w * v_W[row] (v_W 0, negative and random); and one K5 call
     captured in a CUDA graph and replayed on a fresh stream, against the
     eager call bit for bit;
  4. serve: ``dlrm_yx_tpu_torch.cli.main --inference-only`` on the full-width
     Terabyte-MLPerf DLRM (26 tables capped at 1M rows, dim 128, batch 2048,
     bf16, --interaction-impl pallas), with the launch counts set to 0 just
     before and read just after. Phases 4, b, g, h and m run the CLI's
     captured steps: after one eager warm-up step each train and eval step
     is a CUDA-graph replay (one step a replay at --print-freq 1), and the
     launch counts count replays;
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
  r. capture: every captured path against its eager steps on the card, bit
     for bit (losses, stores, accumulators, MLP tensors), with deterministic
     algorithms on and an LR policy whose lr moves every step: three
     dispatches (eager warm-up, capture + replay, replay) of the L=1 train
     step (N=4: K1, K2, K3), the eval step (K1), gradient accumulation over
     2 micro-batches (K1, K4, K3), the bf16 store with SR (N=4: K4, K3), the
     L=100 SGD step (N=4: K5) and the B=4096 RWSAdagrad stream step (N=2:
     K6), the mixed-dimension L=1 step (N=4: K1, K2, K3), the QR L=1 step
     (N=4: K1, K3, K4) and the L=100 step with learned pooling weights (N=4:
     K5; v_W 0, negative and random), each with the eager steps' launch
     counts (K3 once an optimizer step, grouped, on the L=1 paths);
  6. throughput: the eager eval step at full width, CUDA-event timed, with
     the fused kernel and with the plain interaction, in turns;
  d. throughput: the eager train step at full width, CUDA-event timed over
     20 steps after warm-up, with either interaction, in turns;
  j. throughput: the eager L=100 train step at batch 2048, SGD pallas (the
     benchmark) and RWSAdagrad stream, in turns;
  s. throughput: the captured steps at N=1 and N=16 steps a replay against
     the eager step, in turns (eager, N=1, N=16, N=16, N=1, eager), for the
     L=1 train, L=100 SGD and capacity (SR off) steps, and the captured eval
     step (one batch a replay) against the eager one; then the captured N=16
     L=1 step of the mixed-dimension and QR models against the plain one,
     in turns; before them, the MD and QR steps' K3 stores as one eager
     step collects them, in one grouped launch against the plain version,
     timed warm and cold and beside one launch a store (the QR row goes in
     the kernels line as rwsadagrad_dense_finish_many);
  7. profile: a torch.profiler window over the eager serving step: device
     busy share and the kernels that take the time;
  e. profile: a torch.profiler window over the eager train step;
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
  t. profile: the captured eval, L=1, L=100 and capacity steps and the
     mixed-dimension and QR L=1 steps (16 steps a replay), kernels busy and
     the idle share per step;
  q. ops: the device operations (kernels, memsets, copies) of one K2 and
     one K4 wrapper call at each main-path shape, read as the nodes of a
     CUDA graph that captures the call (at most 5, no sort), and of one K1
     call (bf16 and f32), one K3 call (lr on the device) and one K6 call
     (one kernel each) and one K5 call (at most 5, no sort); the capture
     itself fails on a host synchronisation.
  u. data: the real-data paths through ``cli.main``, their files written
     under build/chip_smoke_data (gitignored): (1) bench/run_and_time.sh's
     command line (the MLPerf binary loader with its shuffle, SGD) on a
     train.bin of 32 x 2048 records, ids drawn from a power law over the
     Terabyte raw counts, with --max-ind-range 1000000, no
     --processed-data-file and --interaction-impl pallas: K1 per step and
     eval batch, K2 per step; then a file with a short last batch at one
     step a replay over two epochs, whose train and eval graphs of the
     short batch must replay; (2) bench/dlrm_tpu_criteo_kaggle.sh's
     command line on a 7 x 32,768-row TSV from synth_kaggle, preprocessed on
     first touch, no kernel launched (D=16), and again with --memory-map,
     equal bit for bit (deterministic algorithms on); (3) the
     stack-distance trace path (--data-generation synthetic, the shipped
     input/dist_emb_j.log) at (1)'s flags, SGD and RWSAdagrad, with the
     distinct rows a table per batch and the density hint; (4) the native
     parser was built and used. The CLI runs of one model and seed share
     one host draw of the tables (``SharedInit``);
  v. checkpoint: on (2), a run with --save-model stopped at its first eval,
     a run with --load-model (the uninterrupted run's losses and params from
     the saved iteration on, bit for bit) and --inference-only --load-model
     (the metrics of the eval that saved it);
  w. throughput: the captured N=16 L=1 train step of (1)'s flags through
     ``Trainer.fit`` fed random host batches, the binary loader and trace
     batches in turns (ms/step, examples/s, the fits' wall time), then one
     profiler window each (kernels busy, idle share, K2's time a step);
  x. kernel: the kernels on the shapes of the embedding variants: K2 at row
     widths 1, 2 and 4 (the Kaggle mixed-dimension big group [33.7M, 1] with
     one batch's ids, the Terabyte one's rows at widths 2 and 4), each also
     with a hot row on half of K, bit for bit against the plain version run
     on the CPU; K4 on a QR quotient table [250,000, 128] f32 (no sentinel
     rows) with a coalesced batch that updates its last row, bit for bit,
     the last row kept and its update on the row before (the JAX kernel's
     clip); K3 on every small group of both mixed-dimension models (dims 1
     to 128) and on every group of the processed model (dims 64 to 512,
     one batch of pooled ids from the dataset the port's generator writes
     under build/chip_smoke_data: 12 tables, rows 500-10,000, pooling 1-32,
     10 batches of 2048, m_den 512); each with its time, the plain version's, index_add_'s (K2, K4)
     and its bound; K3 warm and cold; then the processed model's groups as
     one eager train step collects them, in one grouped launch, against the
     plain version, timed warm and cold and beside one launch a store;
  y. variants: through ``cli.main``, launch counts set to 0 just before and
     read just after: Terabyte-MLPerf (1M cap) with --md-flag
     --md-round-dims (K2 once a step on the dim-4 big group, K3 once: its
     four small groups in one grouped launch, K1 per step and eval batch;
     no big-store row that no live lookup
     touched changed), Kaggle's model with --md-flag --md-round-dims (SGD,
     B=128: K2 once a step on the dim-1 big group), Terabyte-MLPerf with
     --qr-flag (K4 on the 7 quotient tables of 64 MiB or more, K3 once: the
     small group and the other 29 QR sub-tables in one grouped launch, K1)
     and served again with
     --inference-only, the L=100 benchmark with --weighted-pooling learned
     (K5 once a step and nothing else; v_W moved only on looked-up rows),
     and phase x's processed dataset, trained (RWSAdagrad: K3 once a step,
     every dim group in one grouped launch) and served with
     --load-processed;
  z. reference: small mixed-dimension (K2 at widths 1 and 2, K3, K4 on the
     momenta), QR (K4, K3, K1) and learned-pooling L=100 (K5, v_W 0 and
     negative on some rows) models, an eval step and three train steps on
     the card against the CPU with the kernel gates at 0;
  8. serve-quantized: ``cli.main --inference-only`` on phase 4's model with
     --quantize-emb-with-bit 8 and 4, each with --quantize-mlp-with-bit 32,
     8 and 16, the launch counts set to 0 just before each run and read
     just after (no kernel: the JAX package serves it with XLA); the
     quantized stores' bytes on the card (torch.cuda.memory_allocated
     around the quantization) against their size, the card's quantized rows
     (each group's first and last 4,096 rows and the first batch's ids) bit
     for bit against the CPU's quantization of the same rows, and the first
     batch's predictions within 0.05 of the float eval step's (the JAX
     test's bound), and the last batch's graph replay within 1e-6 of the
     same step run eagerly; then (after phase s) the captured quantized eval steps
     against the captured float one, in turns, and (after phase t) one
     profiler window each, device time by kind;
  9. export: phase b's CLI training run with --save-onnx, --enable-profiling
     and --collect-execution-graph (one more K1, K2 and K3 launch: the
     collected eager step, on copies of the params); the exported program
     reloaded in the process and run on the trained params and a batch:
     its predictions equal the live forward's bit for bit and it launches
     K1 once; the Chrome trace names every phase and at least one of K1-K3
     (a profiler window may drop a kernel), the execution trace every phase
     and K1's operator; --debug-mode on a tiny model prints the same
     initial parameters on the card as on the CPU;
  10. hybrid: whole-table (hybrid) sharding (``dlrm_yx_tpu_torch.parallel``)
     on phase b's model (Terabyte-MLPerf <=1M rows, B=2048, L=1, bf16,
     RWSAdagrad, pallas): (a) a world of one rank over NCCL, mesh 1 x 1,
     ``HybridRunner`` with the plan's big and small stores laid out from
     the single-device stores drawn on the card, a few captured steps and
     an eval through ``Trainer.fit`` (launch counts set to 0 just before and
     read just after: K1 once a step and an eval batch, K2 and K3 once a
     step), held to ``make_train_step`` from the same params, optimizer
     state and batches (losses and both stores bit for bit, else within
     rtol 1e-5 / atol 1e-6 with the max |diff| shown); no big-store row that
     no live lookup touched changed; the captured N=4 hybrid step against
     the eager one bit for bit; the captured N=16 hybrid step against the
     captured single-device step, in turns; the all-to-all issued before
     the bottom MLP and waited on after it in one profiler window (and the
     device side of that window read: the exchange's device time and the
     time it runs beside the bottom MLP's GEMMs); the stores' bytes on the
     card; (b) two ranks on the card over gloo (NCCL takes one rank a
     device), eager, mesh 1 x 2, greedy sharder: each rank's stores hold
     the tables the plan gives it, K1, K2 and K3 launch once a step on each
     rank, the losses agree with (a)'s within rtol 1e-4, and each table's
     change over the run (gathered to rank 0 by ``extract_tables``, minus
     the table before the run) moved the same rows as (a)'s change and is
     within 5e-2 of it in relative norm (bf16 compute; see TWO_RANK_LOSS).
     This script runs each rank (``--hybrid-rank``);
  11. sharded: row and column sharding (``parallel/row_sharded.py``,
     ``col_sharded.py``) on phase 10's model and batches: (a) for each of
     ``RowShardedRunner`` and ``ColShardedRunner``, a world of one rank over
     NCCL, mesh 1 x 1, its shards laid out from the single-device stores
     drawn on the card, a few captured steps and an eval through
     ``Trainer.fit`` (launch counts set to 0 just before and read just
     after: K1 once a step and an eval batch, K2 and K3 once a step), held
     to ``make_train_step`` as in phase 10 (a); no big-store row that no
     live lookup touched changed; the captured N=4 step against the eager
     one bit for bit; then the captured N=16 row, column and single-device
     steps timed in turns; (b) for each mode two ranks on the card over
     gloo, eager, mesh 1 x 2 (row: half the row space a rank; column: a
     [~7.0M, 64] slice a rank, K2 at width 64): the tables gathered from
     the shards equal the single-device ones, K1, K2 and K3 launch once a
     step on each rank, and the losses and table changes are held to (a)'s
     as in phase 10 (b) (``--sharded-rank``); (c) K2 and K4 on the column
     slice of the big space at M = 2 ([~7.0M, 64]) and M = 4 ([~7.0M, 32])
     with one batch's ids, as drawn and with a hot row on half of K, bit
     for bit against their plain versions on the CPU, with their times,
     the plain versions', ``index_add_``'s and the bounds;
  12. mesh: the mesh paths as one world of NCCL ranks, one a card, where
     there are 4 cards (2 or 3: a world of 2, without hybrid 2 x 2; one:
     a line that says it did not run), started by ``spawn_local``
     (``--mesh-rank``) after the single-device references on card 0:
     (a) on phase 10's model and ACC0 accumulators, hybrid 1 x 4 and
     2 x 2, row and column 1 x 4, each run eagerly and then captured
     (N=4, three dispatches) on the same batches, captured equal to eager
     bit for bit on every rank, K1, K2 and K3 once a step on each rank,
     and the eager run held to card 0's single-device steps (losses within
     rtol 1e-4, each table's change over the run on the same rows and
     within TWO_RANK_CHANGE); (b) MLPerf's 40M-row model (187,767,399
     rows x 128, 96.1 GB of f32 tables) as hybrid, row and column 1 x 4,
     each rank drawing only its own shard on its card: K1, K2 and K3 at
     the rank's shapes against their plain versions, timed warm and cold;
     Trainer.fit (captured steps and an eval) with the launches counted;
     only rows that the rank's own live lookups read changed (against
     the draw, with no copy of the store); max_memory_allocated; the
     captured N=16 step timed at B=2048 and 8192; the hybrid eager step's
     NCCL kernel time and its all-to-all issued before the bottom MLP in
     a profiler trace; (c) ``cli.main`` with phase b's flags and
     --distributed --mesh-model=4 (1M cap), bf16 and f32 compute: each
     rank's launches, rank 0's f32 losses within rtol 1e-4 of card 0's
     single-device CLI run, the bf16 ones read (see ``mesh_cli_argvs``).
     ``python3 chip_smoke.py --phase 12`` runs phases 1, 2 and 12 alone.
Then a JSON line of the kernels (launches from the path each kernel serves:
K1-K3 phase b, K5 phase g, K6 phase h, K4 phase m; K3's grouped launch of
many stores as its own row, timed on the QR step's stores, its launches
from phase y's QR run; every row with its warm and cold times, ``ms`` the
warm one; on 2 or more cards K1-K3 also carry phase 12's launches per
rank and times at its shapes, under ``mesh``),
nvidia-smi's line, and the result line.

Bound: bytes each input read once and each output written once over
3.35 TB/s, or operations over the card's peak for their type (67 TFLOP/s
f32 outside the tensor cores), whichever is larger (H100 SXM data sheet).
Where the work depends on the data (K2's duplicates and inactive items,
K3's untouched rows, the distinct rows K6 and K4 update and those K5
updates with a nonzero weight), the bytes are those this run's inputs need.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# cuBLAS's workspace setting that deterministic algorithms need (phase r),
# set before torch is imported
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
N_SERVE_BATCHES = 4
N_TRAIN_BATCHES = 4  # the training run's steps; its eval takes as many batches
BATCH = 2048
LR = 0.01
FLUSH_BYTES = 128 << 20  # the cold timer's scratch write: well past the 50 MB L2


def fail(msg):
    """Print the failure on both streams (a caller may keep only the end of
    standard error) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_time_ms(fn, reps=20, samples=50, cold=False):
    """Median device time of one fn() call: fn is captured ``reps`` times
    into a CUDA graph, and each of ``samples`` replays is timed with CUDA
    events, so the host's per-call overhead is not in the number.

    Warm (the default), a working set under the L2's 50 MB is read from the
    L2 by every call after the first. Cold, the graph holds ``reps`` x (a
    write of a FLUSH_BYTES scratch buffer, then the call), a second graph
    the writes alone; the two replay in turns, and the call's time is the
    median of their differences over ``reps``: each call finds its inputs
    in device memory, as a train step finds a store it last touched a step
    before."""
    import torch

    fn()
    torch.cuda.synchronize()
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None
    graphs = []
    for with_fn in (True, False) if cold else (True,):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                if cold:
                    scratch.fill_(1)
                if with_fn:
                    fn()
        graph.replay()
        graphs.append(graph)
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        sample = []
        for graph in graphs:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            sample.append(e0.elapsed_time(e1) / reps)
        times.append(sample[0] - sample[1] if cold else sample[0])
    del graphs, scratch
    return statistics.median(times)


def cold_reading(what, fn, bound, reps=20, samples=50):
    """fn's cold device time (``device_time_ms(cold=True)``); fails where it
    is below ``bound``, the least time the card could take: the byte count
    is wrong or the kernel skipped work."""
    ms = device_time_ms(fn, reps, samples, cold=True)
    if not ms >= bound:
        fail(f"{what}: cold reading {ms:.5f} ms below its bound {bound:.5f} ms")
    return ms


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
            row = {"max_abs_err": err, "ms": ms, "warm_ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "cold_ms": cold_reading(f"fused_interaction B={b} {cdt}",
                                           lambda: fused_interaction(x, ly, itself, cdt),
                                           bound_ms)}
            say("kernel", f"  cold (L2 flushed before each call): {row['cold_ms']:.5f} ms")
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
    """Phase 6: eager eval steps at full width on device-drawn params and
    batch. Returns the fused-interaction step, its config, params and batch."""
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
    steps = {impl: make_eval_step(dataclasses.replace(cfg, interaction_impl=impl),
                                  capture=False)
             for impl in ("pallas", "xla")}

    def check(impl, out):
        preds, loss = out
        if not math.isfinite(loss.item()) or not torch.isfinite(preds).all():
            fail(f"serving step ({impl}) gave non-finite output")

    times = time_in_turns({impl: (lambda s=s: s(params, batch)) for impl, s in steps.items()},
                          check)
    for impl, ts in times.items():
        ms = statistics.mean(ts)
        say("throughput", f"eval step (eager), interaction {impl}: {ms:.4f} ms/step "
                          f"({BATCH / ms * 1e3:.0f} examples/s; runs {ts})")
    return steps["pallas"], cfg, params, batch


def profile_step(run_once, what, phases, steps=1):
    """Phases 7, e, k, p and t: where a step's device time goes, over 10
    calls of ``run_once`` that run ``steps`` steps each. Returns the device
    ms per step of each kernel by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run_once()
    torch.cuda.synchronize()
    calls = 10
    n = calls * steps  # steps in the window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
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
                       f"x{e.count / n:g} {e.key[:90]}")
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
                  f"wrapper (plan + apply + place + tail, CUDA graph) {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, index_add_ {library_ms:.5f} ms, bound {bound:.5f} ms "
                  f"({by}, {nbytes} B)")
    del masked, idx64
    cold = cold_reading("sparse_rows_overwrite",
                        lambda: sparse_rows_overwrite(store, idx, new_vals, delta, active), bound)
    say("kernel", f"  cold (L2 flushed before each call): {cold:.5f} ms")
    check_overwrite_traffic(big, store, gen, tol)
    return {"max_abs_err": err, "ms": ms, "warm_ms": ms, "cold_ms": cold, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def check_finish_kernel(small):
    """Phase a, K3: the small group's store, f32 and bf16, a padded
    accumulator, and the coalesced gradient of one batch (18 tables x
    2048 uniform ids); returns the f32 row (the training path's store)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    return finish_case("the Terabyte small group", small, batch_rows(small, gen, repeats=False),
                       gen, (torch.float32, torch.bfloat16), acc_tol=1e-6)


def finish_bytes(store, dense_g):
    """K3's bytes on one store: the gradient read whole; each touched row's
    store read and written and its accumulator entry read and written.
    Returns (bytes, touched rows)."""
    r, w = dense_g.shape
    touched = int((dense_g != 0).any(dim=1).sum().item())
    return 4 * r * w + touched * (2 * store.element_size() * w + 8), touched


def finish_tols(dtype, want_a, acc_tol=None):
    """(store, accumulator) tolerances of K3 against its plain version: both
    sum g*g in f32 in other orders, so a bf16 store may round one ulp apart
    (2^-8 of the value); the accumulators agree to ``acc_tol``, by default
    1e-6 of the largest (pooled ids sum many rows)."""
    import torch

    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    return tol, acc_tol if acc_tol is not None else 1e-6 * max(1.0, want_a.abs().max().item())


def finish_case(what, group, ids, gen, dtypes=None, acc_tol=None):
    """K3 on a group's store (f32, or each of ``dtypes``), its padded
    accumulator and the coalesced gradient of the global row ids ``ids`` (a
    random gradient row each): against the plain version (``finish_tols``),
    the accumulator's padding kept, timed warm and cold (the cold reading
    held to its bound); returns the first dtype's row of the kernels line.
    ``acc_tol``: see ``finish_tols``."""
    import torch

    from dlrm_yx_tpu_torch.ops.dense_finish import (
        rwsadagrad_dense_finish,
        rwsadagrad_dense_finish_reference,
    )
    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    r, w = group.total_rows, group.dim
    ids = ids.long()
    dense_g = torch.zeros(r, w, device="cuda")
    dense_g.index_add_(0, ids, torch.randn(ids.numel(), w, device="cuda", generator=gen))
    acc = torch.rand(acc_len(r), device="cuda", generator=gen)
    row = None
    for dtype in dtypes or (torch.float32,):
        store = (torch.rand(r, w, device="cuda", generator=gen) - 0.5).to(dtype)
        got = rwsadagrad_dense_finish(store.clone(), acc.clone(), dense_g, LR, w, 1e-10)
        want = rwsadagrad_dense_finish_reference(store.clone(), acc.clone(), dense_g, LR, w,
                                                 1e-10)
        torch.cuda.synchronize()
        err, aerr, tol, atol = check_finished(f"rwsadagrad_dense_finish {what}", [got], [want],
                                              [(store, acc, dense_g)], acc_tol)
        del got, want
        nbytes, touched = finish_bytes(store, dense_g)
        bound, by = bound_ms(nbytes, touched * 5 * w)
        # the lr on the card, as the train step passes it (a float would add a fill a call)
        lr = torch.full((), LR, device="cuda")

        def call():
            rwsadagrad_dense_finish(store, acc, dense_g, lr, w, 1e-10)

        warm = device_time_ms(call)
        cold = cold_reading(f"rwsadagrad_dense_finish {what} {dtype}", call, bound)
        plain_ms = device_time_ms(
            lambda: rwsadagrad_dense_finish_reference(store, acc, dense_g, LR, w, 1e-10))
        say("kernel", f"rwsadagrad_dense_finish {what}: store [{r}, {w}] {dtype}, acc "
                      f"{acc.numel()}, {touched} rows touched by {ids.numel()} ids: max_abs_err "
                      f"{err:.3e} (tol {tol:.3e}), acc err {aerr:.3e} (tol {atol:.3e}); kernel "
                      f"cold {cold:.5f} ms, warm {warm:.5f} ms, plain {plain_ms:.5f} ms, "
                      f"bound {bound:.5f} ms ({by}, {nbytes} B)")
        if row is None:
            row = {"max_abs_err": err, "ms": warm, "cold_ms": cold, "warm_ms": warm,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   # no single PyTorch call does a row-wise Adagrad step
                   "library_ms": None}
    return row


# K3's routes by row width (the kernel's narrow_lanes): on the 16-byte route
# (dim % 4 == 0) lane groups of G = 1, 2, 4 (dim 12: a lane idle), 4, 8, 16
# lanes up to 64 columns, a warp per row from 68 (dim 100: lanes idle; 160
# and past: a second chunk for some lanes, 640: five); on the scalar route
# lane groups of G = 1, 2, 4, 8, 16 up to 15 columns (dim 3: a lane idle),
# a warp per row from 17 (dims 31 and 33 about one pass of the warp, 130
# several)
FINISH_ROUTE_DIMS = (4, 8, 12, 16, 32, 64, 68, 100, 128, 160, 256, 384, 512, 640,
                     1, 2, 3, 5, 9, 15, 17, 31, 33, 130)


def finish_inputs(r, w, dtype, gen, live=0.2):
    """(store [r, w] of ``dtype``, a padded accumulator, a gradient whose
    rows are nonzero on a ``live`` share of the rows and zero elsewhere)."""
    import torch

    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    store = (torch.rand(r, w, device="cuda", generator=gen) - 0.5).to(dtype)
    acc = torch.rand(acc_len(r), device="cuda", generator=gen)
    g = torch.randn(r, w, device="cuda", generator=gen)
    g *= (torch.rand(r, 1, device="cuda", generator=gen) < live).float()
    return store, acc, g


def check_finished(what, got, want, before, acc_tol=None):
    """K3's (store, acc) pairs against the plain version's (``finish_tols``),
    with each untouched row's store and accumulator entry and each
    accumulator's padding bit-identical to ``before`` (store, acc, g).
    Returns the largest store and accumulator errors, with the last
    item's tolerances."""
    import torch

    worst = (0.0, 0.0)
    for (gs, ga), (ws, wa), (s0, a0, g) in zip(got, want, before):
        r, w = s0.shape
        tol, atol = finish_tols(s0.dtype, wa, acc_tol)
        err = (gs.float() - ws.float()).abs().max().item()
        aerr = (ga - wa).abs().max().item()
        idle = ~(g != 0).any(dim=1)
        kept = (torch.equal(bits(gs[idle]), bits(s0[idle]))
                and torch.equal(bits(ga[:r][idle]), bits(a0[:r][idle]))
                and torch.equal(bits(ga[r:]), bits(a0[r:])))
        if not (err <= tol and aerr <= atol and kept):
            fail(f"{what}, store [{r}, {w}] {s0.dtype}: store err {err} > {tol} or acc err "
                 f"{aerr} > {atol}, or an untouched row or the padding changed: {not kept}")
        worst = (max(worst[0], err), max(worst[1], aerr))
    return worst + (tol, atol)


def check_finish_routes():
    """Phase a, K3's routes: a store of each width of FINISH_ROUTE_DIMS, f32
    and bf16, 3,001 rows (a ragged last tile), a fifth of them touched,
    each finished alone (one launch each) and all together in one grouped
    launch, then 70 of them grouped (two launches: 64 stores a launch), each
    against the plain version with the untouched rows and the padding
    bit-identical and the launches counted."""
    import torch

    from dlrm_yx_tpu_torch.ops.dense_finish import (
        rwsadagrad_dense_finish,
        rwsadagrad_dense_finish_many,
        rwsadagrad_dense_finish_many_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)
    lr = torch.full((), LR, device="cuda")
    cases = [finish_inputs(3001, w, dtype, gen)
             for w in FINISH_ROUTE_DIMS for dtype in (torch.float32, torch.bfloat16)]
    want = rwsadagrad_dense_finish_many_reference(
        [(s.clone(), a.clone(), g) for s, a, g in cases], LR, 1e-10)
    n0 = rwsadagrad_dense_finish.launches
    got = [rwsadagrad_dense_finish(s.clone(), a.clone(), g, lr, s.shape[1], 1e-10)
           for s, a, g in cases]
    torch.cuda.synchronize()
    check_finished("rwsadagrad_dense_finish (one store a launch)", got, want, cases)
    singles = rwsadagrad_dense_finish.launches - n0
    for n_stores, launches in ((len(cases), 1), (70, 2)):
        # each a copy of case i % len(cases)
        pick = [i % len(cases) for i in range(n_stores)]
        items = [(cases[i][0].clone(), cases[i][1].clone(), cases[i][2]) for i in pick]
        m0, k0 = rwsadagrad_dense_finish_many.launches, rwsadagrad_dense_finish.launches
        got = rwsadagrad_dense_finish_many(items, lr, 1e-10)
        torch.cuda.synchronize()
        ran = (rwsadagrad_dense_finish_many.launches - m0, rwsadagrad_dense_finish.launches - k0)
        check_finished(f"rwsadagrad_dense_finish_many, {n_stores} stores", got,
                       [want[i] for i in pick], [cases[i] for i in pick])
        if ran != (launches, launches):
            fail(f"rwsadagrad_dense_finish_many of {n_stores} stores: {ran} launches (grouped, "
                 f"K3), want {launches}")
    if singles != len(cases):
        fail(f"rwsadagrad_dense_finish: {singles} launches for {len(cases)} stores")
    say("kernel", f"rwsadagrad_dense_finish routes: widths {FINISH_ROUTE_DIMS}, f32 and bf16, "
                  f"3001 rows a fifth touched: {len(cases)} single launches and grouped "
                  f"launches of {len(cases)} stores (1 launch) and 70 (2 launches) equal the "
                  "plain version within tolerance, untouched rows and padding bit-identical")


def grouped_finish_case(what, items):
    """K3's grouped launch on ``items``, (store, acc, g) as a train step
    collected them: against the plain version (``check_finished``), timed
    warm and cold (the cold reading held to the bound: the sum of the
    stores' bytes), beside the stores finished one launch each (cold) and
    the plain version. Returns its row of the kernels line."""
    import torch

    from dlrm_yx_tpu_torch.ops.dense_finish import (
        rwsadagrad_dense_finish,
        rwsadagrad_dense_finish_many,
        rwsadagrad_dense_finish_many_reference,
    )

    got = rwsadagrad_dense_finish_many([(s.clone(), a.clone(), g) for s, a, g in items], LR,
                                       1e-10)
    want = rwsadagrad_dense_finish_many_reference(
        [(s.clone(), a.clone(), g) for s, a, g in items], LR, 1e-10)
    torch.cuda.synchronize()
    err = check_finished(f"rwsadagrad_dense_finish_many, {what}", got, want, items)[0]
    del got, want
    nbytes = touched = ops = 0
    for s, _, g in items:
        b, t = finish_bytes(s, g)
        nbytes, touched, ops = nbytes + b, touched + t, ops + t * 5 * s.shape[1]
    bound, by = bound_ms(nbytes, ops)
    lr = torch.full((), LR, device="cuda")

    def grouped():
        rwsadagrad_dense_finish_many(items, lr, 1e-10)

    def one_by_one():
        for s, a, g in items:
            rwsadagrad_dense_finish(s, a, g, lr, s.shape[1], 1e-10)

    warm = device_time_ms(grouped)
    cold = cold_reading(f"rwsadagrad_dense_finish_many, {what}", grouped, bound)
    singles = cold_reading(f"rwsadagrad_dense_finish one launch a store, {what}", one_by_one,
                           bound)
    plain_ms = device_time_ms(
        lambda: rwsadagrad_dense_finish_many_reference(items, LR, 1e-10))
    widths = sorted({s.shape[1] for s, _, _ in items})
    say("kernel", f"rwsadagrad_dense_finish_many, {what}: {len(items)} stores (widths {widths}, "
                  f"{sum(s.shape[0] for s, _, _ in items)} rows, {touched} touched): "
                  f"max_abs_err {err:.3e}; one launch cold {cold:.5f} ms, warm {warm:.5f} ms; "
                  f"one launch a store cold {singles:.5f} ms; plain {plain_ms:.5f} ms; bound "
                  f"{bound:.5f} ms ({by}, {nbytes} B)")
    return {"max_abs_err": err, "ms": warm, "cold_ms": cold, "warm_ms": warm,
            "one_launch_a_store_cold_ms": singles, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "what": what}


def record_finish_stores(cfg, opt, params, state, batch):
    """The (store, acc, g) items that one eager train step of ``cfg`` on
    ``params`` and ``state`` (updated by the step) finishes with K3, as
    copies taken before the finish ran: the grouped finish's stores, or
    the stores finished one a call (a checkout without the grouped
    finish)."""
    from dlrm_yx_tpu_torch.optim import optimizer
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    seen, real = [], {}

    def keep(stores):
        seen.extend((s.clone(), a.clone(), g.clone()) for s, a, g in stores)

    def many(stores, lr, eps):
        keep(stores)
        return real["rwsadagrad_dense_finish_many"](stores, lr, eps)

    def one(store, acc, g, lr, dim, eps):
        keep([(store, acc, g)])
        return real["rwsadagrad_dense_finish"](store, acc, g, lr, dim, eps)

    for name, fn in (("rwsadagrad_dense_finish_many", many), ("rwsadagrad_dense_finish", one)):
        if hasattr(optimizer, name):
            real[name] = getattr(optimizer, name)
            setattr(optimizer, name, fn)
    try:
        make_train_step(cfg, opt, device="cuda")(params, state, batch, 0)
    finally:
        for name, fn in real.items():
            setattr(optimizer, name, fn)
    return seen


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
    from dlrm_yx_tpu_torch.ops.dense_finish import (
        rwsadagrad_dense_finish,
        rwsadagrad_dense_finish_many,
    )
    from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
    from dlrm_yx_tpu_torch.ops.stream_update import sorted_stream_add, sorted_stream_apply

    return {"fused_interaction": fused_interaction,
            "sparse_rows_overwrite": sparse_rows_overwrite,
            "rwsadagrad_dense_finish": rwsadagrad_dense_finish,
            "rwsadagrad_dense_finish_many": rwsadagrad_dense_finish_many,
            "sorted_stream_apply": sorted_stream_apply,
            "sorted_stream_add": sorted_stream_add,
            "sparse_rows_add": sparse_rows_add}


def only(**launched):
    """A launch-count dict: the named kernels' counts, every other kernel 0.
    K3's grouped launches (``rwsadagrad_dense_finish_many``, counted in K3's
    launches too) are all of K3's unless named: the train steps finish their
    dense-branch stores in one grouped launch a step."""
    want = {name: launched.get(name, 0) for name in launch_counters()}
    if "rwsadagrad_dense_finish_many" not in launched:
        want["rwsadagrad_dense_finish_many"] = want["rwsadagrad_dense_finish"]
    return want


def cli_training_run(phase, what, argv, n_steps, want, big_index, n_prints=None, out=None):
    """A CLI training run (``cli.main`` without --inference-only: n_steps
    steps, then an eval), with the launch counts set to 0 just before and
    read just after. Fails unless the kernels launched as ``want`` says,
    the ``n_prints`` printed losses (one a step by default) and the eval
    metrics are finite, and (unless ``big_index`` is None) the big store
    changed where it should, bit for bit: every row that a live
    (nonzero-weight) lookup of the first batch touched changed, and no row
    that no live lookup touched (once the loss saturates, a later step's
    samples may have an exactly zero gradient). Returns the launch counts;
    ``out`` (a dict) also gets the trainer, the printed losses, the output,
    the metrics and the run's seconds."""
    import contextlib
    import gc
    import io
    import math
    import re

    import torch

    from dlrm_yx_tpu_torch import cli

    made = []
    gc.collect()  # the graphs of earlier runs go before this one's are counted
    torch.cuda.empty_cache()

    class Recorded(cli.Trainer):
        """The CLI's Trainer, keeping the big store as it was before the
        run and the batches it trained on."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if big_index is not None:
                self.big_before = self.params["emb"][big_index].clone()
            made.append(self)

        def fit(self, train, test):
            self.trained_on = train
            return super().fit(train, test)

    counters = launch_counters()
    printed = io.StringIO()
    cli.Trainer = Recorded
    try:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            metrics = cli.main(argv)
        seconds = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        cli.Trainer = Recorded.__base__
    text = printed.getvalue()
    losses = [float(x) for x in re.findall(r"loss ([-+.\deE]+|nan|inf)", text)]
    for line in text.splitlines():
        if not line.startswith(":::MLLOG"):
            say(phase, f"  cli: {line}")
    if launches != want:
        fail(f"{what}: launched {launches}, want {want}")
    n_prints = n_steps if n_prints is None else n_prints
    if len(losses) != n_prints or not all(map(math.isfinite, losses)):
        fail(f"{what}: losses {losses}, want {n_prints} finite values")
    # the eval always gives accuracy and streaming_auc; roc_auc with --mlperf-logging
    keys = ("accuracy", "streaming_auc") + ("roc_auc",) * ("--mlperf-logging" in argv)
    for key in keys:
        if not math.isfinite(metrics.get(key, math.nan)):
            fail(f"{what}: post-training metric {key} = {metrics.get(key)} is missing or "
                 f"not finite")
    trainer = made[0]
    if out is not None:
        out.update(trainer=trainer, losses=losses, text=text, metrics=metrics, seconds=seconds)
    shown = {k: round(v, 6) for k, v in metrics.items() if isinstance(v, float)}
    if big_index is None:
        say(phase, f"{what}: {n_steps} steps and an eval in {seconds:.1f} s (host init and "
                   f"data included); losses {losses}; eval {shown}; launches {launches}")
        return launches
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
    interaction impl, and the state they share; with the fused
    interaction's config and the optimizer."""
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
    return (steps, params, state, batch, cfg.dup_density_hint,
            dataclasses.replace(cfg, interaction_impl="pallas"), opt)


def time_in_turns(fns, check, n=20):
    """Each fn of ``fns`` (name -> fn()) warmed up 5 times, then timed over
    ``n`` calls with CUDA events in turns (first to last, then last to
    first); ``check(name, out)`` sees each window's last output. Returns
    name -> [ms per call of each window]."""
    def window(name, calls):
        ms, out = events_ms(fns[name], calls)
        check(name, out)
        return ms

    for name in fns:
        window(name, 5)  # warm-up (a captured step's warm-up and capture)
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
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
    """A train step's loss (or a dispatch's losses) is finite."""
    import torch

    if not bool(torch.isfinite(out[2]).all()):
        fail(f"train step ({name}) gave a non-finite loss")


def train_throughput(steps, params, state, batch, hint):
    """Phase d: train steps at full width, CUDA-event timed, in turns."""
    times = time_in_turns({impl: train_step_fn(s, params, state, batch)
                           for impl, s in steps.items()}, check_loss)
    for impl, ts in times.items():
        ms = statistics.mean(ts)
        say("throughput", f"train step (eager; rwsadagrad, bf16, sparse-update pallas, density "
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
    cold = cold_reading("sorted_stream_apply",
                        lambda: sorted_stream_apply(store, pos, seg, w_eff, gtab), bound)
    say("kernel", f"  cold (L2 flushed before each call): {cold:.5f} ms")
    k5 = {"max_abs_err": err, "ms": ms, "warm_ms": ms, "cold_ms": cold, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by, "library_ms": None}
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
    cold = cold_reading("sorted_stream_add", lambda: sorted_stream_add(store, pos, upd), bound)
    say("kernel", f"  cold (L2 flushed before each call): {cold:.5f} ms")
    k6 = {"max_abs_err": err, "ms": ms, "warm_ms": ms, "cold_ms": cold, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by, "library_ms": library_ms}
    return k5, k6


def check_stream_apply_traffic(group, store, b, gidx, gtab, compare):
    """Phase f, K5 on more traffic from the benchmark batch, each against its
    plain version with its time: (i) every weight-0 id sent to its table's
    row 0, as host batches pad (one run of ~100k items a table); (ii) every
    weight 0; (iii) a grad row holding inf and one holding NaN, referenced
    only by weight-0 items: 0 * inf is NaN, and the NaN rows must match;
    (iv) a store with -0.0 elements: the elements that keep -0.0 where the
    plain version's +0.0 add makes +0.0 are counted, not failed; (v)
    learned pooling's weights w * v_W[row] (the train step's w_eff), v_W 0
    on a tenth of the rows, negative on a tenth and random elsewhere."""
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
    del got, want, neg

    # (v) w * v_W[row], v_W as learning may leave it: 0, negative, random
    u = torch.rand(store.shape[0], device="cuda", generator=gen)
    vw = torch.where(u < 0.1, 0.0, torch.where(u < 0.2, -u, 2 * u))
    w_vw = w_eff * vw[pos.long()]
    vw_rows = int(torch.unique_consecutive(pos[w_vw != 0]).numel())
    err, rel, ms, plain_ms = timed("w * v_W", w_vw, gtab, vw_rows)
    # the bound as phase f's benchmark row counts it: the rows with a nonzero
    # weight read and written once, the (pos, seg, w) streams and the grad table
    d = store.shape[1]
    nbytes = 2 * 4 * d * vw_rows + 12 * pos.numel() + 4 * gtab.numel()
    bound, by = bound_ms(nbytes, 2 * d * int((w_vw != 0).sum()))
    say("kernel", f"sorted_stream_apply, learned pooling's weights w * v_W[row] (v_W 0 on "
                  f"{int((vw == 0).sum())} rows, negative on {int((vw < 0).sum())}, random "
                  f"elsewhere): max_abs_err {err:.3e} (relative {rel:.3e}), {vw_rows} rows "
                  f"changed, kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound:.5f} ms "
                  f"({by}, {nbytes} B)")


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
    on params that RWSAdagrad's first steps have moved can diverge. Also
    returns the SGD step's (config, optimizer, params, state, batch)."""
    import dataclasses

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    cfg = benchmark_config()
    batch = benchmark_batch(cfg, BATCH, seed=3)
    sgd, rws = OptConfig("sgd", 0.1), OptConfig("rwsadagrad", LR)
    rws_params = init_dlrm_on_device(cfg, seed=0)
    sgd_params = init_dlrm_on_device(cfg, seed=0)
    return {
        "sgd pallas": train_step_fn(make_train_step(cfg, sgd), sgd_params, {}, batch),
        "rwsadagrad stream": train_step_fn(
            make_train_step(dataclasses.replace(cfg, sparse_update_impl="stream"), rws),
            rws_params, init_opt_state(rws, rws_params, model_groups(cfg)), batch),
    }, (cfg, sgd, sgd_params, {}, batch)


def l100_throughput(steps):
    """Phase j: both L=100 steps, CUDA-event timed, in turns."""
    for name, ts in time_in_turns(steps, check_loss).items():
        ms = statistics.mean(ts)
        say("throughput", f"L={L100} train step (eager), 8 x 1M x 64, B={BATCH}, bf16, {name}: "
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


# kernels of the L=1 train step by what they do (names as torch 2.x gives them)
L1_KINDS = {
    "K1 fused_interaction": "fused_interaction",
    "K2 sparse_rows_overwrite (row_plan)": "row_plan",
    "K3 rwsadagrad_dense_finish": "dense_finish",
    "gather (index_select)": "indexselect|index_select|gather",
    "scatter (index_add_, index_put_)": "indexfunc|index_add|scatter|index_put|indexing_backward",
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


def sr_step_on_card():
    """K4's SR step 7 on the card, as a train step passes it (an int would
    add a fill to every call); the plain version takes the int 7."""
    import torch

    return torch.full((), 7, dtype=torch.int64, device="cuda")


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
        got = sparse_rows_add(store.clone(), ids, upd, active, True, seed=sr_step_on_card())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse_rows_add_reference(store, ids, upd, active, True, seed=7)
        plain_s = time.perf_counter() - t0
        equal, err = same_bits(got, store)
        del got
        if not equal:
            fail(f"sparse_rows_add, {case}: kernel and plain version differ (max abs err {err})")
        seed = sr_step_on_card()
        ms = device_time_ms(lambda: sparse_rows_add(store, ids, upd, active, True, seed=seed),
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
        seed = sr_step_on_card()
        got = sparse_rows_add(store.clone(), ids, upd, active, sr, seed=seed)
        torch.cuda.synchronize()
        sparse_rows_add_reference(store, ids, upd, active, sr, seed=7)
        equal, err = same_bits(got, store)
        moved = bool((bits(got.index_select(0, uniq)) != bits(before)).any(dim=1).all())
        del got
        if not equal or not moved:
            fail(f"sparse_rows_add {what}: kernel and plain version differ (max abs err "
                 f"{err}), or a touched row kept its value")
        ms = device_time_ms(lambda: sparse_rows_add(store, ids, upd, active, sr, seed=seed))
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
                      f"touched row changed; wrapper (plan + apply + place + tail, CUDA graph) {ms:.5f} ms, "
                      f"plain {plain_ms:.5f} ms (CUDA events over 10 calls, host sync "
                      f"included), index_add_ "
                      f"{'none' if library_ms is None else f'{library_ms:.5f} ms'}, bound "
                      f"{bound:.5f} ms ({by}, {nbytes} B)")
        if row is None:
            cold = cold_reading(f"sparse_rows_add {what}", lambda: sparse_rows_add(
                store, ids, upd, active, sr, seed=seed), bound)
            say("kernel", f"  cold (L2 flushed before each call): {cold:.5f} ms")
            row = {"max_abs_err": err, "ms": ms, "warm_ms": ms, "cold_ms": cold,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": library_ms}
        if sr:
            check_rows_add_traffic(group, store, gen)
    del store
    torch.cuda.empty_cache()
    return row


GRAPH_NODE_KINDS = ("KERNEL", "MEMSET", "MEMCPY", "HOST", "EMPTY", "MEM_ALLOC", "MEM_FREE",
                    "EVENT_RECORD", "WAIT_EVENT", "CONDITIONAL", "GRAPH")


DCN_CELL = "dcn25m-train-multihot-zipf"
DCN_SPREAD_ROWS = 1 << 26  # past ACC_KERNEL_MIN_BYTES: the momentum takes K4, as in the cell


def dcn_step_items(seed=1):
    """One step's big-store bag items of the DLRM-DCNv2 cell on the card:
    (flat_idx [K] int32, as the step's, a ``BagRowGrads`` over a random pooled cotangent
    [T_g * B, 128] of scale 1e-3, store rows). The ids are the benchmark's
    draw (``benchmark.train_dcn.make_bag_batches`` from ``seed``), their
    distinct rows spread at random over DCN_SPREAD_ROWS rows: the cell's
    runs, in a store about half the cell's big store."""
    import torch

    from benchmark.common import Bench, program_config
    from benchmark.reference_dcn import model_shape
    from benchmark.train_dcn import make_bag_batches
    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.embedding import bag_row_grads, bag_slots

    cell = Bench().cell(DCN_CELL)
    _, cfg = program_config(cell.config)
    shape = model_shape(cell.config)
    ((_, ids, _, _),) = make_bag_batches(cell.mix, shape, 1, seed, "cuda")
    groups = model_groups(cfg)
    gi = next(i for i, g in enumerate(groups) if g.size_class == 1)
    bags = bag_slots(groups, cfg.multi_hot_sizes)[gi]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_pooled = torch.randn(len(bags.sizes), shape["batch"], groups[gi].dim, device="cuda",
                           generator=gen) * 1e-3
    flat_idx, grads = bag_row_grads(bags, torch.from_numpy(ids).cuda(), g_pooled, expand=False)
    uniq, inv = torch.unique(flat_idx.long(), return_inverse=True)
    rows = torch.randperm(DCN_SPREAD_ROWS, device="cuda", generator=gen)[:uniq.numel()]
    return rows[inv].to(torch.int32), grads, DCN_SPREAD_ROWS + 16


def torch_coalesce_route(store, acc, flat_idx, flat_g, old_rows, lr, sentinel, eps=1e-10):
    """RWSAdagrad's coalesce-first write-only update as the optimizer took
    it before K7, in place: the plain coalesce with the gathered rows by
    representative, the momentum (K4 past ACC_KERNEL_MIN_BYTES) and the
    finish on every item, K2."""
    import torch

    from dlrm_yx_tpu_torch.ops.coalesce import coalesce_rows_reference
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
    from dlrm_yx_tpu_torch.optim import optimizer as opt_mod

    flat_idx, flat_g, old_rows = coalesce_rows_reference(flat_idx, flat_g, sentinel,
                                                         aux=old_rows)
    active = (flat_idx < sentinel).to(torch.int32)
    safe = torch.where(active > 0, flat_idx, sentinel)
    mom_inc = ((flat_g * flat_g).sum(dim=-1) / store.shape[1]) * active
    opt_mod._acc_update_1d(acc, flat_idx, mom_inc, active, sentinel, "pallas")
    denom = opt_mod._take_fill(acc, safe, 1.0, sentinel).sqrt() + eps
    delta = -lr * flat_g / denom[:, None]
    sparse_rows_overwrite(store, flat_idx, old_rows + delta, delta, active)
    return store, acc


def check_coalesce_route():
    """Phase a, K7: ``optimizer._coalesced_overwrite`` (sort, K7a, K4, K7b,
    K2) on one step of the DLRM-DCNv2 cell's big-store items against
    ``torch_coalesce_route`` on the same inputs: the store to f32's rtol
    1e-5 / atol 1e-6, the momentum to rtol 1e-4 (each side's sums of up to
    ~87,000 items a row round in their own order, a few 1e-7 of the sum of
    |g| apart; a dropped or doubled item moves a row's momentum by 1e-5 of
    it or more); K7a twice bit for bit; ``coalesce.kernel`` once a call and
    ``coalesce.rows`` the step's distinct rows."""
    import torch

    from dlrm_yx_tpu_torch.ops.coalesce import coalesce_segments
    from dlrm_yx_tpu_torch.optim import optimizer as opt_mod
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len
    from dlrm_yx_tpu_torch.utils.profiling import counter_deltas, counters

    flat_idx, grads, rows = dcn_step_items(1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    store = torch.rand(rows, 128, device="cuda", generator=gen) * 0.1 - 0.05
    acc = torch.rand(acc_len(rows), device="cuda", generator=gen) * 0.1
    old = store.index_select(0, flat_idx)
    lr = torch.tensor(0.005, device="cuda")
    opt = OptConfig("rwsadagrad", 0.005)
    uniq = torch.unique(flat_idx.long())
    n_rows = uniq.numel()
    before = counters()
    one = coalesce_segments(flat_idx, grads, rows, mdim=128, zero_tail=True)
    two = coalesce_segments(flat_idx, grads, rows, mdim=128, zero_tail=True)
    torch.cuda.synchronize()
    moved = counter_deltas(before, counters())
    if moved.get("coalesce.kernel") != 2 or moved.get("coalesce.rows") != 2 * n_rows:
        fail(f"K7a: counted {moved} for two calls on {n_rows} distinct rows")
    for a, b in zip(one, two):
        if not torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)):
            fail("K7a: two calls on the same items differ")
    split = moved.get("coalesce.split_runs", 0) // 2
    del one, two
    # each route on the same store in turn (a copy of it would not fit):
    # only the touched rows and the momentum change, and are put back
    pre, acc0 = store[uniq], acc.clone()
    torch_coalesce_route(store, acc, flat_idx, grads.expand(), old, lr, rows)
    want_s, want_a = store[uniq], acc.clone()
    store[uniq] = pre
    acc.copy_(acc0)
    opt_mod._coalesced_overwrite(opt, store, acc, flat_idx, grads, lr, rows, "pallas", old)
    got_s, got_a = store[uniq], acc
    torch.cuda.synchronize()
    if not torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-6):
        fail(f"K7 route: store off the torch route by {(got_s - want_s).abs().max().item()}")
    if not torch.allclose(got_a, want_a, rtol=1e-4, atol=0):
        err = ((got_a - want_a).abs() / want_a.abs().clamp_min(1e-30)).max().item()
        fail(f"K7 route: momentum off the torch route by {err} relative")
    changed = int((got_s != pre).any(dim=1).sum())
    if changed != n_rows:
        fail(f"K7 route: {changed} store rows changed of {n_rows} distinct rows")
    say("a", f"K7 route on one DLRM-DCNv2 step (K = {flat_idx.numel()}, {n_rows} distinct "
             f"rows, {split} summed across chunks): equals the torch route (store rtol 1e-5, "
             f"momentum rtol 1e-4); K7a bit for bit twice")


CROSS_SHAPE = (8192, 3456, 512, 3)  # DLRM-DCNv2's cell: B, N, rank, layers


def cross_inputs(seed):
    """x0 [B, N], the cross layers (V, W, b) and an upstream gradient at
    ``CROSS_SHAPE``, f32 on the card: x0 and the gradient N(0, 1), V and W
    TorchRec's Xavier normal, b N(0, 0.1) (zero at init; nonzero here so
    that its add is exercised)."""
    import torch

    b_, n, r, layers = CROSS_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    std = (2.0 / (n + r)) ** 0.5
    x0 = torch.randn(b_, n, device="cuda", generator=gen)
    flat = []
    for _ in range(layers):
        flat += [torch.randn(n, r, device="cuda", generator=gen) * std,
                 torch.randn(r, n, device="cuda", generator=gen) * std,
                 torch.randn(n, device="cuda", generator=gen) * 0.1]
    return x0, flat, torch.randn(b_, n, device="cuda", generator=gen)


def cross_route(fn, x0, flat, g):
    """The output of ``fn(x0, layers) -> (y, extra)`` on fresh leaves of x0
    and ``flat``'s layers, and the gradients of x0, every layer's (V, W, b)
    and the tensors ``extra`` under the upstream gradient g."""
    import torch

    leaves = [p.detach().clone().requires_grad_() for p in [x0] + flat]
    layers = [tuple(leaves[1 + 3 * i:4 + 3 * i]) for i in range(len(flat) // 3)]
    y, extra = fn(leaves[0], layers)
    grads = torch.autograd.grad(y, leaves + list(extra), g)
    return [y.detach()] + list(grads)


def check_cross_layer_kernel():
    """Phase a, K8 (``ops/dcn.py``, ``csrc/cross_layer.cu``) at the
    DLRM-DCNv2 cell's cross network, bf16 compute (``CROSS_SHAPE``):

      * each kernel against its plain version run on the card, bit for bit:
        a layer's forward; the backward at the top, a middle and the bottom
        layer (its cotangent, the bf16 product cotangent, x0's gradient, b's
        gradient summed by bands); x0's last term;
      * the whole network, the kernel route against the plain torch path
        (``cross_net_autograd``: autograd through the formula, the
        ``_F32OutProduct`` GEMMs): the output bit for bit; V's and W's
        gradients (the same GEMMs of the same operands) and x0's (five terms
        summed in another order) to f32's rtol 1.3e-6 / atol 1e-5; b's, a
        sum over 8,192 rows in another order, within 1.3e-6 of the column's
        sum of |g * x0| (the forward error bound of a sum, at f32's rtol);
        two calls bit for bit; ``dcn.kernel`` once a call and 10 launches;
      * each kernel's time, warm and cold (its cold reading held to its
        bound: 18 bytes an element for the forward, 30 for a middle layer's
        backward with its bias sum, 12 for x0's last term), beside its plain
        version's, and the whole network's forward and backward on both
        routes in turns.

    Returns the K8 row's numbers (ms)."""
    import torch

    from dlrm_yx_tpu_torch.ops import dcn
    from dlrm_yx_tpu_torch.ops.mlp import product_f32_out
    from dlrm_yx_tpu_torch.utils.profiling import counter_deltas, counters

    bf16 = torch.bfloat16
    rows, width, rank, layers = CROSS_SHAPE
    x0, flat, g = cross_inputs(8)
    elems = rows * width
    band = dcn.band_rows(rows, width)

    def equal(a, b):
        return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                  b.reshape(-1).view(torch.uint8))

    # the kernels against their plain versions, one layer's tensors
    v, w, b = flat[0], flat[1], flat[2]
    x16 = x0.to(bf16)
    xw = dcn._product(dcn._product(x16, v.to(bf16)).to(bf16), w.to(bf16))
    x_l = x0 * 0.5 + 0.25
    got = dcn._layer_forward(xw, b, x0, x_l, True)
    want = dcn.cross_layer_forward_reference(xw, b, x0, x_l, True)
    if not all(equal(a, c) for a, c in zip(got, want)):
        fail("K8 forward: differs from its plain version")
    gx = torch.randn(rows, width, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(9)) * 0.3
    acc0 = torch.randn_like(x0)
    for where, gx_, acc, with_g in (("top", None, None, False), ("middle", gx, acc0, False),
                                    ("bottom", gx, acc0, True)):
        g_out = torch.empty_like(x0) if where == "middle" else None
        got = dcn._layer_backward(g, gx_, x0, xw, b, g_out, None if acc is None else acc.clone(),
                                  with_g, band)
        want = dcn.cross_layer_backward_reference(g, gx_, x0, xw, b,
                                                  None if acc is None else acc.clone(), with_g,
                                                  band)
        if where == "middle" and not equal(got[0], want[0]):
            fail("K8 backward: the cotangent differs from its plain version")
        for name, a, c in (("the product's cotangent", got[1], want[1].to(bf16)),
                           ("x0's gradient", got[2], want[2]), ("b's gradient", got[3], want[3])):
            if not equal(a, c):
                fail(f"K8 backward ({where} layer): {name} differs from its plain version")
    if not equal(dcn._finish(acc0.clone(), gx), dcn.cross_layer_finish_reference(acc0.clone(), gx)):
        fail("K8 finish: x0's gradient differs from its plain version")
    torch.cuda.synchronize()
    say("a", f"K8 kernels at B={rows}, N={width}: each bit for bit with its plain version on "
             f"the card (forward; backward at the top, a middle and the bottom layer, bands of "
             f"{band} rows; x0's last term)")

    # the whole network on both routes
    def kernel_route(x, ls):
        return dcn.cross_net(x, ls, bf16), ()

    def plain_route(x, ls):
        # the formula as cross_net_autograd takes it, each layer's output kept
        xs, y = [], x
        for v_, w_, b_ in ls:
            xv = product_f32_out(y.to(bf16), v_.to(bf16))
            y = x * (product_f32_out(xv.to(bf16), w_.to(bf16)) + b_.float()) + y
            xs.append(y)
        return y, xs[:-1]

    if not equal(plain_route(x0, [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)])[0],
                 dcn.cross_net_autograd(x0, [tuple(flat[i:i + 3])
                                             for i in range(0, len(flat), 3)], bf16)):
        fail("K8: the phase's copy of the formula differs from cross_net_autograd")
    launches = dcn.cross_net.launches
    before = counters()
    one = cross_route(kernel_route, x0, flat, g)
    two = cross_route(kernel_route, x0, flat, g)
    torch.cuda.synchronize()
    moved = counter_deltas(before, counters())
    if moved.get("dcn.kernel") != 2 or dcn.cross_net.launches - launches != 2 * (3 * layers + 1):
        fail(f"K8: counted {moved}, {dcn.cross_net.launches - launches} launches for two calls")
    if not all(equal(a, c) for a, c in zip(one, two)):
        fail("K8: two calls on the same inputs differ")
    del two
    ref = cross_route(plain_route, x0, flat, g)
    if not equal(one[0], ref[0]):
        fail(f"K8: the output differs from the plain torch path by "
             f"{(one[0] - ref[0]).abs().max().item()}")
    # the cotangent of each layer's output: g * x0 is what b's gradient sums
    cot = ref[2 + 3 * layers:] + [g]
    worst, bitwise = 0.0, []
    for i, (a, c) in enumerate(zip(one[1:], ref[1:2 + 3 * layers])):
        name = "x0" if i == 0 else f"layer {(i - 1) // 3}'s {'VWb'[(i - 1) % 3]}"
        if i > 0 and (i - 1) % 3 == 2:
            tol = 1.3e-6 * (cot[(i - 1) // 3] * x0).abs().sum(0)
            err = (a - c).abs()
            if not bool((err <= tol).all()):
                fail(f"K8: {name}'s gradient off the plain torch path by "
                     f"{(err / tol).max().item():.3f} of its bound")
            worst = max(worst, (err / tol).max().item())
        else:
            try:
                torch.testing.assert_close(a, c, rtol=1.3e-6, atol=1e-5)
            except AssertionError as exc:
                fail(f"K8: {name}'s gradient off the plain torch path: {exc}")
        bitwise.append(equal(a, c))
    say("a", f"K8 route on the cell's cross network ({layers} layers, rank {rank}): output bit "
             f"for bit with the plain torch path; gradients within f32's rtol (b's at "
             f"{worst:.4f} of its bound; bit for bit: x0 {bitwise[0]}, V/W "
             f"{all(bitwise[1 + 3 * i + j] for i in range(layers) for j in (0, 1))}, b "
             f"{all(bitwise[3 + 3 * i] for i in range(layers))}); two calls bit for bit; "
             f"dcn.kernel once a call, {3 * layers + 1} launches")
    del one, ref, cot

    # times: each kernel warm and cold against its bound, its plain version
    g_out, t_acc = torch.empty_like(x0), torch.randn_like(x0)
    out = {}
    for name, nbytes, kernel, plain in (
            ("forward", 18 * elems, lambda: dcn._layer_forward(xw, b, x0, x_l, True),
             lambda: dcn.cross_layer_forward_reference(xw, b, x0, x_l, True)),
            ("backward", 30 * elems,
             lambda: dcn._layer_backward(g, gx, x0, xw, b, g_out, t_acc, False, band),
             lambda: dcn.cross_layer_backward_reference(g, gx, x0, xw, b, t_acc, False, band)),
            ("x0 finish", 12 * elems, lambda: dcn._finish(t_acc, gx),
             lambda: dcn.cross_layer_finish_reference(t_acc, gx))):
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        warm = device_time_ms(kernel, reps=5, samples=20)
        cold = cold_reading(f"K8 {name}", kernel, bound, reps=5, samples=20)
        plain_ms = device_time_ms(plain, reps=5, samples=10)
        out[name] = {"bound_ms": bound, "warm_ms": warm, "cold_ms": cold, "plain_ms": plain_ms}
        say("a", f"K8 {name} (one layer, {nbytes / elems:.0f} B an element): {warm:.5f} ms warm, "
                 f"{cold:.5f} cold, bound {bound:.5f} ({100 * bound / warm:.1f}%); plain version "
                 f"{plain_ms:.5f} ms")
    del g_out, t_acc

    # the whole network forward and backward on both routes, in turns
    leaves = [p.detach().clone().requires_grad_() for p in [x0] + flat]
    ls = [tuple(leaves[1 + 3 * i:4 + 3 * i]) for i in range(layers)]

    def both(route):
        def run():
            y = route(leaves[0], ls)
            return torch.autograd.grad(y, leaves, g)[0]
        return run

    times = time_in_turns({"kernel": both(lambda x, l_: dcn.cross_net(x, l_, bf16)),
                           "plain": both(lambda x, l_: dcn.cross_net_autograd(x, l_, bf16))},
                          lambda name, o: None, n=10)
    ms = {k: statistics.median(v) for k, v in times.items()}
    out["network_ms"] = ms
    say("a", f"K8: the cross network's forward and backward (6 GEMMs forward, 12 backward) "
             f"{ms['kernel']:.4f} ms on the kernel route, {ms['plain']:.4f} on the plain torch "
             f"path (in turns: {times})")
    return out


def kernel_name(mangled):
    """A mangled kernel symbol's qualified name, its anonymous namespaces
    left out: the <length><identifier> components of its name, up to its
    template arguments or parameters."""
    parts, i = [], 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    named = [p for p in parts if not p.startswith("_GLOBAL__N")]
    return "::".join(named) if named else mangled


def graph_ops(fn, what):
    """Phase q: the device operations of one fn() call, as the nodes of a
    CUDA graph that captures it: [(kind, label)] from the graph's DOT dump
    (``CUDAGraph.debug_dump``, where a kernel node's label holds its
    function's name), empty nodes left out. A capture records each launch
    on the stream, whichever library makes it, and raises on a host
    synchronisation. (torch.profiler's windows missed some of these
    calls' first kernels at random.)"""
    import re

    import torch

    dump = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "graph_dumps")
    os.makedirs(dump, exist_ok=True)
    path = os.path.join(dump, re.sub(r"\W+", "_", what) + ".dot")
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # the graph stays to be dumped
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        fail(f"{what}: one call could not be captured in a CUDA graph (a host "
             f"synchronisation inside it?): {e}")
    graph.debug_dump(path)
    del graph
    with open(path) as f:
        dot = f.read()
    # node declarations open a line; an edge's line goes on with "->"
    decls = list(re.finditer(r'^\s*"(graph_\d+_node_\d+)"\s*\[', dot, flags=re.M))
    nodes = []
    for i, m in enumerate(decls):
        body = dot[m.end():decls[i + 1].start() if i + 1 < len(decls) else len(dot)]
        body = body.split("];")[0]
        kind = next((k for k in GRAPH_NODE_KINDS if re.search(rf"\b{k}\b", body)), "?")
        name = re.search(r"_Z\w+", body)
        if kind != "EMPTY":
            nodes.append((kind, kernel_name(name.group(0)) if name
                          else " ".join(body.split())[:80]))
    if not nodes:
        fail(f"{what}: no node read from the captured graph's dump {path}: {dot[:1500]!r}")
    return nodes


def count_device_ops(big, cap_big):
    """Phase q: the device operations (kernels, memsets, copies) of one
    wrapper call at each main-path shape of K2 and K4, the nodes of a
    CUDA graph that captures it (graph_ops); fails above 5 or on a sort."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    gen = torch.Generator(device="cuda").manual_seed(15)
    seed = torch.full((), 7, dtype=torch.int64, device="cuda")  # on the card, as a step passes it
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
            fn = lambda: sparse_rows_add(store, ids, upd, active, sr, seed=seed)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        nodes = graph_ops(fn, what)
        del store
        torch.cuda.empty_cache()
        ours = [n for _, n in nodes if "row_plan" in n]
        sorts = [n for _, n in nodes if "sort" in n.lower() or "radix" in n.lower()]
        if not ours or len(nodes) > 5 or sorts:
            fail(f"{what}: one call ran {len(nodes)} device operations {nodes} (want 1 to 5 "
                 f"with the row plan's kernels, no sort)")
        counts[what.split()[0]] = max(counts.get(what.split()[0], 0), len(nodes))
        say("ops", f"{what} [{r}, {d}], K={k}: {len(nodes)} device operations in one call "
                   f"({', '.join(f'{kind} {n}' for kind, n in nodes)})")
    return counts


def count_k1_k5_ops(bench_cfg, small):
    """Phase q: the device operations of one K1 call at the serving shape
    (bf16 and f32), of one K5 and one K6 call at the benchmark's shapes and
    of one K3 call at the small group's (with the lr on the device, as the
    train step passes it), the nodes of a CUDA graph that captures the
    call (graph_ops, which fails on a host synchronisation), and of one
    grouped K3 call on that store and a narrow one: K1, K3 (either entry)
    and K6 one kernel; K5 at most 5 operations (its flags, count, compaction and
    walk); no sort. Returns the counts."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.embedding import global_row_ids
    from dlrm_yx_tpu_torch.ops.dense_finish import (
        rwsadagrad_dense_finish,
        rwsadagrad_dense_finish_many,
    )
    from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
    from dlrm_yx_tpu_torch.ops.stream_update import sorted_stream_add, sorted_stream_apply
    from dlrm_yx_tpu_torch.optim.optimizer import acc_len

    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(BATCH, 128, device="cuda", generator=gen)
    ly = torch.randn(BATCH, 26, 128, device="cuda", generator=gen)
    (group,) = model_groups(bench_cfg)
    store = torch.zeros(group.total_rows, group.dim, device="cuda")
    b = benchmark_batch(bench_cfg, BATCH, seed=23)
    pos, seg, w, _ = sorted_occurrences(global_row_ids(group, b.indices), b.weights)
    gtab = torch.randn(group.num_tables * BATCH, group.dim, device="cuda", generator=gen)
    w_eff = -0.1 * w
    big_b = benchmark_batch(bench_cfg, BIG_BATCH, seed=24)
    pos6, _, _, _ = sorted_occurrences(global_row_ids(group, big_b.indices), big_b.weights)
    upd6 = torch.randn(pos6.numel(), group.dim, device="cuda", generator=gen) * 1e-2
    del big_b
    fin_store = torch.zeros(small.total_rows, small.dim, device="cuda")
    fin_acc = torch.zeros(acc_len(small.total_rows), device="cuda")
    fin_g = torch.randn(small.total_rows, small.dim, device="cuda", generator=gen)
    narrow = finish_inputs(4096, 8, torch.float32, gen)
    lr = torch.full((), LR, device="cuda")
    cases = [  # (what, a name its kernels carry, shape, most operations, one call)
        ("fused_interaction bf16", "fused_interaction", f"[{BATCH}, 26, 128]", 1,
         lambda: fused_interaction(x, ly, False, torch.bfloat16)),
        ("fused_interaction f32", "fused_interaction", f"[{BATCH}, 26, 128]", 1,
         lambda: fused_interaction(x, ly, False, torch.float32)),
        ("sorted_stream_apply", "sorted_stream_apply",
         f"store [{group.total_rows}, {group.dim}], K={pos.numel()}", 5,
         lambda: sorted_stream_apply(store, pos, seg, w_eff, gtab)),
        ("sorted_stream_add", "sorted_stream_add",
         f"store [{group.total_rows}, {group.dim}], K={pos6.numel()} (B={BIG_BATCH})", 1,
         lambda: sorted_stream_add(store, pos6, upd6)),
        ("rwsadagrad_dense_finish", "dense_finish",
         f"store [{small.total_rows}, {small.dim}] f32, lr on the device", 1,
         lambda: rwsadagrad_dense_finish(fin_store, fin_acc, fin_g, lr, small.dim, 1e-10)),
        ("rwsadagrad_dense_finish_many", "dense_finish",
         "the same store and one [4096, 8], grouped", 1,
         lambda: rwsadagrad_dense_finish_many([(fin_store, fin_acc, fin_g), narrow], lr, 1e-10)),
    ]
    counts = {}
    for what, pattern, shape, most, fn in cases:
        fn()
        torch.cuda.synchronize()
        nodes = graph_ops(fn, what)
        ours = [n for _, n in nodes if pattern in n]
        # a torch sort's kernels (cub radix sort); K5's own names hold "sorted"
        sorts = [n for _, n in nodes
                 if pattern not in n and ("sort" in n.lower() or "radix" in n.lower())]
        if not ours or len(nodes) > most or sorts:
            fail(f"{what}: one call ran {len(nodes)} device operations {nodes} (want 1 to "
                 f"{most} with a kernel named *{pattern}*, no sort)")
        say("ops", f"{what} {shape}: {len(nodes)} device operations in one call "
                   f"({', '.join(f'{kind} {n}' for kind, n in nodes)}), no sort, no host "
                   f"synchronisation (captured whole)")
        counts[what.split()[0]] = max(counts.get(what.split()[0], 0), len(nodes))
    del store, x, ly, gtab, upd6, fin_store, fin_acc, fin_g, narrow
    torch.cuda.empty_cache()
    return counts


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
    twice, K3 once) and returns the steps as functions of nothing, and the
    SR-off step's (config, optimizer, params, state, batch)."""
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
    return steps, (cfg, opt, params, state, batch)


def capacity_throughput(steps):
    """Phase n: the capacity steps, CUDA-event timed, in turns."""
    for name, ts in time_in_turns(steps, check_loss).items():
        ms = statistics.mean(ts)
        say("throughput", f"capacity train step (eager; Terabyte-MLPerf <=10M rows, bf16 stores and "
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


# ---------------------------------------------- captured steps (CUDA graphs)

N_CAPTURE = 4        # steps a dispatch in phase r (2 on the B=4096 path)
N_DISPATCH = 16      # steps a dispatch in phases s and t
LR_WARMUP = 100      # phase r's LR policy warms up past its last step: every step has its own lr


def leaves(tree):
    """The tensors of a params or optimizer-state tree, in a fixed order."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from leaves(t)


def clone_tree(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def drawn_batches(cfg, n, seed, batch=BATCH, lookups=1):
    """n batches drawn on the card (--data-generation random-device's draws)."""
    from dlrm_yx_tpu_torch.data.synthetic import make_device_random_batches

    return list(make_device_random_batches(cfg.emb_rows, cfg.ln_bot[0], batch, n, lookups,
                                           seed=seed, device="cuda"))


def counted(run):
    """(run(), the launches each kernel wrapper counted during it)."""
    counters = launch_counters()
    before = {n: c.launches for n, c in counters.items()}
    out = run()
    return out, {n: c.launches - before[n] for n, c in counters.items()}


def capture_parity(what, cfg, opt, n_steps, params, state, seed, batch=BATCH, lookups=1,
                   accum=0, k3_per_step=None):
    """Phase r, one path: three dispatches of ``n_steps`` steps (or, with
    ``accum``, three accumulated steps of ``accum`` micro-batches) through
    the captured step (the first runs eagerly as the warm-up, the second is
    captured and replayed, the third replayed), against the same steps run
    eagerly from a clone of the params and optimizer state (the eager step
    takes a float lr and an int seed), each on its own batch, with an LR
    policy that warms up over all of them. Losses, every store, accumulator
    and MLP tensor must be equal bit for bit, and the launches equal; with
    ``k3_per_step``, K3 launched that many times an optimizer step, each a
    grouped launch."""
    import torch

    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
    from dlrm_yx_tpu_torch.train.train_step import (
        make_accum_train_step,
        make_multistep_train_step,
        make_train_step,
    )

    lr_fn = LRPolicy(base_lr=opt.lr, num_warmup_steps=LR_WARMUP)
    per = accum or n_steps
    batches = drawn_batches(cfg, 3 * per, seed, batch, lookups)
    groups = [stack_batches(batches[j * per:(j + 1) * per]) for j in range(3)]
    eager_p, eager_s = clone_tree(params), clone_tree(state)
    if accum:
        eager = make_accum_train_step(cfg, opt, accum, lr_fn, capture=False)
        captured = make_accum_train_step(cfg, opt, accum, lr_fn)
        want, eager_launches = counted(lambda: torch.stack(
            [eager(eager_p, eager_s, g, j)[2] for j, g in enumerate(groups)]))
        got, replay_launches = counted(lambda: torch.stack(
            [captured(params, state, g, j)[2] for j, g in enumerate(groups)]))
    else:
        eager = make_train_step(cfg, opt, lr_fn)
        captured = make_multistep_train_step(cfg, opt, n_steps, lr_fn)
        want, eager_launches = counted(lambda: torch.stack(
            [eager(eager_p, eager_s, b, i)[2] for i, b in enumerate(batches)]))
        got, replay_launches = counted(lambda: torch.cat(
            [captured(params, state, g, j * n_steps)[2] for j, g in enumerate(groups)]))
    torch.cuda.synchronize()
    replays = captured.graph_step.replays()
    pairs = [("losses", want, got)] + [
        (f"tensor {i}", a, b)
        for i, (a, b) in enumerate(zip(leaves((eager_p, eager_s)), leaves((params, state))))]
    differ = [name for name, a, b in pairs if not torch.equal(bits(a), bits(b))]
    n_elems = sum(a.numel() for _, a, _ in pairs)
    del eager_p, eager_s, batches, groups
    torch.cuda.empty_cache()
    n_opt = 3 if accum else 3 * n_steps  # optimizer steps
    k3 = (eager_launches["rwsadagrad_dense_finish"],
          eager_launches["rwsadagrad_dense_finish_many"])
    if k3_per_step is not None and k3 != (k3_per_step * n_opt,) * 2:
        fail(f"capture parity, {what}: K3 launched {k3} times (all, grouped) in {n_opt} "
             f"optimizer steps, want {k3_per_step} a step, grouped")
    if differ or replay_launches != eager_launches or replays < 2:
        fail(f"capture parity, {what}: {len(differ)} of {len(pairs)} tensors differ from the "
             f"eager steps ({differ[:5]}), launches {replay_launches} against the eager "
             f"{eager_launches}, {replays} replays (want 2 or more)")
    ran = {k: v for k, v in replay_launches.items() if v}
    say("capture", f"{what}: {'3 accumulated steps of ' + str(accum) + ' micro-batches' if accum else '3 dispatches of ' + str(n_steps) + ' steps'} "
                   f"(eager warm-up, capture + replay, replay: {replays} replays), lr "
                   f"{lr_fn(0):.6g} .. {lr_fn(3 * per - 1):.6g}: losses "
                   f"{[round(v, 6) for v in got.tolist()]}; all {len(pairs)} tensors "
                   f"({n_elems} elements: losses, stores, accumulators, MLPs) equal to the "
                   f"eager steps' bit for bit; launches {ran}, as eager")


def eval_capture_parity(cfg, params):
    """Phase r, the eval step: 4 batches through the captured step (warm-up,
    capture + replay, 2 replays) against the eager step: predictions and
    loss bit for bit."""
    import torch

    from dlrm_yx_tpu_torch.train.train_step import make_eval_step

    eager, captured = make_eval_step(cfg, capture=False), make_eval_step(cfg)
    batches = drawn_batches(cfg, 4, seed=31)
    (want, got), (eager_launches, replay_launches) = zip(*(
        counted(lambda: [torch.cat([p.reshape(-1), l.reshape(-1)]) for p, l in
                         (step(params, b) for b in batches)])
        for step in (eager, captured)))
    replays = captured.graph_step.replays()
    differ = [i for i, (a, b) in enumerate(zip(want, got)) if not torch.equal(bits(a), bits(b))]
    if differ or replay_launches != eager_launches or replays < 2:
        fail(f"capture parity, eval step: batches {differ} differ, launches {replay_launches} "
             f"against {eager_launches}, {replays} replays")
    say("capture", f"eval step, 26 tables <=1M rows x 128, B={BATCH}, bf16, pallas "
                   f"interaction: 4 batches ({replays} replays): predictions and losses equal "
                   f"to the eager step's bit for bit; launches "
                   f"{ {k: v for k, v in replay_launches.items() if v} }, as eager")


def check_capture(rows):
    """Phase r: every captured path against its eager steps on the card,
    bit for bit, with deterministic algorithms on: index_add_ (the
    scatters of the momenta and of the dense branch) adds a row's
    duplicates with atomics in no fixed order otherwise, so two eager runs
    could already differ."""
    import dataclasses

    import torch

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import (
        OptConfig,
        init_opt_state,
        uniform_stream_density,
    )

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        base = DLRMConfig.build(
            emb_rows=rows, ln_bot=(13, 512, 256, 128), ln_top=(1024, 1024, 512, 256, 1),
            loss="bce", compute_dtype="bfloat16", sparse_update_impl="pallas",
            interaction_impl="pallas")
        base = dataclasses.replace(base, dup_density_hint=uniform_stream_density(
            base.emb_rows, base.emb_split_threshold, BATCH))
        rws = OptConfig("rwsadagrad", LR)
        params = init_dlrm_on_device(base, seed=5)
        state = init_opt_state(rws, params, model_groups(base))
        capture_parity(f"L=1 train, 26 tables <=1M rows x 128 f32, B={BATCH}, bf16 compute, "
                       "rwsadagrad, sparse-update pallas, pallas interaction (K1, K2, K3)",
                       base, rws, N_CAPTURE, params, state, seed=32, k3_per_step=1)
        eval_capture_parity(base, params)
        capture_parity(f"L=1 gradient accumulation, the same model (K1, K4 on the f32 store, "
                       "K3)", base, rws, 0, params, state, seed=33, accum=2, k3_per_step=1)
        del params, state
        torch.cuda.empty_cache()
        sr = dataclasses.replace(base, emb_dtype="bfloat16", stochastic_rounding=True)
        params = init_dlrm_on_device(sr, seed=5)
        state = init_opt_state(rws, params, model_groups(sr))
        capture_parity("L=1 train on bf16 stores with stochastic rounding (K1, K4 with SR, K3; "
                       "a seed frozen at its captured steps would round other bits than the "
                       "eager steps' own seeds)", sr, rws, N_CAPTURE, params, state, seed=34,
                       k3_per_step=1)
        del params, state
        torch.cuda.empty_cache()
        bench = benchmark_config()
        sgd = OptConfig("sgd", 0.1)
        params = init_dlrm_on_device(bench, seed=5)
        capture_parity(f"L={L100} benchmark train, 8 x 1M x 64, B={BATCH}, bf16, sgd, "
                       "sparse-update pallas (K5)", bench, sgd, N_CAPTURE, params, {}, seed=35,
                       lookups=L100)
        del params
        torch.cuda.empty_cache()
        stream = dataclasses.replace(bench, sparse_update_impl="stream")
        params = init_dlrm_on_device(stream, seed=5)
        state = init_opt_state(rws, params, model_groups(stream))
        capture_parity(f"L={L100}, B={BIG_BATCH}, rwsadagrad, sparse-update stream (K6)",
                       stream, rws, 2, params, state, seed=36, batch=BIG_BATCH, lookups=L100)
        del params, state
        torch.cuda.empty_cache()
        # the variants; MD and QR tables are drawn on the host (device init
        # takes plain tables only, as in the JAX package)
        for name, argv, kernels in (("mixed-dimension", md_terabyte_argv(rows), "K1, K2, K3"),
                                    ("QR", qr_terabyte_argv(rows), "K1, K3, K4")):
            cfg = config_of(argv)
            cfg = dataclasses.replace(cfg, dup_density_hint=uniform_stream_density(
                cfg.emb_rows, cfg.emb_split_threshold, BATCH))
            params = init_dlrm(cfg, seed=5, device="cuda")
            state = init_opt_state(rws, params, model_groups(cfg))
            capture_parity(f"L=1 train, Terabyte-MLPerf <=1M rows with {name} tables, B={BATCH}, "
                           f"bf16, rwsadagrad, sparse-update pallas ({kernels})", cfg, rws,
                           N_CAPTURE, params, state, seed=37, k3_per_step=1)
            del params, state
            torch.cuda.empty_cache()
        weighted = dataclasses.replace(bench, weighted_pooling="learned")
        params = init_dlrm_on_device(weighted, seed=5)
        gen = torch.Generator(device="cuda").manual_seed(39)
        for v in params["vw"]:  # v_W as learning may leave it; padding rows stay 0
            u = torch.rand(v.shape, device="cuda", generator=gen)
            v.mul_(torch.where(u < 0.1, 0.0, torch.where(u < 0.2, -u, 2 * u)))
        capture_parity(f"L={L100} benchmark train with learned pooling weights (v_W 0 on a "
                       "tenth of the rows, negative on a tenth, random elsewhere), sgd, "
                       "sparse-update pallas (K5 on w * v_W)", weighted, sgd, N_CAPTURE, params,
                       {}, seed=38, lookups=L100)
        del params
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    say("capture", f"phase r at full width in {time.perf_counter() - t0:.1f} s")


def captured_throughput(what, cfg, opt, params, state, batch, eager_fn):
    """Phase s: the captured train step at N=1 and N=16 steps a dispatch
    against the eager step, CUDA-event timed in turns; the dispatch copies
    its batch (the same one, stacked N deep) into its graph's inputs and
    its lrs and seeds from pinned memory every call. Returns the N=16
    dispatch as a function of nothing."""
    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.train.train_step import make_multistep_train_step

    fns, per_call = {"eager": eager_fn}, {"eager": 1}
    for n in (1, N_DISPATCH):
        step = make_multistep_train_step(cfg, opt, n)
        fns[f"captured N={n}"] = train_step_fn(step, params, state, stack_batches([batch] * n))
        per_call[f"captured N={n}"] = n
    times = time_in_turns(fns, check_loss)
    report_throughput(what, times, per_call)
    return fns[f"captured N={N_DISPATCH}"]


def report_throughput(what, times, per_call):
    eager_ms = statistics.mean(times["eager"])
    for name, ts in times.items():
        ms = statistics.mean(ts) / per_call[name]
        say("throughput", f"{what}, {name}: {ms:.4f} ms/step ({BATCH / ms * 1e3:.0f} "
                          f"examples/s; {eager_ms / ms:.2f}x eager; ms a call {ts})")


def captured_eval_throughput(cfg, params, batch, eager_fn):
    """Phase s, the eval step: one batch a replay (neither package has a
    multi-batch eval dispatch) against the eager step, in turns."""
    import math

    import torch

    from dlrm_yx_tpu_torch.train.train_step import make_eval_step

    step = make_eval_step(cfg)

    def check(name, out):
        preds, loss = out
        if not math.isfinite(loss.item()) or not torch.isfinite(preds).all():
            fail(f"eval step ({name}) gave non-finite output")

    fns = {"eager": eager_fn, "captured": lambda: step(params, batch)}
    report_throughput(f"eval step, 26 tables <=1M rows x 128, B={BATCH}, bf16, pallas "
                      "interaction", time_in_turns(fns, check), {"eager": 1, "captured": 1})
    return fns["captured"]


# ---------------------------------------- real-data paths and checkpoints

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO, "build", "chip_smoke_data")  # gitignored, like the kernels
MLPERF_BATCHES = 32        # batches of 2048 in phase u's train.bin
MAX_IND_RANGE = 1_000_000  # the tables' cap (40M rows x 128 x 4 B is 96 GB: beyond the card)
SHORT_TAIL = 1000          # records past the last whole batch of its second file
KAGGLE_DAY_ROWS = 32_768   # 7 days: the test split (half of day 6) is one batch of 16,384
KAGGLE_PRINT, KAGGLE_TEST = 256, 512  # multiples of the 16 steps a dispatch
TRACE_BATCHES = 8
W_STEPS = 128              # steps a fit in phase w: 8 dispatches of 16, so that the
                           # prefetch thread's start (its first group) weighs little


def bench_flags(script):
    """The flags of a bench/ script's ``python -m dlrm_yx_tpu.cli`` line,
    less those that take a shell variable (the data paths)."""
    with open(os.path.join(REPO, "bench", script)) as f:
        body = f.read().split("python -m dlrm_yx_tpu.cli", 1)[1].split('"$@"', 1)[0]
    return [a for a in body.replace("\\\n", " ").split() if "$" not in a]


def with_changes(phase, flags, changes=(), drop=()):
    """``flags`` (``--name=value`` or ``--name``) less the flags named in
    ``drop``, with each change in place of the flag of its name; each
    change is printed."""
    def name(a):
        return a.split("=", 1)[0]

    out = [a for a in flags if name(a) not in drop]
    for flag in drop:
        say(phase, f"  flag change: {flag} dropped")
    for change in changes:
        old = [a for a in out if name(a) == name(change)]
        out = [a for a in out if name(a) != name(change)] + [change]
        say(phase, f"  flag change: {old[0] if old else '(not given)'} -> {change}")
    return out


class SharedInit:
    """Runs of one model and seed share one host draw of the tables: the
    CLI's Trainer draws them on the host (``init_dlrm``, numpy: about 7M
    rows x 128 for the Terabyte model); the first run keeps its f32 draw on
    the card and each run gets a copy made there, cast to its store dtype
    (the values ``init_dlrm`` gives: it draws in f32 and casts)."""

    def __init__(self):
        import dlrm_yx_tpu_torch.train.trainer as trainer_mod

        self.mod, self.real = trainer_mod, trainer_mod.init_dlrm
        self.cache, self.draws, self.copies = {}, 0, 0

    def __enter__(self):
        import dataclasses

        from dlrm_yx_tpu_torch.models.dlrm import DTYPES, _ones_vw, model_groups

        def init(config, seed=123, device=None):
            # v_W is no draw (ones), so runs with and without it share one
            key = (tuple(config.emb_rows), tuple(config.emb_dims), config.emb_split_threshold,
                   tuple(config.ln_bot), tuple(config.ln_top), config.qr_table_ids,
                   config.qr_collisions, config.qr_operation, config.md_table_ids, seed,
                   str(device))
            if key not in self.cache:
                f32 = dataclasses.replace(config, emb_dtype="float32", weighted_pooling=None)
                self.cache[key] = self.real(f32, seed=seed, device=device)
                self.draws += 1
            self.copies += 1
            params = clone_tree(self.cache[key])
            params["emb"] = [e.to(DTYPES[config.emb_dtype]) for e in params["emb"]]
            params["vw"] = _ones_vw(model_groups(config), config, params["emb"][0].device)
            return params

        self.mod.init_dlrm = init
        return self

    def keep_only(self, emb_rows):
        for key in [k for k in self.cache if k[0] != tuple(emb_rows)]:
            del self.cache[key]

    def __exit__(self, *exc):
        import torch

        self.mod.init_dlrm = self.real
        self.cache.clear()
        torch.cuda.empty_cache()


def pool_mib(pool):
    """The memory (MiB) of one CUDA-graph memory pool."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool)) / 2**20


def write_mlperf_bin(path, n_records, seed):
    """``path``: ``n_records`` records of the MLPerf binary format (40
    int32 a record: label, 13 dense, 26 categorical), ids per table drawn
    from a seeded power law over the Terabyte raw counts; beside it
    ``{path}_fea_count.npz`` with those counts."""
    import numpy as np

    from dlrm_yx_tpu_torch.config import DLRMConfig

    raw = DLRMConfig.terabyte_mlperf(max_ind_range=2**31 - 1).emb_rows
    rng = np.random.RandomState(seed)
    rec = np.empty((n_records, 40), np.int32)
    rec[:, 0] = rng.random_sample(n_records) < 0.25
    rec[:, 1:14] = rng.poisson(3.0, (n_records, 13))
    a = 1.15  # Zipf-like: rank r drawn with density ~ r^-a (synth_kaggle's law)
    for j, m in enumerate(raw):
        r = (1.0 - rng.random_sample(n_records) * (1.0 - m ** (1.0 - a))) ** (1.0 / (1.0 - a))
        rec[:, 14 + j] = np.minimum(r.astype(np.int64) - 1, m - 1)
    rec.tofile(path)
    np.savez(f"{path}_fea_count.npz", counts=np.asarray(raw, np.int32))


def check_graphs(phase, what, graph_step, short_rows):
    """Each graph (one a batch shape) of ``graph_step``: its replays and its
    memory pool. The graph of the ``short_rows``-row batch must have
    replayed."""
    short = 0
    for key, slot in graph_step._slots.items():
        rows = key[0][-2]
        mib = pool_mib(slot.graph.pool()) if slot.graph is not None else 0.0
        say(phase, f"  {what}, batch of shape {key[0][:-1]} (dense): {slot.replays} replays, "
                   f"graph pool {mib:.1f} MiB")
        if rows == short_rows:
            short += slot.replays
    if short < 1:
        fail(f"{what}: the graph of the {short_rows}-row batch never replayed")


def mlperf_bin_main_path(rows):
    """Phase u.1: bench/run_and_time.sh's command line through the port's
    CLI on a written train.bin (SGD, binary loader with its shuffle): K1
    per step and eval batch, K2 per step; then a file with a short last
    batch at one step a dispatch over two epochs, so that the short batch
    is warmed up, captured and replayed (train and eval)."""
    import math

    t0 = time.perf_counter()
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, "train.bin")
    short = os.path.join(DATA_DIR, "train_short.bin")
    write_mlperf_bin(path, MLPERF_BATCHES * BATCH, seed=2)
    write_mlperf_bin(short, MLPERF_BATCHES * BATCH + SHORT_TAIL, seed=2)  # path's, and more
    say("data", f"wrote {path} ({MLPERF_BATCHES} x {BATCH} records) and {short} "
                f"({SHORT_TAIL} more) in {time.perf_counter() - t0:.1f} s")
    flags = with_changes("data", bench_flags("run_and_time.sh"), [
        f"--max-ind-range={MAX_IND_RANGE}",
        f"--print-freq={MLPERF_BATCHES // 2}", f"--test-freq={MLPERF_BATCHES}",
        "--interaction-impl=pallas"])
    say("data", "  and no --processed-data-file: the JAX CLI hands it to np.load as the "
                "counts file, which raises (ROADMAP Queue C); eval reads the train file")
    want = only(fused_interaction=2 * MLPERF_BATCHES, sparse_rows_overwrite=MLPERF_BATCHES)
    out = {}
    cli_training_run("data", f"cli bench/run_and_time.sh flags, binary loader + shuffle, 26 "
                             f"tables <=1M rows x 128, B={BATCH}, L=1, bf16, sgd, pallas",
                     flags + [f"--raw-data-file={path}"], MLPERF_BATCHES, want, big_index=1,
                     n_prints=2, out=out)
    check_graphs("data", "train step", out["trainer"].multi_step.graph_step, BATCH)
    out = {}
    n = MLPERF_BATCHES + 1
    argv = with_changes("data", flags, [f"--raw-data-file={short}", "--steps-per-dispatch=1",
                                        "--nepochs=2"])
    # the short batch (1000 rows, not a multiple of 64) takes the plain interaction
    want = only(fused_interaction=4 * MLPERF_BATCHES, sparse_rows_overwrite=2 * n)
    cli_training_run("data", f"the same on {n} batches, the last of {SHORT_TAIL} rows, one "
                             "step a replay, 2 epochs (a new batch order each)",
                     argv, 2 * n, want, big_index=1, n_prints=2 * n // (MLPERF_BATCHES // 2),
                     out=out)
    trainer = out["trainer"]
    check_graphs("data", "train step (N=1)", trainer.train_step.graph_step, SHORT_TAIL)
    check_graphs("data", "eval step", trainer.eval_step.graph_step, SHORT_TAIL)
    if not all(map(math.isfinite, out["losses"])):
        fail(f"short-batch run: losses {out['losses']}")
    say("data", f"phase u.1 in {time.perf_counter() - t0:.1f} s")


def final_bits(trainer):
    """The trainer's params and optimizer state on the host, as bits."""
    return [bits(t.detach()).cpu() for t in leaves((trainer.params, trainer.opt_state))]


def kaggle_main_path():
    """Phase u.2 and v: bench/dlrm_tpu_criteo_kaggle.sh's command line on a
    written Kaggle TSV (preprocessed on first touch by the native parser),
    then with --memory-map (the same losses and params, bit for bit), then
    checkpoints: a run stopped at its first eval saves the best checkpoint,
    a run resumed from it gives the uninterrupted run's losses and params
    bit for bit, and --inference-only --load-model serves it with the
    metrics of the eval that saved it. Deterministic algorithms on."""
    import contextlib
    import io
    import json
    import shutil

    import torch

    from dlrm_yx_tpu_torch import cli
    from dlrm_yx_tpu_torch.data import fastparse, synth_kaggle
    from dlrm_yx_tpu_torch.data.criteo import convert_days_to_memmap

    t0 = time.perf_counter()
    d = os.path.join(DATA_DIR, "kaggle")
    shutil.rmtree(d, ignore_errors=True)  # preprocess on first touch, every run
    os.makedirs(d)
    txt, prefix = os.path.join(d, "train.txt"), os.path.join(d, "kaggle")
    stats = synth_kaggle.generate(txt, 7 * KAGGLE_DAY_ROWS, seed=0)
    say("data", f"synth_kaggle: {stats['rows']} rows, ctr {stats['ctr']:.4f}, in "
                f"{stats['gen_seconds']:.1f} s; vocabularies scaled down (at most "
                f"{max(synth_kaggle.VOCAB_SIZES):,} rows a table; Kaggle's run to 10M)")
    flags = with_changes("data", bench_flags("dlrm_tpu_criteo_kaggle.sh"), [
        f"--print-freq={KAGGLE_PRINT}", f"--test-freq={KAGGLE_TEST}",
        "--mlperf-acc-threshold=0",  # no early stop: the resume check needs the whole run
        f"--raw-data-file={txt}", f"--processed-data-file={prefix}"])
    steps = 6 * KAGGLE_DAY_ROWS // 128
    n_prints = steps // KAGGLE_PRINT
    what = (f"cli bench/dlrm_tpu_criteo_kaggle.sh flags, Kaggle TSV -> npz, 26 tables x 16, "
            f"B=128, test batch 16384, sgd, xla (no kernel: D=16)")
    parsed = fastparse.calls["parse_raw_tsv"]
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, extra, n, k in (("first", [], steps, n_prints),
                                  ("memory-map", ["--memory-map"], steps, n_prints)):
            if name == "memory-map":
                convert_days_to_memmap(prefix, 7)
            out = {}
            cli_training_run("data", f"{what}, {name} run", flags + extra, n, only(), None,
                             n_prints=k, out=out)
            runs[name] = (out["losses"], out["metrics"], final_bits(out["trainer"]),
                          out["text"])
            if name == "first":  # the graphs of the B=128 steps and the 16,384-row eval
                check_graphs("data", "train step", out["trainer"].multi_step.graph_step, 128)
                check_graphs("data", "eval step", out["trainer"].eval_step.graph_step, 16_384)
                if fastparse.calls["parse_raw_tsv"] != parsed + 7 or "preprocessing" not in \
                        out["text"]:
                    fail("the Kaggle run did not preprocess with the native parser: "
                         f"{fastparse.calls['parse_raw_tsv'] - parsed} native parses")
                say("data", f"  preprocessed on first touch: "
                            f"{[l for l in out['text'].splitlines() if 'stage seconds' in l]}")
            del out
        same_run("memory-map run against the first", runs["memory-map"], runs["first"])
        say("data", f"phase u.2 in {time.perf_counter() - t0:.1f} s")

        t1 = time.perf_counter()
        ckpt = os.path.join(d, "ckpt")
        out = {}
        cli_training_run("checkpoint", f"{what}, saving the best checkpoint and stopping at "
                                       "the first eval", flags + [
                             f"--save-model={ckpt}", "--mlperf-acc-threshold=1e-9"],
                         KAGGLE_TEST, only(), None, n_prints=KAGGLE_TEST // KAGGLE_PRINT,
                         out=out)
        with open(os.path.join(ckpt, "meta.json")) as f:
            meta = json.load(f)
        if meta["iteration"] != KAGGLE_TEST or out["losses"] != runs["first"][0][:2]:
            fail(f"checkpoint at iteration {meta['iteration']} (want {KAGGLE_TEST}); losses "
                 f"{out['losses']} against the first run's {runs['first'][0][:2]}")
        out = {}
        cli_training_run("checkpoint", f"{what}, resumed from it", flags + [
                             f"--load-model={ckpt}"], steps - KAGGLE_TEST, only(), None,
                         n_prints=n_prints - KAGGLE_TEST // KAGGLE_PRINT, out=out)
        if f"Resumed checkpoint at epoch 0 iteration {KAGGLE_TEST}" not in out["text"]:
            fail("the resumed run did not resume at the saved iteration")
        resumed = (out["losses"], out["metrics"], final_bits(out["trainer"]), out["text"])
        first = runs["first"]
        same_run("resumed run against the uninterrupted run from the saved iteration on",
                 resumed, (first[0][KAGGLE_TEST // KAGGLE_PRINT:],) + first[1:])
        del out
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            served = cli.main(flags + [f"--load-model={ckpt}", "--inference-only"])
        if served != meta["metrics"]:
            fail(f"--inference-only --load-model: {served}, the saving eval {meta['metrics']}")
        say("checkpoint", f"--inference-only --load-model: metrics {served}, equal to those "
                          "of the eval that saved the checkpoint")
    finally:
        torch.use_deterministic_algorithms(False)
    say("checkpoint", f"phase v in {time.perf_counter() - t1:.1f} s")


def same_run(what, got, want):
    """Two runs' (losses, metrics, final params bits, output): equal."""
    import torch

    differ = [i for i, (a, b) in enumerate(zip(got[2], want[2])) if not torch.equal(a, b)]
    if got[0] != want[0] or got[1] != want[1] or differ or len(got[2]) != len(want[2]):
        fail(f"{what}: losses {got[0]} against {want[0]}, metrics {got[1]} against "
             f"{want[1]}, {len(differ)} tensors differ")
    say("checkpoint" if "resumed" in what else "data",
        f"  {what}: losses {got[0]}, eval metrics and all {len(got[2])} params and optimizer "
        "tensors equal bit for bit")


def trace_main_path(rows):
    """Phase u.3: --data-generation synthetic on the shipped stack-distance
    files at item 1's flags (run_and_time.sh's, SGD, L=1, 1M-capped tables),
    then with RWSAdagrad (the density measured on the first batch makes it
    coalesce first: K2 sees unique rows, K3 finishes the small tables).
    Returns the trace batches."""
    import re

    import numpy as np

    from dlrm_yx_tpu_torch import cli

    t0 = time.perf_counter()
    made = {}
    real = cli.make_trace_batches

    def cached(*a, **k):  # one draw for both runs (and phase w): same seed, same batches
        key = repr((a, sorted(k.items())))
        if key not in made:
            t = time.perf_counter()
            made[key] = real(*a, **k)
            say("data", f"  make_trace_batches: {len(made[key])} batches in "
                        f"{time.perf_counter() - t:.1f} s (host)")
        return made[key]

    cli.make_trace_batches = cached
    try:
        for optimizer, want in (
                ("sgd", only(fused_interaction=2 * TRACE_BATCHES,
                             sparse_rows_overwrite=TRACE_BATCHES)),
                ("rwsadagrad", only(fused_interaction=2 * TRACE_BATCHES,
                                    sparse_rows_overwrite=TRACE_BATCHES,
                                    rwsadagrad_dense_finish=TRACE_BATCHES))):
            flags = with_changes("data", bench_flags("run_and_time.sh"), [
                "--data-generation=synthetic", f"--arch-embedding-size={'-'.join(map(str, rows))}",
                f"--data-trace-file={os.path.join(REPO, 'input', 'dist_emb_j.log')}",
                f"--num-batches={TRACE_BATCHES}", "--num-indices-per-lookup=1",
                "--print-freq=4", f"--test-freq={TRACE_BATCHES}", "--interaction-impl=pallas",
                f"--optimizer={optimizer}", f"--max-ind-range={MAX_IND_RANGE}"],
                drop=("--data-set", "--mlperf-bin-loader", "--mlperf-bin-shuffle"))
            out = {}
            cli_training_run("data", f"cli trace path (stack-distance files "
                                     f"input/dist_emb_{{0,1,2}}.log over 26 tables <=1M rows x "
                                     f"128), B={BATCH}, L=1, bf16, {optimizer}, pallas", flags,
                             TRACE_BATCHES, want, big_index=1, n_prints=TRACE_BATCHES // 4,
                             out=out)
            hint = re.findall(r"duplicate-density hint from first batch: ([.\d]+)", out["text"])
            say("data", f"  density hint the CLI measured on the first batch: {hint}")
            del out
    finally:
        cli.make_trace_batches = real
    (batches,) = made.values()
    distinct = np.array([[len(np.unique(b.indices[t])) for t in range(len(rows))]
                         for b in batches])  # [batch, table]
    say("data", f"  distinct rows a table in a batch of {BATCH}: min {distinct.min()}, median "
                f"{int(np.median(distinct))}, max {distinct.max()}; per table (mean over the "
                f"batches) {distinct.mean(0).round(1).tolist()}")
    say("data", f"phase u.3 in {time.perf_counter() - t0:.1f} s")
    return batches


def check_native_parser():
    """Phase u.4: the native data-path library was built and ran."""
    from dlrm_yx_tpu_torch.data import fastparse

    so = fastparse.lib_path()
    if not fastparse.available() or not so.exists() or not fastparse.calls["parse_raw_tsv"] \
            or not fastparse.calls["read_bin_batch"]:
        fail(f"native data path: built {so.exists()}, calls {fastparse.calls}")
    say("data", f"native parser {os.path.relpath(so, REPO)} built with g++ and used: "
                f"{fastparse.calls}")


def real_data_feeds(rows, trace_batches):
    """Phase w: the captured N=16 L=1 train step of item 1's flags (SGD lr
    1.0 with run_and_time.sh's LR policy, bf16, pallas, pallas
    interaction) through ``Trainer.fit`` with the prefetch thread, fed in
    turns with random host batches, the binary loader (a file of W_STEPS
    batches written like phase u.1's) and trace batches (phase u.3's,
    repeated), W_STEPS steps a fit; CUDA events are not used: the fit's
    wall time (it fetches its losses at the end) over its steps. Returns
    (fit, feeds) for the profiles."""
    import contextlib
    import io

    import numpy as np
    import torch

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.batch import Batch
    from dlrm_yx_tpu_torch.data.criteo_bin import CriteoBinLoader
    from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
    from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = DLRMConfig.build(
        emb_rows=rows, ln_bot=(13, 512, 256, 128), ln_top=(1024, 1024, 512, 256, 1),
        loss="bce", compute_dtype="bfloat16", sparse_update_impl="pallas",
        interaction_impl="pallas")
    policy = LRPolicy(base_lr=1.0, num_warmup_steps=2750, decay_start_step=49315,
                      num_decay_steps=27772)
    trainer = Trainer(cfg, OptConfig("sgd", 1.0), TrainerConfig(
        print_freq=0, steps_per_dispatch=N_DISPATCH, prefetch_depth=2), policy)
    rng = np.random.RandomState(7)
    n_rows = np.asarray(rows, np.float64)[:, None, None]
    bin_path = os.path.join(DATA_DIR, "feed.bin")
    write_mlperf_bin(bin_path, W_STEPS * BATCH, seed=3)
    feeds = {
        "random host batches": [Batch(
            rng.random_sample((BATCH, 13)).astype(np.float32),
            (rng.random_sample((len(rows), BATCH, 1)) * n_rows).astype(np.int32),
            np.ones((len(rows), BATCH, 1), np.float32),
            (rng.random_sample((BATCH, 1)) < 0.25).astype(np.float32)) for _ in range(W_STEPS)],
        "binary loader": CriteoBinLoader(bin_path, batch_size=BATCH,
                                         max_ind_range=MAX_IND_RANGE, shuffle_seed=123),
        "trace batches": list(trace_batches) * (W_STEPS // len(trace_batches)),
    }

    def fit(feed):
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.fit(feed)

    for _ in range(2):  # eager warm-up dispatch, capture, then replays
        for feed in feeds.values():
            fit(feed)
    times = {name: [] for name in feeds}
    for name in list(feeds) + list(reversed(feeds)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(feeds[name])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    for t in leaves(trainer.params):
        if not bool(torch.isfinite(t).all()):
            fail("phase w: a parameter is not finite after the fits")
    for name, ts in times.items():
        ms = statistics.mean(ts) / len(feeds[name])
        say("throughput", f"L=1 train step (sgd lr 1.0 + run_and_time.sh's LR policy, bf16, "
                          f"pallas, captured N={N_DISPATCH}, prefetch 2) fed {name}: "
                          f"{ms:.4f} ms/step ({BATCH / ms * 1e3:.0f} examples/s); fit wall "
                          f"for {len(feeds[name])} steps {ts} ms")
    return fit, feeds


def profile_real_data(fit, feeds):
    """Phase w's profiles: one window per feed (10 fits of W_STEPS steps),
    with K2's device time a step."""
    for name, feed in feeds.items():
        per_kernel = profile_step(lambda: fit(feed), f"L=1 sgd train (captured N={N_DISPATCH}, "
                                  f"Trainer.fit fed {name})", (), steps=len(feed))
        k2 = sum(v for k, v in per_kernel.items() if "row_plan" in k)
        profile_by_kind(per_kernel, L1_KINDS)
        say("profile", f"  K2 (row plan) device time fed {name}: {k2:.5f} ms/step")


# ------------------------- the embedding variants and the processed dataset

N_VARIANT_STEPS = 4  # each variant CLI run's steps; its eval takes as many batches
KAGGLE_BATCH = 128   # bench/dlrm_tpu_criteo_kaggle.sh's mini-batch
PROCESSED_FLAGS = [  # the port's generator, at its table_configs ranges' defaults
    "--T", "12", "--m-den", "512", "--num-batches", "10", "--mini-batch-size", str(BATCH),
    "--row-range", "500,10000", "--dim-range", "64,128,256,512",
    "--pooling-factor-range", "1,32", "--seed", "123"]


def md_terabyte_argv(rows):
    """Phase b's Terabyte-MLPerf flags (1M cap) with mixed dims."""
    return terabyte_argv(rows) + ["--md-flag", "--md-round-dims", "--optimizer", "rwsadagrad",
                                  "--learning-rate", str(LR), "--sparse-update-impl", "pallas"]


def qr_terabyte_argv(rows):
    """Phase b's Terabyte-MLPerf flags (1M cap) with QR tables (threshold
    200, 4 collisions, mult: the flags' defaults)."""
    return terabyte_argv(rows) + ["--qr-flag", "--optimizer", "rwsadagrad",
                                  "--learning-rate", str(LR), "--sparse-update-impl", "pallas"]


def kaggle_md_argv():
    """bench/dlrm_tpu_criteo_kaggle.sh's model (Kaggle's table counts, D=16,
    SGD lr 0.1, B=128) on random data, with mixed dims."""
    from dlrm_yx_tpu_torch.config import DLRMConfig

    return [
        "--arch-embedding-size", "-".join(map(str, DLRMConfig.kaggle().emb_rows)),
        "--arch-sparse-feature-size", "16", "--arch-mlp-bot", "13-512-256-64-16",
        "--arch-mlp-top", "512-256-1", "--data-generation", "random",
        "--mini-batch-size", str(KAGGLE_BATCH), "--num-indices-per-lookup", "1",
        "--loss-function", "bce", "--round-targets", "True", "--learning-rate", "0.1",
        "--md-flag", "--md-round-dims", "--sparse-update-impl", "pallas",
    ]


PROCESSED_DIR = os.path.join(DATA_DIR, "processed")


def variant_finish_shapes(rows, gen):
    """K3's stores on the variants' paths: (what, group, global row ids) of
    every small group of the two mixed-dimension models (one batch's ids)
    and of every group of the processed model (its dataset's first batch of
    pooled ids, live items only), and that first batch; writes the
    processed dataset."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.embedding import global_row_ids

    shapes = []
    for name, cfg, batch in (("Terabyte MD", config_of(md_terabyte_argv(rows)), BATCH),
                             ("Kaggle MD", config_of(kaggle_md_argv()), KAGGLE_BATCH)):
        for group in model_groups(cfg):
            if group.size_class == 0:
                shapes.append((f"{name} small group dim {group.dim}", group,
                               batch_rows(group, gen, batch, repeats=False)))
    first = write_processed_dataset()
    for group in model_groups(config_of(processed_argv())):
        t = list(group.table_ids)
        idx = torch.as_tensor(first.indices[t], device="cuda").long()
        live = torch.as_tensor(first.weights[t], device="cuda") != 0
        n = group.num_tables
        shapes.append((f"processed group dim {group.dim} ({n} table{'s' * (n > 1)}, one batch "
                       "of pooled ids)", group, global_row_ids(group, idx)[live]))
    return shapes, first


def write_processed_dataset():
    """Phase x: the port's generator writes the processed dataset under
    build/chip_smoke_data; returns its first batch."""
    from dlrm_yx_tpu_torch.data import processed

    t0 = time.perf_counter()
    processed.main(PROCESSED_FLAGS + ["--out-dir", PROCESSED_DIR])
    tables, batches = processed.load_processed(PROCESSED_DIR)
    tables = tables["tables"]
    say("kernel", f"processed dataset: 12 tables (rows {min(t['row'] for t in tables)}.."
                  f"{max(t['row'] for t in tables)}, dims {sorted({t['dim'] for t in tables})}, "
                  f"pooling {min(t['pooling_factor'] for t in tables)}.."
                  f"{max(t['pooling_factor'] for t in tables)}), {len(batches)} batches of "
                  f"{BATCH}, m_den 512, written and read in {time.perf_counter() - t0:.1f} s")
    return batches[0]


def processed_argv():
    """Phase y's training line on the processed dataset (bot 512-512-64)."""
    return ["--load-processed", PROCESSED_DIR, "--arch-mlp-bot", "512-512-64",
            "--arch-sparse-feature-size", "64", "--arch-mlp-top", "512-256-1",
            "--loss-function", "bce", "--optimizer", "rwsadagrad", "--learning-rate", str(LR),
            "--sparse-update-impl", "pallas", "--print-freq", "1"]


def config_of(argv):
    from dlrm_yx_tpu_torch import cli

    return cli.config_from_args(cli.build_parser().parse_args(argv))


def overwrite_case(what, store, ids, active, gen, tol):
    """K2 on ``store`` with the items (ids, active): the kernel against its
    plain version run on the CPU (bit for bit), no row that no item names
    changed; the wrapper, the plain version on the card and index_add_
    timed; returns the kernels line's numbers."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import (
        sparse_rows_overwrite,
        sparse_rows_overwrite_reference,
    )

    r, w = store.shape
    k = ids.numel()
    delta = torch.randn(k, w, device="cuda", generator=gen) * 1e-2
    new_vals = store[ids.long()] + delta
    got = sparse_rows_overwrite(store.clone(), ids, new_vals, delta, active)
    torch.cuda.synchronize()
    rows, want = overwrite_plain_on_cpu(store, ids, new_vals, delta, active)
    err = (got[rows] - want).abs().max().item()
    equal = torch.equal(bits(got[rows]), bits(want))
    named = torch.zeros(r, dtype=torch.bool, device="cuda")
    named[rows] = True
    stray = int(((got != store).any(dim=1) & ~named).sum().item())
    del got
    if not equal or not err <= tol or stray:
        fail(f"sparse_rows_overwrite {what}: not bit-equal to the plain version on the CPU "
             f"(max abs err {err}), or {stray} rows that no item names changed")
    ms = device_time_ms(lambda: sparse_rows_overwrite(store, ids, new_vals, delta, active),
                        reps=TRAFFIC_REPS, samples=TRAFFIC_REPS)
    plain_ms = device_time_ms(
        lambda: sparse_rows_overwrite_reference(store, ids, new_vals, delta, active),
        reps=TRAFFIC_REPS, samples=TRAFFIC_REPS)
    masked, ids64 = delta * active[:, None], ids.long()
    library_ms = device_time_ms(lambda: store.index_add_(0, ids64, masked),
                                reps=TRAFFIC_REPS, samples=TRAFFIC_REPS)
    live = ids[active > 0].long()
    _, counts = torch.unique(live, return_counts=True)
    n_once, n_dup_rows = int((counts == 1).sum()), int((counts > 1).sum())
    n_dup_items = int(counts[counts > 1].sum())
    row = 4 * w
    nbytes = 8 * k + 2 * row * n_once + row * n_dup_items + 2 * row * n_dup_rows
    bound, by = bound_ms(nbytes, w * n_dup_items)
    say("kernel", f"sparse_rows_overwrite {what} [{r}, {w}] f32, K={k} ({n_once} unique live "
                  f"rows, {n_dup_items} items on {n_dup_rows} duplicated rows): bit-equal to "
                  f"the plain version on the CPU; wrapper {ms:.5f} ms, plain {plain_ms:.5f} ms, "
                  f"index_add_ {library_ms:.5f} ms, bound {bound:.5f} ms ({by}, {nbytes} B)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


def check_variant_kernels(rows):
    """Phase x: the kernels on the shapes the variants give them. K2 at
    widths 1, 2 and 4 (the Kaggle MD big group [R, 1] with one batch's ids,
    the Terabyte MD big group's rows at W=2 and W=4), each also with a hot
    row on half of K, bit for bit against the plain version on the CPU; K4
    on a quotient table [250,000, 128] f32 (no sentinel tail) with a
    coalesced batch that updates row 249,999, bit for bit, the last row
    kept and its update on the row before (the JAX kernel's clip); K3 on
    every small group of both MD models (dims 1 to 128) and on every group
    of the processed model (dims 64 to 512: one to four 16-byte chunks a
    lane) with the dataset's first batch of pooled ids, then the processed
    model's groups as one eager train step collects them, in one grouped
    launch (``grouped_finish_case``; returns its row)."""
    import torch

    from dlrm_yx_tpu_torch.data.batch import to_device
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.ops.coalesce import coalesce_rows
    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add, sparse_rows_add_reference
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state

    gen = torch.Generator(device="cuda").manual_seed(41)
    md_tb, md_kg = config_of(md_terabyte_argv(rows)), config_of(kaggle_md_argv())
    tb_big = next(g for g in model_groups(md_tb) if g.size_class == 1)
    kg_big = next(g for g in model_groups(md_kg) if g.size_class == 1)
    for what, group, w, batch in (("Kaggle MD big group", kg_big, 1, KAGGLE_BATCH),
                                  ("Terabyte MD big group's rows", tb_big, 2, BATCH),
                                  ("Terabyte MD big group", tb_big, 4, BATCH)):
        assert group.dim == w or what.endswith("rows"), (what, group.dim)
        store = torch.rand(group.total_rows, w, device="cuda", generator=gen) - 0.5
        for case in ("one batch", "a hot row on half of K"):
            ids = batch_rows(group, gen, batch)
            if case != "one batch":
                ids[::2] = ids[0]
            active = torch.ones(ids.numel(), dtype=torch.int32, device="cuda")
            overwrite_case(f"W={w}, {what}, {case}", store, ids, active, gen, 1e-6)
        del store
        torch.cuda.empty_cache()

    # K4 on a quotient table: the RWSAdagrad route coalesces first
    q_rows = 250_000
    store = torch.rand(q_rows, 128, device="cuda", generator=gen) - 0.5
    ids = torch.randint(0, q_rows, (BATCH,), device="cuda", generator=gen, dtype=torch.int32)
    ids[7] = q_rows - 1
    g = torch.randn(BATCH, 128, device="cuda", generator=gen) * 1e-2
    uniq, upd = coalesce_rows(ids, g, q_rows)
    active = (uniq < q_rows).int()
    got = sparse_rows_add(store.clone(), uniq, upd, active)
    want = sparse_rows_add_reference(store.clone(), uniq, upd, active)
    torch.cuda.synchronize()
    equal, err = same_bits(got, want)
    kept = torch.equal(bits(got[-1]), bits(store[-1]))
    moved = not torch.equal(bits(got[-2]), bits(store[-2]))
    del got, want
    if not equal or not kept or not moved:
        fail(f"sparse_rows_add on a quotient table: bit-equal {equal} (max abs err {err}), "
             f"last row kept {kept}, the row before it moved {moved}")
    ms = device_time_ms(lambda: sparse_rows_add(store, uniq, upd, active))
    plain_ms = events_ms(lambda: sparse_rows_add_reference(store, uniq, upd, active), 10)[0]
    masked, ids64 = upd * active[:, None], uniq.long().clamp(max=q_rows - 1)
    library_ms = device_time_ms(lambda: store.index_add_(0, ids64, masked))
    n = int(active.sum())
    nbytes = 8 * BATCH + 4 * 128 * BATCH + 2 * 4 * 128 * n
    bound, by = bound_ms(nbytes, 128 * n)
    say("kernel", f"sparse_rows_add quotient table [{q_rows}, 128] f32 (no sentinel rows), "
                  f"K={BATCH} coalesced to {n} rows, one on row {q_rows - 1}: bit-equal to the "
                  f"plain version, row {q_rows - 1} kept and row {q_rows - 2} moved (the JAX "
                  f"clip, ROADMAP Queue C); wrapper {ms:.5f} ms, plain {plain_ms:.5f} ms, "
                  f"index_add_ {library_ms:.5f} ms, bound {bound:.5f} ms ({by}, {nbytes} B)")
    del store, masked
    torch.cuda.empty_cache()

    shapes, first = variant_finish_shapes(rows, gen)
    for what, group, ids in shapes:
        finish_case(what, group, ids, gen)
    # the processed step's groups in one grouped launch, as its train step
    # collects them
    processed_cfg = config_of(processed_argv())
    rws = OptConfig("rwsadagrad", LR)
    params = init_dlrm(processed_cfg, seed=0, device="cuda")
    state = init_opt_state(rws, params, model_groups(processed_cfg))
    items = record_finish_stores(processed_cfg, rws, params, state,
                                  to_device(first, torch.device("cuda")))
    del params, state
    return grouped_finish_case("the processed step's groups", items)


def variant_main_paths(rows):
    """Phase y: the variants and the processed dataset through ``cli.main``,
    each with the launch counts set to 0 just before and read just after:
    Terabyte-MLPerf with mixed dims (K2 once a step on the dim-4 big group,
    K3 once a step on the four small groups, grouped, K1 per step and eval
    batch; no row of the
    big store that no live lookup touched moved), Kaggle's model with mixed
    dims (K2 once a step on the dim-1 big group), Terabyte-MLPerf with QR
    tables (K4 on the seven quotient tables of 64 MiB or more, K3 once a
    step on the small group and the other QR sub-tables, grouped, K1) and
    served again with
    --inference-only (K1), the L=100 benchmark with learned pooling weights
    (K5 once a step and nothing else; v_W moved only on rows a live lookup
    touched), and a processed dataset written by the port's generator,
    trained (K3 once a step on every dim group, grouped) and served with
    --load-processed.
    Returns the launch counts by run."""
    import torch

    from dlrm_yx_tpu_torch.data import processed
    from dlrm_yx_tpu_torch.models.dlrm import model_groups

    n = N_VARIANT_STEPS
    launched = {}
    md = config_of(md_terabyte_argv(rows))
    n_small = sum(g.size_class == 0 for g in model_groups(md))
    if n_small != 4:
        fail(f"the Terabyte MD model has {n_small} small groups, want 4 (dims 8, 16, 32, 128)")
    launched["md"] = cli_training_run(
        "variants", f"cli Terabyte-MLPerf (<=1M rows) with --md-flag --md-round-dims (dims "
                    f"{sorted(set(md.emb_dims))}), B={BATCH}, L=1, bf16, rwsadagrad, "
                    "sparse-update pallas, pallas interaction",
        md_terabyte_argv(rows) + ["--num-batches", str(n), "--print-freq", "1"], n,
        only(fused_interaction=2 * n, sparse_rows_overwrite=n, rwsadagrad_dense_finish=n),
        big_index=0)
    kg = config_of(kaggle_md_argv())
    groups = model_groups(kg)
    big = next(i for i, g in enumerate(groups) if g.size_class == 1)
    launched["kaggle md"] = cli_training_run(
        "variants", f"cli Kaggle model (D=16) with --md-flag --md-round-dims, big group "
                    f"[{groups[big].total_rows}, {groups[big].dim}], B={KAGGLE_BATCH}, L=1, sgd, "
                    "sparse-update pallas",
        kaggle_md_argv() + ["--num-batches", str(n), "--print-freq", "1"], n,
        only(sparse_rows_overwrite=n), big_index=big)
    qr = config_of(qr_terabyte_argv(rows))
    launched["qr"] = cli_training_run(
        "variants", f"cli Terabyte-MLPerf (<=1M rows) with --qr-flag ({len(qr.qr_table_ids)} "
                    "QR tables: 7 quotient tables on K4; the other 29 QR sub-tables and the "
                    f"small group on K3, one grouped launch a step), B={BATCH}, L=1, bf16, "
                    "rwsadagrad, sparse-update "
                    "pallas, pallas interaction",
        qr_terabyte_argv(rows) + ["--num-batches", str(n), "--print-freq", "1"], n,
        only(fused_interaction=2 * n, sparse_rows_add=7 * n, rwsadagrad_dense_finish=n),
        big_index=None)
    launched["qr serve"] = serve_run(
        "variants", "cli --inference-only, the same QR model",
        qr_terabyte_argv(rows) + ["--num-batches", str(n), "--inference-only"],
        only(fused_interaction=n))
    out = {}
    launched["weighted"] = cli_training_run(
        "variants", f"cli bench/dlrm_tpu_benchmark.sh flags with --weighted-pooling learned, "
                    f"8 x 1M x 64, B={BATCH}, L={L100}, bf16, sgd, sparse-update pallas",
        benchmark_argv() + ["--weighted-pooling", "learned", "--num-batches", str(n),
                            "--print-freq", "1"], n,
        only(sorted_stream_apply=n), big_index=0, out=out)
    check_vw_moved_only_where_looked_up(out["trainer"])
    del out
    dims = sorted({t["dim"] for t in processed.load_table_configs(PROCESSED_DIR)["tables"]})
    argv = processed_argv()
    launched["processed"] = cli_training_run(
        "variants", f"cli --load-processed (12 tables, dims {dims}: {len(dims)} small groups), "
                    "rwsadagrad, sparse-update pallas", argv, 10,
        only(rwsadagrad_dense_finish=10), big_index=None)
    launched["processed serve"] = serve_run(
        "variants", "cli --load-processed --inference-only", argv + ["--inference-only"], only())
    torch.cuda.empty_cache()
    return launched


def serve_run(phase, what, argv, want):
    """A CLI serving run with the launch counts set to 0 just before and
    read just after; fails unless they are ``want`` and the metrics finite."""
    import contextlib
    import io
    import math

    from dlrm_yx_tpu_torch import cli

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        metrics = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    if launches != want:
        fail(f"{what}: launched {launches}, want {want}")
    for key in ("accuracy", "streaming_auc"):
        if not math.isfinite(metrics.get(key, math.nan)):
            fail(f"{what}: metric {key} = {metrics.get(key)} is missing or not finite")
    shown = {k: round(v, 6) for k, v in metrics.items() if isinstance(v, float)}
    say(phase, f"{what}: served in {seconds:.1f} s (host init and data included); {shown}; "
               f"launches {launches}")
    return launches


def check_vw_moved_only_where_looked_up(trainer):
    """Learned v_W after a CLI run: no entry moved on a row that no live
    (nonzero-weight) lookup touched. At full width an update can be below
    half an ulp of 1.0 (rows ~1e-3, a mean loss over 2048 samples), so v_W
    may keep every value: phase z shows v_W learning on the card."""
    import torch

    g = trainer.groups[0]
    offs = torch.tensor(g.row_offsets, device="cuda")[:, None, None]
    live = torch.zeros(g.total_rows, dtype=torch.bool, device="cuda")
    for b in trainer.trained_on:
        idx = torch.as_tensor(b.indices, device="cuda").long() + offs
        live[idx[torch.as_tensor(b.weights, device="cuda") != 0]] = True
    vw = trainer.params["vw"][0]
    ones = torch.zeros_like(vw)
    for n, off in zip(g.rows, g.row_offsets):
        ones[off:off + n] = 1.0
    moved = bits(vw) != bits(ones)
    if (moved & ~live).any():
        fail(f"learned v_W: {int(moved.sum())} entries moved, "
             f"{int((moved & ~live).sum())} of them on rows no live lookup touched")
    say("variants", f"  learned v_W moved on {int(moved.sum())} rows (max |change| "
                    f"{(vw - ones).abs().max().item():.3e}), none that no live lookup touched "
                    f"({int(live.sum())} rows were looked up); at this width v_W may keep "
                    "every value, so this check can catch only a stray move: phases f and r "
                    "drive K5 on w * v_W with v_W 0, negative and random")


def card_vs_cpu(what, cfg, opt, batches, want, mutate=None, learns=()):
    """Three train steps (and an eval step) on the card against the CPU (the
    kernels' plain versions) from the same state, with the kernel gates at
    0: losses and every params and optimizer-state tensor within rtol 1e-4
    / atol 1e-6 (the card sums in other orders); the card's launches must
    be ``want``; each params key in ``learns`` must have moved on the
    card."""
    import numpy as np
    import torch

    import dlrm_yx_tpu_torch.optim.optimizer as optimizer
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.train.train_step import make_eval_step, make_train_step

    counters = launch_counters()
    out = []  # the CPU's run, then the card's
    saved = optimizer.PALLAS_MIN_STORE_BYTES, optimizer.ACC_KERNEL_MIN_BYTES
    optimizer.PALLAS_MIN_STORE_BYTES = optimizer.ACC_KERNEL_MIN_BYTES = 0
    try:
        for dev in ("cpu", "cuda"):
            params = init_dlrm(cfg, seed=7, device=dev)
            if mutate is not None:
                mutate(params)
            start = {k: clone_tree(params[k]) for k in learns}
            state = optimizer.init_opt_state(opt, params, model_groups(cfg))
            for t in leaves(state):
                t.fill_(0.01)
            before = {n: c.launches for n, c in counters.items()}
            step = make_train_step(cfg, opt, device=dev)
            preds, _ = make_eval_step(cfg, dev, capture=False)(params, batches[0])
            losses = [preds.float().mean().item()]
            for i, b in enumerate(batches):
                params, state, loss = step(params, state, b, i)
                losses.append(float(loss))
            ran = {n: c.launches - before[n] for n, c in counters.items()}
            out.append((np.array(losses), params, state, ran))
    finally:
        optimizer.PALLAS_MIN_STORE_BYTES, optimizer.ACC_KERNEL_MIN_BYTES = saved
    (lc, pc, sc, _), (lg, pg, sg, ran) = out
    if ran != want:
        fail(f"{what} on the card launched {ran}, want {want}")
    for k in learns:
        if all(torch.equal(a, b) for a, b in zip(leaves(start[k]), leaves(pg[k]))):
            fail(f"{what}: {k} did not move on the card")
    rtol, atol = 1e-4, 1e-6
    pairs = [("losses", torch.from_numpy(lc), torch.from_numpy(lg))] + [
        (f"tensor {i}", a.detach().float(), b.detach().float().cpu())
        for i, (a, b) in enumerate(zip(leaves((pc, sc)), leaves((pg, sg))))]
    for name, a, b in pairs:
        if not torch.allclose(b, a, rtol=rtol, atol=atol):
            fail(f"{what} card vs CPU: {name} differs beyond rtol {rtol} atol {atol}: max "
                 f"{(a - b).abs().max().item()}")
    worst = max((a - b).abs().max().item() for _, a, b in pairs)
    say("reference", f"{what}: eval + 3 train steps card vs CPU, losses {lg[1:].tolist()}; "
                     f"max |diff| over the mean prediction, losses and all {len(pairs) - 1} "
                     f"params and state tensors {worst:.3e} (rtol {rtol}, atol {atol}); "
                     f"launches { {k: v for k, v in want.items() if v} }")


def check_variants_against_cpu():
    """Phase z: small MD, QR and learned-pooling models, three train steps
    each on the card against the CPU with the kernel gates at 0: MD at D=16
    (big groups of widths 1 and 2: K2; small groups: K3), QR at D=128
    (quotient tables: K4; remainder tables and the small group: K3; K1),
    and learned pooling at L=100 on the stream route (K5) with v_W 0 and
    negative on some rows."""
    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
    from dlrm_yx_tpu_torch.ops.md_embedding import md_solver
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig

    def batches(cfg, m_den, lookups):
        return make_random_batches(RandomDataConfig(
            emb_rows=cfg.emb_rows, m_den=m_den, mini_batch_size=64, num_batches=3,
            num_indices_per_lookup=lookups, num_indices_per_lookup_fixed=False, seed=8))

    rows = (50, 300, 100_000, 1_000_000)
    dims = tuple(int(d) if n > 200 else 16 for d, n in
                 zip(md_solver(rows, 0.3, d0=16, round_dim=True), rows))
    md = DLRMConfig.build(emb_rows=rows, emb_dims=dims, ln_bot=(4, 32, 16), ln_top=(32, 1),
                          emb_split_threshold=100, loss="bce", md_flag=True,
                          sparse_update_impl="pallas")
    rws = OptConfig("rwsadagrad", 0.05)
    # K4 on the big groups' 1-D momenta (ACC_KERNEL_MIN_BYTES at 0)
    card_vs_cpu(f"MD dims {dims}, rwsadagrad", md, rws, batches(md, 4, 1),
                only(sparse_rows_overwrite=6, rwsadagrad_dense_finish=3, sparse_rows_add=6),
                learns=("md_proj",))
    qr = DLRMConfig.build(emb_rows=(3000, 40, 60, 5000), ln_bot=(4, 64, 128), ln_top=(64, 1),
                          emb_split_threshold=100, loss="bce", interaction_impl="pallas",
                          qr_flag=True, sparse_update_impl="pallas")
    card_vs_cpu("QR mult, rwsadagrad", qr, rws, batches(qr, 4, 1),
                only(fused_interaction=4, sparse_rows_add=6, rwsadagrad_dense_finish=3),
                learns=("qr",))

    def zero_some(params):
        for v in params["vw"]:
            v[:40] = 0.0
            v[40:60] = -0.5

    wp = DLRMConfig.build(emb_rows=(3000, 4000), ln_bot=(16, 64, 64), ln_top=(64, 1),
                          emb_split_threshold=0, loss="bce", weighted_pooling="learned",
                          sparse_update_impl="pallas")
    card_vs_cpu(f"learned pooling, L={L100}, sgd (stream route)", wp, OptConfig("sgd", 0.05),
                batches(wp, 16, L100), only(sorted_stream_apply=3), mutate=zero_some,
                learns=("vw",))


# kernels of the variants' L=1 steps by what they do (K2 on MD's big group,
# K4 on QR's quotient tables: both the row plan's kernels)
VARIANT_KINDS = {
    "K1 fused_interaction": "fused_interaction",
    "K2 / K4 (row_plan)": "row_plan",
    "K3 rwsadagrad_dense_finish": "dense_finish",
    "sort (cub radix)": "radix|sort",
    "gather (index_select)": "indexselect|index_select|gather",
    "scatter (index_add_, index_put_)": "indexfunc|index_add|scatter|index_put|indexing_backward",
    "GEMM": "gemm|nvjet|xmma|cutlass|cublas",
    "elementwise and reductions": "elementwise|reduce",
}


def variant_throughput(plain_fn, rows, grouped):
    """Phase s, the variants: the captured N=16 L=1 train step of the MD
    and QR Terabyte models against the plain one (``plain_fn``), in turns;
    first, each model's stores as one eager step collects them for the
    grouped finish go through ``grouped_finish_case``, whose row goes into
    ``grouped`` under "MD" and "QR". Returns the MD and QR dispatches as
    functions of nothing (phase t profiles them)."""
    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_multistep_train_step

    rws = OptConfig("rwsadagrad", LR)
    fns = {"plain": plain_fn}
    for name, argv in (("MD", md_terabyte_argv(rows)), ("QR", qr_terabyte_argv(rows))):
        cfg = config_of(argv)
        params = init_dlrm(cfg, seed=0, device="cuda")
        state = init_opt_state(rws, params, model_groups(cfg))
        batch = drawn_batches(cfg, 1, seed=4)[0]
        grouped[name] = grouped_finish_case(
            f"the {name} step's stores", record_finish_stores(cfg, rws, params, state, batch))
        step = make_multistep_train_step(cfg, rws, N_DISPATCH)
        fns[name] = train_step_fn(step, params, state, stack_batches([batch] * N_DISPATCH))
    times = time_in_turns(fns, check_loss)
    plain_ms = statistics.mean(times["plain"]) / N_DISPATCH
    for name, ts in times.items():
        ms = statistics.mean(ts) / N_DISPATCH
        say("throughput", f"captured N={N_DISPATCH} L=1 train step, Terabyte-MLPerf <=1M rows, "
                          f"B={BATCH}, bf16, rwsadagrad, sparse-update pallas, {name} tables: "
                          f"{ms:.4f} ms/step ({BATCH / ms * 1e3:.0f} examples/s; "
                          f"{ms / plain_ms:.2f}x plain; ms a call {ts})")
    return {name: fn for name, fn in fns.items() if name != "plain"}


# ---------------------------------------------- quantized serving (phase 8)

QUANT_COMBOS = tuple((e, m) for e in (8, 4) for m in (32, 8, 16))  # (table bits, tower bits)
QUANT_SAMPLE_ROWS = 4096  # each group's first and last rows held to the CPU's quantization
QUANT_TOL = 0.05          # |quantized - float| predictions: the JAX test's bound
                          # (tests/test_variants.py:313)
QUANT_REPLAY_TOL = 1e-6   # a replayed batch against the same step run eagerly: the same
                          # operations, whose reductions may pick other kernels
QUANT_KINDS = {
    "gather (index_select: quantized rows, scales, biases)": "indexselect|index_select|gather",
    "GEMM (the towers' f32 and exact int8-valued products)": "gemm|nvjet|xmma|cutlass|cublas",
    "elementwise and reductions (dequantize, pool, quantize x, activations)":
        "elementwise|reduce",
}


def quantized_store_bytes(groups, bits):
    """The bytes of the quantized stores: uint8 rows (two values a byte at
    int4) and an f32 scale and bias a row."""
    return sum(g.total_rows * (g.dim if bits == 8 else g.dim // 2) + 8 * g.total_rows
               for g in groups)


def check_quantized_rows(what, seen, bits):
    """The card's quantized rows against the CPU's quantization of the same
    rows (each group's first and last QUANT_SAMPLE_ROWS rows and the first
    batch's ids), bit for bit: the quantization is row by row."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import group_indices
    from dlrm_yx_tpu_torch.ops.quantized import quantize_store

    n_rows = 0
    for g, store, qs in zip(seen["groups"], seen["params"]["emb"], seen["qstores"]):
        r = g.total_rows
        offs = torch.tensor(g.row_offsets)[:, None, None]
        idx = group_indices(g, torch.as_tensor(seen["batch"].indices)).long() + offs
        ids = torch.cat([torch.arange(min(r, QUANT_SAMPLE_ROWS)),
                         torch.arange(max(0, r - QUANT_SAMPLE_ROWS), r),
                         idx.reshape(-1)]).unique().to(store.device)
        want = quantize_store(store[ids].cpu(), bits)
        differ = {name: int((getattr(qs, name)[ids].cpu().view(torch.uint8).reshape(len(ids), -1)
                             != getattr(want, name).view(torch.uint8).reshape(len(ids), -1))
                            .any(dim=1).sum())
                  for name in ("data", "scale", "bias")}
        if any(differ.values()):
            fail(f"{what}: the card's quantized rows of a group of {r} rows x {g.dim} differ "
                 f"from the CPU's quantization of the same {len(ids)} rows (rows differing "
                 f"by field: {differ})")
        n_rows += ids.numel()
    return n_rows


def quantized_main_paths(rows):
    """Phase 8: ``cli.main --inference-only`` on the full-width model with
    the tables at 8 and 4 bits and the towers at 32, 8 and 16, the launch
    counts set to 0 just before each run and read just after (none: the
    quantized step is torch work, as the JAX package routes it to XLA).
    Each run's quantized stores are measured on the card against their
    size, held bit for bit to the CPU's quantization on a sample of rows,
    and its first batch's predictions to the float eval step's."""
    import contextlib
    import io
    import math

    import torch

    from dlrm_yx_tpu_torch import cli
    from dlrm_yx_tpu_torch.train.train_step import make_eval_step

    real_quantize, real_step = cli.quantize_model_embeddings, cli.make_fully_quantized_eval_step
    for emb_bits, mlp_bits in QUANT_COMBOS:
        seen = {}

        def quantize(params, groups, bits):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            qstores = real_quantize(params, groups, bits)
            torch.cuda.synchronize()
            seen.update(qbytes=torch.cuda.memory_allocated() - before, qstores=qstores,
                        params=params, groups=groups)
            return qstores

        def make_step(cfg, *a, **k):
            ev = real_step(cfg, *a, **k)
            seen.update(cfg=cfg, eager=real_step(cfg, *a, **{**k, "capture": False}))

            def step(params, batch):
                out = ev(params, batch)
                if "batch" not in seen:
                    seen.update(batch=batch, preds=out.clone())
                seen["last"] = (batch, out.clone())  # the last batches are graph replays
                return out

            return step

        argv = terabyte_argv(rows) + [
            "--num-batches", str(N_SERVE_BATCHES), "--inference-only",
            f"--quantize-emb-with-bit={emb_bits}", f"--quantize-mlp-with-bit={mlp_bits}"]
        what = f"cli --inference-only, int{emb_bits} tables, towers at {mlp_bits} bits"
        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        cli.quantize_model_embeddings, cli.make_fully_quantized_eval_step = quantize, make_step
        printed = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                metrics = cli.main(argv)
            seconds = time.perf_counter() - t0
            launches = {name: c.launches for name, c in counters.items()}
        finally:
            cli.quantize_model_embeddings, cli.make_fully_quantized_eval_step = (
                real_quantize, real_step)
        if launches != only():
            fail(f"{what}: launched {launches}, want no kernel")
        acc = metrics.get("accuracy", math.nan)
        if metrics.get("quantized") is not True or not 0.0 <= acc <= 1.0:
            fail(f"{what}: metrics {metrics}")
        want_bytes = quantized_store_bytes(seen["groups"], emb_bits)
        nbytes = sum(t.numel() * t.element_size() for qs in seen["qstores"]
                     for t in (qs.data, qs.scale, qs.bias))
        # the caching allocator does not split off a remainder of 1 MiB or
        # less from a large block: each of the tensors may hold up to that more
        slack = 3 * len(seen["groups"]) * 2**20
        if nbytes != want_bytes or not want_bytes <= seen["qbytes"] <= want_bytes + slack:
            fail(f"{what}: the quantized stores hold {nbytes} B and took {seen['qbytes']} B "
                 f"on the card, want {want_bytes} B")
        n_rows = check_quantized_rows(what, seen, emb_bits)
        float_preds, _ = make_eval_step(seen["cfg"], seen["preds"].device, capture=False)(
            seen["params"], seen["batch"])
        err = (seen["preds"] - float_preds).abs().max().item()
        if not err <= QUANT_TOL:
            fail(f"{what}: predictions {err} from the float eval step's > {QUANT_TOL}")
        last_batch, replayed = seen["last"]
        eager = seen["eager"](seen["params"], last_batch)
        replay_err = (replayed - eager).abs().max().item()
        if not replay_err <= QUANT_REPLAY_TOL:
            fail(f"{what}: the last batch's replayed predictions are {replay_err} from the "
                 f"same step run eagerly > {QUANT_REPLAY_TOL}")
        scale_bias = 8 * sum(g.total_rows for g in seen["groups"])
        replay = ("bit for bit with" if replay_err == 0 else f"{replay_err:.3e} from")
        say("serve-quantized", f"{what}, 26 tables <=1M rows x 128, B={BATCH}: "
                               f"{N_SERVE_BATCHES} batches in {seconds:.1f} s (host init and "
                               f"data included); accuracy {acc:.6f}; stores of {nbytes} B, "
                               f"{seen['qbytes']} B allocated on the card (want {want_bytes} B: "
                               f"rows {want_bytes - scale_bias} B + scale and bias {scale_bias} "
                               f"B); {n_rows} rows bit for bit with the CPU's quantization; "
                               f"first batch's predictions within {err:.3e} of the float eval "
                               f"step's (tol {QUANT_TOL}); the last batch's replay {replay} the "
                               f"eager step; launches {launches}")


def quantized_throughput(cfg, params, batch):
    """Phase 8, timing: the captured quantized eval steps (one batch a
    replay) against the captured float eval step (bf16, K1), in turns, on
    device-drawn params and batch. Returns the quantized steps as
    functions of nothing (profiled later)."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.quantized import (
        make_fully_quantized_eval_step,
        quantize_mlp,
        quantize_model_embeddings,
    )
    from dlrm_yx_tpu_torch.train.train_step import make_eval_step

    groups = model_groups(cfg)
    qstores = {bits: quantize_model_embeddings(params, groups, bits) for bits in (8, 4)}
    towers = {8: tuple(quantize_mlp(params[k], "int8") for k in ("bot", "top")),
              16: tuple(quantize_mlp(params[k], "fp16") for k in ("bot", "top")),
              32: (None, None)}
    dev = params["emb"][0].device
    float_step = make_eval_step(cfg, dev)
    fns = {"float (bf16, K1)": lambda: float_step(params, batch)[0]}
    for e, m in QUANT_COMBOS:
        step = make_fully_quantized_eval_step(cfg, groups, qstores[e], *towers[m], dev)
        fns[f"int{e} tables, towers at {m} bits"] = lambda s=step: s(params, batch)

    def check(name, preds):
        if not bool(torch.isfinite(preds).all()):
            fail(f"eval step ({name}) gave non-finite predictions")

    times = time_in_turns(fns, check)
    float_ms = statistics.mean(times["float (bf16, K1)"])
    for name, ts in times.items():
        ms = statistics.mean(ts)
        say("throughput", f"captured eval step, one batch a replay, 26 tables <=1M rows x 128, "
                          f"B={BATCH}, {name}: {ms:.4f} ms/batch ({BATCH / ms * 1e3:.0f} "
                          f"examples/s; {ms / float_ms:.2f}x float; ms a call {ts})")
    return {name: fn for name, fn in fns.items() if name.startswith("int")}


# ------------------------------------ export and diagnostics (phase 9)

PHASE_NAMES = ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp", "loss_compute",
               "backward", "optimizer")
K1_K3_NAMES = {"K1": "fused_interaction", "K2": "row_plan", "K3": "dense_finish"}


def export_and_diagnostics(rows):
    """Phase 9: phase b's CLI training run with --save-onnx,
    --enable-profiling and --collect-execution-graph (launch counts: one
    more K1, K2 and K3 for the collected eager step); the exported program
    reloaded and run on the trained params and a batch, against the live
    forward, bit for bit, with K1 launched by it once; the trace and the
    execution trace read for the phases and K1-K3; then --debug-mode on a
    tiny model on the card against the CPU."""
    import contextlib
    import io
    import shutil

    import torch

    from dlrm_yx_tpu_torch import cli
    from dlrm_yx_tpu_torch.data.batch import to_device
    from dlrm_yx_tpu_torch.export import load_exported
    from dlrm_yx_tpu_torch.models.dlrm import forward
    from dlrm_yx_tpu_torch.utils.profiling import TRACE_FILE

    out_dir = os.path.join(DATA_DIR, "export")
    shutil.rmtree(out_dir, ignore_errors=True)
    prof = os.path.join(out_dir, "prof")
    os.makedirs(out_dir)
    n = N_TRAIN_BATCHES
    argv = terabyte_argv(rows) + [
        "--num-batches", str(n), "--optimizer", "rwsadagrad", "--learning-rate", str(LR),
        "--sparse-update-impl", "pallas", "--print-freq", "1", "--save-onnx",
        "--enable-profiling", "--collect-execution-graph", "--profile-out-dir", prof]
    want = only(fused_interaction=2 * n + 1, sparse_rows_overwrite=n + 1,
                rwsadagrad_dense_finish=n + 1)
    run = {}
    cwd = os.getcwd()
    os.chdir(out_dir)  # --save-onnx without --save-model writes ./dlrm_torch.pt2
    try:
        with SharedInit():
            cli_training_run("export", f"cli training with --save-onnx --enable-profiling "
                                       f"--collect-execution-graph, 26 tables <=1M rows x 128, "
                                       f"B={BATCH}, L=1, bf16, rwsadagrad, pallas", argv, n,
                             want, big_index=1, out=run)
    finally:
        os.chdir(cwd)
    trainer = run["trainer"]
    path = os.path.join(out_dir, "dlrm_torch.pt2")
    program = load_exported(path)
    b = to_device(trainer.trained_on[0], trainer.device)
    counters = launch_counters()
    with torch.no_grad():
        live = forward(trainer.params, trainer.config, trainer.groups, b.dense, b.indices,
                       b.weights)
        for c in counters.values():
            c.launches = 0
        got = program.module()(trainer.params, b.dense, b.indices, b.weights)
        launches = {name: c.launches for name, c in counters.items()}
    if launches != only(fused_interaction=1):
        fail(f"the reloaded program launched {launches}, want K1 once")
    if not torch.equal(got, live):
        fail(f"the reloaded program's predictions differ from the live forward's by "
             f"{(got - live).abs().max().item()}")
    say("export", f"{path} ({os.path.getsize(path)} B; sidecar "
                  f"{open(path + '.json').read()}) reloaded: predictions on a batch equal the "
                  f"live forward's bit for bit; launches {launches}")
    with open(os.path.join(prof, TRACE_FILE)) as f:
        text = f.read()
    missing = [p for p in PHASE_NAMES if f'"{p}"' not in text]
    named = [k for k, pat in K1_K3_NAMES.items() if pat in text]
    if missing or not named:
        fail(f"the --enable-profiling trace lacks phases {missing} or names none of K1-K3")
    say("export", f"--enable-profiling: {TRACE_FILE} of {len(text)} B names every phase and "
                  f"{named} of K1-K3 (a profiler window may drop a kernel; the launch "
                  "counters count them)")
    with open(os.path.join(prof, "train_step.et.json")) as f:
        names = {node["name"] for node in json.load(f)["nodes"]}
    with open(os.path.join(prof, "train_step.kernels.txt")) as f:
        table = f.read()
    missing = [p for p in PHASE_NAMES if p not in names]
    if missing or "dlrm_yx_tpu_torch::fused_interaction" not in names:
        fail(f"the execution trace lacks phases {missing} or K1's operator")
    say("export", f"--collect-execution-graph: train_step.et.json ({len(names)} operator "
                  f"names, every phase and K1's operator), train_step.kernels.txt names "
                  f"{[k for k, pat in K1_K3_NAMES.items() if pat in table]} of K1-K3")

    def debug_printout(device):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli.main(["--mini-batch-size=2", "--data-size=6", "--debug-mode", "--device",
                      device])
        text = printed.getvalue()
        return text[text.index("model arch:"):text.index("Finished training it")]

    card, cpu = debug_printout("cuda"), debug_printout("cpu")
    if card != cpu:
        fail("--debug-mode: the initial printout on the card differs from the CPU's")
    say("export", f"--debug-mode: the initial printout on the card equals the CPU's "
                  f"({len(card.splitlines())} lines)")


# ------------------------------------------- phase 10: hybrid (table) sharding

HYBRID_STEPS = 4      # phase 10's Trainer.fit steps; its eval takes as many batches
HYBRID_SEED = 41      # the tables' device draw, the same in (a) and (b)
# (a) against the single-device step where it is not bit for bit
HYBRID_TOL = dict(rtol=1e-5, atol=1e-6)
# Both runs start from a nonzero optimizer state (ACC0 in every accumulator, as
# phase c starts): from zero, RWSAdagrad's first dense update is lr * g / |g| for
# every element, whatever g's size, so an element whose gradient is rounding noise
# moves by the full lr either way (phase b's second loss is near 100)
ACC0 = 0.01
# (b) against (a). The towers compute in bf16, each of the two ranks on half
# the batch, and each rank's dense grads are rounded to bf16 before the two
# are summed (one card rounds the whole batch's once), as in the JAX
# package's hybrid step. The losses read 6e-6 relative apart on an H100 80GB
# HBM3 at 700 W: the limit keeps a margin of 16.
TWO_RANK_LOSS = dict(rtol=1e-4, atol=0.0)
# The tables are held by their change over the run, not their values: with
# every accumulator at ACC0 a step moves an entry by at most lr * |g| /
# sqrt(ACC0), far below the entries themselves, so values agree whatever the
# update did. Each table's change must touch the same rows as (a)'s, and the
# two changes may differ by TWO_RANK_CHANGE of (a)'s in norm over all tables.
# With the dense grads rounded per rank (tests/test_torch_hybrid.py's
# rwsadagrad_bf16 case holds the port's mesh of two to JAX's), the towers
# drift from one card's, and the tables with them: (b) read 1.735e-02 on an H100 80GB
# HBM3 at 700 W. The limit keeps a margin of about 3; a run that applied no
# sparse update reads 1, and (a)'s change on rows shifted by one 0.601.
TWO_RANK_CHANGE = 5e-2


def hybrid_config(rows):
    """Phase 10's model: phase b's (Terabyte-MLPerf <=1M rows, B=2048, L=1,
    bf16 compute, RWSAdagrad, --sparse-update-impl pallas, pallas
    interaction), with the uniform stream's density hint."""
    import dataclasses

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, uniform_stream_density

    cfg = DLRMConfig.build(
        emb_rows=rows, ln_bot=(13, 512, 256, 128), ln_top=(1024, 1024, 512, 256, 1),
        loss="bce", compute_dtype="bfloat16", sparse_update_impl="pallas",
        interaction_impl="pallas")
    cfg = dataclasses.replace(cfg, dup_density_hint=uniform_stream_density(
        cfg.emb_rows, cfg.emb_split_threshold, BATCH))
    return cfg, OptConfig("rwsadagrad", LR)


def same_or_close(what, got, want, tol):
    """'bit for bit', or the max |diff| within ``tol``; fails otherwise."""
    import torch

    if all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
        return "bit for bit"
    worst = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    if not all(torch.allclose(a.float(), b.float(), **tol) for a, b in zip(got, want)):
        fail(f"{what}: max |diff| {worst} beyond rtol {tol['rtol']} atol {tol['atol']}")
    return f"within rtol {tol['rtol']} atol {tol['atol']} (max |diff| {worst:.3e})"


def fill_state(state):
    """Every accumulator of an optimizer state set to ACC0, in place."""
    for t in leaves(state):
        t.fill_(ACC0)
    return state


def looked_up_big_rows(runner, batches):
    """The rows of the rank's big store that the batches' live lookups read."""
    import torch

    from dlrm_yx_tpu_torch.ops.embedding import device_ints

    plan, nb = runner.plan, runner.plan.n_big_slots
    offs = device_ints(plan.row_offsets[runner.mesh.m * plan.t_pad:][:nb], "cuda")
    rows = torch.zeros(plan.r_big_pad, dtype=torch.bool, device="cuda")
    for b in batches:
        lb = runner.prepare_batch(b)
        ids = (lb.indices[:nb] + offs[:, None, None]).long()
        ids = ids[(lb.weights[:nb] != 0) & (ids < plan.r_big_pad)]
        rows[ids] = True
    return rows


def hybrid_capture_parity(cfg, opt, plan, single):
    """Phase 10 (a): the captured N=4 hybrid step (three dispatches: eager
    warm-up, capture + replay, replay) against the eager hybrid step from a
    clone, bit for bit: losses and every tensor."""
    import torch

    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner, params_from_single_device

    n = 4
    runner = HybridRunner(cfg, opt, 1, 1, params=params_from_single_device(cfg, plan, single))
    eager_p, eager_s = clone_tree(runner.params), clone_tree(runner.opt_state)
    eager = runner.eager_step()
    captured = runner.make_multi_step(n)
    batches = drawn_batches(cfg, 3 * n, seed=44)
    want, eager_launches = counted(lambda: torch.stack(
        [eager(eager_p, eager_s, runner.prepare_batch(b), i)[2] for i, b in enumerate(batches)]))
    got, replay_launches = counted(lambda: torch.cat(
        [captured(runner.params, runner.opt_state,
                  runner.prepare_batch(stack_batches(batches[j * n:(j + 1) * n])), j * n)[2]
         for j in range(3)]))
    torch.cuda.synchronize()
    replays = captured.graph_step.replays()
    pairs = [("losses", want, got)] + [
        (f"tensor {i}", a, b) for i, (a, b) in enumerate(
            zip(leaves((eager_p, eager_s)), leaves((runner.params, runner.opt_state))))]
    differ = [name for name, a, b in pairs if not torch.equal(bits(a), bits(b))]
    if differ or replay_launches != eager_launches or replays < 2:
        fail(f"hybrid capture parity: {differ[:5]} of {len(pairs)} tensors differ, launches "
             f"{replay_launches} against the eager {eager_launches}, {replays} replays")
    say("hybrid", f"captured N={n} hybrid step (NCCL, world size 1): 3 dispatches ({replays} "
                  f"replays) equal to the eager hybrid step bit for bit (losses and all "
                  f"{len(pairs)} tensors); launches "
                  f"{ {k: v for k, v in replay_launches.items() if v} }, as eager")


def hybrid_throughput(cfg, opt, plan, single, state):
    """Phase 10 (a): the captured N=16 hybrid step against the captured
    single-device step, CUDA-event timed in turns; returns an eager hybrid
    step (a function of nothing) for the overlap check."""
    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner, params_from_single_device
    from dlrm_yx_tpu_torch.train.train_step import make_multistep_train_step

    runner = HybridRunner(cfg, opt, 1, 1, params=params_from_single_device(cfg, plan, single))
    batch = drawn_batches(cfg, 1, seed=45)[0]
    stacked = stack_batches([batch] * N_DISPATCH)
    fns = {
        "single-device captured": train_step_fn(
            make_multistep_train_step(cfg, opt, N_DISPATCH), single, state, stacked),
        "hybrid captured": train_step_fn(runner.make_multi_step(N_DISPATCH), runner.params,
                                         runner.opt_state, runner.prepare_batch(stacked)),
    }
    times = time_in_turns(fns, check_loss)
    base = statistics.mean(times["single-device captured"])
    for name, ts in times.items():
        ms = statistics.mean(ts) / N_DISPATCH
        say("throughput", f"phase 10, {name} N={N_DISPATCH} (Terabyte-MLPerf <=1M rows, "
                          f"B={BATCH}, bf16, rwsadagrad, pallas): {ms:.4f} ms/step "
                          f"({BATCH / ms * 1e3:.0f} examples/s; "
                          f"{statistics.mean(ts) / base:.3f}x the single-device step; ms a "
                          f"call {ts})")
    eager = runner.eager_step()
    return train_step_fn(eager, runner.params, runner.opt_state, runner.prepare_batch(batch))


def hybrid_overlap(eager_step):
    """Phase 10 (a): one profiler window over an eager hybrid step: the
    all-to-all issued before the bottom MLP's first GEMM and waited on after
    its last one (``parallel/overlap.check_a2a_overlap``), and the device
    side of the same window (read, not held: at world size 1 the exchange
    moves no bytes between cards)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrm_yx_tpu_torch.parallel.overlap import check_a2a_overlap

    for _ in range(2):
        eager_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eager_step()
        torch.cuda.synchronize()
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, "hybrid_step_trace.json")
    prof.export_chrome_trace(path)
    got = check_a2a_overlap(path)
    nccl = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type.name == "CUDA" and "nccl" in e.key.lower()]
    if not got["overlapped"]:
        fail(f"hybrid step: the all-to-all does not overlap the bottom MLP: {got}")
    say("hybrid", f"overlap (one eager step under torch.profiler): {got}; NCCL kernels "
                  f"{[(k[:60], round(us, 2)) for k, us in nccl]} (us)")


def hybrid_world_of_one(rows):
    """Phase 10 (a): the hybrid path at world size 1 over NCCL, at full
    width; returns its losses."""
    import contextlib
    import gc
    import io

    import torch
    import torch.distributed as dist

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import init_opt_state
    from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner, params_from_single_device
    from dlrm_yx_tpu_torch.parallel.multihost import free_port, init_multihost
    from dlrm_yx_tpu_torch.parallel.plan import make_plan
    from dlrm_yx_tpu_torch.train.train_step import make_train_step
    from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    init_multihost(coordinator=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                   device="cuda")
    if dist.get_backend() != "nccl":
        fail(f"phase 10 (a) wants NCCL, the world runs {dist.get_backend()}")
    cfg, opt = hybrid_config(rows)
    plan = make_plan(cfg, 1, "greedy")
    torch.use_deterministic_algorithms(True)
    try:
        single = init_dlrm_on_device(cfg, seed=HYBRID_SEED)
        before = torch.cuda.memory_allocated()
        hp = params_from_single_device(cfg, plan, single)
        runner = HybridRunner(cfg, opt, 1, 1, params=hp)
        grown = torch.cuda.memory_allocated() - before
        fill_state(runner.opt_state)
        store_bytes = 4 * plan.dim * (plan.r_big_pad + plan.r_small_pad)
        acc_bytes = sum(t.numel() * t.element_size()
                        for t in (runner.opt_state["emb"], runner.opt_state["emb_small"]))
        say("hybrid", f"mesh {runner.mesh.shape} over NCCL; plan: big store [{plan.r_big_pad}, "
                      f"{plan.dim}] ({plan.n_big_slots} tables), small store "
                      f"[{plan.r_small_pad}, {plan.dim}] ({plan.t_pad - plan.n_big_slots} "
                      f"tables): {store_bytes} B of f32 stores and {acc_bytes} B of row "
                      f"momenta on the card; memory_allocated rose {grown} B building the "
                      f"rank's params, momenta and steps")
        big_before = hp["emb"].clone()
        train = drawn_batches(cfg, HYBRID_STEPS, seed=42)
        test = drawn_batches(cfg, HYBRID_STEPS, seed=43)
        trainer = Trainer(cfg, opt, TrainerConfig(print_freq=1, seed=HYBRID_SEED),
                          runner=runner)
        losses = []
        step = trainer.train_step

        def recording(*a):
            out = step(*a)
            losses.append(out[2])
            return out

        trainer.train_step = recording
        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            metrics = trainer.fit(train, lambda: test)
        launches = {name: c.launches for name, c in counters.items()}
        want = only(fused_interaction=2 * HYBRID_STEPS, sparse_rows_overwrite=HYBRID_STEPS,
                    rwsadagrad_dense_finish=HYBRID_STEPS)
        if launches != want:
            fail(f"phase 10 Trainer.fit on the hybrid runner launched {launches}, want {want}")
        got_losses = torch.cat([x.reshape(-1) for x in losses])
        # the single-device step from the same params and batches
        state = fill_state(init_opt_state(opt, single, model_groups(cfg)))
        ref = make_train_step(cfg, opt)
        want_losses = torch.stack([ref(single, state, b, i)[2] for i, b in enumerate(train)])
        gathered = runner.single_device_params(trainer.params)
        how = same_or_close("phase 10 hybrid vs single-device", [got_losses] + gathered["emb"],
                            [want_losses] + single["emb"], HYBRID_TOL)
        changed = (bits(trainer.params["emb"]) != bits(big_before)).any(dim=1)
        live = looked_up_big_rows(runner, train)
        if (changed & ~live).any() or not torch.isfinite(got_losses).all():
            fail(f"phase 10: {int((changed & ~live).sum())} big-store rows changed that no "
                 f"live lookup touched; losses {got_losses.tolist()}")
        shown = {k: round(v, 6) for k, v in metrics.items() if isinstance(v, float)}
        say("hybrid", f"Trainer.fit on HybridRunner (mesh 1 x 1, NCCL; every accumulator "
                      f"starting at {ACC0}), {HYBRID_STEPS} captured "
                      f"steps + {HYBRID_STEPS} eval batches: losses {got_losses.tolist()}, eval "
                      f"{shown}; against make_train_step from the same params and batches: "
                      f"losses and both stores {how}; {int(changed.sum())} big-store rows "
                      f"changed, none that no live lookup touched ({int(live.sum())} were "
                      f"looked up); launches {launches}")
        del trainer, runner, hp, gathered, big_before
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_capture_parity(cfg, opt, plan, init_dlrm_on_device(cfg, seed=HYBRID_SEED))
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    eager_step = hybrid_throughput(cfg, opt, plan, single, state)
    hybrid_overlap(eager_step)
    del eager_step, single, state
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    say("hybrid", f"phase 10 (a) in {time.perf_counter() - t0:.1f} s")
    return [float(x) for x in want_losses.tolist()]


def hybrid_two_ranks(a_losses):
    """Phase 10 (b): two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), eager, mesh 1 x 2 with the greedy sharder on phase
    (a)'s model and batches: this script run as each rank
    (``--hybrid-rank SPEC``)."""
    from dlrm_yx_tpu_torch.parallel.multihost import spawn_local

    t0 = time.perf_counter()
    os.makedirs(DATA_DIR, exist_ok=True)
    spec = os.path.join(DATA_DIR, "hybrid_ranks.json")
    with open(spec, "w") as f:
        json.dump({"losses": a_losses}, f)
    try:
        outs = spawn_local([os.path.abspath(__file__), "--hybrid-rank", spec], 2, timeout=300,
                           capture=True)
    except RuntimeError as e:
        fail(f"phase 10 (b): {str(e)[-3000:]}")
    for rank, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("[hybrid-rank]"):
                say("hybrid", f"rank {rank}: {line[len('[hybrid-rank] '):]}")
    if not all("[hybrid-rank] ok" in out for out in outs):
        fail("phase 10 (b): a rank did not finish its checks")
    say("hybrid", f"phase 10 (b) in {time.perf_counter() - t0:.1f} s")


def change_gap(got, want, before, n_tables):
    """Two runs' table changes (each ``{table: tensor}`` minus ``before``):
    the tables whose moved rows differ, the rows each moved, |got's change -
    want's| / |want's change| over all tables, and the same for want's
    change against itself shifted by one row."""
    other, moved, moved_want, sq = [], 0, 0, {"diff": 0.0, "want": 0.0, "shifted": 0.0}
    for t in range(n_tables):
        d_w = (want[t] - before[t]).double()
        d_g = (got[t] - before[t]).double()
        rows_w, rows_g = (d_w != 0).any(dim=1), (d_g != 0).any(dim=1)
        if not bool((rows_w == rows_g).all()):
            other.append(t)
        moved += int(rows_g.sum())
        moved_want += int(rows_w.sum())
        sq["diff"] += (d_g - d_w).square().sum().item()
        sq["want"] += d_w.square().sum().item()
        sq["shifted"] += (d_w.roll(1, dims=0) - d_w).square().sum().item()
    norm = sq["want"] or float("nan")
    return {"other_rows": other, "moved": moved, "moved_want": moved_want,
            "rel": (sq["diff"] / norm) ** 0.5, "shifted": (sq["shifted"] / norm) ** 0.5}


def hybrid_rank_main(spec_path):
    """One rank of phase 10 (b), on cuda:0 over gloo."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner, params_from_single_device
    from dlrm_yx_tpu_torch.parallel.multihost import init_multihost
    from dlrm_yx_tpu_torch.parallel.plan import extract_tables, make_plan
    from dlrm_yx_tpu_torch.utils.device import resolve_device

    def note(msg):
        print(f"[hybrid-rank] {msg}", flush=True)

    with open(spec_path) as f:
        spec = json.load(f)
    resolve_device("cuda:0")
    rank, world = init_multihost(device="cuda:0", backend="gloo")
    torch.use_deterministic_algorithms(True)
    rows = terabyte_rows()
    cfg, opt = hybrid_config(rows)
    plan = make_plan(cfg, world, "greedy")
    single = init_dlrm_on_device(cfg, seed=HYBRID_SEED, device="cuda:0")
    # eager: gloo's collectives cannot be captured
    runner = HybridRunner(cfg, opt, 1, world, sharder="greedy", device="cuda:0",
                          params=params_from_single_device(cfg, plan, single, rank))
    fill_state(runner.opt_state)
    m = runner.mesh.m
    # each rank's stores hold the tables the plan gives it
    tables = {}
    for g, store in zip(model_groups(cfg), single["emb"]):
        for t, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            tables[t] = store[off: off + n]
    held = []
    for pos in range(m * plan.t_pad, (m + 1) * plan.t_pad):
        t = plan.device_table_order[pos]
        if t < 0:
            continue
        section = "emb" if pos % plan.t_pad < plan.n_big_slots else "emb_small"
        off = plan.row_offsets[pos]
        if not torch.equal(runner.params[section][off: off + cfg.emb_rows[t]], tables[t]):
            raise SystemExit(f"rank {rank}: table {t} is not at row {off} of its {section}")
        held.append(t)
    note(f"mesh {runner.mesh.shape} over gloo with CUDA tensors, model index {m}: holds "
         f"tables {held} as the plan places them")
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    batches = drawn_batches(cfg, HYBRID_STEPS, seed=42)
    losses = torch.stack([runner.train_step(runner.params, runner.opt_state,
                                            runner.prepare_batch(b), i)[2]
                          for i, b in enumerate(batches)])
    launches = {name: c.launches for name, c in counters.items()}
    want = only(fused_interaction=HYBRID_STEPS, sparse_rows_overwrite=HYBRID_STEPS,
                rwsadagrad_dense_finish=HYBRID_STEPS)
    if launches != want:
        raise SystemExit(f"rank {rank}: launched {launches}, want {want}")
    big = runner.mesh.all_gather_model(runner.params["emb"].unsqueeze(0))
    small = runner.mesh.all_gather_model(runner.params["emb_small"].unsqueeze(0))
    if rank == 0:
        got_tables = extract_tables(plan, cfg, big, small)
        del big, small, runner
        two_rank_verdict(note, cfg, opt, single, tables, batches, losses, got_tables,
                         spec["losses"], len(rows))
    note(f"launches {launches} (K1, K2 and K3 once a step on this rank)")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    note("ok")

# ------------------------------------- phase 11: row and column sharding

SHARD_MODES = ("row", "col")
# (c): the column slice of the big space at M = 2 and M = 4
SLICE_MESHES = (2, 4)


def sharded_mode(mode):
    """(the mode's module, its runner class, its plan maker)."""
    from dlrm_yx_tpu_torch.parallel import col_sharded, row_sharded

    if mode == "row":
        return row_sharded, row_sharded.RowShardedRunner, row_sharded.make_row_plan
    return col_sharded, col_sharded.ColShardedRunner, col_sharded.make_col_plan


def live_rows(plan, batches, n_rows, lo=0, hi=None):
    """[n_rows] bool: the rows of a shard of the big space (its rows [lo, lo
    + hi) at row 0; by default a model-rank-0 shard of n_rows, at M = 1 the
    whole space) that the batches' live lookups read."""
    import torch

    from dlrm_yx_tpu_torch.ops.embedding import device_ints

    hi = n_rows if hi is None else hi
    big = device_ints(plan.big_ids, "cuda").long()
    offs = device_ints(plan.row_offsets, "cuda")
    rows = torch.zeros(n_rows, dtype=torch.bool, device="cuda")
    for b in batches:
        ids = (b.indices.index_select(0, big) + offs[:, None, None]).long() - lo
        rows[ids[(b.weights.index_select(0, big) != 0) & (ids >= 0) & (ids < hi)]] = True
    return rows


def sharded_fit(mode, cfg, opt):
    """Phase 11 (a), one mode: Trainer.fit on the mode's runner at world size
    1 (its shards laid out from the single-device stores drawn on the
    card), the launch counts set to 0 just before and read just after, held
    to make_train_step from the same params, optimizer state and batches;
    no big-store row that no live lookup touched changed. Returns the
    single-device run's losses."""
    import contextlib
    import io

    import torch

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_train_step
    from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig

    module, runner_cls, make_plan = sharded_mode(mode)
    single = init_dlrm_on_device(cfg, seed=HYBRID_SEED)
    plan = make_plan(cfg, 1)
    params = module.params_from_single_device(cfg, plan, single)
    runner = runner_cls(cfg, opt, 1, 1, params=params)
    fill_state(runner.opt_state)
    big_before = params["emb"].clone()
    train = drawn_batches(cfg, HYBRID_STEPS, seed=42)
    test = drawn_batches(cfg, HYBRID_STEPS, seed=43)
    trainer = Trainer(cfg, opt, TrainerConfig(print_freq=1, seed=HYBRID_SEED), runner=runner)
    losses = []
    step = trainer.train_step

    def recording(*a):
        out = step(*a)
        losses.append(out[2])
        return out

    trainer.train_step = recording
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        metrics = trainer.fit(train, lambda: test)
    launches = {name: c.launches for name, c in counters.items()}
    want = only(fused_interaction=2 * HYBRID_STEPS, sparse_rows_overwrite=HYBRID_STEPS,
                rwsadagrad_dense_finish=HYBRID_STEPS)
    if launches != want:
        fail(f"phase 11 Trainer.fit on the {mode} runner launched {launches}, want {want}")
    got_losses = torch.cat([x.reshape(-1) for x in losses])
    state = fill_state(init_opt_state(opt, single, model_groups(cfg)))
    ref = make_train_step(cfg, opt)
    want_losses = torch.stack([ref(single, state, b, i)[2] for i, b in enumerate(train)])
    gathered = runner.single_device_params(trainer.params)
    how = same_or_close(f"phase 11 {mode} vs single-device", [got_losses] + gathered["emb"],
                        [want_losses] + single["emb"], HYBRID_TOL)
    store = trainer.params["emb"]
    changed = (bits(store) != bits(big_before)).any(dim=1)
    live = live_rows(plan, train, store.shape[0])
    if (changed & ~live).any() or not torch.isfinite(got_losses).all():
        fail(f"phase 11 {mode}: {int((changed & ~live).sum())} big-store rows changed that no "
             f"live lookup touched; losses {got_losses.tolist()}")
    shown = {k: round(v, 6) for k, v in metrics.items() if isinstance(v, float)}
    say("sharded", f"{mode}: plan {type(plan).__name__} (n_model 1, big store "
                   f"{list(store.shape)} f32 of {len(plan.big_ids)} tables, small store "
                   f"{list(trainer.params['emb_small'].shape)} of "
                   f"{plan.small_group.num_tables} tables, pack {plan.pack}, dups_in_big "
                   f"{plan.dups_in_big}); Trainer.fit (NCCL, mesh 1 x 1, every accumulator "
                   f"starting at {ACC0}), {HYBRID_STEPS} captured steps + {HYBRID_STEPS} eval "
                   f"batches: losses {got_losses.tolist()}, eval {shown}; against "
                   f"make_train_step from the same params and batches: losses and both stores "
                   f"{how}; {int(changed.sum())} big-store rows changed, none that no live "
                   f"lookup touched ({int(live.sum())} were looked up); launches {launches}")
    return [float(x) for x in want_losses.tolist()]


def sharded_capture_parity(mode, cfg, opt):
    """Phase 11 (a): the mode's captured N=4 step (three dispatches) against
    its eager step from a clone, bit for bit: losses and every tensor."""
    import torch

    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device

    module, runner_cls, make_plan = sharded_mode(mode)
    n = 4
    runner = runner_cls(cfg, opt, 1, 1, params=module.params_from_single_device(
        cfg, make_plan(cfg, 1), init_dlrm_on_device(cfg, seed=HYBRID_SEED)))
    eager_p, eager_s = clone_tree(runner.params), clone_tree(runner.opt_state)
    eager = runner.eager_step()
    captured = runner.make_multi_step(n)
    batches = drawn_batches(cfg, 3 * n, seed=44)
    want, eager_launches = counted(lambda: torch.stack(
        [eager(eager_p, eager_s, runner.prepare_batch(b), i)[2] for i, b in enumerate(batches)]))
    got, replay_launches = counted(lambda: torch.cat(
        [captured(runner.params, runner.opt_state,
                  runner.prepare_batch(stack_batches(batches[j * n:(j + 1) * n])), j * n)[2]
         for j in range(3)]))
    torch.cuda.synchronize()
    replays = captured.graph_step.replays()
    pairs = [("losses", want, got)] + [
        (f"tensor {i}", a, b) for i, (a, b) in enumerate(
            zip(leaves((eager_p, eager_s)), leaves((runner.params, runner.opt_state))))]
    differ = [name for name, a, b in pairs if not torch.equal(bits(a), bits(b))]
    if differ or replay_launches != eager_launches or replays < 2:
        fail(f"{mode} capture parity: {differ[:5]} of {len(pairs)} tensors differ, launches "
             f"{replay_launches} against the eager {eager_launches}, {replays} replays")
    say("sharded", f"{mode}: captured N={n} step (NCCL, world size 1): 3 dispatches "
                   f"({replays} replays) equal to the eager step bit for bit (losses and all "
                   f"{len(pairs)} tensors); launches "
                   f"{ {k: v for k, v in replay_launches.items() if v} }, as eager")


def sharded_throughput(cfg, opt, smi):
    """Phase 11 (a): the captured N=16 row, column and single-device steps,
    CUDA-event timed in turns."""
    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_multistep_train_step

    single = init_dlrm_on_device(cfg, seed=HYBRID_SEED)
    state = fill_state(init_opt_state(opt, single, model_groups(cfg)))
    stacked = stack_batches([drawn_batches(cfg, 1, seed=45)[0]] * N_DISPATCH)
    fns = {"single-device captured": train_step_fn(
        make_multistep_train_step(cfg, opt, N_DISPATCH), single, state, stacked)}
    for mode in SHARD_MODES:
        module, runner_cls, make_plan = sharded_mode(mode)
        runner = runner_cls(cfg, opt, 1, 1, params=module.params_from_single_device(
            cfg, make_plan(cfg, 1), single))
        fill_state(runner.opt_state)
        fns[f"{mode} captured"] = train_step_fn(runner.make_multi_step(N_DISPATCH),
                                                runner.params, runner.opt_state,
                                                runner.prepare_batch(stacked))
    times = time_in_turns(fns, check_loss)
    base = statistics.mean(times["single-device captured"])
    for name, ts in times.items():
        ms = statistics.mean(ts) / N_DISPATCH
        say("throughput", f"phase 11, {name} N={N_DISPATCH} (Terabyte-MLPerf <=1M rows, "
                          f"B={BATCH}, bf16, rwsadagrad, pallas; {smi}): {ms:.4f} ms/step "
                          f"({BATCH / ms * 1e3:.0f} examples/s; "
                          f"{statistics.mean(ts) / base:.3f}x the single-device step; ms a "
                          f"call {ts})")


def sharded_world_of_one(rows, smi):
    """Phase 11 (a): row and column sharding at world size 1 over NCCL, at
    full width; returns mode -> the single-device run's losses."""
    import gc

    import torch
    import torch.distributed as dist

    from dlrm_yx_tpu_torch.parallel.multihost import free_port, init_multihost

    t0 = time.perf_counter()
    init_multihost(coordinator=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                   device="cuda")
    if dist.get_backend() != "nccl":
        fail(f"phase 11 (a) wants NCCL, the world runs {dist.get_backend()}")
    cfg, opt = hybrid_config(rows)
    losses = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in SHARD_MODES:
            losses[mode] = sharded_fit(mode, cfg, opt)
            gc.collect()
            torch.cuda.empty_cache()
            sharded_capture_parity(mode, cfg, opt)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    sharded_throughput(cfg, opt, smi)
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    say("sharded", f"phase 11 (a) in {time.perf_counter() - t0:.1f} s")
    return losses


def sharded_two_ranks(a_losses):
    """Phase 11 (b): for each mode, two ranks on the one card over gloo,
    eager, mesh 1 x 2, on (a)'s model and batches: this script run as each
    rank (``--sharded-rank SPEC``)."""
    from dlrm_yx_tpu_torch.parallel.multihost import spawn_local

    t0 = time.perf_counter()
    os.makedirs(DATA_DIR, exist_ok=True)
    for mode in SHARD_MODES:
        spec = os.path.join(DATA_DIR, f"sharded_ranks_{mode}.json")
        with open(spec, "w") as f:
            json.dump({"mode": mode, "losses": a_losses[mode]}, f)
        try:
            outs = spawn_local([os.path.abspath(__file__), "--sharded-rank", spec], 2,
                               timeout=300, capture=True)
        except RuntimeError as e:
            fail(f"phase 11 (b) {mode}: {str(e)[-3000:]}")
        for rank, out in enumerate(outs):
            for line in out.splitlines():
                if line.startswith("[sharded-rank]"):
                    say("sharded", f"{mode} rank {rank}: {line[len('[sharded-rank] '):]}")
        if not all("[sharded-rank] ok" in out for out in outs):
            fail(f"phase 11 (b) {mode}: a rank did not finish its checks")
    say("sharded", f"phase 11 (b) in {time.perf_counter() - t0:.1f} s")


def sharded_rank_main(spec_path):
    """One rank of phase 11 (b), on cuda:0 over gloo."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.parallel.multihost import init_multihost
    from dlrm_yx_tpu_torch.utils.device import resolve_device

    def note(msg):
        print(f"[sharded-rank] {msg}", flush=True)

    with open(spec_path) as f:
        spec = json.load(f)
    mode = spec["mode"]
    resolve_device("cuda:0")
    rank, world = init_multihost(device="cuda:0", backend="gloo")
    torch.use_deterministic_algorithms(True)
    rows = terabyte_rows()
    cfg, opt = hybrid_config(rows)
    module, runner_cls, make_plan = sharded_mode(mode)
    plan = make_plan(cfg, world)
    single = init_dlrm_on_device(cfg, seed=HYBRID_SEED, device="cuda:0")
    # eager: gloo's collectives cannot be captured
    runner = runner_cls(cfg, opt, 1, world, device="cuda:0",
                        params=module.params_from_single_device(cfg, plan, single, rank))
    fill_state(runner.opt_state)
    tables = {t: store[off: off + n] for g, store in zip(model_groups(cfg), single["emb"])
              for t, n, off in zip(g.table_ids, g.rows, g.row_offsets)}
    # the shards, gathered over the model group, give back every table
    laid = runner.tables(runner.params)
    wrong = [t for t, w in enumerate(laid) if not torch.equal(w, tables[t])]
    del laid
    if wrong:
        raise SystemExit(f"rank {rank}: tables {wrong} are not where the plan lays them")
    note(f"mesh {runner.mesh.shape} over gloo with CUDA tensors, model index "
         f"{runner.mesh.m}: big store {list(runner.params['emb'].shape)} f32 "
         f"({runner.params['emb'].numel() * 4} B), small store "
         f"{list(runner.params['emb_small'].shape)}; the {len(rows)} tables gathered from the "
         f"shards equal the single-device tables bit for bit")
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    batches = drawn_batches(cfg, HYBRID_STEPS, seed=42)
    losses = torch.stack([runner.train_step(runner.params, runner.opt_state,
                                            runner.prepare_batch(b), i)[2]
                          for i, b in enumerate(batches)])
    launches = {name: c.launches for name, c in counters.items()}
    want = only(fused_interaction=HYBRID_STEPS, sparse_rows_overwrite=HYBRID_STEPS,
                rwsadagrad_dense_finish=HYBRID_STEPS)
    if launches != want:
        raise SystemExit(f"rank {rank}: launched {launches}, want {want}")
    got = runner.tables(runner.params)
    if rank == 0:
        del runner
        two_rank_verdict(note, cfg, opt, single, tables, batches, losses, dict(enumerate(got)),
                         spec["losses"], len(rows))
    del got
    note(f"launches {launches} (K1, K2 and K3 once a step on this rank)")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    note("ok")


def rows_add_case(what, store, ids, active, gen):
    """K4 on ``store`` with the items (ids, active): the kernel against its
    plain version run on the CPU over the whole store, bit for bit; the
    wrapper, the plain version on the card and index_add_ timed; returns
    the numbers."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add, sparse_rows_add_reference

    r, w = store.shape
    k = ids.numel()
    upd = torch.randn(k, w, device="cuda", generator=gen) * 1e-2
    got = sparse_rows_add(store.clone(), ids, upd, active).cpu()
    want = sparse_rows_add_reference(store.cpu(), ids.cpu(), upd.cpu(), active.cpu())
    equal, err = same_bits(got, want)
    del got, want
    if not equal:
        fail(f"sparse_rows_add {what}: not bit-equal to the plain version on the CPU "
             f"(max abs err {err})")
    ms = device_time_ms(lambda: sparse_rows_add(store, ids, upd, active),
                        reps=TRAFFIC_REPS, samples=TRAFFIC_REPS)
    sparse_rows_add_reference(store, ids, upd, active)  # warm-up
    plain_ms = events_ms(lambda: sparse_rows_add_reference(store, ids, upd, active), 1)[0]
    ids64 = ids.long()
    library_ms = device_time_ms(lambda: store.index_add_(0, ids64, upd * active[:, None]),
                                reps=TRAFFIC_REPS, samples=TRAFFIC_REPS)
    n_rows = torch.unique(ids64[active > 0]).numel()
    nbytes = 8 * k + 4 * w * k + 2 * 4 * w * n_rows
    bound, by = bound_ms(nbytes, w * k)
    say("kernel", f"sparse_rows_add {what} [{r}, {w}] f32, K={k} on {n_rows} distinct rows: "
                  f"bit-equal to the plain version on the CPU; wrapper {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms (one call, host sync included), index_add_ "
                  f"{library_ms:.5f} ms, bound {bound:.5f} ms ({by}, {nbytes} B)")
    return {"shape": [r, w], "k": k, "max_abs_err": err, "ms": ms, "warm_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def check_slice_kernels(rows):
    """Phase 11 (c): K2 and K4 on the column slice of the big space at its
    own widths (M = 2: [total_rows, 64], M = 4: [total_rows, 32]) with one
    batch's ids, as drawn and with a hot row on half of K, bit for bit
    against their plain versions on the CPU, timed."""
    import torch

    from dlrm_yx_tpu_torch.parallel.col_sharded import make_col_plan

    t0 = time.perf_counter()
    cfg, _ = hybrid_config(rows)
    gen = torch.Generator(device="cuda").manual_seed(47)
    batch = drawn_batches(cfg, 1, seed=48)[0]
    for n_model in SLICE_MESHES:
        plan = make_col_plan(cfg, n_model)
        store = torch.rand(plan.total_rows, plan.d_local, device="cuda", generator=gen) - 0.5
        big = torch.tensor(plan.big_ids, device="cuda")
        offs = torch.tensor(plan.row_offsets, device="cuda", dtype=torch.int32)
        drawn = (batch.indices.index_select(0, big) + offs[:, None, None]).reshape(-1).int()
        for case in ("one batch", "a hot row on half of K"):
            ids = drawn.clone()
            if case != "one batch":
                ids[::2] = ids[0]
            active = torch.ones(ids.numel(), dtype=torch.int32, device="cuda")
            what = f"column slice M={n_model} (pack {plan.pack}), {case}"
            overwrite_case(what, store, ids, active, gen, 0.0)
            rows_add_case(what, store, ids, active, gen)
        del store
        torch.cuda.empty_cache()
    say("kernel", f"phase 11 (c) in {time.perf_counter() - t0:.1f} s")


def two_rank_verdict(note, cfg, opt, single, tables, batches, losses, got_tables, a_losses,
                     n_tables):
    """Rank 0 of a two-rank run (phases 10 (b) and 11 (b)): the losses
    against (a)'s, and each table's change over the run (``got_tables``,
    gathered to rank 0, minus the table before) against the single-device
    run's from ``single`` (the params before the run; ``tables`` its
    tables), which it runs here again; the metric's resolution from the
    same run on the examples in another order. Raises SystemExit beyond the
    limits."""
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    before = {t: v.clone() for t, v in tables.items()}

    def single_device_run(params, batches):
        """make_train_step's losses over the batches and its tables after them."""
        state = fill_state(init_opt_state(opt, params, model_groups(cfg)))
        ref = make_train_step(cfg, opt)
        out = torch.stack([ref(params, state, b, i)[2] for i, b in enumerate(batches)])
        return out, {t: store[off: off + n]
                     for g, store in zip(model_groups(cfg), params["emb"])
                     for t, n, off in zip(g.table_ids, g.rows, g.row_offsets)}

    # phase (a)'s single-device run, again: its losses were (a)'s, bit for bit
    ref_losses, tables = single_device_run(single, batches)
    # the metric's resolution: the same run on the examples in another order
    perm = torch.randperm(BATCH, generator=torch.Generator().manual_seed(46)).cuda()
    shuffled = [type(b)(b.dense[perm], b.indices[:, perm], b.weights[:, perm],
                        b.labels[perm]) for b in batches]
    perm_losses, perm_tables = single_device_run(
        init_dlrm_on_device(cfg, seed=HYBRID_SEED, device="cuda:0"), shuffled)
    a_losses_t = torch.tensor(a_losses, device="cuda:0")
    loss_ok = torch.allclose(losses, a_losses_t, **TWO_RANK_LOSS)
    loss_diff = (losses - a_losses_t).abs().max().item()
    gap, floor = (change_gap(got, tables, before, n_tables)
                  for got in (got_tables, perm_tables))
    ok = (loss_ok and not gap["other_rows"] and gap["moved"] == gap["moved_want"] > 0
          and gap["rel"] <= TWO_RANK_CHANGE)
    rows_read = ("the same rows" if not gap["other_rows"]
                 else f"other rows in tables {gap['other_rows']}")
    note(f"losses {losses.tolist()} against (a)'s {a_losses} (the single-device "
         f"run again here: {ref_losses.tolist()}): max |diff| {loss_diff:.3e} "
         f"{'within' if loss_ok else 'BEYOND'} rtol {TWO_RANK_LOSS['rtol']}; the "
         f"{n_tables} tables gathered to rank 0, each minus the table before the run: "
         f"{gap['moved']} rows moved here, {gap['moved_want']} "
         f"in (a), {rows_read}; |change - (a)'s change| / |(a)'s change| over all "
         f"tables {gap['rel']:.3e} {'within' if gap['rel'] <= TWO_RANK_CHANGE else 'BEYOND'}"
         f" {TWO_RANK_CHANGE:.3e}. The metric's resolution, (a)'s run on the examples "
         f"in another order: losses max |diff| "
         f"{(perm_losses - a_losses_t).abs().max().item():.3e}, "
         f"{len(floor['other_rows'])} tables moved other rows, change {floor['rel']:.3e}. "
         f"Controls on (a)'s change: no sparse update reads 1, the rows shifted by one "
         f"read {gap['shifted']:.3f}")
    if not ok:
        raise SystemExit("rank 0: the two-rank run disagrees with (a) beyond the limits")


# ------------------------------- phase 12: the mesh paths on several cards

MESH_N = 4            # (a): steps a dispatch of the captured runs, three dispatches
MESH_STEPS = 3 * MESH_N
MESH_TERABYTE_CAP = 40_000_000  # MLPerf's cap: 187,767,399 rows, 96.1 GB of f32 tables
MESH_BATCHES = (BATCH, 4 * BATCH)  # (b)'s timed batches: 2048, and 2048 a card of four
MESH_WORLD_TIMEOUT_S = 1100  # the whole world of ranks
DRAW_BLOCK_ROWS = 1 << 20    # rows of one seeded draw of a 40M shard (512 MB at dim 128)


def mesh_world(count):
    """The ranks of phase 12 on ``count`` cards: 4, else 2, else none."""
    return 4 if count >= 4 else 2 if count >= 2 else 0


def mesh_parity_cases(world):
    """(a)'s meshes: (mode, data, model)."""
    return ([("hybrid", 1, world)] + [("hybrid", 2, 2)] * (world == 4)
            + [("row", 1, world), ("col", 1, world)])


def mesh_mode(mode):
    """(the mode's module, its runner class, its plan maker (config, n_model))."""
    from dlrm_yx_tpu_torch.parallel import hybrid
    from dlrm_yx_tpu_torch.parallel.plan import make_plan

    if mode == "hybrid":
        return hybrid, hybrid.HybridRunner, lambda cfg, n: make_plan(cfg, n, "greedy")
    return sharded_mode(mode)


def momentum_k4(runner, mode):
    """K4's launches a step on ``runner``'s path at L=1: one where RWSAdagrad's
    row momentum of the big store takes the row-RMW kernel
    (``optimizer._acc_update_1d``'s gate: ACC_KERNEL_MIN_BYTES or more, as
    the JAX package gates it), else none; the column path adds its row norms
    by a scatter."""
    from dlrm_yx_tpu_torch.optim.optimizer import ACC_KERNEL_MIN_BYTES

    acc = runner.opt_state["emb"]
    sentinel = runner.plan.r_big_pad if mode == "hybrid" else getattr(
        runner.plan, "rows_local", 0)
    return int(mode != "col" and acc.shape[0] % 128 == 0 and acc.shape[0] >= sentinel + 129
               and acc.shape[0] * 4 >= ACC_KERNEL_MIN_BYTES)


def mesh_cli_argvs(rows):
    """(c)'s command lines: phase b's, and the same with f32 compute. The bf16
    towers round each rank's dense grads to bf16 before the sum (one card
    rounds the whole batch's once), and RWSAdagrad's first step from zero
    accumulators moves every element by lr * sign(g), so a gradient element
    at rounding-noise size moves by the full lr either way: in a run
    on the CPU (26 tables capped at 100,000 rows, four gloo ranks) the
    losses read up to 4.6e-4 relative apart at bf16 and 1.2e-7 at f32. The
    f32 run is the one held at rtol 1e-4."""
    argv = terabyte_argv(rows) + [
        "--num-batches", str(N_TRAIN_BATCHES), "--optimizer", "rwsadagrad",
        "--learning-rate", str(LR), "--sparse-update-impl", "pallas", "--print-freq", "1"]
    f32 = list(argv)
    f32[f32.index("--compute-dtype") + 1] = "float32"
    return {"bf16": argv, "f32": f32}


def mesh_reference(rows):
    """Phase 12 (a), first: the single-device steps on card 0, from phase
    10's device draw with every accumulator at ACC0, over (a)'s batches.
    Writes their losses and, for each table, the rows that moved and their
    change; returns the file's path."""
    import gc

    import torch

    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import init_opt_state
    from dlrm_yx_tpu_torch.train.train_step import make_train_step

    cfg, opt = hybrid_config(rows)
    torch.use_deterministic_algorithms(True)
    try:
        single = init_dlrm_on_device(cfg, seed=HYBRID_SEED)
        before = [s.clone() for s in single["emb"]]
        state = fill_state(init_opt_state(opt, single, model_groups(cfg)))
        ref = make_train_step(cfg, opt)
        losses = torch.stack([ref(single, state, b, i)[2] for i, b in
                              enumerate(drawn_batches(cfg, MESH_STEPS, seed=44))])
    finally:
        torch.use_deterministic_algorithms(False)
    moved = {}
    for g, b0, b1 in zip(model_groups(cfg), before, single["emb"]):
        for t, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            d = b1[off: off + n] - b0[off: off + n]
            r = (d != 0).any(dim=1).nonzero()[:, 0]
            moved[t] = (r.cpu(), d[r].cpu())
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, "mesh_reference.pt")
    torch.save({"losses": losses.cpu(), "moved": moved}, path)
    say("mesh", f"(a) the single-device steps on card 0 (make_train_step, {MESH_STEPS} steps, "
                f"every accumulator at {ACC0}): losses {losses.tolist()}; "
                f"{sum(r.numel() for r, _ in moved.values())} table rows moved")
    del single, before, state, ref
    gc.collect()
    torch.cuda.empty_cache()
    return path


def mesh_cli_reference(rows):
    """Phase 12 (c), first: the single-device CLI runs of (c)'s command lines
    on card 0; returns name -> their printed losses."""
    want = only(fused_interaction=2 * N_TRAIN_BATCHES, sparse_rows_overwrite=N_TRAIN_BATCHES,
                rwsadagrad_dense_finish=N_TRAIN_BATCHES)
    losses = {}
    with SharedInit():
        for name, argv in mesh_cli_argvs(rows).items():
            out = {}
            cli_training_run("mesh", f"(c) single-device cli, phase b's flags, {name} compute",
                             argv, N_TRAIN_BATCHES, want, None, out=out)
            losses[name] = out["losses"]
    return losses


def mesh_paths(count):
    """Phase 12: the mesh paths as one world of NCCL ranks, one a card (4, or
    2 on 2-3 cards); on one card a line that says it did not run. Returns
    each rank's results, or None."""
    import gc

    import torch

    from dlrm_yx_tpu_torch.parallel.multihost import spawn_local

    world = mesh_world(count)
    if not world:
        say("mesh", f"phase 12: needs 2 or more cards, found {count}: not run")
        return None
    t0 = time.perf_counter()
    if world < 4:
        say("mesh", f"phase 12: {count} cards, so a world of 2 (hybrid, row and column 1 x 2; "
                    "hybrid 2 x 2 needs 4)")
    rows = terabyte_rows()
    spec = {"world": world, "cases": mesh_parity_cases(world),
            "reference": mesh_reference(rows), "cli": mesh_cli_reference(rows)}
    gc.collect()
    torch.cuda.empty_cache()
    path = os.path.join(DATA_DIR, "mesh_ranks.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    # NCCL_DEBUG=WARN: a failed communicator says why in the ranks' output
    env = dict(os.environ, NCCL_DEBUG=os.environ.get("NCCL_DEBUG", "WARN"))
    try:
        outs = spawn_local([os.path.abspath(__file__), "--mesh-rank", path], world,
                           timeout=MESH_WORLD_TIMEOUT_S, env=env, capture=True)
    except RuntimeError as e:
        # which rank failed first, then the end of each rank's output
        head, *parts = str(e).split("\n--- rank ")
        fail(f"phase 12: {head}" + "".join(f"\n--- rank {p[:12]}...{p[-2500:]}" for p in parts))
    results = []
    for rank, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("[mesh-rank]"):
                say("mesh", f"rank {rank}: {line[len('[mesh-rank] '):]}")
            elif line.startswith("[kernel]"):
                say("kernel", f"rank {rank}: {line[len('[kernel] '):]}")
            elif line.startswith("[mesh-result]"):
                results.append(json.loads(line[len("[mesh-result] "):]))
    if len(results) != world or not all("[mesh-rank] ok" in out for out in outs):
        fail("phase 12: a rank did not finish its checks")
    say("mesh", f"phase 12 in {time.perf_counter() - t0:.1f} s")
    return results


# --- the ranks


def mesh_note(msg):
    print(f"[mesh-rank] {msg}", flush=True)


def mesh_tables(mode, runner, params):
    """Every table (canonical order) from the model group's shards, on
    every rank of the group (a collective; the 1M-cap model only)."""
    if mode != "hybrid":
        return dict(enumerate(runner.tables(params)))
    from dlrm_yx_tpu_torch.models.dlrm import model_groups

    gathered = runner.single_device_params(params)["emb"]
    return {t: store[off: off + n] for g, store in zip(model_groups(runner.config), gathered)
            for t, n, off in zip(g.table_ids, g.rows, g.row_offsets)}


def sparse_change_gap(got, before, moved):
    """The tables' change over a run (``got`` minus ``before``) against the
    single-device run's (``moved``: per table the rows that moved and their
    change): the tables whose moved rows differ, the rows each moved, and
    |change - the single-device change| / |the single-device change|."""
    other, n_got, n_want, diff, norm = [], 0, 0, 0.0, 0.0
    for t, (rows_w, d_w) in moved.items():
        d = got[t] - before[t]
        rows_g = (d != 0).any(dim=1).nonzero()[:, 0]
        rows_w, d_w = rows_w.to(d.device), d_w.to(d.device).double()
        if not (rows_g.numel() == rows_w.numel() and bool((rows_g == rows_w).all())):
            other.append(t)
        n_got += rows_g.numel()
        n_want += rows_w.numel()
        d_g = d.double()
        diff += ((d_g[rows_w] - d_w).square().sum() + d_g.square().sum()
                 - d_g[rows_w].square().sum()).item()
        norm += d_w.square().sum().item()
    return {"other_rows": other, "moved": n_got, "moved_want": n_want,
            "rel": (diff / (norm or float("nan"))) ** 0.5}


def mesh_parity(spec, rank):
    """Phase 12 (a) on a rank: each mesh of ``spec["cases"]`` on phase 10's
    model (1M cap) from the single-device stores drawn on this card, every
    accumulator at ACC0, run eagerly and then captured (N=MESH_N, three
    dispatches) on (a)'s batches: captured equal to eager bit for bit, the
    launches of each, and (rank 0) the eager run held to the single-device
    run of card 0 by its losses and each table's change. Returns the
    launches per case."""
    import gc

    import torch

    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm_on_device, model_groups

    ref = torch.load(spec["reference"])
    cfg, opt = hybrid_config(terabyte_rows())
    single = init_dlrm_on_device(cfg, seed=HYBRID_SEED)
    before = {t: store[off: off + n] for g, store in zip(model_groups(cfg), single["emb"])
              for t, n, off in zip(g.table_ids, g.rows, g.row_offsets)}
    batches = drawn_batches(cfg, MESH_STEPS, seed=44)
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode, data, model in spec["cases"]:
            name = f"{mode} {data} x {model}"
            module, runner_cls, plan_of = mesh_mode(mode)
            plan = plan_of(cfg, model)

            def start():
                runner = runner_cls(cfg, opt, data, model, params=module.params_from_single_device(
                    cfg, plan, single, rank % model))
                fill_state(runner.opt_state)
                return runner

            def eager_run(runner):
                p, s = clone_tree(runner.params), clone_tree(runner.opt_state)
                step = runner.eager_step()
                losses, launches = counted(lambda: torch.stack(
                    [step(p, s, runner.prepare_batch(b), i)[2] for i, b in enumerate(batches)]))
                return p, s, losses, launches

            runner = start()
            eager_p, eager_s, want, eager_launches = eager_run(runner)
            captured = runner.make_multi_step(MESH_N)
            got, replay_launches = counted(lambda: torch.cat(
                [captured(runner.params, runner.opt_state, runner.prepare_batch(
                    stack_batches(batches[j * MESH_N:(j + 1) * MESH_N])), j * MESH_N)[2]
                 for j in range(MESH_STEPS // MESH_N)]))
            torch.cuda.synchronize()
            replays = captured.graph_step.replays()
            pairs = [("losses", want, got)] + [
                (f"tensor {i}", a, b) for i, (a, b) in enumerate(
                    zip(leaves((eager_p, eager_s)), leaves((runner.params, runner.opt_state))))]
            differ = [n for n, a, b in pairs if not torch.equal(bits(a), bits(b))]
            if differ:
                # is the eager run itself repeatable on this rank?
                again = eager_run(start())
                same = [n for n, a, b in zip(
                    [p[0] for p in pairs], [want] + list(leaves((eager_p, eager_s))),
                    [again[2]] + list(leaves(again[:2]))) if not torch.equal(bits(a), bits(b))]
                raise SystemExit(f"rank {rank}, {name}: captured against eager: {differ[:6]} of "
                                 f"{len(pairs)} tensors differ; eager against itself: "
                                 f"{same[:6] or 'none differ'}")
            launched = only(fused_interaction=MESH_STEPS, sparse_rows_overwrite=MESH_STEPS,
                            rwsadagrad_dense_finish=MESH_STEPS,
                            sparse_rows_add=MESH_STEPS * momentum_k4(runner, mode))
            if eager_launches != launched or replay_launches != launched or replays < 2:
                raise SystemExit(f"rank {rank}, {name}: launched {eager_launches} eager and "
                                 f"{replay_launches} captured ({replays} replays), want "
                                 f"{launched} each")
            width = runner.params["emb"].shape[1]
            mesh_note(f"(a) {name} (mesh {runner.mesh.shape}, d {runner.mesh.d}, m "
                      f"{runner.mesh.m}, big store {list(runner.params['emb'].shape)} f32): "
                      f"{MESH_STEPS} eager steps, then {MESH_STEPS // MESH_N} captured "
                      f"dispatches of {MESH_N} ({replays} replays) equal to them bit for bit "
                      f"(losses and all {len(pairs)} tensors); K1, K2 (width {width}) and K3 "
                      f"once a step, eager and captured: "
                      f"{ {k: v for k, v in eager_launches.items() if v} }")
            out[name] = eager_launches
            del captured
            tables = mesh_tables(mode, runner, eager_p)
            if rank == 0:
                gap = sparse_change_gap(tables, before, ref["moved"])
                loss_ok = torch.allclose(want.cpu(), ref["losses"], **TWO_RANK_LOSS)
                loss_diff = (want.cpu() - ref["losses"]).abs().max().item()
                ok = (loss_ok and not gap["other_rows"] and gap["moved"] == gap["moved_want"] > 0
                      and gap["rel"] <= TWO_RANK_CHANGE)
                mesh_note(f"(a) {name} against the single-device steps of card 0: losses "
                          f"max |diff| {loss_diff:.3e} "
                          f"{'within' if loss_ok else 'BEYOND'} rtol {TWO_RANK_LOSS['rtol']}; "
                          f"{gap['moved']} table rows moved ({gap['moved_want']} on card 0), "
                          f"{'the same rows' if not gap['other_rows'] else 'other rows in tables ' + str(gap['other_rows'])}; "
                          f"|change - card 0's| / |card 0's| {gap['rel']:.3e} "
                          f"{'within' if gap['rel'] <= TWO_RANK_CHANGE else 'BEYOND'} "
                          f"{TWO_RANK_CHANGE:.0e}")
                if not ok:
                    raise SystemExit(f"rank 0, {name}: disagrees with the single-device run")
            del tables, eager_p, eager_s, runner
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    del single, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_views(mode, cfg, plan, m):
    """Where the tables' draw blocks lie in model rank ``m``'s stores: (store
    key, first store row, table, block's first row r0 and end r1, the block's
    rows [a, b) and columns [c0, c1) that the store holds there)."""
    from dlrm_yx_tpu_torch.parallel.hybrid import _slot_places

    def blocks(t):
        n = cfg.emb_rows[t]
        return [(r0, min(n, r0 + DRAW_BLOCK_ROWS)) for r0 in range(0, n, DRAW_BLOCK_ROWS)]

    views, dim = [], plan.dim
    if mode == "hybrid":
        for pid, (section, off) in _slot_places(plan, m).items():
            t = plan.pseudo_table[pid]
            key = "emb" if section == "big" else "emb_small"
            views += [(key, off + r0, t, r0, r1, 0, r1 - r0, 0, dim) for r0, r1 in blocks(t)]
        return views
    sg = plan.small_group
    for t, off in zip(sg.table_ids if sg else (), sg.row_offsets if sg else ()):
        views += [("emb_small", off + r0, t, r0, r1, 0, r1 - r0, 0, dim) for r0, r1 in blocks(t)]
    for t, off in zip(plan.big_ids, plan.row_offsets):
        for r0, r1 in blocks(t):
            g0 = off + r0
            if mode == "col":
                c0 = m * plan.d_local
                views.append(("emb", g0, t, r0, r1, 0, r1 - r0, c0, c0 + plan.d_local))
                continue
            lo = m * plan.rows_local
            a, b = max(g0, lo), min(g0 + r1 - r0, lo + plan.rows_local)
            if a < b:
                views.append(("emb", a - lo, t, r0, r1, a - g0, b - g0, 0, dim))
    return views


def draw_block(cfg, seed, t, r0, r1):
    """Rows [r0, r1) of table t as the 40M shards draw them on the card:
    init_dlrm_on_device's distribution (U(+-1/sqrt n), f32) in one pass,
    each block of DRAW_BLOCK_ROWS rows from its own torch.Generator seeded
    from (seed, t, block), so a table's values do not depend on the mesh."""
    import numpy as np
    import torch

    n, d = cfg.emb_rows[t], cfg.emb_dims[t]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(np.random.SeedSequence([seed, t, r0 // DRAW_BLOCK_ROWS]).generate_state(
        1, np.uint64)[0] >> np.uint64(1)))
    bound = float(np.float32(np.sqrt(1.0 / n)))
    return torch.empty((r1 - r0, d), device="cuda").uniform_(-bound, bound, generator=gen)


def drawn_shard_params(mode, cfg, plan, m, seed):
    """Model rank ``m``'s params of ``mode`` drawn on its card (``draw_block``;
    zero padding and sentinel rows), the towers from numpy's RandomState(seed)
    as init_dlrm_on_device draws them: no rank draws or holds another's
    shard."""
    import numpy as np
    import torch

    from dlrm_yx_tpu_torch.models.dlrm import _dense_params
    from dlrm_yx_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    if mode == "hybrid":
        shapes = {"emb": (plan.r_big_pad, plan.dim), "emb_small": (plan.r_small_pad, plan.dim)}
    else:
        sg = plan.small_group
        shapes = {"emb": (plan.store_rows, plan.dim) if mode == "row"
                  else (plan.total_rows, plan.d_local),
                  "emb_small": (sg.total_rows, sg.dim) if sg else None}
    params = {k: None if s is None else torch.zeros(s, dtype=torch.float32, device=dev)
              for k, s in shapes.items()}
    for key, s0, t, r0, r1, a, b, c0, c1 in shard_views(mode, cfg, plan, m):
        params[key][s0: s0 + b - a] = draw_block(cfg, seed, t, r0, r1)[a:b, c0:c1]
    params.update(_dense_params(np.random.RandomState(seed), cfg, dev), vw=None)
    if mode != "hybrid":
        params["vw_small"] = None
    return params


def changed_big_rows(mode, cfg, plan, m, seed, store):
    """[rows] bool: the rows of rank ``m``'s big store that differ from the
    draw (``drawn_shard_params``), block by block, with no copy of the store:
    padding and sentinel rows against zero."""
    import torch

    changed = torch.zeros(store.shape[0], dtype=torch.bool, device=store.device)
    drawn = torch.zeros_like(changed)
    for key, s0, t, r0, r1, a, b, c0, c1 in shard_views(mode, cfg, plan, m):
        if key == "emb":
            want = draw_block(cfg, seed, t, r0, r1)[a:b, c0:c1].contiguous()
            changed[s0: s0 + b - a] = (bits(store[s0: s0 + b - a]) != bits(want)).any(dim=1)
            drawn[s0: s0 + b - a] = True
    for r0 in range(0, store.shape[0], DRAW_BLOCK_ROWS):
        sl = slice(r0, r0 + DRAW_BLOCK_ROWS)
        changed[sl] |= (bits(store[sl]) != 0).any(dim=1) & ~drawn[sl]
    return changed


def mesh_live_rows(mode, plan, runner, batches):
    """[store rows] bool: the rows of this rank's big store that the batches'
    live lookups read, from the rank's own ids (no gather)."""
    if mode == "hybrid":
        return looked_up_big_rows(runner, batches)
    n = runner.params["emb"].shape[0]
    if mode == "col":
        return live_rows(plan, batches, n)
    return live_rows(plan, batches, n, runner.mesh.m * plan.rows_local, plan.rows_local)


def mesh_k2_items(mode, plan, runner, b):
    """(ids, active) that this rank's K2 call takes from batch ``b``: the
    rank's big slots (hybrid), every big id with those of other ranks at the
    sentinel (row), or every big id (column)."""
    import torch

    from dlrm_yx_tpu_torch.ops.embedding import device_ints

    if mode == "hybrid":
        nb = plan.n_big_slots
        lb = runner.prepare_batch(b)
        offs = device_ints(plan.row_offsets[runner.mesh.m * plan.t_pad:][:nb], "cuda")
        live = (lb.weights[:nb] != 0).reshape(-1)
        gid = (lb.indices[:nb] + offs[:, None, None]).reshape(-1)
        return torch.where(live, gid, 0).int(), live.int()
    big = device_ints(plan.big_ids, "cuda").long()
    gid = (b.indices.index_select(0, big)
           + device_ints(plan.row_offsets, "cuda")[:, None, None]).reshape(-1)
    if mode == "col":
        return gid.int(), (b.weights.index_select(0, big) != 0).reshape(-1).int()
    local = gid - runner.mesh.m * plan.rows_local
    owned = (local >= 0) & (local < plan.rows_local) & (
        b.weights.index_select(0, big) != 0).reshape(-1)
    return torch.where(owned, local, plan.rows_local).int(), owned.int()


def overwrite_in_place(what, store, ids, active):
    """K2 on a store too large to copy (a 40M shard): the rows its items
    name saved, the kernel against its plain version run on the CPU over
    them (bit for bit), timed warm and cold beside the plain version and
    index_add_, the rows put back. Returns the kernels line's numbers."""
    import torch

    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import (
        sparse_rows_overwrite,
        sparse_rows_overwrite_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(49)
    r, w = store.shape
    k = ids.numel()
    delta = torch.randn(k, w, device="cuda", generator=gen) * 1e-2
    new_vals = store[ids.long()] + delta
    rows, want = overwrite_plain_on_cpu(store, ids, new_vals, delta, active)
    saved = store[rows].clone()
    sparse_rows_overwrite(store, ids, new_vals, delta, active)
    torch.cuda.synchronize()
    err = (store[rows] - want).abs().max().item()
    if not torch.equal(bits(store[rows]), bits(want)):
        fail(f"sparse_rows_overwrite {what}: not bit-equal to the plain version on the CPU "
             f"(max abs err {err})")
    live = ids[active > 0].long()
    _, counts = torch.unique(live, return_counts=True)
    n_once, n_dup_rows = int((counts == 1).sum()), int((counts > 1).sum())
    n_dup_items = int(counts[counts > 1].sum())
    nbytes = 8 * k + 2 * 4 * w * n_once + 4 * w * n_dup_items + 2 * 4 * w * n_dup_rows
    bound, by = bound_ms(nbytes, w * n_dup_items)

    def call():
        sparse_rows_overwrite(store, ids, new_vals, delta, active)

    warm = device_time_ms(call)
    cold = cold_reading(f"sparse_rows_overwrite {what}", call, bound)
    plain_ms = device_time_ms(
        lambda: sparse_rows_overwrite_reference(store, ids, new_vals, delta, active))
    masked, ids64 = delta * active[:, None], ids.long()
    library_ms = device_time_ms(lambda: store.index_add_(0, ids64, masked))
    store[rows] = saved
    say("kernel", f"sparse_rows_overwrite {what} [{r}, {w}] f32, K={k} ({n_once} unique live "
                  f"rows, {n_dup_items} items on {n_dup_rows} duplicated rows): bit-equal to the "
                  f"plain version on the CPU; warm {warm:.5f} ms, cold {cold:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, index_add_ {library_ms:.5f} ms, bound {bound:.5f} ms "
                  f"({by}, {nbytes} B)")
    return {"shape": [r, w], "k": k, "max_abs_err": err, "ms": warm, "warm_ms": warm,
            "cold_ms": cold, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms}


def interaction_row(b, s, d):
    """K1 at [b, s + 1, d] bf16 against its plain version, timed warm and
    cold; returns the kernels line's numbers."""
    import torch

    from dlrm_yx_tpu_torch.ops.fused_interaction import (
        fused_interaction,
        fused_interaction_reference,
        num_pairs,
    )

    gen = torch.Generator(device="cuda").manual_seed(b + s + d)
    x = torch.randn(b, d, device="cuda", generator=gen)
    ly = torch.randn(b, s, d, device="cuda", generator=gen)
    got = fused_interaction(x, ly, False, torch.bfloat16)
    want = fused_interaction_reference(x, ly, False, torch.bfloat16)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    if got.shape != want.shape or not rel <= 1e-5 or not torch.equal(got[:, :d], x):
        fail(f"fused_interaction {b}x{s}x{d} bf16: max abs err {err}, relative {rel} > 1e-5")
    bound, by = interaction_bound_ms(b, s, d, num_pairs(s + 1, False))

    def call():
        fused_interaction(x, ly, False, torch.bfloat16)

    warm = device_time_ms(call)
    cold = cold_reading(f"fused_interaction B={b} bf16", call, bound)
    plain_ms = device_time_ms(lambda: fused_interaction_reference(x, ly, False, torch.bfloat16))
    say("kernel", f"fused_interaction B={b} S={s} D={d} bf16: max_abs_err {err:.3e} (relative "
                  f"{rel:.3e} <= 1e-05), warm {warm:.5f} ms, cold {cold:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, bound {bound:.5f} ms ({by})")
    return {"shape": [b, s + 1, d], "max_abs_err": err, "ms": warm, "warm_ms": warm,
            "cold_ms": cold, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def mesh_kernel_rows(mode, cfg, plan, runner, batch):
    """Phase 12 (b), before the fit: the kernels at this rank's shapes where
    they differ from the single card's: K2 on its store with its items of
    ``batch``, K4 on its row momentum where the step takes K4 there
    (``momentum_k4``); on the hybrid path also K1 on its tower slice and K3
    on its small store (the row and column paths' small store is the single
    card's [121,232, 128])."""
    import types

    import torch

    from dlrm_yx_tpu_torch.ops.embedding import device_ints
    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add

    world = runner.mesh.size
    ids, active = mesh_k2_items(mode, plan, runner, batch)
    rows = {"sparse_rows_overwrite": overwrite_in_place(
        f"{mode} 1 x {world}, rank {runner.mesh.rank}'s store", runner.params["emb"], ids,
        active)}
    if momentum_k4(runner, mode):
        # K4 on a copy of the row momentum viewed [len, 1], with the same items
        acc = runner.opt_state["emb"].clone().view(-1, 1)
        what = f"{mode} 1 x {world}, rank {runner.mesh.rank}'s row momentum"
        gen = torch.Generator(device="cuda").manual_seed(51)
        row = rows_add_case(what, acc, ids, active, gen)
        inc = torch.rand(ids.numel(), 1, device="cuda", generator=gen)
        row.update(cold_ms=cold_reading(f"sparse_rows_add {what}",
                                        lambda: sparse_rows_add(acc, ids, inc, active),
                                        row["bound_ms"]))
        say("kernel", f"  cold (L2 flushed before each call): {row['cold_ms']:.5f} ms")
        rows["sparse_rows_add"] = row
        del acc
    if mode == "hybrid":
        rows["fused_interaction"] = interaction_row(BATCH // world, len(cfg.emb_rows),
                                                    cfg.emb_dims[0])
        nb, m = plan.n_big_slots, runner.mesh.m
        lb = runner.prepare_batch(batch)
        offs = device_ints(plan.row_offsets[m * plan.t_pad:][nb:plan.t_pad], "cuda")
        small = (lb.indices[nb:] + offs[:, None, None])[lb.weights[nb:] != 0]
        gen = torch.Generator(device="cuda").manual_seed(50)
        group = types.SimpleNamespace(total_rows=plan.r_small_pad, dim=plan.dim)
        rows["rwsadagrad_dense_finish"] = dict(
            finish_case(f"hybrid 1 x {world}, rank {runner.mesh.rank}'s small store", group,
                        small, gen), shape=[plan.r_small_pad, plan.dim])
    return rows


def nccl_window(fn, steps, trace=None):
    """One torch.profiler window over fn() (``steps`` steps) after two
    warm-up calls: (the NCCL kernels' device µs a step by kernel (their
    ``ncclDevKernel`` names: the ranges NCCL's calls open hold the same time
    again), every kernel's and copy's device µs a step), and the window's
    Chrome trace written to ``trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return ({e.key: e.self_device_time_total / steps for e in device
             if e.key.startswith("ncclDevKernel")},
            sum(e.self_device_time_total for e in device) / steps)


def mesh_overlap(eager_step, captured_step, rank):
    """Phase 12 (b), hybrid: a profiler window over an eager step on each
    rank, as phase 10's: the all-to-all issued before the bottom MLP's first
    GEMM (``check_a2a_overlap``; the device side read) and the NCCL kernels'
    device time, which holds each rank's wait for the last to arrive; then
    one over a captured dispatch of N_DISPATCH steps, where the ranks
    launch in step and the kernels' time is the exchange's (with the
    dispatch's device-busy µs a step)."""
    from dlrm_yx_tpu_torch.parallel.overlap import check_a2a_overlap

    path = os.path.join(DATA_DIR, f"mesh_hybrid_step_rank{rank}.json")
    eager, _ = nccl_window(eager_step, 1, path)
    got = check_a2a_overlap(path)
    if not got["issued_before"]:
        raise SystemExit(f"rank {rank}: the all-to-all is not issued before the bottom MLP's "
                         f"first GEMM: {got}")
    return got, eager, nccl_window(captured_step, N_DISPATCH)


def mesh_terabyte(spec, rank):
    """Phase 12 (b) on a rank: MLPerf's 40M-row Terabyte model as hybrid,
    row and column 1 x world, each rank's shard drawn on its card; the
    kernels at the rank's shapes; Trainer.fit (captured steps, an eval) with
    the launches counted; only looked-up rows changed; the peak memory; the
    captured N=16 step timed at each of MESH_BATCHES; the hybrid step's
    NCCL time and overlap. Returns the numbers."""
    import contextlib
    import gc
    import io

    import torch

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.batch import stack_batches
    from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig

    world = spec["world"]
    cfg, opt = hybrid_config(DLRMConfig.terabyte_mlperf(max_ind_range=MESH_TERABYTE_CAP).emb_rows)
    out = {}
    for mode in ("hybrid", "row", "col"):
        name = f"{mode} 1 x {world}"
        module, runner_cls, plan_of = mesh_mode(mode)
        plan = plan_of(cfg, world)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = drawn_shard_params(mode, cfg, plan, rank, HYBRID_SEED)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        runner = runner_cls(cfg, opt, 1, world, params=params)
        store = runner.params["emb"]
        mesh_note(f"(b) {name}: {sum(cfg.emb_rows)} rows, this rank's big store "
                  f"{list(store.shape)} f32 ({store.numel() * 4} B), small store "
                  f"{list(runner.params['emb_small'].shape)}, drawn on {store.device} in "
                  f"{draw_s:.1f} s")
        train = drawn_batches(cfg, HYBRID_STEPS, seed=42)
        test = drawn_batches(cfg, HYBRID_STEPS, seed=43)
        kernels = mesh_kernel_rows(mode, cfg, plan, runner, test[0])
        trainer = Trainer(cfg, opt, TrainerConfig(print_freq=1, seed=HYBRID_SEED), runner=runner)
        losses = []
        step = trainer.train_step

        def recording(*a):
            got = step(*a)
            losses.append(got[2])
            return got

        trainer.train_step = recording
        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = trainer.fit(train, lambda: test)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        want = only(fused_interaction=2 * HYBRID_STEPS, sparse_rows_overwrite=HYBRID_STEPS,
                    rwsadagrad_dense_finish=HYBRID_STEPS,
                    sparse_rows_add=HYBRID_STEPS * momentum_k4(runner, mode))
        got_losses = torch.cat([x.reshape(-1) for x in losses])
        if launches != want or not bool(torch.isfinite(got_losses).all()):
            raise SystemExit(f"rank {rank}, (b) {name}: launched {launches}, want {want}; "
                             f"losses {got_losses.tolist()}")
        changed = changed_big_rows(mode, cfg, plan, runner.mesh.m, HYBRID_SEED, store)
        live = mesh_live_rows(mode, plan, runner, train)
        if (changed & ~live).any() or not changed.any():
            raise SystemExit(f"rank {rank}, (b) {name}: {int(changed.sum())} big-store rows "
                             f"changed, {int((changed & ~live).sum())} that no live lookup "
                             f"of this rank touched")
        peak = torch.cuda.max_memory_allocated()
        shown = {k: round(v, 6) for k, v in metrics.items() if isinstance(v, float)}
        mesh_note(f"(b) {name}: Trainer.fit, {HYBRID_STEPS} captured steps + {HYBRID_STEPS} "
                  f"eval batches in {fit_s:.1f} s: losses {got_losses.tolist()}, eval {shown}; "
                  f"{int(changed.sum())} big-store rows changed, all among the "
                  f"{int(live.sum())} that this rank's live lookups read; launches "
                  f"{ {k: v for k, v in launches.items() if v} }; max_memory_allocated "
                  f"{peak} B")
        del trainer
        fns = {}
        for bsz in MESH_BATCHES:
            stacked = stack_batches([drawn_batches(cfg, 1, seed=45, batch=bsz)[0]] * N_DISPATCH)
            fns[bsz] = train_step_fn(runner.make_multi_step(N_DISPATCH), runner.params,
                                     runner.opt_state, runner.prepare_batch(stacked))
        times = time_in_turns(fns, check_loss)
        timed = {}
        for bsz, ts in times.items():
            ms = statistics.mean(ts) / N_DISPATCH
            timed[bsz] = {"ms_per_step": ms, "examples_per_s": bsz / ms * 1e3,
                          "examples_per_s_per_card": bsz / ms * 1e3 / world,
                          "ms_a_call": ts}
            mesh_note(f"(b) {name}, captured N={N_DISPATCH}, B={bsz} ({bsz // world} a card's "
                      f"towers): {ms:.4f} ms/step, {bsz / ms * 1e3:.0f} examples/s, "
                      f"{bsz / ms * 1e3 / world:.0f} a card (ms a call {ts})")
        entry = {"launches": launches, "peak_bytes": peak, "store": list(store.shape),
                 "draw_s": draw_s, "fit_s": fit_s, "losses": got_losses.tolist(),
                 "times": timed, "kernels": kernels, "changed_rows": int(changed.sum())}
        if mode == "hybrid":
            eager = runner.eager_step()
            batch = runner.prepare_batch(drawn_batches(cfg, 1, seed=45)[0])
            overlap, nccl, (nccl_captured, busy) = mesh_overlap(
                train_step_fn(eager, runner.params, runner.opt_state, batch), fns[BATCH], rank)
            idle = 1 - busy / 1e3 / timed[BATCH]["ms_per_step"]
            entry.update(overlap=overlap, nccl_us=nccl, nccl_captured_us=nccl_captured,
                         busy_us=busy, idle_share=idle)
            for what, us in (("one eager step", nccl),
                             (f"a captured dispatch of {N_DISPATCH} at B={BATCH}", nccl_captured)):
                mesh_note(f"(b) {name}, {what} under torch.profiler: NCCL kernels "
                          f"{ {k[:40]: round(v, 2) for k, v in us.items()} } (device us a "
                          f"step, {sum(us.values()):.2f} in all)")
            mesh_note(f"(b) {name}, the captured dispatch: {busy:.2f} device-busy us a step "
                      f"(kernels and copies), idle share {idle:.3f} of the timed "
                      f"{timed[BATCH]['ms_per_step']:.4f} ms/step")
            mesh_note(f"(b) {name}: overlap (the eager step) {overlap}")
        del fns
        out[mode] = entry
        del runner, params, store, changed, live
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_cli(spec, rank):
    """Phase 12 (c) on a rank: ``cli.main`` with (c)'s command lines plus
    --distributed --mesh-model=WORLD in the ranks' world, launches counted;
    rank 0 holds the f32 run's losses to card 0's single-device run at rtol
    1e-4 and reads the bf16 run's against its own."""
    import contextlib
    import io
    import math
    import re

    import torch

    from dlrm_yx_tpu_torch import cli

    world = spec["world"]
    want = only(fused_interaction=2 * N_TRAIN_BATCHES, sparse_rows_overwrite=N_TRAIN_BATCHES,
                rwsadagrad_dense_finish=N_TRAIN_BATCHES)
    out = {}
    for name, argv in mesh_cli_argvs(terabyte_rows()).items():
        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            metrics = cli.main(argv + ["--distributed", f"--mesh-model={world}"])
        seconds = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        if launches != want:
            raise SystemExit(f"rank {rank}, (c) {name}: launched {launches}, want {want}")
        entry = {"launches": launches, "seconds": seconds}
        if rank == 0:
            losses = [float(x) for x in re.findall(r"loss ([-+.\deE]+|nan|inf)",
                                                   printed.getvalue())]
            ref = torch.tensor(spec["cli"][name], dtype=torch.float64)
            got = torch.tensor(losses, dtype=torch.float64)
            if got.shape != ref.shape or not all(map(math.isfinite, losses)) or not all(
                    math.isfinite(metrics.get(k, math.nan)) for k in ("accuracy", "roc_auc")):
                raise SystemExit(f"rank 0, (c) {name}: losses {losses}, eval {metrics}")
            rel = ((got - ref).abs() / ref.abs()).max().item()
            held = name == "f32"
            if held and not torch.allclose(got, ref, rtol=1e-4, atol=0.0):
                raise SystemExit(f"rank 0, (c) {name}: losses {losses} against card 0's "
                                 f"{spec['cli'][name]}: relative {rel:.3e} beyond 1e-4")
            entry.update(losses=losses, rel=rel)
            mesh_note(f"(c) cli, phase b's flags, {name} compute, --distributed "
                      f"--mesh-model={world}: {N_TRAIN_BATCHES} steps and an eval in "
                      f"{seconds:.1f} s (host init included): losses {losses} against card "
                      f"0's single-device run {spec['cli'][name]}: max relative "
                      f"{rel:.3e}{' within rtol 1e-4' if held else ' (read, not held)'}")
        mesh_note(f"(c) {name}: launches {launches}")
        out[name] = entry
    return out


def mesh_rank_main(spec_path):
    """One rank of phase 12: cuda:LOCAL_RANK over NCCL (``init_multihost``),
    (a), (b) and (c) in turn; prints its results as one JSON line."""
    import torch
    import torch.distributed as dist

    from dlrm_yx_tpu_torch.parallel.multihost import init_multihost
    from dlrm_yx_tpu_torch.utils.device import resolve_device

    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = init_multihost(device="cuda")
    dev = resolve_device("cuda")
    if (dist.get_backend() != "nccl" or world != spec["world"]
            or dev.index != int(os.environ["LOCAL_RANK"])):
        raise SystemExit(f"rank {rank}: backend {dist.get_backend()}, world {world}, device "
                         f"{dev}: want NCCL, {spec['world']} ranks, one a card")
    mesh_note(f"rank {rank} of {world} on {dev} ({torch.cuda.get_device_name(dev)}), NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    result = {"rank": rank, "device": str(dev)}
    t0 = time.perf_counter()
    result["a"] = mesh_parity(spec, rank)
    mesh_note(f"(a) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    result["b"] = mesh_terabyte(spec, rank)
    mesh_note(f"(b) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    result["c"] = mesh_cli(spec, rank)
    mesh_note(f"(c) in {time.perf_counter() - t0:.1f} s")
    # the cards this process made a CUDA context on (its own alone, unless
    # something ran or allocated on another card; read, not held)
    result["contexts"] = [i for i in range(torch.cuda.device_count())
                          if torch._C._cuda_hasPrimaryContext(i)]
    mesh_note(f"CUDA primary contexts of this process: cards {result['contexts']}")
    print("[mesh-result] " + json.dumps(result), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    mesh_note("ok")


# --- the kernels line

MESH_KERNELS = {  # kernel -> (the TPU kernel it replaces, its source)
    "fused_interaction": ("dlrm_yx_tpu/ops/pallas_interaction.py:84",
                          "dlrm_yx_tpu_torch/csrc/fused_interaction.cu"),
    "sparse_rows_overwrite": ("dlrm_yx_tpu/ops/pallas_sparse_update.py:505",
                              "dlrm_yx_tpu_torch/csrc/sparse_rows_overwrite.cu"),
    "rwsadagrad_dense_finish": ("dlrm_yx_tpu/ops/pallas_dense_finish.py:119",
                                "dlrm_yx_tpu_torch/csrc/rwsadagrad_dense_finish.cu"),
    "sparse_rows_add": ("dlrm_yx_tpu/ops/pallas_sparse_update.py:293",
                        "dlrm_yx_tpu_torch/csrc/sparse_rows_add.cu"),
}


def mesh_kernel_entry(results, name):
    """A kernels-line row's ``mesh`` part: the world, the kernel's launches
    on each rank in every run of phase 12, and each rank's readings at the
    shapes (b) gives it."""
    ranks = sorted(results, key=lambda r: r["rank"])
    launches = {}
    for part in ("a", "b", "c"):
        for run in ranks[0][part]:
            launched = [r[part][run] if part == "a" else r[part][run]["launches"] for r in ranks]
            launches[f"({part}) {run}"] = [x[name] for x in launched]
    shapes = [dict(mode=mode, rank=r["rank"], **entry["kernels"][name])
              for r in ranks for mode, entry in r["b"].items() if name in entry["kernels"]]
    return {"world": len(ranks), "launches_per_rank": launches, "shapes": shapes}


def mesh_kernels_line(results):
    """The kernels line of ``--phase 12``: K1-K4 at the shapes of (b)'s hybrid
    run, on the rank whose call has the most work (the largest bound; rank 0
    may hold no small table), launched as that rank's Trainer.fit launched
    them, each with its ``mesh`` part."""
    kernels = []
    for name, (replaces, source) in MESH_KERNELS.items():
        rank = max((r for r in results if name in r["b"]["hybrid"]["kernels"]),
                   key=lambda r: r["b"]["hybrid"]["kernels"][name]["bound_ms"])
        hybrid = rank["b"]["hybrid"]
        row = hybrid["kernels"][name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": hybrid["launches"][name], "rank": rank["rank"],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "cold_ms",
                                               "warm_ms")},
                        "mesh": mesh_kernel_entry(results, name)})
    return kernels


def terabyte_rows():
    from dlrm_yx_tpu_torch.config import DLRMConfig

    return DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000).emb_rows


def _events_ms(fn, reps=3):
    """Mean device time of ``reps`` eager fn() calls (after one warm call),
    between two CUDA events: calls of tens of milliseconds, where the
    host's launches hide under the device's work."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


HSTU_SHAPE = dict(tokens=32768, heads=4, dqk=128, dv=128, max_len=8192, block=1024,
                  buckets=128, dim=512, items=8_000_000, negatives=128)


def check_hstu():
    """Phase hstu: the HSTU cell's tiled attention (``ops/hstu_attention.py``)
    at its shapes in bf16 (32,768 tokens of histories log-uniform on [256,
    8192], 4 heads of 128, N 8,192, query blocks of 1,024) against its
    plain version on the card (each history whole, f32, from the same bf16
    q, k, v), forward and backward, with their times and the share of the
    computed scores that is live; then the coalesce-first row update at
    width 512 (``optimizer.coalesced_rows_update``: K7a, the momentum, K7b,
    K2) on the cell's ~4.26M items a step (a step's tokens, positives and
    128 uniform negatives each, mostly distinct rows) of an 8M-row store,
    against exact row-wise Adagrad in torch ops, with its time."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dlrm_yx_tpu_torch.data.synthetic import history_lengths
    from dlrm_yx_tpu_torch.ops.hstu_attention import hstu_attention, jagged_context, scores
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, coalesced_rows_update
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import CLIP_MARGIN

    c = HSTU_SHAPE
    dev = torch.device("cuda")
    rng = np.random.RandomState(23)
    t, h, n = c["tokens"], c["heads"], c["max_len"]
    lengths = history_lengths(rng, t, 256, n)
    gaps = np.exp(rng.normal(np.log(60.0), 2.0, t)).astype(np.int64)
    ends = np.cumsum(lengths)
    starts = np.repeat(ends - lengths, lengths)
    times = torch.as_tensor(np.cumsum(gaps) - np.cumsum(gaps)[starts], device=dev)
    offsets = torch.as_tensor(np.concatenate([[0], ends]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k = (torch.randn((t, h, c["dqk"]), generator=gen, device=dev).bfloat16()
            .requires_grad_() for _ in range(2))
    v = torch.randn((t, h, c["dv"]), generator=gen, device=dev).bfloat16().requires_grad_()
    pos_w = (torch.randn(2 * n - 1, generator=gen, device=dev) * 0.3).requires_grad_()
    time_w = (torch.randn(c["buckets"] + 1, generator=gen, device=dev) * 0.3).requires_grad_()
    cot = torch.randn((t, h, c["dv"]), generator=gen, device=dev).bfloat16()
    ctx_ms = _events_ms(lambda: jagged_context(offsets, times, n, c["buckets"], c["block"]))
    ctx = jagged_context(offsets, times, n, c["buckets"], c["block"])
    torch.cuda.synchronize()
    out = hstu_attention(q, k, v, pos_w, time_w, ctx)
    grads = torch.autograd.grad(out, (q, k, v, pos_w, time_w), cot)

    def plain(qf, kf, vf, pw, tw):
        outs = []
        for s, e in zip((ends - lengths).tolist(), ends.tolist()):
            qh, kh, vh = (x[s:e].transpose(0, 1) for x in (qf, kf, vf))
            i = torch.arange(e - s, device=dev)
            rel = (i[:, None] - i[None, :]).clamp(min=0)
            tt = times[s:e]
            b = (torch.log((tt[:, None] - tt[None, :]).abs().clamp(min=1).float()) / 0.301)
            rab = pw[n - 1 - rel] + tw[b.long().clamp(0, c["buckets"])]
            a = F.silu(qh @ kh.transpose(1, 2) + rab) * (i[None, :] <= i[:, None]) / n
            outs.append((a @ vh).transpose(0, 1))
        return torch.cat(outs)

    leaves = [x.detach().float().requires_grad_() for x in (q, k, v, pos_w, time_w)]
    want = plain(*leaves)
    want_g = torch.autograd.grad(want, leaves, cot.float())

    def rel_gap(a, b):
        return float((a.float() - b).detach().norm() / b.detach().norm())

    out_gap = rel_gap(out, want)
    g_gaps = [rel_gap(a, b) for a, b in zip(grads, want_g)]
    say("hstu", f"attention (bf16) vs its plain version (f32): output {out_gap:.3e}, "
                f"gradients q {g_gaps[0]:.3e} k {g_gaps[1]:.3e} v {g_gaps[2]:.3e} "
                f"pos_w {g_gaps[3]:.3e} time_w {g_gaps[4]:.3e} (norm of the difference "
                "over the plain version's)")
    # bf16 products and bias against f32: a few bf16 ulps of the output's
    # norm; a dropped block, band or bucket reads far above it
    if out_gap > 2e-2 or max(g_gaps) > 5e-2:
        fail(f"the tiled attention departs from its plain version: {out_gap}, {g_gaps}")
    del want, want_g, leaves
    fwd_ms = _events_ms(lambda: hstu_attention(q.detach(), k.detach(), v.detach(),
                                               pos_w.detach(), time_w.detach(), ctx))

    def fwd_bwd():
        o = hstu_attention(q, k, v, pos_w, time_w, ctx)
        torch.autograd.grad(o, (q, k, v, pos_w, time_w), cot)

    both_ms = _events_ms(fwd_bwd)
    live, computed = scores(torch.as_tensor(lengths), t, h, n, c["block"])
    flops = 2 * (c["dqk"] + c["dv"]) * int(computed)
    say("hstu", f"attention at T {t}, H {h}, N {n}, block {c['block']}: context "
                f"{ctx_ms:.3f} ms, forward {fwd_ms:.3f} ms, forward+backward {both_ms:.3f} ms; "
                f"live scores {int(live)} of {int(computed)} computed "
                f"({100 * int(live) / int(computed):.2f}%); the computed forward products "
                f"{flops / fwd_ms / 1e9:.1f} TFLOP/s")
    del q, k, v, grads, out, ctx
    torch.cuda.empty_cache()

    # the row update at width 512
    d, rows, r = c["dim"], c["items"], c["negatives"]
    opt = OptConfig(name="rwsadagrad", lr=0.005)
    store = torch.randn((rows + CLIP_MARGIN + 1, d), generator=gen, device=dev).mul_(0.02)
    store[rows:] = 0
    acc = torch.zeros(rows + CLIP_MARGIN + 1, device=dev)
    zipf = torch.as_tensor(np.minimum(rng.zipf(1.15, 2 * t) - 1, rows - 1), device=dev)
    ids = torch.cat([zipf, torch.randint(0, rows, (t * r,), generator=gen, device=dev)])
    g = torch.randn((ids.shape[0], d), generator=gen, device=dev)
    uniq, inv = torch.unique(ids, return_inverse=True)
    sums = torch.zeros((uniq.shape[0], d), device=dev).index_add_(0, inv, g)
    want_acc = (sums * sums).mean(dim=1)
    want_rows = store[uniq] - opt.lr * sums / (want_acc.sqrt() + opt.eps)[:, None]
    say("hstu", f"row update: {ids.shape[0]} items on {int(uniq.shape[0])} distinct rows of "
                f"{rows} x {d}")
    del sums, inv
    before = float(store[rows - 1].sum()) if int(uniq[-1]) < rows - 1 else None
    coalesced_rows_update(opt, store, acc, ids, [g.clone()], opt.lr, rows)
    torch.cuda.synchronize()
    err = float((store[uniq] - want_rows).abs().max())
    acc_err = float(((acc[uniq] - want_acc).abs() / want_acc.clamp(min=1e-30)).max())
    if before is not None and float(store[rows - 1].sum()) != before:
        fail("the coalesced row update moved a row no item names")
    if float(store[rows:].abs().sum()) != 0.0:
        fail("the coalesced row update wrote a spare row")
    say("hstu", f"coalesced row update vs torch ops: store max abs err {err:.3e}, momentum "
                f"max rel err {acc_err:.3e}")
    # f32 sums of the same items in another order
    if err > 1e-5 or acc_err > 1e-4:
        fail(f"the coalesced row update departs from exact row-wise Adagrad: {err}, {acc_err}")
    del want_rows, want_acc, uniq
    ms = _events_ms(lambda: coalesced_rows_update(opt, store, acc, ids, [g.clone()], opt.lr, rows))
    copy_ms = _events_ms(lambda: g.clone())
    say("hstu", f"coalesced row update (K7a, momentum, K7b, K2): {ms - copy_ms:.3f} ms a call "
                f"(a call's {copy_ms:.3f} ms copy of its gradients left out)")
    del store, acc, g, ids
    torch.cuda.empty_cache()


def main(mesh_only=False, cross_only=False, hstu_only=False):
    """The smoke run; ``mesh_only`` (``--phase 12``): phases 1, 2 and 12 alone,
    the kernels line of K1-K3 at phase 12's shapes; ``cross_only``
    (``--phase k8``): phases 1, 2 and phase a's K8 check alone;
    ``hstu_only`` (``--phase hstu``): phases 1, 2 and phase hstu alone."""
    import gc
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
    if hstu_only:
        check_hstu()
        say("done", f"chip_smoke.py --phase hstu wall time {time.perf_counter() - T_START:.1f} s")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": count}}))
        return
    if cross_only:
        check_cross_layer_kernel()
        say("done", f"chip_smoke.py --phase k8 wall time {time.perf_counter() - T_START:.1f} s")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": count}}))
        return
    if mesh_only:
        mesh = mesh_paths(count)
        if mesh is None:
            fail("--phase 12 needs 2 or more cards")
        kernels = mesh_kernels_line(mesh)
        say("done", f"chip_smoke.py --phase 12 wall time {time.perf_counter() - T_START:.1f} s")
        print(json.dumps({"kernels": kernels}))
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": count}}))
        return

    # 3, a, f, l. kernels against their plain versions
    k1 = check_interaction_kernel()
    small, big = terabyte_groups()
    k2 = check_overwrite_kernel(big)
    k3 = check_finish_kernel(small)
    check_finish_routes()
    bench_cfg = benchmark_config()
    k5, k6 = check_stream_kernels(bench_cfg)
    from dlrm_yx_tpu_torch.models.dlrm import model_groups

    _, cap_big = model_groups(capacity_config())
    k4 = check_rows_add_kernel(cap_big, big)
    check_coalesce_route()
    check_cross_layer_kernel()
    check_hstu()
    rows = DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000).emb_rows
    # x. the kernels on the variants' shapes (and the processed dataset)
    grouped = {"processed": check_variant_kernels(rows)}

    # 4, b, g, h, m. the main paths: serving, training at L=1, the L=100
    # benchmark (K5), its batch-4096 RWSAdagrad run (K6) and training on
    # bf16 stores with stochastic rounding (K4)
    with SharedInit() as shared:
        serve_main_path(rows)
        launches = train_main_path(rows, big_index=1)
        l100_launches = benchmark_main_path()
        big_launches = big_batch_main_path()
        bf16_launches = train_bf16_sr_main_path(rows, big_index=1)
        # y. the embedding variants and the processed dataset
        variant_launches = variant_main_paths(rows)
        # 8. quantized serving
        quantized_main_paths(rows)

        # u, v. the real-data paths (MLPerf binary file, Kaggle TSV -> npz,
        # stack-distance traces) and checkpoints; w. their feeds' throughput,
        # timed here, before any profiler session
        mlperf_bin_main_path(rows)
        kaggle_main_path()
        trace_batches = trace_main_path(rows)
        check_native_parser()
        shared.keep_only(rows)
        fit, feeds = real_data_feeds(rows, trace_batches)
        say("data", f"CLI runs and phase w drew the tables on the host {shared.draws} times "
                    f"for {shared.copies} models")

    # 5, c, i, o. the eval and train steps against the CPU on a small input
    check_against_cpu()
    check_train_against_cpu()
    check_stream_train_against_cpu()
    check_k4_train_against_cpu()
    # z. the variants' train steps against the CPU
    check_variants_against_cpu()

    # r. every captured path against its eager steps, bit for bit
    check_capture(rows)

    # 6, d, j, n. eager serving and training throughput, s. the captured
    # steps against them, then 7, e, k, p, t. where their device time goes:
    # every timing runs before the first profiler session, whose tracing can
    # linger and slow the host's launches
    step, serve_cfg, params, batch = serving_throughput(rows)
    steps, tparams, state, tbatch, hint, train_cfg, train_opt = full_train_step(rows)
    train_throughput(steps, tparams, state, tbatch, hint)
    l100_steps, l100_parts = l100_train_steps()
    l100_throughput(l100_steps)
    cap_steps, cap_parts = capacity_steps()
    capacity_throughput(cap_steps)
    captured = {
        "eval": (captured_eval_throughput(serve_cfg, params, batch, lambda: step(params, batch)),
                 1),
        "L=1 train": (captured_throughput(
            f"L=1 train step (rwsadagrad, bf16, sparse-update pallas, density hint {hint:.4f}, "
            "pallas interaction)", train_cfg, train_opt, tparams, state, tbatch,
            train_step_fn(steps["pallas"], tparams, state, tbatch)), N_DISPATCH),
        f"L={L100} train (sgd pallas)": (captured_throughput(
            f"L={L100} train step, 8 x 1M x 64, B={BATCH}, bf16, sgd pallas", *l100_parts,
            l100_steps["sgd pallas"]), N_DISPATCH),
        "capacity train (sr off)": (captured_throughput(
            "capacity train step (Terabyte-MLPerf <=10M rows, bf16 stores and compute, "
            "rwsadagrad, sparse-update pallas), sr off", *cap_parts, cap_steps["sr off"]),
            N_DISPATCH),
    }
    variant_fns = variant_throughput(captured["L=1 train"][0], rows, grouped)
    for name, fn in variant_fns.items():
        captured[f"L=1 train, {name} tables"] = (fn, N_DISPATCH)
    quantized = quantized_throughput(serve_cfg, params, batch)
    profile_step(lambda: step(params, batch), "serving (eager)",
                 ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp"))
    train_phases = ("embedding_lookup", "bottom_mlp", "interaction", "top_mlp",
                    "loss_compute", "backward", "optimizer")
    per_kernel = profile_step(train_step_fn(steps["pallas"], tparams, state, tbatch),
                              "train (eager, pallas interaction)", train_phases)
    for name, pattern in (("K2 sparse_rows_overwrite (row_plan)", "row_plan"),
                          ("K3 rwsadagrad_dense_finish", "dense_finish")):
        ms = sum(v for k, v in per_kernel.items() if pattern in k)
        say("profile", f"  {name} kernels: {ms:.5f} ms/step of device time")
    for name, fn in l100_steps.items():
        profile_by_kind(profile_step(fn, f"L={L100} train (eager, {name})", train_phases))
    per_kernel = profile_step(cap_steps["sr off"], "capacity train (eager, sr off)",
                              train_phases)
    profile_by_kind(per_kernel, CAPACITY_KINDS)
    for name, ms in per_kernel.items():
        if "row_plan" in name:  # K4's kernels, once a step each for the store and the momentum
            say("profile", f"  K4 kernel: {ms:.5f} ms/step {name[:90]}")
    # t. the captured steps (the host's phase annotations are not replayed)
    for name, (fn, n) in captured.items():
        per_kernel = profile_step(fn, f"{name} (captured, {n} step{'s' * (n > 1)} a replay)",
                                  (), steps=n)
        if name.startswith(f"L={L100}"):
            profile_by_kind(per_kernel)
        elif name.endswith(" tables"):
            profile_by_kind(per_kernel, VARIANT_KINDS)
        elif name.startswith("L=1 "):
            profile_by_kind(per_kernel, L1_KINDS)
        elif name.startswith("capacity"):
            profile_by_kind(per_kernel, CAPACITY_KINDS)
    del captured
    for name, fn in quantized.items():
        profile_by_kind(profile_step(fn, f"quantized eval, {name} (captured, one batch a "
                                         "replay)", ()), QUANT_KINDS)
    del quantized
    profile_real_data(fit, feeds)
    del fit, feeds

    # q. device operations per wrapper call
    count_device_ops(big, cap_big)
    count_k1_k5_ops(bench_cfg, small)

    # 9. export and the diagnostic flags on the training path
    del step, params, batch, steps, tparams, state, tbatch, l100_steps, l100_parts
    del cap_steps, cap_parts
    gc.collect()
    torch.cuda.empty_cache()
    export_and_diagnostics(rows)

    # 10. hybrid (whole-table) sharding: world size 1 over NCCL, then two
    # ranks on the card over gloo
    hybrid_two_ranks(hybrid_world_of_one(rows))
    # 11. row and column sharding: the same, then the column slice's kernels
    sharded_two_ranks(sharded_world_of_one(rows, smi))
    check_slice_kernels(rows)
    # 12. the mesh paths across the cards (one line on one card)
    mesh = mesh_paths(count)

    sources = {
        "fused_interaction": ("dlrm_yx_tpu/ops/pallas_interaction.py:84", k1, launches,
                              "no single call computes bmm + tril + concat"),
        "sparse_rows_overwrite": ("dlrm_yx_tpu/ops/pallas_sparse_update.py:505", k2,
                                  launches, None),
        "rwsadagrad_dense_finish": ("dlrm_yx_tpu/ops/pallas_dense_finish.py:119", k3,
                                    launches, "no single call does a row-wise Adagrad step"),
        # K3's grouped launch of many stores: timed on the QR step's 30
        # stores, its launches those of phase y's QR run (phase b's step
        # launches it too, with its one small-group store: K3's row above)
        "rwsadagrad_dense_finish_many": ("dlrm_yx_tpu/ops/pallas_dense_finish.py:119",
                                         grouped["QR"], variant_launches["qr"],
                                         "no single call does a row-wise Adagrad step"),
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
            "source": "dlrm_yx_tpu_torch/csrc/rwsadagrad_dense_finish.cu"
                      if name.startswith("rwsadagrad") else f"dlrm_yx_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
            # ms is every kernel's warm reading, as the earlier lines had it;
            # cold_ms has the L2 emptied before each call (held to the bound)
            "cold_ms": row["cold_ms"],
            "warm_ms": row["warm_ms"],
        })
        if name == "rwsadagrad_dense_finish_many":
            kernels[-1].update(launches_from="phase y: the QR model's CLI training run",
                               timed_on="the QR step's 30 stores, one launch")
        if mesh and name in MESH_KERNELS:
            kernels[-1]["mesh"] = mesh_kernel_entry(mesh, name)
        if no_library:
            say("kernel", f"{name}: library_ms null ({no_library})")
    say("done", f"chip_smoke.py wall time {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--hybrid-rank"]:
        hybrid_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(sys.argv[2])
    elif sys.argv[1:] == ["--phase", "12"]:
        main(mesh_only=True)
    elif sys.argv[1:] == ["--phase", "k8"]:
        main(cross_only=True)
    elif sys.argv[1:] == ["--phase", "hstu"]:
        main(hstu_only=True)
    else:
        main()
