"""Command-line entry point: train or serve a DLRM.

The port of the single-device training and ``--inference-only`` paths of
``dlrm_yx_tpu/cli.py``, on random data (``--data-generation random`` or
``random-device``), stack-distance trace data (``synthetic``, from
``--data-trace-file``) or a Criteo dataset (``dataset``: the Kaggle /
Terabyte TSV preprocessed on first touch into day npz files, read by
``CriteoNpzLoader`` with ``--memory-map`` optional, or the MLPerf binary
file with ``--mlperf-bin-loader [--mlperf-bin-shuffle]``). In dataset mode
the table rows come from ``{prefix}_fea_count.npz``, capped by
``--max-ind-range``. ``--save-model`` saves the best checkpoint at each
eval, ``--load-model`` resumes from one (or serves it with
``--inference-only``). The flags keep the JAX package's names, defaults
and meaning; one flag is new, ``--device`` (``cuda`` by default; ``cpu``
for the tests). Flags of parts not yet ported are still recognised, and
giving any of them raises ``NotImplementedError`` instead of being
ignored. ``--print-time`` and the reference-compat flags of
``add_noop_flags`` are accepted and have no effect, as in the JAX CLI.
The reference's L=100 throughput benchmark
(``bench/dlrm_tpu_benchmark.sh``) runs with ``dlrm_yx_tpu.cli`` replaced by
``dlrm_yx_tpu_torch.cli``. bf16 table storage (``--emb-dtype bfloat16``)
takes ``--stochastic-rounding``. On the card every train and eval step runs
as a replay of a CUDA graph, ``--steps-per-dispatch`` steps a replay (0 =
auto), with batches staged by a prefetch thread ``--prefetch-depth`` deep;
``--mlperf-grad-accum-iter`` accumulates gradients over micro-batches.

    python -m dlrm_yx_tpu_torch.cli \
        --arch-embedding-size 1000-1000 --arch-sparse-feature-size 128 \
        --arch-mlp-bot 13-256-128 --arch-mlp-top 64-1 \
        --mini-batch-size 2048 --num-batches 4 --num-indices-per-lookup 1 \
        --optimizer rwsadagrad --learning-rate 0.01 \
        --sparse-update-impl pallas --interaction-impl pallas \
        --compute-dtype bfloat16 --loss-function bce
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig, parse_int_list
from dlrm_yx_tpu_torch.data.criteo import (
    CriteoNpzLoader,
    preprocess_criteo,
    split_kaggle_train_txt,
)
from dlrm_yx_tpu_torch.data.criteo_bin import CriteoBinLoader
from dlrm_yx_tpu_torch.data.synthetic import (
    RandomDataConfig,
    make_device_random_batches,
    make_random_batches,
)
from dlrm_yx_tpu_torch.data.trace import make_trace_batches
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.logging import rank0_print

# flags of dlrm_yx_tpu/cli.py whose parts are not ported yet
UNPORTED_FLAGS = (
    "weighted-pooling", "md-flag", "md-threshold", "md-temperature",
    "md-round-dims", "qr-flag", "qr-threshold", "qr-operation",
    "qr-collisions", "load-processed", "print-precision",
    "force-cpu-devices", "distributed", "mesh-data", "mesh-model",
    "shard-mode", "sharder", "allocation", "debug-mode",
    "enable-profiling", "profile-out-dir", "plot-compute-graph",
    "save-onnx", "quantize-mlp-with-bit", "quantize-emb-with-bit",
    "collect-execution-graph",
)
# --data-generation values ported; "processed" (--load-processed) waits for
# per-table dims (mixed-dimension embeddings)
DATA_GENERATIONS = ("random", "random-device", "synthetic", "dataset")


def add_noop_flags(p: argparse.ArgumentParser) -> None:
    """The reference-compat flags that dlrm_yx_tpu/cli.py accepts and never
    reads (backend pick, DDP buckets, pinned memory, loader workers,
    table-batched storage), with its types and defaults; nothing reads
    them here either."""
    p.add_argument("--activation-function", type=str, default="relu")
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--use-tpu", action="store_true", default=False)
    p.add_argument("--use-gpu", action="store_true", default=False)
    p.add_argument("--batched-emb", action="store_true", default=False)
    p.add_argument("--fbgemm-emb", action="store_true", default=False)
    p.add_argument("--sync-dense-params", type=bool, default=True)
    p.add_argument("--bucket-size-mb", type=int, default=25)
    p.add_argument("--dist-backend", type=str, default="")
    p.add_argument("--local-rank", type=int, default=-1)
    p.add_argument("--pin-memory", action="store_true", default=False)
    p.add_argument("--early-barrier", action="store_true", default=False)
    p.add_argument("--aggregated-allreduce", action="store_true", default=False)
    p.add_argument("--test-num-workers", type=int, default=-1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train or serve a Deep Learning Recommendation Model (DLRM) on a GPU"
    )
    # model arch
    p.add_argument("--arch-sparse-feature-size", type=int, default=2)
    p.add_argument("--arch-embedding-size", type=str, default="4-3-2")
    p.add_argument("--arch-mlp-bot", type=str, default="4-3-2")
    p.add_argument("--arch-mlp-top", type=str, default="4-2-1")
    p.add_argument("--arch-interaction-op", type=str, choices=["dot", "cat"], default="dot")
    p.add_argument("--arch-interaction-itself", action="store_true", default=False)
    # loss
    p.add_argument("--loss-function", type=str, default="mse")  # or bce or wbce
    p.add_argument("--loss-weights", type=str, default="1.0-1.0")  # for wbce
    p.add_argument("--loss-threshold", type=float, default=0.0)
    p.add_argument("--round-targets", type=bool, default=False)
    # data
    p.add_argument("--data-size", type=int, default=1)
    p.add_argument("--num-batches", type=int, default=0)
    p.add_argument("--data-generation", type=str, default="random",
                   help="random (numpy, on the host) | random-device (drawn on "
                        "the device) | synthetic (stack-distance traces) | "
                        "dataset (Criteo)")
    p.add_argument("--rand-data-dist", type=str, default="uniform")  # or gaussian
    p.add_argument("--rand-data-min", type=float, default=0)
    p.add_argument("--rand-data-max", type=float, default=1)
    p.add_argument("--rand-data-mu", type=float, default=-1)
    p.add_argument("--rand-data-sigma", type=float, default=1)
    p.add_argument("--num-indices-per-lookup", type=int, default=10)
    p.add_argument("--num-indices-per-lookup-fixed", type=bool, default=False)
    p.add_argument("--data-trace-file", type=str, default="./input/dist_emb_j.log",
                   help="synthetic: per-table stack-distance files, 'j' = the "
                        "table id (wrapped over the files present)")
    p.add_argument("--data-trace-enable-padding", type=bool, default=False)
    p.add_argument("--data-set", type=str, default="kaggle")  # or terabyte
    p.add_argument("--raw-data-file", type=str, default="")
    p.add_argument("--processed-data-file", type=str, default="")
    p.add_argument("--data-randomize", type=str, default="total")  # none, day or total
    p.add_argument("--data-sub-sample-rate", type=float, default=0.0)
    p.add_argument("--memory-map", action="store_true", default=False)
    p.add_argument("--mlperf-bin-loader", action="store_true", default=False)
    p.add_argument("--mlperf-bin-shuffle", action="store_true", default=False)
    p.add_argument("--dataset-multiprocessing", action="store_true", default=False,
                   help="parse the raw day files in parallel processes")
    p.add_argument("--mini-batch-size", type=int, default=1)
    p.add_argument("--test-mini-batch-size", type=int, default=-1)
    p.add_argument("--numpy-rand-seed", type=int, default=123)
    # execution
    p.add_argument("--lookup-impl", type=str, default="xla", choices=["xla", "pallas"],
                   help="accepted for parity with the JAX CLI; both values "
                        "take the same gather")
    p.add_argument("--interaction-impl", type=str, default="xla",
                   choices=["xla", "pallas"],
                   help="pallas = the fused dot-interaction CUDA kernel "
                        "(D%%128==0 and batch%%64==0; other shapes take the "
                        "plain formulation)")
    p.add_argument("--emb-split-threshold", type=int, default=65536,
                   help="tables with more rows get their own group stores; "
                        "0 disables splitting")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--emb-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--stochastic-rounding", action="store_true", default=False,
                   help="round bf16 table updates stochastically on the "
                        "row-update kernel's route")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises when absent) or cpu")
    p.add_argument("--max-ind-range", type=int, default=-1,
                   help="caps table rows in dataset mode (ids taken mod it), as "
                        "in the JAX CLI; random and trace data take "
                        "--arch-embedding-size as it is")
    # training
    p.add_argument("--nepochs", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adagrad", "rwsadagrad"])
    p.add_argument("--sparse-update-impl", type=str, default="xla",
                   choices=["xla", "pallas", "stream"],
                   help="pallas = the row-touching update kernels for big "
                        "tables (write-only update, CUDA), the fused "
                        "RWSAdagrad finish for small ones and, with SGD, the "
                        "sorted-stream update in the dense regime; stream = "
                        "the sorted-stream update in the dense regime")
    p.add_argument("--exact-row-momentum", action="store_true", default=False,
                   help="coalesce duplicate rows before the kernel route's "
                        "adagrad-family momentum")
    p.add_argument("--no-write-only-update", action="store_true", default=False,
                   help="read-modify-write every updated row (the "
                        "sparse_rows_add kernel) instead of writing the rows "
                        "the lookup gathered")
    p.add_argument("--lr-num-warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-start-step", type=int, default=0)
    p.add_argument("--lr-num-decay-steps", type=int, default=0)
    p.add_argument("--print-freq", type=int, default=1)
    p.add_argument("--print-time", action="store_true", default=False,
                   help="accepted for parity with the JAX CLI; no effect")
    p.add_argument("--print-wall-time", action="store_true", default=False)
    # store/load model, scalars
    p.add_argument("--save-model", type=str, default="")
    p.add_argument("--load-model", type=str, default="")
    p.add_argument("--ckpt-backend", type=str, default="npz", choices=["npz", "orbax"],
                   help="npz (the port's only backend; orbax is a JAX library "
                        "and raises)")
    p.add_argument("--tensor-board-filename", type=str, default="")
    p.add_argument("--test-freq", type=int, default=-1)
    # mlperf
    p.add_argument("--inference-only", action="store_true", default=False)
    p.add_argument("--mlperf-logging", action="store_true", default=False)
    p.add_argument("--mlperf-acc-threshold", type=float, default=0.0)
    p.add_argument("--mlperf-auc-threshold", type=float, default=0.0)
    p.add_argument("--mlperf-grad-accum-iter", type=int, default=1,
                   help="micro-batches per optimizer step (gradient accumulation; "
                        "turns multi-step dispatch off)")
    # dispatch: on the card each dispatch is one CUDA-graph replay
    p.add_argument("--steps-per-dispatch", type=int, default=0,
                   help="full optimizer steps a dispatch, one CUDA-graph replay on the "
                        "card (0 = auto: largest of 16/8/4/2 dividing print/test freq)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="host->device staging queue depth (0 = synchronous)")
    add_noop_flags(p)
    for flag in UNPORTED_FLAGS:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def check_ported(args) -> None:
    """Raise on a flag whose part is not ported yet."""
    for flag in UNPORTED_FLAGS:
        if getattr(args, flag.replace("-", "_")) is not None:
            raise NotImplementedError(
                f"--{flag} is not yet ported to dlrm_yx_tpu_torch"
            )
    if args.data_generation not in DATA_GENERATIONS:
        raise NotImplementedError(
            f"--data-generation={args.data_generation} is not yet ported "
            f"({', '.join(DATA_GENERATIONS)} only)"
        )


def dataset_prefix(args) -> str:
    """The day-file prefix of dataset mode (a bin run's ``--raw-data-file``
    is its ``train.bin``; its counts npz, when present, sits at that
    prefix)."""
    return args.processed_data_file or args.raw_data_file


def config_from_args(args, argv=None) -> DLRMConfig:
    rows = parse_int_list(args.arch_embedding_size)
    if args.data_generation == "dataset":
        # dataset mode derives table sizes from the preprocessed feature
        # counts, clamped to --max-ind-range, not from --arch-embedding-size
        # (dlrm_s_pytorch.py:1388-1400). Preprocesses raw data on first
        # touch so the counts exist; takes the arch flag only when no
        # dataset files are reachable.
        if not args.mlperf_bin_loader:
            ensure_preprocessed(args)
        prefix = dataset_prefix(args)
        cf = f"{prefix}_fea_count.npz" if prefix else ""
        if cf and os.path.exists(cf):
            flag_rows = rows
            with np.load(cf) as d:
                rows = [int(n) for n in d["counts"]]
            if args.max_ind_range > 0:
                rows = [min(n, args.max_ind_range) for n in rows]
            if flag_rows not in ([], rows) and "--arch-embedding-size" in (
                    sys.argv if argv is None else argv):
                rank0_print(f"note: dataset feature counts override "
                            f"--arch-embedding-size ({len(rows)} tables from {cf})")
    return DLRMConfig.build(
        emb_rows=rows,
        ln_bot=parse_int_list(args.arch_mlp_bot),
        ln_top=parse_int_list(args.arch_mlp_top),
        interaction=args.arch_interaction_op,
        interact_itself=args.arch_interaction_itself,
        loss=args.loss_function,
        loss_threshold=args.loss_threshold,
        wbce_weights=tuple(float(x) for x in args.loss_weights.split("-")),
        compute_dtype=args.compute_dtype,
        emb_dtype=args.emb_dtype,
        stochastic_rounding=args.stochastic_rounding,
        write_only_update=not args.no_write_only_update,
        lookup_impl=args.lookup_impl,
        interaction_impl=args.interaction_impl,
        sparse_update_impl=args.sparse_update_impl,
        exact_row_momentum=args.exact_row_momentum,
        emb_split_threshold=args.emb_split_threshold,
    )


def ensure_preprocessed(args) -> None:
    """Preprocess the raw Criteo TSV on first touch, like the reference
    (CriteoDataset.__init__ -> getCriteoAdData). Idempotent; called before
    the model is built so the feature counts exist for the table rows."""
    prefix = dataset_prefix(args)
    if not prefix or os.path.exists(f"{prefix}_day_count.npz"):
        return
    if not args.raw_data_file or not os.path.exists(args.raw_data_file):
        return
    days = 7 if args.data_set == "kaggle" else 24
    rank0_print(f"preprocessing {args.raw_data_file} -> {prefix} ...")
    day_files = split_kaggle_train_txt(args.raw_data_file, days)
    info = preprocess_criteo(
        day_files, prefix,
        max_ind_range=args.max_ind_range,
        sub_sample_rate=args.data_sub_sample_rate,
        randomize=args.data_randomize,
        seed=args.numpy_rand_seed,
        nprocs=(os.cpu_count() or 1) if args.dataset_multiprocessing else 1,
    )
    rank0_print(f"preprocess stage seconds: {info['stage_seconds']}")


def make_data(args, cfg: DLRMConfig, train: bool = True):
    """(train, test) as the JAX CLI makes them. Random batches: test drawn
    with seed + 1; without ``train`` only the test batches are drawn (train
    is None); ``random-device`` batches are drawn on ``--device``. Trace
    batches (``synthetic``) and the binary loader serve as their own test
    set. Dataset mode: ``CriteoNpzLoader`` train and test splits (test at
    ``--test-mini-batch-size``), or ``CriteoBinLoader`` over
    ``--raw-data-file`` with ``--processed-data-file`` as its counts file,
    as in the JAX CLI (which makes the reference's MLPerf command line fail
    there: ROADMAP Queue C)."""
    nb = args.num_batches or int(np.ceil(args.data_size / args.mini_batch_size))
    if args.data_generation == "synthetic":
        batches = make_trace_batches(
            args.data_trace_file, cfg.emb_rows, cfg.ln_bot[0], args.mini_batch_size, nb,
            args.num_indices_per_lookup, args.num_indices_per_lookup_fixed,
            seed=args.numpy_rand_seed, enable_padding=args.data_trace_enable_padding)
        return batches, batches
    if args.data_generation == "dataset":
        if args.mlperf_bin_loader:
            loader = CriteoBinLoader(
                args.raw_data_file, args.processed_data_file or None,
                batch_size=args.mini_batch_size, max_ind_range=args.max_ind_range,
                shuffle_seed=args.numpy_rand_seed if args.mlperf_bin_shuffle else None)
            return loader, loader
        days = 7 if args.data_set == "kaggle" else 24
        prefix = dataset_prefix(args)
        ensure_preprocessed(args)
        tb = args.test_mini_batch_size if args.test_mini_batch_size > 0 else args.mini_batch_size
        test = CriteoNpzLoader(prefix, days, tb, split="test", max_ind_range=args.max_ind_range,
                               memory_map=args.memory_map)
        if not train:
            return None, test
        return CriteoNpzLoader(prefix, days, args.mini_batch_size, split="train",
                               max_ind_range=args.max_ind_range,
                               memory_map=args.memory_map), test
    if args.data_generation == "random-device":
        def device_batches(seed):
            return make_device_random_batches(
                cfg.emb_rows, cfg.ln_bot[0], args.mini_batch_size, nb,
                args.num_indices_per_lookup, args.num_indices_per_lookup_fixed,
                bool(args.round_targets), seed, resolve_device(args.device))

        test = device_batches(args.numpy_rand_seed + 1)
        return (device_batches(args.numpy_rand_seed) if train else None), test
    dc = RandomDataConfig(
        emb_rows=cfg.emb_rows, m_den=cfg.ln_bot[0],
        mini_batch_size=args.mini_batch_size, num_batches=nb,
        num_indices_per_lookup=args.num_indices_per_lookup,
        num_indices_per_lookup_fixed=args.num_indices_per_lookup_fixed,
        dist=args.rand_data_dist,
        rand_data_min=args.rand_data_min, rand_data_max=args.rand_data_max,
        rand_data_mu=args.rand_data_mu, rand_data_sigma=args.rand_data_sigma,
        round_targets=bool(args.round_targets), seed=args.numpy_rand_seed,
    )
    test = make_random_batches(dc, seed=args.numpy_rand_seed + 1)
    return (make_random_batches(dc) if train else None), test


def _measure_dup_density(cfg: DLRMConfig, train):
    """Unique rows per occurrence of the big (kernel-eligible) tables on
    the first batch: the measured statistic behind the dense-vs-kernel
    routing (``config.dup_density_hint``). The first batch is ``train[0]``
    where the source has ``__getitem__`` (a list, or the binary loader,
    through its shuffle order), else the first one it iterates. None when
    there is no big table or no batch. A batch drawn on the device is
    copied to the host once."""
    if train is None:
        return None
    try:
        b0 = train[0] if hasattr(train, "__getitem__") else next(iter(train))
    except (IndexError, StopIteration):  # no batch
        return None
    idx = torch.as_tensor(b0.indices).cpu().numpy()  # [T, B, L]
    thr = cfg.emb_split_threshold or 0
    big = [t for t, n in enumerate(cfg.emb_rows) if not thr or n > thr]
    if not big:
        return None
    uniq = sum(len(np.unique(idx[t])) for t in big)
    total = len(big) * idx.shape[1] * idx.shape[2]
    return max(1e-3, min(1.0, uniq / max(total, 1)))


def main(argv=None):
    """Trains (and evaluates at the end of each epoch, or every
    --test-freq iterations) and returns the last eval's metrics; with
    --inference-only evaluates the initial model and returns its metrics."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    np.random.seed(args.numpy_rand_seed)
    cfg = config_from_args(args, argv)
    opt = OptConfig(name=args.optimizer, lr=args.learning_rate)
    lr_policy = None
    if args.lr_num_warmup_steps or args.lr_num_decay_steps:
        lr_policy = LRPolicy(
            base_lr=args.learning_rate,
            num_warmup_steps=args.lr_num_warmup_steps,
            decay_start_step=args.lr_decay_start_step,
            num_decay_steps=args.lr_num_decay_steps,
        )
    tcfg = TrainerConfig(
        nepochs=args.nepochs,
        print_freq=args.print_freq,
        test_freq=max(args.test_freq, 0),
        mlperf_logging=args.mlperf_logging,
        mlperf_acc_threshold=args.mlperf_acc_threshold,
        mlperf_auc_threshold=args.mlperf_auc_threshold,
        save_path=args.save_model,
        load_path=args.load_model,
        ckpt_backend=args.ckpt_backend,
        tb_logdir=args.tensor_board_filename,
        seed=args.numpy_rand_seed,
        grad_accum_iter=args.mlperf_grad_accum_iter,
        steps_per_dispatch=args.steps_per_dispatch,
        prefetch_depth=args.prefetch_depth,
    )
    train, test = make_data(args, cfg, train=not args.inference_only)
    if cfg.sparse_update_impl in ("pallas", "stream") and cfg.dup_density_hint <= 0:
        hint = _measure_dup_density(cfg, train)
        if hint is not None:
            cfg = dataclasses.replace(cfg, dup_density_hint=hint)
            rank0_print(
                f"duplicate-density hint from first batch: {hint:.3f} "
                "unique rows per occurrence (drives the dense-vs-kernel "
                "update crossover)"
            )
    trainer = Trainer(cfg, opt, tcfg, lr_policy, device=args.device)
    if args.inference_only:
        metrics = trainer.evaluate(test)
        rank0_print("inference metrics:", metrics)
        return metrics
    t0 = time.time()
    summary = trainer.fit(train, lambda: test)
    if args.print_wall_time:
        rank0_print(f"Total wall time: {time.time() - t0:.2f} s")
    return summary


if __name__ == "__main__":
    main()
