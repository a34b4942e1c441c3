"""Command-line entry point: train or serve a DLRM over random data.

The port of the single-device training and ``--inference-only`` paths of
``dlrm_yx_tpu/cli.py``. The flags keep the JAX package's names, defaults
and meaning; one flag is new, ``--device`` (``cuda`` by default; ``cpu``
for the tests). Flags of parts not yet ported are still recognised, and
giving any of them raises ``NotImplementedError`` instead of being
ignored. ``--print-time`` and the reference-compat flags of
``add_noop_flags`` are accepted and have no effect, as in the JAX CLI.
The reference's L=100 throughput benchmark
(``bench/dlrm_tpu_benchmark.sh``) runs with ``dlrm_yx_tpu.cli`` replaced by
``dlrm_yx_tpu_torch.cli``. bf16 table storage (``--emb-dtype bfloat16``)
takes ``--stochastic-rounding``.

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

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig, parse_int_list
from dlrm_yx_tpu_torch.data.synthetic import (
    RandomDataConfig,
    make_device_random_batches,
    make_random_batches,
)
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.logging import rank0_print

# flags of dlrm_yx_tpu/cli.py whose parts are not ported yet
UNPORTED_FLAGS = (
    "weighted-pooling", "md-flag", "md-threshold", "md-temperature",
    "md-round-dims", "qr-flag", "qr-threshold", "qr-operation",
    "qr-collisions", "data-trace-file", "data-set",
    "raw-data-file", "processed-data-file", "load-processed",
    "data-randomize", "data-trace-enable-padding",
    "data-sub-sample-rate", "memory-map", "mlperf-bin-loader",
    "mlperf-bin-shuffle", "print-precision",
    "dataset-multiprocessing", "force-cpu-devices",
    "distributed", "mesh-data", "mesh-model", "shard-mode",
    "sharder", "allocation", "debug-mode",
    "enable-profiling", "profile-out-dir", "plot-compute-graph",
    "tensor-board-filename", "save-model", "load-model", "ckpt-backend",
    "save-onnx", "mlperf-grad-accum-iter", "quantize-mlp-with-bit",
    "quantize-emb-with-bit", "collect-execution-graph", "steps-per-dispatch",
    "prefetch-depth", "test-mini-batch-size", "print-wall-time",
)


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
    # data (random only)
    p.add_argument("--data-size", type=int, default=1)
    p.add_argument("--num-batches", type=int, default=0)
    p.add_argument("--data-generation", type=str, default="random",
                   help="random (numpy, on the host) or random-device (drawn on "
                        "the device)")
    p.add_argument("--rand-data-dist", type=str, default="uniform")  # or gaussian
    p.add_argument("--rand-data-min", type=float, default=0)
    p.add_argument("--rand-data-max", type=float, default=1)
    p.add_argument("--rand-data-mu", type=float, default=-1)
    p.add_argument("--rand-data-sigma", type=float, default=1)
    p.add_argument("--num-indices-per-lookup", type=int, default=10)
    p.add_argument("--num-indices-per-lookup-fixed", type=bool, default=False)
    p.add_argument("--mini-batch-size", type=int, default=1)
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
                   help="caps table rows in dataset mode, as in the JAX CLI; "
                        "random data takes --arch-embedding-size as it is")
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
    p.add_argument("--test-freq", type=int, default=-1)
    # mlperf
    p.add_argument("--inference-only", action="store_true", default=False)
    p.add_argument("--mlperf-logging", action="store_true", default=False)
    p.add_argument("--mlperf-acc-threshold", type=float, default=0.0)
    p.add_argument("--mlperf-auc-threshold", type=float, default=0.0)
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
    if args.data_generation not in ("random", "random-device"):
        raise NotImplementedError(
            f"--data-generation={args.data_generation} is not yet ported "
            "(random and random-device only)"
        )


def config_from_args(args) -> DLRMConfig:
    return DLRMConfig.build(
        emb_rows=parse_int_list(args.arch_embedding_size),
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


def make_data(args, cfg: DLRMConfig, train: bool = True):
    """The JAX CLI's random batches: (train, test), test drawn with
    seed + 1; without ``train`` only the test batches are drawn (train is
    None). ``random-device`` batches are drawn on ``--device``."""
    nb = args.num_batches or int(np.ceil(args.data_size / args.mini_batch_size))
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
    routing (``config.dup_density_hint``). None when there is no big table
    or no batch. A batch drawn on the device is copied to the host once."""
    if not train:
        return None
    idx = torch.as_tensor(train[0].indices).cpu().numpy()  # [T, B, L]
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
    cfg = config_from_args(args)
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
        seed=args.numpy_rand_seed,
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
    return trainer.fit(train, lambda: test)


if __name__ == "__main__":
    main()
