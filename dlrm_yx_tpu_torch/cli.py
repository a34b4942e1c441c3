"""Command-line entry point: serve a DLRM over random data.

The port of the ``--inference-only`` path of ``dlrm_yx_tpu/cli.py``. The
flags keep the JAX package's names, defaults and meaning; one flag is new,
``--device`` (``cuda`` by default; ``cpu`` for the tests). Flags of parts not
yet ported are still recognised, and giving any of them raises
``NotImplementedError`` instead of being ignored; so does a run without
``--inference-only`` (training is not ported yet).

    python -m dlrm_yx_tpu_torch.cli --inference-only \
        --arch-embedding-size 1000-1000 --arch-sparse-feature-size 128 \
        --arch-mlp-bot 13-256-128 --arch-mlp-top 64-1 \
        --mini-batch-size 2048 --num-batches 4 --num-indices-per-lookup 1 \
        --interaction-impl pallas --compute-dtype bfloat16
"""

from __future__ import annotations

import argparse

import numpy as np

from dlrm_yx_tpu_torch.config import DLRMConfig, parse_int_list
from dlrm_yx_tpu_torch.data.synthetic import RandomDataConfig, make_random_batches
from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig
from dlrm_yx_tpu_torch.utils.logging import rank0_print

# flags of dlrm_yx_tpu/cli.py whose parts are not ported yet
UNPORTED_FLAGS = (
    "weighted-pooling", "md-flag", "md-threshold", "md-temperature",
    "md-round-dims", "qr-flag", "qr-threshold", "qr-operation",
    "qr-collisions", "activation-function", "data-trace-file", "data-set",
    "raw-data-file", "processed-data-file", "load-processed",
    "data-randomize", "data-trace-enable-padding", "max-ind-range",
    "data-sub-sample-rate", "num-workers", "memory-map", "mlperf-bin-loader",
    "mlperf-bin-shuffle", "nepochs", "learning-rate", "print-precision",
    "optimizer", "dataset-multiprocessing", "use-tpu", "force-cpu-devices",
    "use-gpu", "distributed", "mesh-data", "mesh-model", "shard-mode",
    "sharder", "allocation", "sparse-update-impl", "exact-row-momentum",
    "no-write-only-update", "stochastic-rounding", "debug-mode",
    "enable-profiling", "profile-out-dir", "plot-compute-graph",
    "tensor-board-filename", "save-model", "load-model", "ckpt-backend",
    "save-onnx", "mlperf-acc-threshold", "mlperf-auc-threshold",
    "mlperf-grad-accum-iter", "quantize-mlp-with-bit", "quantize-emb-with-bit",
    "lr-num-warmup-steps", "lr-decay-start-step", "lr-num-decay-steps",
    "batched-emb", "fbgemm-emb", "sync-dense-params", "bucket-size-mb",
    "dist-backend", "local-rank", "pin-memory", "early-barrier",
    "aggregated-allreduce", "test-num-workers", "collect-execution-graph",
    "print-freq", "test-freq", "steps-per-dispatch", "prefetch-depth",
    "test-mini-batch-size", "print-time", "print-wall-time",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve a Deep Learning Recommendation Model (DLRM) on a GPU"
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
    p.add_argument("--data-generation", type=str, default="random")
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
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises when absent) or cpu")
    # mlperf
    p.add_argument("--inference-only", action="store_true", default=False)
    p.add_argument("--mlperf-logging", action="store_true", default=False)
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
    if not args.inference_only:
        raise NotImplementedError(
            "training is not yet ported to dlrm_yx_tpu_torch: pass --inference-only"
        )
    if args.data_generation != "random":
        raise NotImplementedError(
            f"--data-generation={args.data_generation} is not yet ported "
            "(random only)"
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
        lookup_impl=args.lookup_impl,
        interaction_impl=args.interaction_impl,
        emb_split_threshold=args.emb_split_threshold,
    )


def make_data(args, cfg: DLRMConfig):
    """The eval batches: the JAX CLI's random test set (seed + 1)."""
    nb = args.num_batches or int(np.ceil(args.data_size / args.mini_batch_size))
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
    return make_random_batches(dc, seed=args.numpy_rand_seed + 1)


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    cfg = config_from_args(args)
    tcfg = TrainerConfig(mlperf_logging=args.mlperf_logging, seed=args.numpy_rand_seed)
    trainer = Trainer(cfg, tcfg, device=args.device)
    metrics = trainer.evaluate(make_data(args, cfg))
    rank0_print("inference metrics:", metrics)
    return metrics


if __name__ == "__main__":
    main()
