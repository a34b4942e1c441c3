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
``--inference-only``). The embedding variants: ``--qr-flag`` (QR
tables, ``--qr-threshold`` / ``--qr-collisions`` / ``--qr-operation``),
``--md-flag`` (mixed dims from ``md_solver`` at ``--md-temperature``,
``--md-round-dims``, for tables over ``--md-threshold``) and
``--weighted-pooling fixed|learned``. ``--load-processed DIR`` trains on a
processed dataset written by ``python -m dlrm_yx_tpu_torch.data.processed``
(its tables' rows and dims from ``DIR/table_configs.json``, its batches
from ``DIR/data.npz``). The flags keep the JAX package's names, defaults
and meaning; one flag is new, ``--device`` (``cuda`` by default; ``cpu``
for the tests). ``--inference-only`` with ``--quantize-emb-with-bit 4|8``
and / or ``--quantize-mlp-with-bit 8|16`` serves from quantized tables
(int4 / int8; 8 when only the towers are quantized) and int8 / fp16 towers
(``ops/quantized.py``). ``--debug-mode`` prints the model and its
parameters before and after training (``--print-precision`` digits);
``--enable-profiling`` writes a ``torch.profiler`` Chrome trace of the run
and its counter deltas into ``--profile-out-dir``
(``utils.profiling.trace``); ``--collect-execution-graph`` (or
``--plot-compute-graph``) writes the execution trace of one eager train
step there; ``--save-onnx`` exports the inference forward with
``torch.export`` to ``<--save-model>/dlrm_torch.pt2`` (``export.py``). The
mesh flags keep the JAX CLI's meaning: with --mesh-data > 1 or
--mesh-model > 1 a runner shards the tables over a world of one process a
device (``--distributed`` joins the launcher's world, NCCL on the card,
gloo on the CPU; ``--force-cpu-devices N`` starts N CPU ranks on this host
and returns rank 0's result): ``parallel.hybrid.HybridRunner`` places whole
tables (``--shard-mode table``), ``parallel.row_sharded.RowShardedRunner``
splits the big tables' rows (``row``) and
``parallel.col_sharded.ColShardedRunner`` their columns (``col``); with a
runner, --collect-execution-graph traces one eager sharded step on copies
of the params, and --debug-mode fails as the JAX CLI's does.
DLRM-DCNv2 (MLPerf Training's recommendation model since v3.0):
``--arch-interaction-op=dcn`` with ``--dcn-num-layers`` and
``--dcn-low-rank-dim``, and fixed multi-hot bags with
``--multi-hot-sizes`` (random data draws bags of those sizes); they train
and serve on one device (the mesh runners, export and quantized serving
refuse them). HSTU (``--model=hstu`` with the ``--hstu-*`` flags: ``models/hstu.py``;
row-wise Adagrad on its table, AdamW on its dense leaves) trains on one
device from random jagged histories, with no eval (``refuse_for_hstu``
lists what it refuses). ``--print-time``
and the reference-compat flags of ``add_noop_flags`` are accepted and have
no effect, as in the JAX CLI.
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
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import (
    DLRMConfig,
    HSTUConfig,
    parse_int_list,
    refuse_dcn_and_bags,
)
from dlrm_yx_tpu_torch.data.criteo import (
    CriteoNpzLoader,
    preprocess_criteo,
    split_kaggle_train_txt,
)
from dlrm_yx_tpu_torch.data.criteo_bin import CriteoBinLoader
from dlrm_yx_tpu_torch.data.processed import load_processed, load_table_configs
from dlrm_yx_tpu_torch.data.synthetic import (
    RandomDataConfig,
    make_device_random_batches,
    make_random_batches,
    make_sequence_batches,
)
from dlrm_yx_tpu_torch.data.trace import make_trace_batches
from dlrm_yx_tpu_torch.export import collect_execution_graph, export_inference
from dlrm_yx_tpu_torch.models.dlrm import model_groups
from dlrm_yx_tpu_torch.ops.md_embedding import md_solver
from dlrm_yx_tpu_torch.ops.quantized import (
    make_fully_quantized_eval_step,
    quantize_mlp,
    quantize_model_embeddings,
)
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
from dlrm_yx_tpu_torch.parallel.col_sharded import ColShardedRunner
from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner
from dlrm_yx_tpu_torch.parallel.multihost import init_multihost, local_device, spawn_local
from dlrm_yx_tpu_torch.parallel.row_sharded import RowShardedRunner
from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.logging import is_rank0, rank0_print
from dlrm_yx_tpu_torch.utils.profiling import trace

# where a rank of a --force-cpu-devices world writes its result (rank 0)
RESULT_ENV = "DLRM_TORCH_RESULT_FILE"
# --data-generation values ported (all of the JAX CLI's)
DATA_GENERATIONS = ("random", "random-device", "synthetic", "dataset", "processed")


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
    p.add_argument("--arch-interaction-op", type=str, choices=["dot", "cat", "dcn"],
                   default="dot", help="dcn = DLRM-DCNv2's low-rank cross network")
    p.add_argument("--arch-interaction-itself", action="store_true", default=False)
    p.add_argument("--dcn-num-layers", type=int, default=3,
                   help="cross layers of --arch-interaction-op=dcn")
    p.add_argument("--dcn-low-rank-dim", type=int, default=512,
                   help="rank of each cross layer of --arch-interaction-op=dcn")
    p.add_argument("--multi-hot-sizes", type=str, default="",
                   help="dash-separated fixed bag size of each table (DLRM-DCNv2's "
                        "multi-hot ids); random data then draws bags of these sizes")
    p.add_argument("--model", type=str, default="dlrm", choices=["dlrm", "hstu"],
                   help="hstu = the generative recommender's sequential transducer "
                        "(the --hstu-* flags; random jagged histories)")
    p.add_argument("--hstu-num-items", type=int, default=1000)
    p.add_argument("--hstu-embedding-dim", type=int, default=512)
    p.add_argument("--hstu-num-heads", type=int, default=4)
    p.add_argument("--hstu-attention-dim", type=int, default=128, help="dqk a head")
    p.add_argument("--hstu-linear-dim", type=int, default=128, help="dv a head")
    p.add_argument("--hstu-num-blocks", type=int, default=8)
    p.add_argument("--hstu-max-seq-len", type=int, default=8192)
    p.add_argument("--hstu-num-negatives", type=int, default=128)
    p.add_argument("--hstu-temperature", type=float, default=0.05)
    p.add_argument("--hstu-tokens-per-batch", type=int, default=32768,
                   help="the tokens of a batch: whole histories packed, the last cut")
    p.add_argument("--hstu-max-sequences", type=int, default=160,
                   help="the histories of a batch are padded to this bound")
    p.add_argument("--weighted-pooling", type=str, default=None,
                   help="fixed | learned: per-row pooling weights v_W")
    # embedding compression
    p.add_argument("--md-flag", action="store_true", default=False)
    p.add_argument("--md-threshold", type=int, default=200)
    p.add_argument("--md-temperature", type=float, default=0.3)
    p.add_argument("--md-round-dims", action="store_true", default=False)
    p.add_argument("--qr-flag", action="store_true", default=False)
    p.add_argument("--qr-threshold", type=int, default=200)
    p.add_argument("--qr-operation", type=str, default="mult")
    p.add_argument("--qr-collisions", type=int, default=4)
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
                        "dataset (Criteo) | processed (--load-processed)")
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
    p.add_argument("--load-processed", type=str, default="",
                   help="a processed dataset's directory (table_configs.json, "
                        "data.npz): the model's tables and the batches")
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
    p.add_argument("--print-precision", type=int, default=5)
    # debugging and profiling
    p.add_argument("--debug-mode", action="store_true", default=False)
    p.add_argument("--enable-profiling", action="store_true", default=False)
    p.add_argument("--profile-out-dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "dlrm_tpu_trace"))
    p.add_argument("--plot-compute-graph", action="store_true", default=False)
    p.add_argument("--collect-execution-graph", action="store_true", default=False)
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
    p.add_argument("--save-onnx", action="store_true", default=False,
                   help="export the inference forward (torch.export) to "
                        "<--save-model>/dlrm_torch.pt2 after training")
    # quantize (--inference-only)
    p.add_argument("--quantize-mlp-with-bit", type=int, default=32)
    p.add_argument("--quantize-emb-with-bit", type=int, default=32)
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
    # parallelism: one process per device (parallel/); the JAX CLI's types
    # and defaults
    p.add_argument("--force-cpu-devices", type=int, default=0,
                   help="run N CPU ranks on this host (a gloo world on localhost, "
                        "each rank one process; rank 0's result is returned)")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="join a multi-process world before building the mesh (reads "
                        "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID or torchrun-style "
                        "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT envs; auto-enabled when "
                        "COORDINATOR_ADDRESS is set); NCCL on the card, gloo on the CPU")
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data-parallel mesh axis size")
    p.add_argument("--mesh-model", type=int, default=0,
                   help="model-parallel (table-sharding) axis size; 0 = all devices")
    p.add_argument("--shard-mode", type=str, default="table",
                   choices=["table", "row", "col"],
                   help="embedding sharding over 'model': whole tables "
                        "(reference parity), row slices, or column slices")
    p.add_argument("--sharder", type=str, default="naive",
                   help="naive | naive_chunk | greedy | hardcode | input")
    p.add_argument("--allocation", type=str, default="",
                   help="comma/dash-separated table->device ids for --sharder=input")
    add_noop_flags(p)
    return p


def uses_mesh(args) -> bool:
    """The JAX CLI builds a mesh only for --mesh-data > 1 or --mesh-model > 1."""
    return args.mesh_data > 1 or args.mesh_model > 1


def check_ported(args) -> None:
    """Raise on an option whose part is not ported yet, before any process
    starts."""
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


def hstu_config(args) -> HSTUConfig:
    """The HSTU configuration of the --hstu-* flags and --compute-dtype."""
    return HSTUConfig(
        num_items=args.hstu_num_items, embedding_dim=args.hstu_embedding_dim,
        num_heads=args.hstu_num_heads, attention_dim=args.hstu_attention_dim,
        linear_dim=args.hstu_linear_dim, num_blocks=args.hstu_num_blocks,
        max_seq_len=args.hstu_max_seq_len, num_negatives=args.hstu_num_negatives,
        temperature=args.hstu_temperature, tokens_per_batch=args.hstu_tokens_per_batch,
        max_sequences=args.hstu_max_sequences, compute_dtype=args.compute_dtype)


def config_from_args(args, argv=None) -> DLRMConfig:
    if args.model == "hstu":
        return hstu_config(args)
    kw = dict(
        ln_bot=parse_int_list(args.arch_mlp_bot),
        ln_top=parse_int_list(args.arch_mlp_top),
        qr_flag=args.qr_flag,
        qr_threshold=args.qr_threshold,
        qr_collisions=args.qr_collisions,
        qr_operation=args.qr_operation,
        md_flag=args.md_flag,
        md_threshold=args.md_threshold,
        weighted_pooling=args.weighted_pooling,
        interaction=args.arch_interaction_op,
        interact_itself=args.arch_interaction_itself,
        loss=args.loss_function,
        loss_threshold=args.loss_threshold,
        wbce_weights=tuple(float(x) for x in args.loss_weights.split("-")),
        compute_dtype=args.compute_dtype,
        emb_dtype=args.emb_dtype,
        stochastic_rounding=args.stochastic_rounding,
        lookup_impl=args.lookup_impl,
        interaction_impl=args.interaction_impl,
        sparse_update_impl=args.sparse_update_impl,
        exact_row_momentum=args.exact_row_momentum,
        emb_split_threshold=args.emb_split_threshold,
        dcn_num_layers=args.dcn_num_layers,
        dcn_low_rank_dim=args.dcn_low_rank_dim,
        multi_hot_sizes=parse_int_list(args.multi_hot_sizes) if args.multi_hot_sizes else (),
    )
    if args.load_processed:
        # the dataset's table_configs.json gives the rows and per-table dims
        # (k*D through the split trick; sub-D dims through the MD
        # up-projection with --md-flag), as in the JAX CLI, whose branch
        # also leaves --no-write-only-update out
        tcs = load_table_configs(args.load_processed)["tables"]
        return DLRMConfig.build(emb_rows=[int(tc["row"]) for tc in tcs],
                                emb_dims=tuple(int(tc["dim"]) for tc in tcs), **kw)
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
    emb_dims = ()
    if args.md_flag:
        md_dims = md_solver(np.array(rows), args.md_temperature,
                            d0=args.arch_sparse_feature_size,
                            round_dim=args.md_round_dims).tolist()
        # MD dims apply only above the threshold; smaller tables keep the
        # base dim (dlrm_s_pytorch.py:291-293)
        emb_dims = tuple(int(md_dims[i]) if rows[i] > args.md_threshold
                         else args.arch_sparse_feature_size for i in range(len(rows)))
    return DLRMConfig.build(emb_rows=rows, emb_dims=emb_dims,
                            write_only_update=not args.no_write_only_update, **kw)


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
    there: ROADMAP Queue C). A processed dataset (``--load-processed`` or
    ``--data-generation processed``) serves its saved batches as both, and
    exits, as the JAX CLI does, when its files disagree with each other or
    with the model's rows."""
    if args.data_generation == "processed" or args.load_processed:
        # --load-processed overrides --data-generation: the saved batches
        # are the dataset, train and test alike (dlrm_s_pytorch.py:1405-1414)
        tc, batches = load_processed(args.load_processed)
        if batches and batches[0].indices.shape[0] != cfg.num_tables:
            sys.exit(
                f"ERROR: processed data has {batches[0].indices.shape[0]} "
                f"tables but the model was built with {cfg.num_tables} "
                "(table_configs.json and data.npz disagree)"
            )
        tc_rows = tuple(int(t["row"]) for t in tc["tables"])
        if tuple(cfg.emb_rows) != tc_rows:
            sys.exit(
                f"ERROR: model table rows {tuple(cfg.emb_rows)} != "
                f"table_configs.json rows {tc_rows} — a stale or "
                "hand-specified --arch-embedding-size would silently clamp "
                "out-of-range indices; rebuild the arch from the dataset "
                "(omit --arch-embedding-size with --load-processed)"
            )
        return (batches if train else None), batches
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
            if cfg.multi_hot_sizes:  # bag slots: one id each, every one live
                return make_device_random_batches(
                    [cfg.emb_rows[t] for t in cfg.slot_tables], cfg.ln_bot[0],
                    args.mini_batch_size, nb, 1, True, bool(args.round_targets), seed,
                    resolve_device(args.device))
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
        multi_hot_sizes=cfg.multi_hot_sizes,
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
        b0 = _first_batch(train)
    except (IndexError, StopIteration):  # no batch
        return None
    idx = torch.as_tensor(b0.indices).cpu().numpy()  # [T, B, L], or bags [S, B, 1]
    thr = cfg.emb_split_threshold or 0
    big = [t for t, n in enumerate(cfg.emb_rows) if not thr or n > thr]
    if not big:
        return None
    if cfg.multi_hot_sizes:  # each table's ids over its bag slots
        slots = np.asarray(cfg.slot_tables)
        per_table = [idx[slots == t] for t in big]
    else:
        per_table = [idx[t] for t in big]
    uniq = sum(len(np.unique(a)) for a in per_table)
    total = sum(a.size for a in per_table)
    return max(1e-3, min(1.0, uniq / max(total, 1)))


def debug_print_model(cfg: DLRMConfig, params, precision: int = 5) -> None:
    """--debug-mode: the model's arch and its parameters, as the JAX CLI
    prints them (the reference's golden printout, dlrm_s_pytorch.py:
    1519-1571): each group's logical store, then each layer's W.T and b."""
    np.set_printoptions(precision=precision)
    print("model arch:")
    print(f"mlp top arch {len(cfg.ln_top)-1} layers, with input to output "
          f"dimensions: {np.array(cfg.ln_top)}")
    print(f"# of interactions: {cfg.num_interactions}")
    print(f"mlp bot arch {len(cfg.ln_bot)-1} layers, with input to output "
          f"dimensions: {np.array(cfg.ln_bot)}")
    print(f"# of features (sparse and dense): {cfg.num_features}")
    print(f"dense feature size: {cfg.ln_bot[0]}")
    print(f"sparse feature size: {cfg.base_dim}")
    print(f"# of embeddings (= # of sparse features) {cfg.num_tables}, with "
          f"dimensions {cfg.base_dim}x: {np.array(cfg.emb_rows)}")
    groups = model_groups(cfg)
    print("initial parameters (weights and bias):")
    for i, store in enumerate(params["emb"]):
        print(logical_rows(store, groups[i]))
    for k in ("bot", "top"):
        for w, b in params[k]:
            print(w.detach().cpu().numpy().T)
            print(b.detach().cpu().numpy())


def logical_rows(store: torch.Tensor, group) -> np.ndarray:
    """A group store's [total_rows, dim] rows as numpy, read as the JAX CLI
    reads them (``unpack_store``: a reshape, a TypeError on a store of
    another size, as a mesh runner's sharded ``emb`` is)."""
    a = store.detach().float().cpu().numpy()
    shape = (group.total_rows, group.dim)
    if a.size != shape[0] * shape[1]:
        raise TypeError(f"cannot reshape array of shape {a.shape} (size {a.size}) into shape "
                        f"{shape} (size {shape[0] * shape[1]})")
    return a.reshape(shape)


def quantized_inference(args, cfg: DLRMConfig, trainer: Trainer, test_batches) -> dict:
    """--inference-only with --quantize-emb-with-bit / --quantize-mlp-with-bit
    (the JAX CLI's ``_quantized_inference``): tables at 4 or 8 bits (8 when
    only the towers are quantized), towers int8 (8) or fp16 (16), the
    accuracy of the rounded predictions."""
    refuse_dcn_and_bags(cfg, "quantized serving")
    bits = args.quantize_emb_with_bit if args.quantize_emb_with_bit in (4, 8) else 8
    # a mesh runner's shards are gathered into the single-device layout first
    params = trainer.runner.single_device_params(trainer.params)
    qstores = quantize_model_embeddings(params, trainer.groups, bits)
    qbot = qtop = None
    if args.quantize_mlp_with_bit in (8, 16):
        mode = "int8" if args.quantize_mlp_with_bit == 8 else "fp16"
        qbot = quantize_mlp(params["bot"], mode)
        qtop = quantize_mlp(params["top"], mode)
    ev = make_fully_quantized_eval_step(cfg, trainer.groups, qstores, qbot, qtop,
                                        trainer.device)
    n_correct = n_total = 0
    for b in test_batches:
        preds = ev(params, b).cpu().numpy().ravel()
        t = torch.as_tensor(b.labels).cpu().numpy().ravel()
        n_correct += int(((preds >= 0.5) == (t > 0.5)).sum())
        n_total += len(t)
    return {"accuracy": n_correct / max(n_total, 1), "quantized": True}


def _first_batch(train):
    return train[0] if hasattr(train, "__getitem__") else next(iter(train))


def _copies(tree):
    """A copy of every tensor of a params or optimizer-state tree."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copies(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copies(v) for v in tree)
    return tree


def run_forced_world(argv, n: int) -> dict:
    """--force-cpu-devices N: the command line run as ranks 0..N-1 of a gloo
    world of CPU processes on this host (``parallel.multihost.spawn_local``),
    each with --distributed --device cpu; returns rank 0's result. (JAX
    simulates N devices in one process; a torch world is processes.)"""
    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        env = dict(os.environ, **{RESULT_ENV: result})
        spawn_local(["-m", "dlrm_yx_tpu_torch.cli"] + argv
                    + ["--force-cpu-devices", "0", "--distributed", "--device", "cpu"],
                    n, env=env)
        with open(result) as f:
            return json.load(f)


def main(argv=None):
    """Trains (and evaluates at the end of each epoch, or every
    --test-freq iterations) and returns the last eval's metrics; with
    --inference-only evaluates the initial (or loaded) model and returns
    its metrics. With --distributed (or COORDINATOR_ADDRESS) it joins the
    world first; with --force-cpu-devices N it starts a world of N CPU
    ranks and returns rank 0's result."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    if args.force_cpu_devices > 1:
        return run_forced_world(argv, args.force_cpu_devices)
    if args.force_cpu_devices == 1:
        args.device = "cpu"  # a world of one rank is this process
    joined = False
    if args.distributed or os.environ.get("COORDINATOR_ADDRESS"):
        # a world the caller set up stays up after the run; one joined here goes
        ours = not torch.distributed.is_initialized()
        pid, num = init_multihost(device=args.device)
        if num > 1:
            joined = ours
            args.device = str(local_device(args.device))
            rank0_print(f"multihost: process {pid}/{num}, {num} global devices")
    try:
        summary = _run(args, argv)
        if os.environ.get(RESULT_ENV) and is_rank0():
            with open(os.environ[RESULT_ENV], "w") as f:
                json.dump(summary, f)
        return summary
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def make_runner(args, cfg: DLRMConfig, opt: OptConfig, lr_policy):
    """The mesh runner of --shard-mode (``dlrm_yx_tpu/cli.py:593-633``)."""
    kw = dict(data=args.mesh_data, model=args.mesh_model or None, lr_fn=lr_policy,
              seed=args.numpy_rand_seed, n_accum=max(1, args.mlperf_grad_accum_iter),
              device=args.device)
    if args.shard_mode == "row":
        runner = RowShardedRunner(cfg, opt, **kw)
    elif args.shard_mode == "col":
        runner = ColShardedRunner(cfg, opt, **kw)
    else:
        allocation = ([int(x) for x in args.allocation.replace(",", "-").split("-")]
                      if args.allocation else None)
        runner = HybridRunner(cfg, opt, sharder=args.sharder, allocation=allocation, **kw)
    rank0_print(f"{args.shard_mode}-sharded mesh {dict(runner.mesh.shape)}"
                + (f", sharder={args.sharder}" if args.shard_mode == "table" else ""))
    return runner


# what an HSTU run refuses: (flag, its value when it is off)
HSTU_REFUSED = (("inference_only", False), ("save_onnx", False), ("debug_mode", False),
                ("collect_execution_graph", False), ("plot_compute_graph", False),
                ("save_model", ""), ("load_model", ""), ("mlperf_grad_accum_iter", 1),
                ("quantize_emb_with_bit", 32), ("quantize_mlp_with_bit", 32))


def refuse_for_hstu(args) -> None:
    """Raise on an option an HSTU run has not got: serving, export,
    checkpoints, the debug printout and execution graph, accumulation, data
    other than random histories."""
    on = [name for name, off in HSTU_REFUSED if getattr(args, name) != off]
    if args.data_generation != "random":
        on.append(f"data_generation={args.data_generation}")
    if on:
        raise NotImplementedError(
            f"HSTU trains on one device from random histories; not ported for it: "
            f"{', '.join('--' + n.replace('_', '-') for n in on)}")


def _run(args, argv):
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
    if args.save_onnx:
        refuse_dcn_and_bags(cfg, "--save-onnx export")  # before training, not after
    if isinstance(cfg, HSTUConfig):
        return _run_hstu(args, cfg, opt, lr_policy, tcfg)
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
    trainer = Trainer(cfg, opt, tcfg, lr_policy, device=args.device,
                      runner=make_runner(args, cfg, opt, lr_policy) if uses_mesh(args) else None)
    runner = trainer.runner
    if args.debug_mode:
        debug_print_model(cfg, trainer.params, args.print_precision)
    if args.inference_only:
        if args.quantize_emb_with_bit in (4, 8) or args.quantize_mlp_with_bit in (8, 16):
            metrics = quantized_inference(args, cfg, trainer, test)
        else:
            metrics = trainer.evaluate(test)
        rank0_print("inference metrics:", metrics)
        return metrics
    if args.plot_compute_graph or args.collect_execution_graph:
        # one eager step on copies of the params and optimizer state: the
        # JAX CLI only traces (or lowers) its step, so the run trains from
        # the same state. With a mesh runner every rank runs the sharded step
        # (its collectives) and writes its own trace.
        arts = collect_execution_graph(
            runner.eager_step(), (_copies(trainer.params), _copies(trainer.opt_state),
                                  runner.prepare_batch(_first_batch(train)), 0),
            args.profile_out_dir, runner.graph_name)
        rank0_print(f"execution graph artifacts: {arts}")
    t0 = time.time()
    if args.enable_profiling:
        with trace(args.profile_out_dir):
            summary = trainer.fit(train, lambda: test)
        rank0_print(f"profiler trace written to {args.profile_out_dir}")
    else:
        summary = trainer.fit(train, lambda: test)
    if args.print_wall_time:
        rank0_print(f"Total wall time: {time.time() - t0:.2f} s")
    if args.debug_mode:
        print("updated parameters (weights and bias):")
        debug_print_model(cfg, trainer.params, args.print_precision)
    if args.save_onnx:
        out_dir = args.save_model or "."
        out = os.path.join(out_dir, "dlrm_torch.pt2")
        # a mesh runner's shards gathered into the single-device layout
        # (every rank takes part; rank 0 writes)
        params = runner.single_device_params(trainer.params)
        if is_rank0():
            os.makedirs(out_dir, exist_ok=True)
            export_inference(params, cfg, _first_batch(train), out)
        rank0_print(f"saved the exported model to {out}")
    return summary


def _run_hstu(args, cfg: HSTUConfig, opt: OptConfig, lr_policy, tcfg: TrainerConfig) -> dict:
    """Train HSTU through ``Trainer.fit`` (one device, no eval) on random
    histories; returns ``{"iterations": ...}``."""
    refuse_for_hstu(args)
    nb = args.num_batches or 1
    train = make_sequence_batches(cfg, nb, seed=args.numpy_rand_seed)
    trainer = Trainer(cfg, opt, tcfg, lr_policy, device=args.device,
                      runner=make_runner(args, cfg, opt, lr_policy) if uses_mesh(args) else None)
    t0 = time.time()
    if args.enable_profiling:
        with trace(args.profile_out_dir):
            trainer.fit(train)
        rank0_print(f"profiler trace written to {args.profile_out_dir}")
    else:
        trainer.fit(train)
    if args.print_wall_time:
        rank0_print(f"Total wall time: {time.time() - t0:.2f} s")
    return {"iterations": trainer.iteration}


if __name__ == "__main__":
    main()
