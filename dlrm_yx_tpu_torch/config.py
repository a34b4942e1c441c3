"""Model/architecture configuration.

The port's own copy of ``dlrm_yx_tpu/config.py`` (standard library only), so
that one ``DLRMConfig`` describes the same model in both packages. The
arch-consistency checks mirror the reference's ``dlrm_s_pytorch.py:1443-1507``
(``ln_top[0] = F*(F-1)/2 [+F] + D``; ``F*D`` for ``cat`` and ``dcn``). The
port's own additions, which the JAX package has not: the ``dcn``
interaction (DLRM-DCNv2's low-rank cross network, ``ops/dcn.py``) and
fixed multi-hot bags (``multi_hot_sizes``). The training path reads the update
fields (``sparse_update_impl``, ``exact_row_momentum``,
``write_only_update``, ``dup_density_hint``, ``stochastic_rounding``) as
the JAX package does; ``lookup_impl`` is kept so a config compares field
for field, and both of its values take the same gather.

``HSTUConfig`` describes the port's other model family, HSTU, the
generative recommender's sequential transducer (``models/hstu.py``); the
paths that run DLRM only refuse it with ``refuse_dcn_and_bags``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def parse_int_list(s: str) -> Tuple[int, ...]:
    """Parse a dash-separated int list, e.g. '13-512-256-64' (the reference's
    --arch-mlp-bot/--arch-embedding-size flag format, dlrm_s_pytorch.py:992)."""
    return tuple(int(x) for x in s.split("-"))


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Architecture of one DLRM.

    Attributes:
      emb_rows: rows per embedding table, canonical table order
        (--arch-embedding-size).
      emb_dims: per-table embedding dim. A table whose dim is k*D (with
        D = ln_bot[-1]) contributes k feature slots to the interaction
        (the reference's "split trick", dlrm_s_pytorch.py:579-585).
      ln_bot: bottom MLP layer sizes, ln_bot[0] = num dense features.
      ln_top: top MLP layer sizes, ln_top[-1] = 1.
      interaction: 'dot', 'cat' or 'dcn' (--arch-interaction-op). 'dcn'
        is DLRM-DCNv2's: the concatenated features [B, F*D] through
        ``dcn_num_layers`` low-rank cross layers of rank
        ``dcn_low_rank_dim`` (TorchRec's ``LowRankCrossNet``), then the
        top MLP.
      interact_itself: include self-interaction diagonal
        (--arch-interaction-itself → tril offset 0 instead of -1).
      sigmoid_bot / sigmoid_top: index of the layer whose activation is
      sigmoid instead of relu (-1 = none; top default = last layer).
      loss: 'bce' | 'mse' | 'wbce'.
      loss_threshold: clamp predictions to [thr, 1-thr] before the loss
        when > 0 (dlrm_s_pytorch.py:722-728).
      wbce_weights: (w_neg, w_pos) per-class loss weights for 'wbce'.
      weighted_pooling: None | 'fixed' | 'learned' per-sample pooling
        weights v_W (dlrm_s_pytorch.py:308-316).
      compute_dtype: 'float32' or 'bfloat16' for MLP/interaction compute
        (params always stored fp32; bf16 rides the MXU).
      multi_hot_sizes: per table, the fixed number of ids of its bag (the
        MLPerf DLRM-DCNv2 reference's ``--multi_hot_sizes``), or () for
        the ``[T, B, L]`` layout. A batch then holds the bags as
        ``[sum(multi_hot_sizes), B, 1]`` slots, table by table, every id
        live (see ``ops/embedding.bag_slots``).
    """

    emb_rows: Tuple[int, ...]
    ln_bot: Tuple[int, ...]
    ln_top: Tuple[int, ...]
    emb_dims: Tuple[int, ...] = ()
    interaction: str = "dot"
    interact_itself: bool = False
    sigmoid_bot: int = -1
    sigmoid_top: int = -2  # sentinel: resolved to len(ln_top)-2 in __post_init__
    loss: str = "bce"
    loss_threshold: float = 0.0
    wbce_weights: Tuple[float, float] = (1.0, 1.0)
    weighted_pooling: Optional[str] = None
    compute_dtype: str = "float32"
    # embedding table STORAGE dtype: 'float32' or 'bfloat16'. bf16 halves
    # HBM footprint and gather bandwidth (the MLPerf 40M-ind-range tables
    # fit a single 16 GB chip) — parity with the reference's fp16 fbgemm
    # table storage (SplitTableBatchedEmbeddingBagsCodegen, SURVEY.md §2.3).
    # Updates round to bf16 each step; use fp32 when tiny learning rates
    # must accumulate (the reference's fbgemm path has the same trade,
    # mitigated there by stochastic rounding).
    emb_dtype: str = "float32"
    # stochastic rounding for reduced-precision table updates (the
    # reference kernel's stochastic_rounding flag, dlrm_s_pytorch.py:333):
    # small updates that deterministic bf16 rounding would drop land in
    # expectation. Kernel path only, like the reference.
    stochastic_rounding: bool = False
    # 'xla' = native gather (fastest measured on v5e); 'pallas' = fused DMA
    # kernel (REMOVED round 3 — lost to the XLA gather at every measured
    # L x D; 'pallas' is accepted for flag parity and maps to 'xla')
    lookup_impl: str = "xla"
    # sparse optimizer update path: 'xla' = scatter-add (XLA:TPU rewrites the
    # whole store every step — exact but slow for multi-GB stores); 'pallas'
    # = row-RMW kernel touching only updated rows (~40 ns/row,
    # ops/pallas_sparse_update.py; adagrad-family momentum accumulates
    # per-occurrence on duplicate rows, matching fbgemm's approx-rowwise
    # behavior — identical to 'xla' when rows are unique within a step)
    sparse_update_impl: str = "xla"
    # dot-interaction path: 'pallas' fuses bmm + tril-extract + dense
    # concat into one streamed kernel (ops/pallas_interaction.py) for
    # D % 128 == 0 shapes; 'xla' = einsum + static gather
    interaction_impl: str = "xla"
    # opt-in: pre-coalesce duplicate rows (sort + segment-sum) before the
    # pallas kernel so adagrad-family momentum matches the reference's
    # grad.coalesce() semantics bit-for-bit even on dup-heavy steps
    # (rwsadagrad.py:98); costs a sort in the hot path — off by default
    # because big hashed tables rarely see intra-step duplicates
    exact_row_momentum: bool = False
    # the write-only sparse update (ops/pallas_sparse_update.
    # sparse_rows_overwrite: new = gathered_row + delta, one DMA issue per
    # row instead of the RMW pair) — ablation/debug switch; off forces the
    # row-RMW kernel on the same routing
    write_only_update: bool = True
    # tables with rows <= this go into separate small group stores whose XLA
    # scatter is cheap; bigger tables' stores route through the RMW kernel
    # when sparse_update_impl='pallas' (0 disables splitting)
    emb_split_threshold: int = 65536
    # measured duplicate density of the index stream: the fraction of
    # UNIQUE rows per step among big-table lookups (0 < hint <= 1), or
    # <= 0 when unknown. Drives the dense-vs-kernel update crossover with
    # the stream's REAL density instead of raw occurrence counts: skewed
    # (Zipf/production) streams in the high-L regime coalesce to far fewer
    # unique rows than K, so the coalesce-first kernel path beats the
    # full-store dense rewrite the static rule would pick. The CLI
    # measures this on the first batch (--sparse-update-impl=pallas with
    # --data-generation synthetic/dataset); library users pass it
    # explicitly. Semantics are unchanged — a density-elected kernel route
    # always coalesces first (grad.coalesce() exactness).
    dup_density_hint: float = -1.0
    # QR compositional embeddings for tables with rows > qr_threshold
    # (--qr-flag/--qr-threshold/--qr-collisions/--qr-operation,
    # dlrm_s_pytorch.py:282-290)
    qr_flag: bool = False
    qr_threshold: int = 200
    qr_collisions: int = 4
    qr_operation: str = "mult"
    # Mixed-dimension embeddings: emb_dims may then be below base_dim for
    # tables with rows > md_threshold; those get a linear up-projection
    # (--md-flag/--md-threshold, dlrm_s_pytorch.py:291-299)
    md_flag: bool = False
    md_threshold: int = 200
    # DLRM-DCNv2's cross network (interaction 'dcn'): layers and rank
    dcn_num_layers: int = 3
    dcn_low_rank_dim: int = 512
    # fixed bag size per table (() = the padded [T, B, L] layout)
    multi_hot_sizes: Tuple[int, ...] = ()
    # internal: used by build() to probe arch math without a final ln_top
    _skip_validation: bool = False

    def __post_init__(self):
        if not self.emb_dims:
            # homogeneous dims = bottom MLP output dim
            object.__setattr__(self, "emb_dims", (self.ln_bot[-1],) * len(self.emb_rows))
        if self.sigmoid_top == -2:
            object.__setattr__(self, "sigmoid_top", len(self.ln_top) - 2)
        if not self._skip_validation:
            self.validate()

    # --- derived arch quantities -------------------------------------------------

    @property
    def num_tables(self) -> int:
        return len(self.emb_rows)

    @property
    def base_dim(self) -> int:
        """D: the interaction feature dim = bottom MLP output dim."""
        return self.ln_bot[-1]

    @property
    def qr_table_ids(self) -> Tuple[int, ...]:
        """Tables replaced by QR compositional embeddings."""
        if not self.qr_flag:
            return ()
        return tuple(
            t for t, n in enumerate(self.emb_rows) if n > self.qr_threshold
        )

    @property
    def regular_table_ids(self) -> Tuple[int, ...]:
        qr = set(self.qr_table_ids)
        return tuple(t for t in range(self.num_tables) if t not in qr)

    def is_md_projected(self, t: int) -> bool:
        """Table stored at a reduced dim with an up-projection to base_dim."""
        return (
            self.md_flag
            and self.emb_rows[t] > self.md_threshold
            and self.emb_dims[t] != self.base_dim
        )

    @property
    def md_table_ids(self) -> Tuple[int, ...]:
        return tuple(
            t for t in range(self.num_tables) if self.is_md_projected(t)
        )

    @property
    def slots_per_table(self) -> Tuple[int, ...]:
        """Feature slots contributed per table (dim k*D → k slots; QR-concat
        → 2 slots; MD-projected → 1 slot).

        Mirrors the feature-count math at dlrm_s_pytorch.py:1434-1441."""
        out = []
        qr = set(self.qr_table_ids)
        for t, d in enumerate(self.emb_dims):
            if t in qr:
                out.append(2 if self.qr_operation == "concat" else 1)
            elif self.is_md_projected(t):
                out.append(1)
            else:
                out.append(d // self.base_dim)
        return tuple(out)

    @property
    def num_slots(self) -> int:
        return sum(self.slots_per_table)

    @property
    def num_features(self) -> int:
        """F = sparse slots + 1 dense feature."""
        return self.num_slots + 1

    @property
    def num_interactions(self) -> int:
        f = self.num_features
        offset = 1 if self.interact_itself else 0
        return (f * (f - 1)) // 2 + offset * f

    def expected_top_in(self) -> int:
        if self.interaction == "dot":
            return self.num_interactions + self.base_dim
        elif self.interaction in ("cat", "dcn"):
            return self.num_features * self.base_dim
        raise ValueError(f"unknown interaction {self.interaction!r}")

    @property
    def slot_tables(self) -> Tuple[int, ...]:
        """The table of each bag slot of a multi-hot batch: table t's
        ``multi_hot_sizes[t]`` slots in a row, tables in order."""
        return tuple(t for t, h in enumerate(self.multi_hot_sizes) for _ in range(h))

    def validate(self):
        if self.interaction not in ("dot", "cat", "dcn"):
            raise ValueError(f"interaction must be dot|cat|dcn, got {self.interaction!r}")
        if self.interaction == "dcn" and (self.dcn_num_layers < 1 or self.dcn_low_rank_dim < 1):
            raise ValueError(f"dcn needs at least one layer of rank >= 1, got "
                             f"{self.dcn_num_layers} layers of rank {self.dcn_low_rank_dim}")
        if self.multi_hot_sizes:
            if len(self.multi_hot_sizes) != len(self.emb_rows):
                raise ValueError(f"{len(self.multi_hot_sizes)} multi-hot sizes for "
                                 f"{len(self.emb_rows)} tables")
            if min(self.multi_hot_sizes) < 1:
                raise ValueError(f"multi-hot sizes must be >= 1, got {self.multi_hot_sizes}")
            if self.qr_flag or self.md_flag or self.weighted_pooling is not None:
                raise ValueError("multi-hot bags take plain tables: no QR, MD or weighted "
                                 "pooling")
        if self.loss not in ("bce", "mse", "wbce"):
            raise ValueError(f"loss must be bce|mse|wbce, got {self.loss!r}")
        if len(self.emb_dims) != len(self.emb_rows):
            raise ValueError("emb_dims and emb_rows length mismatch")
        d = self.base_dim
        qr = set(self.qr_table_ids)
        for t, m in enumerate(self.emb_dims):
            if t in qr:
                if m != d:
                    raise ValueError(f"QR table {t} must use base dim {d}, got {m}")
            elif self.is_md_projected(t):
                if m > d:
                    raise ValueError(f"MD table {t} dim {m} exceeds base dim {d}")
            elif m % d != 0:
                raise ValueError(
                    f"table {t} dim {m} not a multiple of bottom MLP out dim {d} "
                    "(required for the interaction split trick)"
                )
        if self.qr_operation not in ("mult", "add", "concat"):
            raise ValueError(f"bad qr_operation {self.qr_operation!r}")
        want = self.expected_top_in()
        if self.ln_top[0] != want:
            raise ValueError(
                f"ln_top[0]={self.ln_top[0]} inconsistent with arch: expected {want} "
                f"(num_features={self.num_features}, D={d}, op={self.interaction})"
            )
        if self.emb_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad emb_dtype {self.emb_dtype!r}")
        if self.weighted_pooling not in (None, "fixed", "learned"):
            raise ValueError(f"bad weighted_pooling {self.weighted_pooling!r}")

    # --- constructors -------------------------------------------------------------

    @staticmethod
    def build(
        emb_rows,
        ln_bot,
        ln_top,
        **kw,
    ) -> "DLRMConfig":
        """Like the constructor, but auto-prepends the computed interaction
        output size to ln_top when the given ln_top omits it (the reference
        CLI instead *checks* and exits, dlrm_s_pytorch.py:1469-1507)."""
        try:
            return DLRMConfig(emb_rows=emb_rows, ln_bot=ln_bot, ln_top=ln_top, **kw)
        except ValueError:
            pass
        probe = DLRMConfig(
            emb_rows=emb_rows, ln_bot=ln_bot, ln_top=(1,), _skip_validation=True, **kw
        )
        want = probe.expected_top_in()
        return DLRMConfig(
            emb_rows=emb_rows, ln_bot=ln_bot, ln_top=(want,) + tuple(ln_top), **kw
        )

    @staticmethod
    def from_flags(
        arch_embedding_size: str,
        arch_mlp_bot: str,
        arch_mlp_top: str,
        arch_sparse_feature_size: int,
        arch_interaction_op: str = "dot",
        arch_interaction_itself: bool = False,
        **kw,
    ) -> "DLRMConfig":
        """Build from the reference's flag strings; auto-completes ln_top[0]/ln_bot
        appendix like dlrm_s_pytorch.py:1443-1460 (the reference *checks* rather
        than completes; we accept either an exact ln_top or one missing its first
        entry)."""
        rows = parse_int_list(arch_embedding_size)
        ln_bot = parse_int_list(arch_mlp_bot)
        if ln_bot[-1] != arch_sparse_feature_size:
            raise ValueError(
                f"arch_sparse_feature_size {arch_sparse_feature_size} != ln_bot[-1] {ln_bot[-1]}"
            )
        ln_top = parse_int_list(arch_mlp_top)
        # compute expected top input to allow ln_top given without its input size
        probe = object.__new__(DLRMConfig)
        object.__setattr__(probe, "emb_rows", rows)
        object.__setattr__(probe, "ln_bot", ln_bot)
        object.__setattr__(probe, "emb_dims", (ln_bot[-1],) * len(rows))
        object.__setattr__(probe, "interaction", arch_interaction_op)
        object.__setattr__(probe, "interact_itself", arch_interaction_itself)
        want = DLRMConfig.expected_top_in(probe)
        if ln_top[0] != want:
            ln_top = (want,) + ln_top
        return DLRMConfig(
            emb_rows=rows,
            ln_bot=ln_bot,
            ln_top=ln_top,
            interaction=arch_interaction_op,
            interact_itself=arch_interaction_itself,
            **kw,
        )

    @staticmethod
    def tiny(seeded: bool = True) -> "DLRMConfig":
        """The reference's tiny debug arch: --arch-embedding-size 4-3-2,
        --arch-mlp-bot 4-3-2, --arch-mlp-top 4-2-1 (README.md:141-146)."""
        return DLRMConfig(
            emb_rows=(4, 3, 2),
            ln_bot=(4, 3, 2),
            ln_top=(8, 4, 2, 1),
        )

    @staticmethod
    def kaggle() -> "DLRMConfig":
        """Criteo Kaggle DAC config (bench/dlrm_s_criteo_kaggle.sh)."""
        rows = (
            1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
            8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
            15, 286181, 105, 142572,
        )
        return DLRMConfig(
            emb_rows=rows,
            ln_bot=(13, 512, 256, 64, 16),
            ln_top=(367, 512, 256, 1),
        )

    @staticmethod
    def terabyte_mlperf(max_ind_range: int = 40_000_000) -> "DLRMConfig":
        """Criteo Terabyte MLPerf config (bench/run_and_time.sh): 128-dim
        embeddings, bot 13-512-256-128, top 1024-1024-512-256-1."""
        raw = (
            39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
            2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
            25641295, 39664984, 585935, 12972, 108, 36,
        )
        rows = tuple(min(r, max_ind_range) for r in raw)
        return DLRMConfig(
            emb_rows=rows,
            ln_bot=(13, 512, 256, 128),
            ln_top=(479, 1024, 1024, 512, 256, 1),
        )


def refuse_dcn_and_bags(config, path: str) -> None:
    """Raise on a model that trains and serves on one device only, in a path
    that has not got it (the mesh runners, export, quantized serving): an
    HSTU configuration, or a DLRM with the ``dcn`` interaction or fixed
    multi-hot bags (DLRM-DCNv2)."""
    if isinstance(config, HSTUConfig):
        raise NotImplementedError(
            f"{path} does not support HSTU (the sequential transducer): train it on one "
            "device")
    parts = [p for p, on in (("the 'dcn' interaction", config.interaction == "dcn"),
                             ("--multi-hot-sizes bags", bool(config.multi_hot_sizes))) if on]
    if parts:
        raise NotImplementedError(
            f"{path} does not support {' and '.join(parts)} (DLRM-DCNv2): train and serve "
            "it on one device")


# the attention's widest query block: a block's [H, Q, Q + N - 1] scores
MAX_ATTN_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class HSTUConfig:
    """HSTU, the generative recommender's sequential transducer (Zhai et
    al., arXiv:2402.17152; ``models/hstu.py``): a stack of pointwise-attention
    blocks over jagged user histories, trained by next-item sampled softmax
    against one item table that is both the input and the output embedding.

    Attributes:
      num_items: rows of the item table.
      embedding_dim: d, the item embedding's and the residual stream's width.
      num_heads, attention_dim, linear_dim: H, dqk and dv of a block.
      num_blocks: the blocks, each with its own relative bias tables.
      max_seq_len: N, the longest history; the attention divides by it and
        the position tables hold it.
      num_time_buckets: the time bias's buckets (bucket ids 0..this).
      num_negatives: uniformly sampled negatives a position.
      temperature: the sampled softmax's temperature.
      tokens_per_batch: the tokens of a batch (histories packed to it).
      max_sequences: the bound the sequences of a batch are padded to.
      compute_dtype: 'float32' or 'bfloat16' for the products and the
        attention (tables, norms and the loss stay f32).
    """

    num_items: int
    embedding_dim: int = 512
    num_heads: int = 4
    attention_dim: int = 128
    linear_dim: int = 128
    num_blocks: int = 8
    max_seq_len: int = 8192
    num_time_buckets: int = 128
    num_negatives: int = 128
    temperature: float = 0.05
    tokens_per_batch: int = 32768
    max_sequences: int = 160
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        for name in ("num_items", "embedding_dim", "num_heads", "attention_dim", "linear_dim",
                     "num_blocks", "max_seq_len", "num_negatives", "tokens_per_batch",
                     "max_sequences"):
            if getattr(self, name) < 1:
                raise ValueError(f"HSTU {name} must be >= 1, got {getattr(self, name)}")
        if not 1 <= self.num_time_buckets <= 254:
            raise ValueError(f"HSTU takes 1 to 254 time buckets, got {self.num_time_buckets}")
        if self.temperature <= 0:
            raise ValueError(f"HSTU temperature must be > 0, got {self.temperature}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad compute_dtype {self.compute_dtype!r}")

    @property
    def attn_block(self) -> int:
        """The attention's query block (``ops/hstu_attention.py``): the
        largest power of two up to ``MAX_ATTN_BLOCK`` that divides the
        tokens of a batch."""
        return math.gcd(self.tokens_per_batch, MAX_ATTN_BLOCK)

    @property
    def uvqk_width(self) -> int:
        """The columns of W_uvqk: U and V of dv, Q and K of dqk, each head."""
        return self.num_heads * (2 * self.linear_dim + 2 * self.attention_dim)
