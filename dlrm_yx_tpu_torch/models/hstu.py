"""HSTU: the generative recommender's sequential transducer.

Zhai et al., "Actions Speak Louder than Words: Trillion-Parameter
Sequential Transducers for Generative Recommendations" (ICML 2024,
arXiv:2402.17152); the reference code is facebookresearch's
generative-recommenders, ``generative_recommenders/modeling/sequential/
hstu.py`` (``SequentialTransductionUnitJagged``,
``RelativeBucketedTimeAndPositionBasedBias``). With X the [T, d] jagged
residual stream, phi = SiLU and LN a layer norm without affine parameters
(eps 1e-6), a block is

    U, V, Q, K = split(phi(LN(X) @ W_uvqk))      W_uvqk [d, H (2 dv + 2 dqk)], no bias
    A = (phi(Q K^T + rab^{p,t}) * causal mask / N) V   per head, per history
    Y = X + (LN(A) * U) @ W_o + b_o               LN over the H dv columns

(``ops/hstu_attention.py``: N the configuration's longest history, rab a
learned bias by relative position plus one by bucketed time gap, shared by
the heads, each block its own tables). The input is item_emb(id) * sqrt(d)
plus a learned absolute position embedding; the output is L2-normalised
(eps 1e-6). The item table is both the input and the output embedding.
As in the reference: norms without affine parameters, no bias on W_uvqk,
``concat_ua`` off (the output projection takes LN(A) * U, H dv wide).

Parameters, a dict:

    {"items": [num_items + SPARE_ROWS, d] f32, the item table (a store:
               row-wise Adagrad's sparse rows, ``train/train_step.
               hstu_train_body``), its last rows zero spares that no id
               names (the row update's sentinel and K2's margin),
     "hstu_pos": [P [N, d]], the absolute position embedding,
     "hstu_blocks": [(W_uvqk, W_o [H dv, d], b_o [d], pos_w [2N - 1],
                      time_w [num_buckets + 1]) per block]}

whose dense leaves are ``models.dlrm.dense_leaves``' (``DENSE_KEYS``).

Precision: the products (W_uvqk, W_o, the attention's) in the compute
dtype with f32 outputs where the port's towers take them
(``ops.mlp.product_f32_out``), the residual stream, the norms, the tables
and the loss in f32.

Departures from the reference, each a setting and not a shape: dropout is
0 (the published trainer's 0.2 would make the comparison with the plain
reference impossible); every row of the table is an item (the reference
keeps id 0 for padding; a jagged batch has none); the time bias of a pair
is taken at |t_i - t_j|, as the paper's equations give it, where the
reference code takes the query's time from the next event; the attention
divides by the configuration's N, where the reference divides by the
padded length of its [B, N] batch (N plus the one target slot); the
weights are drawn by ``init_hstu`` (normal 0.02 for the table, the
W_uvqk and both bias tables as the reference's constructors draw them,
Xavier-uniform W_o, zero b_o, normal sqrt(1/d) positions).

Spans: ``hstu`` (the blocks) and ``hstu.attention`` (a block's
attention). Counters, each a step: ``hstu.tokens`` (host) and the device
counts (``utils.profiling.count_on_device``, a replay adds its own
batch's) ``hstu.sequences`` (non-empty histories), ``hstu.live_scores``
(each layer's and head's causal scores of the histories) and
``hstu.pad_scores`` (the scores the tiled attention computes beyond them).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from dlrm_yx_tpu_torch.config import HSTUConfig
from dlrm_yx_tpu_torch.ops.hstu_attention import (
    JaggedContext,
    hstu_attention,
    jagged_context,
    scores,
    token_positions,
)
from dlrm_yx_tpu_torch.ops.mlp import product_f32_out
from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import CLIP_MARGIN
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.profiling import count, count_on_device, phase_scope

NORM_EPS = 1e-6  # the blocks' layer norms and the L2 norms of outputs and items
# spare rows past the items: the row update's sentinel and K2's clip margin
SPARE_ROWS = CLIP_MARGIN + 1


def compute_dtype(config: HSTUConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def init_hstu(config: HSTUConfig, seed: int = 123,
              device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The parameters, drawn on ``device`` by one torch generator seeded
    with ``seed``: the table, the positions, then each block's W_uvqk, W_o,
    b_o (zero) and bias tables."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = config
    d, n = c.embedding_dim, c.max_seq_len

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev).mul_(std)

    items = torch.empty((c.num_items + SPARE_ROWS, d), device=dev)
    items[:c.num_items].normal_(0.0, 0.02, generator=gen)
    items[c.num_items:].zero_()
    pos = normal((n, d), math.sqrt(1.0 / d))
    blocks = []
    hv = c.num_heads * c.linear_dim
    bound = math.sqrt(6.0 / (hv + d))
    for _ in range(c.num_blocks):
        w_uvqk = normal((d, c.uvqk_width), 0.02)
        w_o = torch.rand((hv, d), generator=gen, device=dev).mul_(2 * bound).sub_(bound)
        blocks.append((w_uvqk, w_o, torch.zeros(d, device=dev), normal((2 * n - 1,), 0.02),
                       normal((c.num_time_buckets + 1,), 0.02)))
    return {"items": items, "hstu_pos": [pos], "hstu_blocks": blocks}


def count_step(config: HSTUConfig, offsets: torch.Tensor, weights: torch.Tensor) -> None:
    """A step's counters (module docstring): the tokens on the host, the
    rest on the device from the batch's offsets and weights."""
    c = config
    lengths = offsets[1:].long() - offsets[:-1].long()
    live, computed = scores(lengths, c.tokens_per_batch, c.num_heads, c.max_seq_len,
                            c.attn_block)
    count("hstu.tokens", c.tokens_per_batch)
    count_on_device("hstu.sequences", (lengths > 0).sum())
    count_on_device("hstu.live_scores", live * c.num_blocks)
    count_on_device("hstu.pad_scores", computed * c.num_blocks - live * c.num_blocks)


def step_context(config: HSTUConfig, offsets: torch.Tensor, times: torch.Tensor) -> JaggedContext:
    """What the step's blocks share: the time buckets and the mask."""
    return jagged_context(offsets, times, config.max_seq_len, config.num_time_buckets,
                          config.attn_block)


def block_forward(config: HSTUConfig, block, x: torch.Tensor, ctx: JaggedContext) -> torch.Tensor:
    """One HSTU block on the [T, d] f32 residual stream."""
    w_uvqk, w_o, b_o, pos_w, time_w = block
    c = config
    cd = compute_dtype(c)
    t = x.shape[0]
    h, dv, dqk = c.num_heads, c.linear_dim, c.attention_dim
    xn = F.layer_norm(x, (c.embedding_dim,), eps=NORM_EPS)
    uvqk = F.silu(product_f32_out(xn.to(cd), w_uvqk.to(cd)))
    u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], dim=1)
    with phase_scope("hstu.attention"):
        a = hstu_attention(q.to(cd).view(t, h, dqk), k.to(cd).view(t, h, dqk),
                           v.to(cd).view(t, h, dv), pos_w, time_w, ctx)
    an = F.layer_norm(a.reshape(t, h * dv).float(), (h * dv,), eps=NORM_EPS)
    return x + product_f32_out((an * u).to(cd), w_o.to(cd)) + b_o


def hstu_embeddings(params: Dict, config: HSTUConfig, rows: torch.Tensor,
                    positions: torch.Tensor, ctx: JaggedContext) -> torch.Tensor:
    """The L2-normalised outputs [T, d] f32 of the tokens whose item rows
    are ``rows`` [T, d] (gathered from the table) at ``positions`` [T]."""
    pos = params["hstu_pos"][0]
    x = rows * math.sqrt(config.embedding_dim) + pos.index_select(0, positions)
    with phase_scope("hstu"):
        for block in params["hstu_blocks"]:
            x = block_forward(config, block, x, ctx)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=NORM_EPS)


def hstu_outputs(params: Dict, config: HSTUConfig, ids: torch.Tensor, offsets: torch.Tensor,
                 times: torch.Tensor) -> torch.Tensor:
    """The L2-normalised outputs [T, d] of a batch's tokens (a device
    batch's ``ids``, ``offsets`` and ``times``)."""
    ctx = step_context(config, offsets, times)
    rows = params["items"].index_select(0, ids.long())
    return hstu_embeddings(params, config, rows, token_positions(offsets, ids.shape[0]), ctx)
