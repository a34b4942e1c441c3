"""The plain reference of HSTU cells: the generative recommender's sequential
transducer (Zhai et al., arXiv:2402.17152; the reference code's
``SequentialTransductionUnitJagged`` and
``RelativeBucketedTimeAndPositionBasedBias``) and its optimizers, in
float32 PyTorch with TF32 off, written from their equations.

It imports nothing of the program or of the repository's tests and takes
nothing the program made: it draws the weights again from the run's seed
(``draw_items``, ``draw_dense``), only the item rows the compared batches
touch. A block, on the [T, d] stream X, a history at a time (LN without
affine parameters, eps 1e-6):

    U, V, Q, K = split(SiLU(LN(X) @ W_uvqk))
    A = SiLU(Q K^T + pos_w[N - 1 - (i - j)] + time_w[bucket(t_i - t_j)])
        * [j <= i] / N @ V                                  per head
    Y = X + (LN(A) * U) @ W_o + b_o

with bucket(x) = min(floor(ln(max(|x|, 1)) / 0.301), 128); the input
items[id] * sqrt(d) plus the position's embedding, the output
L2-normalised. The loss: at each supervised position (an event with a next
one) the positive (the next event's item) and the negatives' rows
L2-normalised, logits u . e / temperature, a negative equal to the
positive at -5e4, the positive's -log_softmax weighted over the weights'
sum. Training: ``torch.optim.AdamW`` on the dense leaves and exact row-wise
Adagrad on the table (each row's gradient summed over the batch, its
momentum growing by the mean of its squares, ``w -= lr * g / (sqrt(m) +
eps)``), at constant learning rates.

So that it fits a card, each history's attention and each chunk of the
loss's positions is a ``torch.utils.checkpoint`` region: its [H, L, L]
scores and its [C, R + 1, d] candidate rows are recomputed in the backward
and never held for the whole batch. That changes no value.

``precision="fp8"`` rounds every product's operands (the projections' and
the attention's inputs and weights, the loss's outputs and items) to
float8 e4m3 in the forward, straight-through in the backward: the
control, one precision below the configuration's bf16 compute.
``half_batch`` takes the loss over the first half of each batch's
positions: a planted fault.

A batch is ``(ids [T], times [T], offsets [S + 1], positives [T],
negatives [T, R], weights [T])`` (host arrays), the port's jagged layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.common import flag_values
from benchmark.draw import DRAW_BLOCK_ROWS, stream_seed

ITEM_KEY = 1_000_037   # keeps the item table's streams apart from the others'
DENSE_KEY = 1_000_039  # the positions' and the blocks' streams
MASKED_LOGIT = -5e4
NORM_EPS = 1e-6


def model_shape(conf: dict) -> dict:
    """The HSTU model as the reference and the counts read it, from the
    configuration's flags and its ``assumed`` optimizer settings, without
    the program."""
    f = flag_values(conf["flags"])
    if f.get("--model") != "hstu":
        raise ValueError("an HSTU configuration: --model=hstu")
    a = conf["assumed"]
    return {
        "items": int(f["--hstu-num-items"]),
        "dim": int(f["--hstu-embedding-dim"]),
        "heads": int(f["--hstu-num-heads"]),
        "dqk": int(f["--hstu-attention-dim"]),
        "dv": int(f["--hstu-linear-dim"]),
        "blocks": int(f["--hstu-num-blocks"]),
        "max_len": int(f["--hstu-max-seq-len"]),
        "negatives": int(f["--hstu-num-negatives"]),
        "temperature": float(f["--hstu-temperature"]),
        "tokens": int(f["--hstu-tokens-per-batch"]),
        "max_sequences": int(f["--hstu-max-sequences"]),
        "time_buckets": 128,
        "compute_dtype": f.get("--compute-dtype", "float32"),
        "lr": float(f["--learning-rate"]),
        "eps": float(a["eps"]),
        "adam_lr": float(a["adam_lr"]),
        "betas": tuple(float(b) for b in a["adam_betas"]),
        "adam_eps": float(a["adam_eps"]),
    }


def draw_items(seed: int, n_items: int, dim: int, r0: int, r1: int, device) -> torch.Tensor:
    """Rows [r0, r1) of the item table, N(0, 0.02) in f32: the block of
    ``DRAW_BLOCK_ROWS`` rows that holds r0 drawn whole from its own
    generator, so a row's values do not depend on the rows asked for.
    [r0, r1) lies inside one block."""
    block = r0 // DRAW_BLOCK_ROWS
    b0 = block * DRAW_BLOCK_ROWS
    b1 = min(n_items, b0 + DRAW_BLOCK_ROWS)
    if not (b0 <= r0 < r1 <= b1):
        raise ValueError(f"rows [{r0}, {r1}) of {n_items} items cross a draw block")
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, ITEM_KEY, block))
    rows = torch.randn((b1 - b0, dim), generator=gen, device=device).mul_(0.02)
    return rows[r0 - b0: r1 - b0]


def item_rows(seed: int, n_items: int, dim: int, ids: torch.Tensor) -> torch.Tensor:
    """[len(ids), dim] f32: the drawn rows ``ids`` (int64), on their device."""
    out = torch.empty((ids.numel(), dim), device=ids.device)
    block_of = ids // DRAW_BLOCK_ROWS
    for block in torch.unique(block_of).tolist():
        r0 = block * DRAW_BLOCK_ROWS
        r1 = min(n_items, r0 + DRAW_BLOCK_ROWS)
        sel = (block_of == block).nonzero().reshape(-1)
        out[sel] = draw_items(seed, n_items, dim, r0, r1, ids.device)[ids[sel] - r0]
        del sel
    return out


def draw_dense(seed: int, shape: dict, device) -> dict:
    """The positions [N, d] ~ N(0, sqrt(1/d)) and each block's (W_uvqk ~
    N(0, 0.02), W_o Xavier-uniform, b_o zero, pos_w and time_w ~ N(0,
    0.02)), each from its own generator."""
    d, n, h = shape["dim"], shape["max_len"], shape["heads"]
    hv = h * shape["dv"]
    width = h * (2 * shape["dv"] + 2 * shape["dqk"])

    def gen(*key):
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, DENSE_KEY, *key))
        return g

    pos = torch.randn((n, d), generator=gen(0), device=device).mul_(math.sqrt(1.0 / d))
    blocks = []
    bound = math.sqrt(6.0 / (hv + d))
    for i in range(shape["blocks"]):
        g = gen(1, i)
        w_uvqk = torch.randn((d, width), generator=g, device=device).mul_(0.02)
        w_o = torch.rand((hv, d), generator=g, device=device).mul_(2 * bound).sub_(bound)
        pos_w = torch.randn(2 * n - 1, generator=g, device=device).mul_(0.02)
        time_w = torch.randn(shape["time_buckets"] + 1, generator=g, device=device).mul_(0.02)
        blocks.append((w_uvqk, w_o, torch.zeros(d, device=device), pos_w, time_w))
    return {"hstu_pos": [pos], "hstu_blocks": blocks}


def dense_leaves(tree: dict) -> list:
    """The positions, then each block's W_uvqk, W_o, b_o, pos_w, time_w:
    the program's order."""
    return list(tree["hstu_pos"]) + [p for blk in tree["hstu_blocks"] for p in blk]


def bucket(dt: torch.Tensor, num_buckets: int) -> torch.Tensor:
    return (torch.log(dt.abs().clamp(min=1).float()) / 0.301).long().clamp(0, num_buckets)


def _rounder(precision: str):
    if precision == "f32":
        return lambda t: t
    if precision == "fp8":
        return lambda t: t + (t.to(torch.float8_e4m3fn).float() - t).detach()
    raise ValueError(f"unknown precision {precision!r}")


def spans_of(batch):
    """The [start, end) of each non-empty history."""
    off = np.asarray(batch[2]).astype(np.int64)
    return [(int(s), int(e)) for s, e in zip(off[:-1], off[1:]) if e > s]


class _TableAt(torch.autograd.Function):
    """``table[idx]`` whose backward counts each entry's gradient by bucket
    (``torch.bincount``'s histogram) rather than scattering the [L, L]
    gradient into a few hundred entries."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        counts = torch.bincount(idx.reshape(-1), weights=grad.reshape(-1), minlength=ctx.n)
        return counts.to(grad.dtype), None


def position_bias(pos_w: torch.Tensor, length: int, n: int) -> torch.Tensor:
    """[L, L]: pos_w[N - 1 - (i - j)], a Toeplitz view of L windows of
    pos_w (whose backward sums the diagonals without a scatter)."""
    return pos_w[n - length: n + length - 1].unfold(0, length, 1).flip(0)


def _history_attention(q, k, v, pos_w, time_w, t, shape, quant):
    """[L, H dv]: one history's attention, whole."""
    h, dqk, dv, n = shape["heads"], shape["dqk"], shape["dv"], shape["max_len"]
    length = q.shape[0]
    qh = quant(q).reshape(length, h, dqk).transpose(0, 1)
    kh = quant(k).reshape(length, h, dqk).transpose(0, 1)
    vh = quant(v).reshape(length, h, dv).transpose(0, 1)
    i = torch.arange(length, device=q.device)
    rab = position_bias(pos_w, length, n) + _TableAt.apply(
        time_w, bucket(t[:, None] - t[None, :], shape["time_buckets"]))
    causal = i[None, :] <= i[:, None]
    a = F.silu(qh @ kh.transpose(1, 2) + rab) * causal / n
    return (quant(a) @ vh).transpose(0, 1).reshape(length, h * dv)


def outputs(dense: dict, x0: torch.Tensor, times: torch.Tensor, spans, shape, quant):
    """The L2-normalised outputs [T, d] of the input rows ``x0`` (the
    item rows times sqrt(d) plus the positions)."""
    d, h, dqk, dv = shape["dim"], shape["heads"], shape["dqk"], shape["dv"]
    x = x0
    for w_uvqk, w_o, b_o, pos_w, time_w in dense["hstu_blocks"]:
        uvqk = F.silu(quant(F.layer_norm(x, (d,), eps=NORM_EPS)) @ quant(w_uvqk))
        u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], dim=1)
        a = torch.cat([checkpoint(_history_attention, q[s:e], k[s:e], v[s:e], pos_w, time_w,
                                  times[s:e], shape, quant, use_reentrant=False)
                       for s, e in spans])
        an = F.layer_norm(a, (h * dv,), eps=NORM_EPS)
        x = x + quant(an * u) @ quant(w_o) + b_o
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=NORM_EPS)


def _chunk_loss(u, occ, where, hit, w, temperature, quant):
    """The weighted sum of a chunk's -log_softmax at the positive."""
    rows = occ[where]
    e = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True).clamp(min=NORM_EPS)
    logits = (quant(e) @ quant(u)[:, :, None]).squeeze(-1) / temperature
    logits = torch.where(hit, torch.full_like(logits, MASKED_LOGIT), logits)
    return -(torch.log_softmax(logits, dim=1)[:, 0] * w).sum()


LOSS_CHUNK = 2048


def batch_loss(dense: dict, occ: torch.Tensor, loc, batch, shape, quant, half_batch=False):
    """The loss of one batch from its distinct rows ``occ`` [U_b, d] and
    ``loc``: each id's place in them (the tokens', then each position's
    positive and negatives, [T (R + 2)])."""
    dev = occ.device
    t, d = shape["tokens"], shape["dim"]
    times = torch.as_tensor(np.asarray(batch[1])).to(dev)
    spans = spans_of(batch)
    positions = torch.cat([torch.arange(e - s) for s, e in spans]).to(dev)
    x0 = occ[loc[:t]] * math.sqrt(d) + dense["hstu_pos"][0][positions]
    u = outputs(dense, x0, times, spans, shape, quant)
    w = torch.as_tensor(np.asarray(batch[5])).to(dev).float()
    if half_batch:
        w = torch.where(torch.arange(t, device=dev) < t // 2, w, 0.0)
    cand = loc[t:].view(t, -1)
    pos = torch.as_tensor(np.asarray(batch[3])).to(dev).long()
    neg = torch.as_tensor(np.asarray(batch[4])).to(dev).long()
    hit = torch.cat([torch.zeros_like(pos[:, None], dtype=torch.bool), neg == pos[:, None]], 1)
    total = torch.zeros((), device=dev)
    for c0 in range(0, t, LOSS_CHUNK):
        c1 = min(t, c0 + LOSS_CHUNK)
        total = total + checkpoint(_chunk_loss, u[c0:c1], occ, cand[c0:c1], hit[c0:c1],
                                   w[c0:c1], shape["temperature"], quant, use_reentrant=False)
    return total / w.sum()


def batch_ids(batch, device) -> torch.Tensor:
    """The batch's item ids in the program's order (the tokens', then each
    position's positive and negatives), int64 on ``device``."""
    ids = torch.as_tensor(np.asarray(batch[0])).long()
    cand = torch.cat([torch.as_tensor(np.asarray(batch[3])).long()[:, None],
                      torch.as_tensor(np.asarray(batch[4])).long()], dim=1)
    return torch.cat([ids, cand.reshape(-1)]).to(device)


def train_steps(shape, seed, batches, device, compared, precision="f32", half_batch=False):
    """AdamW on the dense leaves and exact row-wise Adagrad on the table
    over ``batches`` (host tuples) from the seed's weights. ``compared``:
    the sorted int64 item ids whose rows are returned. Returns each step's
    loss, the exact gradient of every dense leaf and of the compared rows
    at the first step (``g1``), and the dense leaves and compared rows
    before the first step (``p0``) and after the last (``pn``)."""
    quant = _rounder(precision)
    uniq = torch.unique(torch.cat([batch_ids(b, device) for b in batches]))
    rows = item_rows(seed, shape["items"], shape["dim"], uniq)
    mom = rows.new_zeros(rows.shape[0])
    where = torch.searchsorted(uniq, compared.to(device))
    dense = draw_dense(seed, shape, device)
    leaves = dense_leaves(dense)
    for p in leaves:
        p.requires_grad_(True)
    adam = torch.optim.AdamW(leaves, lr=shape["adam_lr"], betas=shape["betas"],
                             eps=shape["adam_eps"], weight_decay=0.0, foreach=False)

    def snapshot():
        return [p.detach().clone() for p in leaves] + [rows[where]]

    p0 = snapshot()
    losses, g1 = [], None
    for k, batch in enumerate(batches):
        loc = torch.searchsorted(uniq, batch_ids(batch, device))
        su, inv = torch.unique(loc, return_inverse=True)
        occ = rows[su].requires_grad_(True)
        loss = batch_loss(dense, occ, inv, batch, shape, quant, half_batch)
        grads = torch.autograd.grad(loss, leaves + [occ])
        del occ
        for p, g in zip(leaves, grads):
            p.grad = g
        adam.step()
        g_rows = grads[-1]
        with torch.no_grad():
            mom[su] += (g_rows * g_rows).mean(dim=1)
            rows[su] -= shape["lr"] * g_rows / (mom[su].sqrt() + shape["eps"])[:, None]
        losses.append(loss.item())
        if k == 0:
            at = torch.searchsorted(su, where).clamp(max=su.shape[0] - 1)
            hit = su[at] == where
            g1 = [g.detach().clone() for g in grads[:-1]]
            g1.append(torch.where(hit[:, None], g_rows[at], 0.0))
        del grads, g_rows, su, inv, loc
        for p in leaves:
            p.grad = None
    return {"losses": losses, "g1": g1, "p0": p0, "pn": snapshot()}
