"""Plain HSTU, the reference the port's HSTU is held to in the CPU tests.

Written from the equations of Zhai et al. (arXiv:2402.17152) and the
reference code's ``SequentialTransductionUnitJagged`` /
``RelativeBucketedTimeAndPositionBasedBias`` in float32 PyTorch with TF32
off, a history at a time and a whole [L, L] score matrix each: no tiling,
no kernels, no chunking, and every gradient by autograd. It imports
nothing of the port, of JAX or of the JAX package; ``cfg`` is any object
with the configuration's attribute names.

A block (X [T, d], LN without affine parameters, eps 1e-6):

    U, V, Q, K = split(SiLU(LN(X) @ W_uvqk))
    A = SiLU(Q K^T + pos_w[N - 1 - (i - j)] + time_w[bucket(t_i - t_j)])
        * [j <= i] / N @ V                        per head, per history
    Y = X + (LN(A) * U) @ W_o + b_o

bucket(x) = min(floor(ln(max(|x|, 1)) / 0.301), num_buckets). The input
is items[id] * sqrt(d) + P[position]; the output is L2-normalised. The
loss: at every supervised position the positive and the negatives' rows
L2-normalised, logits u . e / temperature, a negative equal to the
positive at -5e4, the positive's -log_softmax weighted over the weights'
sum. Training: AdamW (``torch.optim.AdamW``) on the dense leaves and
exact row-wise Adagrad on the table (each row's gradient summed over the
batch, its momentum growing by the mean of its squares, w -= lr * g /
(sqrt(m) + eps)).

The batch is the port's jagged layout as numpy arrays: (ids [T], times
[T], offsets [S + 1], positives [T], negatives [T, R], weights [T]).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def bucket(dt: torch.Tensor, num_buckets: int) -> torch.Tensor:
    return (torch.log(dt.abs().clamp(min=1).float()) / 0.301).long().clamp(0, num_buckets)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def histories(batch):
    """The [start, end) of each non-empty history."""
    off = np.asarray(batch[2]).astype(np.int64)
    return [(int(s), int(e)) for s, e in zip(off[:-1], off[1:]) if e > s]


def attention(q, k, v, pos_w, time_w, times, spans, cfg):
    """[T, H dv]: the pointwise attention a history at a time."""
    h, dqk, dv, n = cfg.num_heads, cfg.attention_dim, cfg.linear_dim, cfg.max_seq_len
    out = []
    for s, e in spans:
        length = e - s
        qh = q[s:e].reshape(length, h, dqk).transpose(0, 1)
        kh = k[s:e].reshape(length, h, dqk).transpose(0, 1)
        vh = v[s:e].reshape(length, h, dv).transpose(0, 1)
        i = torch.arange(length)
        rel = (i[:, None] - i[None, :]).clamp(min=0)
        t = times[s:e]
        rab = pos_w[n - 1 - rel] + time_w[bucket(t[:, None] - t[None, :], cfg.num_time_buckets)]
        causal = (i[None, :] <= i[:, None]).float()
        a = F.silu(qh @ kh.transpose(1, 2) + rab) * causal / n
        out.append((a @ vh).transpose(0, 1).reshape(length, h * dv))
    return torch.cat(out)


def outputs(params, cfg, batch):
    """The L2-normalised outputs [T, d] of the batch's tokens."""
    ids, times = _t(batch[0]).long(), _t(batch[1]).long()
    spans = histories(batch)
    d = cfg.embedding_dim
    positions = torch.cat([torch.arange(e - s) for s, e in spans])
    x = params["items"][ids] * math.sqrt(d) + params["hstu_pos"][0][positions]
    h, dqk, dv = cfg.num_heads, cfg.attention_dim, cfg.linear_dim
    for w_uvqk, w_o, b_o, pos_w, time_w in params["hstu_blocks"]:
        uvqk = F.silu(F.layer_norm(x, (d,), eps=1e-6) @ w_uvqk)
        u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], dim=1)
        a = attention(q, k, v, pos_w, time_w, times, spans, cfg)
        x = x + (F.layer_norm(a, (h * dv,), eps=1e-6) * u) @ w_o + b_o
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-6)


def loss_of(params, cfg, batch):
    u = outputs(params, cfg, batch)
    pos, neg = _t(batch[3]).long(), _t(batch[4]).long()
    w = _t(batch[5], torch.float32)
    cand = torch.cat([pos[:, None], neg], dim=1)
    rows = params["items"][cand]
    e = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True).clamp(min=1e-6)
    logits = (e * u[:, None, :]).sum(-1) / cfg.temperature
    hit = torch.cat([torch.zeros_like(pos[:, None], dtype=torch.bool), neg == pos[:, None]], 1)
    logits = torch.where(hit, torch.full_like(logits, -5e4), logits)
    nll = -torch.log_softmax(logits, dim=1)[:, 0]
    return (nll * w).sum() / w.sum()


def leaves(params):
    """The dense leaves in the port's order (positions, then each block's
    W_uvqk, W_o, b_o, pos_w, time_w), then the table."""
    return (list(params["hstu_pos"]) + [p for blk in params["hstu_blocks"] for p in blk]
            + [params["items"]])


def train(params, cfg, batches, table_lr, table_eps, adam_lr, betas, adam_eps):
    """Steps over ``batches`` from copies of ``params``; returns (losses,
    the first step's gradients of ``leaves``, the params after the steps)."""
    p = {"items": params["items"].detach().clone().requires_grad_(),
         "hstu_pos": [params["hstu_pos"][0].detach().clone().requires_grad_()],
         "hstu_blocks": [tuple(t.detach().clone().requires_grad_() for t in blk)
                         for blk in params["hstu_blocks"]]}
    dense = leaves(p)[:-1]
    adam = torch.optim.AdamW(dense, lr=adam_lr, betas=betas, eps=adam_eps, weight_decay=0.0,
                             foreach=False)
    mom = torch.zeros(p["items"].shape[0])
    losses, first = [], None
    for b in batches:
        adam.zero_grad(set_to_none=True)
        p["items"].grad = None
        loss = loss_of(p, cfg, b)
        loss.backward()
        if first is None:
            first = [t.grad.detach().clone() for t in leaves(p)]
        adam.step()
        with torch.no_grad():
            g = p["items"].grad
            mom += (g * g).mean(dim=1)
            p["items"] -= table_lr * g / (mom.sqrt() + table_eps)[:, None]
        losses.append(float(loss.detach()))
    out = {"items": p["items"].detach(), "hstu_pos": [p["hstu_pos"][0].detach()],
           "hstu_blocks": [tuple(t.detach() for t in blk) for blk in p["hstu_blocks"]]}
    return losses, first, out
