"""The plain reference of DLRM-DCNv2 cells: the MLPerf reference's model
(``recommendation_v2/torchrec_dlrm``, TorchRec's ``DLRM_DCN``) and its
optimizers, in float32 PyTorch with TF32 off, written from their
equations.

It imports nothing of the program or of the repository's tests and takes
nothing the program made: it draws the weights again from the run's seed
(``benchmark.draw``; the cross layers by ``draw_cross``), only the table
rows the compared batches touch. Equations: the bottom MLP of ReLU layers;
each table's bag summed, a repeated id counted each time
(``EmbeddingBag(mode="sum")``); x0 the bottom output, then each table's
pooled vector, concatenated [B, 27 D]; the low-rank cross layers
``x_{l+1} = x0 * ((x_l @ V_l) @ W_l + b_l) + x_l``; the over-arch of ReLU
layers with a last linear layer, its logit taken by BCE in the stable form.
Training: exact row-wise Adagrad on the tables (each row's gradient summed
over its occurrences, the row's momentum growing by the mean of its
squares, ``w -= lr * g / (sqrt(m) + eps)``) and ``torch.optim.Adagrad`` on
the towers and the cross layers (``a += g * g``, ``p -= lr * g / (sqrt(a)
+ eps)``), at a constant learning rate.

``precision="fp8"`` rounds every product's operands (the towers' and the
cross layers' inputs and weights) to float8 e4m3 in the forward: the
control, one precision below the configuration's bf16 compute. The
rounding is straight-through: the backward takes each operand's cotangent
as it is, since e4m3 without a loss scale flushes BCE's per-sample
cotangents (about 1e-4 at B = 8,192, under e4m3's least subnormal of
2^-9) to zero and would leave every leaf but the last layer's unchanged.
``half_batch`` takes the loss over the first half of each batch: a planted
fault.

A batch is ``(dense [B, 13], ids [S, B, 1], weights, labels [B, 1])``: the
bag layout, table t's ``hotness[t]`` slots in a row.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.common import dashes, flag_values
from benchmark.draw import draw_rows, draw_tower, stream_seed
from benchmark.reference import bce

CROSS_KEY = 1_000_033  # keeps the cross layers' streams apart from the towers'


def model_shape(conf: dict) -> dict:
    """The DLRM-DCNv2 model as the reference and the counts read it, from
    the configuration's flags and raw table rows, without the program."""
    f = flag_values(conf["flags"])
    raw = [int(r) for r in conf["raw_rows"]]
    cap = int(f.get("--max-ind-range", "0"))
    dim = int(f["--arch-sparse-feature-size"])
    width = (len(raw) + 1) * dim
    hot = dashes(f["--multi-hot-sizes"])
    if f.get("--arch-interaction-op") != "dcn" or len(hot) != len(raw):
        raise ValueError("a DLRM-DCNv2 configuration: --arch-interaction-op=dcn and one "
                         "--multi-hot-sizes entry a table")
    return {
        "raw_rows": raw,
        "cap": cap if cap > 0 else max(raw),
        "rows": [min(r, cap) if cap > 0 else r for r in raw],
        "dim": dim,
        "hotness": hot,
        "ln_bot": dashes(f["--arch-mlp-bot"]),
        "ln_top": [width] + dashes(f["--arch-mlp-top"]),
        "width": width,
        "cross_layers": int(f["--dcn-num-layers"]),
        "cross_rank": int(f["--dcn-low-rank-dim"]),
        "batch": int(f["--mini-batch-size"]),
        "compute_dtype": f.get("--compute-dtype", "float32"),
        "split_threshold": int(f.get("--emb-split-threshold",
                                     conf["assumed"]["emb_split_threshold"])),
        "lr": float(f["--learning-rate"]),
        "eps": float(conf["assumed"]["eps"]),
    }


def slot_tables(shape) -> np.ndarray:
    """The table of each bag slot."""
    return np.repeat(np.arange(len(shape["hotness"])), shape["hotness"])


def draw_cross(seed: int, width: int, rank: int, layers: int, device):
    """[(V [width, rank], W [rank, width], b [width])] f32 of each cross
    layer: V and W ~ N(0, sqrt(2 / (width + rank))) (TorchRec's
    Xavier-normal), b zero, each layer from its own generator on the
    device."""
    std = float(np.sqrt(2.0 / (width + rank)))
    out = []
    for i in range(layers):
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, CROSS_KEY, i))
        v = torch.randn((width, rank), device=device, generator=gen).mul_(std)
        w = torch.randn((rank, width), device=device, generator=gen).mul_(std)
        out.append((v, w, torch.zeros(width, device=device)))
    return out


def _rounder(precision: str):
    if precision == "f32":
        return lambda t: t
    if precision == "fp8":
        return lambda t: t + (t.to(torch.float8_e4m3fn).float() - t).detach()
    raise ValueError(f"unknown precision {precision!r}")


def _mlp(x, layers, q, last_raw):
    for i, (w, b) in enumerate(layers):
        x = q(x) @ q(w) + b
        if not (last_raw and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def logits(model, pooled, dense, q):
    """model: {"bot", "top"} lists of (W, b), "dcn" of (V, W, b); pooled
    [B, T, D]; dense [B, 13] -> logits [B]."""
    x = _mlp(dense, model["bot"], q, last_raw=False)
    x0 = torch.cat([x[:, None, :], pooled], dim=1).reshape(x.shape[0], -1)
    xl = x0
    for v, w, b in model["dcn"]:
        xl = x0 * (q(q(xl) @ q(v)) @ q(w) + b) + xl
    return _mlp(xl, model["top"], q, last_raw=True).reshape(-1)


def leaf_names(shape):
    """Dense leaves (bottom, cross, top), then each table's compared rows."""
    names = [f"bot.{i}.{p}" for i in range(len(shape["ln_bot"]) - 1) for p in "wb"]
    names += [f"dcn.{i}.{p}" for i in range(shape["cross_layers"]) for p in "vwb"]
    names += [f"top.{i}.{p}" for i in range(len(shape["ln_top"]) - 1) for p in "wb"]
    return names + [f"emb.{t}" for t in range(len(shape["rows"]))]


def _dense_model(shape, seed, device):
    return {"bot": draw_tower(seed, 0, shape["ln_bot"], device),
            "dcn": draw_cross(seed, shape["width"], shape["cross_rank"], shape["cross_layers"],
                              device),
            "top": draw_tower(seed, 1, shape["ln_top"], device)}


def _dense_leaves(model):
    return [p for k in ("bot", "dcn", "top") for layer in model[k] for p in layer]


def table_ids(batches, shape, device):
    """Each table's ids over ``batches`` (host tuples), int64 on ``device``."""
    slots = slot_tables(shape)
    return [torch.cat([torch.as_tensor(np.asarray(b[1])[slots == t]).reshape(-1)
                       for b in batches]).to(device=device, dtype=torch.int64)
            for t in range(len(shape["rows"]))]


def train_steps(shape, seed, batches, device, compared=None, precision="f32",
                half_batch=False):
    """Exact row-wise Adagrad on the tables and Adagrad on the dense leaves
    over ``batches`` (host tuples) from the seed's weights. ``compared``:
    each table's rows whose values are returned (sorted int64 ids; all the
    rows the batches touch when None). Returns each step's loss, the exact
    gradient of every leaf at the first step (a table's summed over its
    occurrences), and every leaf before the first step (``p0``), after it
    (``p1``, with the optimizer's accumulators then, ``a1``: a table's row
    momentum [rows]) and after the last (``pn``)."""
    q = _rounder(precision)
    ids = table_ids(batches, shape, device)
    uniq = [torch.unique(i) for i in ids]
    rows = [draw_rows(seed, t, shape["rows"][t], shape["dim"], u) for t, u in enumerate(uniq)]
    moms = [r.new_zeros(r.shape[0]) for r in rows]
    if compared is None:
        compared = uniq
    where = [torch.searchsorted(u, c.to(device)) for u, c in zip(uniq, compared)]
    model = _dense_model(shape, seed, device)
    dense_leaves = _dense_leaves(model)
    accs = [torch.zeros_like(p) for p in dense_leaves]
    lr, eps = shape["lr"], shape["eps"]

    def snapshot():
        return ([p.clone() for p in dense_leaves] + [r[w] for r, w in zip(rows, where)])

    p0 = snapshot()
    slots = slot_tables(shape)
    losses, g1, p1, a1 = [], None, None, None
    for k, (dense, idx, _, labels) in enumerate(batches):
        dense = torch.as_tensor(np.asarray(dense)).to(device)
        y = torch.as_tensor(np.asarray(labels)).to(device).reshape(-1)
        idx = np.asarray(idx)[:, :, 0]
        steps, occ, pooled = [], [], []
        for t in range(len(rows)):
            bag = torch.as_tensor(np.ascontiguousarray(idx[slots == t].T))  # [B, h]
            pos = torch.searchsorted(uniq[t], bag.to(device=device, dtype=torch.int64))
            u, inv = torch.unique(pos, return_inverse=True)
            o = rows[t][u].requires_grad_(True)
            steps.append(u)
            occ.append(o)
            pooled.append(o[inv].sum(dim=1))
        for p in dense_leaves:
            p.requires_grad_(True)
        z = logits(model, torch.stack(pooled, dim=1), dense, q)
        n = z.shape[0] // 2 if half_batch else z.shape[0]
        loss = bce(z[:n], y[:n])
        grads = torch.autograd.grad(loss, dense_leaves + occ)
        g_dense, g_rows = grads[:len(dense_leaves)], grads[len(dense_leaves):]
        with torch.no_grad():
            for p, a, g in zip(dense_leaves, accs, g_dense):
                p.requires_grad_(False)
                a.add_(g * g)
                p.sub_(lr * g / (a.sqrt() + eps))
            for t, (u, g) in enumerate(zip(steps, g_rows)):
                moms[t][u] += (g * g).mean(dim=1)
                rows[t][u] -= lr * g / (moms[t][u].sqrt() + eps)[:, None]
        losses.append(loss.item())
        if k == 0:
            g1 = [g.detach() for g in g_dense]
            for t, (u, g) in enumerate(zip(steps, g_rows)):
                at = torch.searchsorted(u, where[t]).clamp(max=u.shape[0] - 1)
                hit = u[at] == where[t]
                g1.append(torch.where(hit[:, None], g[at], 0.0))
            p1 = snapshot()
            a1 = [a.clone() for a in accs] + [m[w] for m, w in zip(moms, where)]
    return {"losses": losses, "g1": g1, "p0": p0, "p1": p1, "a1": a1, "pn": snapshot()}
