"""The plain reference: the DLRM of MLPerf's reference implementation, in
float32 PyTorch with TF32 off, written from its equations.

It imports nothing of the program and takes nothing the program made: it
draws the weights again from the run's seed (``benchmark.draw``), only the
table rows the compared batches touch, and works the learning rate out
from the configuration's flags. Equations (facebookresearch/dlrm
``dlrm_s_pytorch.py``): bottom MLP of ReLU layers; each table's row
pooled by its weight; dot interaction of the bottom output and the 26
pooled rows, the strict lower triangle in row-major order, after the
bottom output; top MLP of ReLU layers with the last layer's logit fed to
a sigmoid (BCE from logits in the stable form); SGD on the towers, and on
the tables as PyTorch's SGD applies the embedding bags' sparse gradient
(``dense.add_(sparse_grad)``: each occurrence's row gradient added to its
row with ``index_add_``, uncoalesced); the LR policy's linear warm-up and
quadratic decay (``LRPolicyScheduler``).

``precision="fp8"`` rounds every product's operands (the towers' inputs
and weights, the interaction's features) to float8 e4m3 first: the
control, one precision below the configuration's bf16 compute.
``half_batch`` takes the loss over the first half of each batch: a
planted fault.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.draw import draw_rows, draw_tower


def exact_matmul() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def lr_at(it: int, lr: dict) -> float:
    """The LR policy at 0-based iteration ``it`` (the scheduler's step count
    is it + 1), in float32: linear warm-up, then the warm-up's last value
    until the decay starts, a quadratic decay to a floor of 1e-7, then the
    last decayed value."""
    f = np.float32
    s = f(it) + f(1.0)
    base, w = f(lr["base"]), f(lr["warmup"])
    ds, nd = f(lr["decay_start"]), f(lr["decay_steps"])
    if s < w:
        return float(base * (s / w))
    if nd > 0 and ds <= s < ds + nd:
        x = (nd - (s - ds)) / nd
        return float(max(f(1e-7), base * (x * x)))
    if nd > 0 and s < ds:
        return float(base * ((w - f(1.0)) / w))
    if nd > 0:
        return float(max(f(1e-7), base * (f(1.0) / nd) ** 2))
    return float(base)


def _rounder(precision: str):
    if precision == "f32":
        return lambda t: t
    if precision == "fp8":
        return lambda t: t.to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown precision {precision!r}")


def _mlp(x, layers, q, last_raw):
    for i, (w, b) in enumerate(layers):
        x = q(x) @ q(w) + b
        if not (last_raw and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def logits(towers, pooled, dense, q):
    """towers: {"bot", "top"} lists of (W [n, m], b [m]); pooled [B, T, D];
    dense [B, 13] -> logits [B]."""
    x = _mlp(dense, towers["bot"], q, last_raw=False)
    t = torch.cat([x[:, None, :], pooled], dim=1)
    f = t.shape[1]
    z = q(t) @ q(t).transpose(1, 2)
    li, lj = torch.tril_indices(f, f, -1, device=t.device)
    r = torch.cat([x, z[:, li, lj]], dim=1)
    return _mlp(r, towers["top"], q, last_raw=True).reshape(-1)


def bce(z, y):
    return torch.mean(torch.clamp_min(z, 0.0) - z * y + torch.log1p(torch.exp(-z.abs())))


def _check(shape):
    if shape["interaction"] != "dot" or shape["loss"] != "bce":
        raise NotImplementedError("the reference has the dot interaction and the BCE loss only")


def _tables(shape, seed, ids_per_table, device):
    """Per table: its sorted touched ids and their drawn rows."""
    uniq, rows = [], []
    for t, ids in enumerate(ids_per_table):
        u = torch.unique(ids.to(device=device, dtype=torch.int64))
        uniq.append(u)
        rows.append(draw_rows(seed, t, shape["rows"][t], shape["dim"], u))
    return uniq, rows


def _positions(uniq, indices):
    """Each table's lookups [B, L] as positions in its touched rows."""
    return [torch.searchsorted(uniq[t], indices[t].to(torch.int64))
            for t in range(indices.shape[0])]


def _pooled(occurrences, weights):
    """[B, T, D]: each table's looked-up rows [B, L, D] pooled by weight."""
    return torch.stack([(occ * weights[t][..., None]).sum(dim=1)
                        for t, occ in enumerate(occurrences)], dim=1)


def _towers(shape, seed, device):
    return {"bot": draw_tower(seed, 0, shape["ln_bot"], device),
            "top": draw_tower(seed, 1, shape["ln_top"], device)}


def _on(batch, device):
    return [torch.as_tensor(np.asarray(a)).to(device) for a in batch]


def leaf_names(shape):
    names = [f"{k}.{i}.{p}" for k, n in (("bot", len(shape["ln_bot"]) - 1),
                                         ("top", len(shape["ln_top"]) - 1))
             for i in range(n) for p in ("w", "b")]
    return names + [f"emb.{t}" for t in range(len(shape["rows"]))]


def _tower_leaves(towers):
    return [p for k in ("bot", "top") for layer in towers[k] for p in layer]


def train_steps(shape, seed, batches, device, precision="f32", half_batch=False):
    """SGD over ``batches`` (host tuples) from the seed's weights. Returns the
    touched ids of each table, each step's loss, the exact gradient of
    every leaf at the first step (a table's summed over its occurrences),
    and every leaf before the first step, after it and after the last
    (tables: the touched rows, in id order)."""
    _check(shape)
    q = _rounder(precision)
    dev_batches = [_on(b, device) for b in batches]
    ids = [torch.cat([b[1][t].reshape(-1) for b in dev_batches]) for t in range(len(shape["rows"]))]
    uniq, rows = _tables(shape, seed, ids, device)
    towers = _towers(shape, seed, device)
    dense_leaves = _tower_leaves(towers)
    p0 = [p.clone() for p in dense_leaves + rows]
    losses, g1, p1 = [], None, None
    for k, (dense, indices, weights, labels) in enumerate(dev_batches):
        pos = _positions(uniq, indices)
        occ = [rows[t][p].requires_grad_(True) for t, p in enumerate(pos)]
        for p in dense_leaves:
            p.requires_grad_(True)
        z = logits(towers, _pooled(occ, weights), dense, q)
        y = labels.reshape(-1)
        n = z.shape[0] // 2 if half_batch else z.shape[0]
        loss = bce(z[:n], y[:n])
        grads = torch.autograd.grad(loss, dense_leaves + occ)
        g_dense, g_occ = grads[:len(dense_leaves)], grads[len(dense_leaves):]
        lr = lr_at(k, shape["lr"])
        with torch.no_grad():
            for p, g in zip(dense_leaves, g_dense):
                p.requires_grad_(False)
                p.sub_(lr * g)
            for t, (p, g) in enumerate(zip(pos, g_occ)):
                rows[t].index_add_(0, p.reshape(-1), (-lr * g).reshape(-1, shape["dim"]))
        losses.append(loss.item())
        if k == 0:
            g1 = [g.detach() for g in g_dense] + [
                torch.zeros_like(rows[t]).index_add_(0, p.reshape(-1),
                                                     g.reshape(-1, shape["dim"]))
                for t, (p, g) in enumerate(zip(pos, g_occ))]
            p1 = [p.detach().clone() for p in dense_leaves + rows]
    return {"uniq": uniq, "losses": losses, "g1": g1, "p0": p0, "p1": p1,
            "pn": [p.detach().clone() for p in dense_leaves + rows]}


@torch.no_grad()
def predictions(shape, seed, batches, device, precision="f32"):
    """Click probabilities [B] of each host batch under the seed's weights;
    the rows of all the batches are drawn once."""
    _check(shape)
    dev_batches = [_on(b, device) for b in batches]
    ids = [torch.cat([b[1][t].reshape(-1) for b in dev_batches]) for t in range(len(shape["rows"]))]
    uniq, rows = _tables(shape, seed, ids, device)
    towers, q = _towers(shape, seed, device), _rounder(precision)
    return [torch.sigmoid(logits(
        towers, _pooled([rows[t][p] for t, p in enumerate(_positions(uniq, indices))], weights),
        dense, q)) for dense, indices, weights, _ in dev_batches]
