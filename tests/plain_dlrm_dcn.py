"""A plain DLRM-DCNv2, written from the equations of the MLPerf reference
(``recommendation_v2/torchrec_dlrm``: TorchRec's ``DLRM_DCN`` with a
``LowRankCrossNet``) in float32 PyTorch, TF32 off, for the tests to hold
the port against. It imports nothing of the port and no JAX.

The model: the bottom MLP of ReLU layers on the dense features; each
table's bag summed (``EmbeddingBag(mode="sum")``, a repeated id counted
each time); x0 the bottom output, then each table's pooled vector,
concatenated; the cross layers

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

with ``V_l`` [N, r] and ``W_l`` [r, N] applied as ``x @ V`` and ``(x V) @ W``;
the top MLP of ReLU layers with a last linear layer, its logit taken by
BCE in the stable form. Training: exact row-wise Adagrad on the tables
(FBGEMM's ``EXACT_ROWWISE_ADAGRAD``: each row's gradient summed over its
occurrences first, its momentum growing by the mean of the summed
gradient's squares, ``w -= lr * g / (sqrt(m) + eps)``), and
``torch.optim.Adagrad``'s update on every dense param (towers and cross
layers): ``a += g * g``, ``p -= lr * g / (sqrt(a) + eps)``.

Parameters are a dict: ``bot`` and ``top`` lists of ``(W [in, out], b)``,
``dcn`` a list of ``(V, W, b)``, ``tables`` a list of [rows, D]. A batch
is ``(dense [B, m], bags, labels [B])`` with ``bags[t]`` the [B, h_t] ids
of table t.
"""

from __future__ import annotations

import torch


def exact_f32() -> None:
    """float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp(x, layers, last_raw: bool):
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if not (last_raw and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def cross(x0, layers):
    x = x0
    for v, w, b in layers:
        x = x0 * ((x @ v) @ w + b) + x
    return x


def pooled(tables, bags):
    """[B, T, D]: each table's bag summed."""
    return torch.stack([torch.nn.functional.embedding_bag(ids, table, mode="sum")
                        for table, ids in zip(tables, bags)], dim=1)


def logits(params, dense, bags):
    x = mlp(dense, params["bot"], last_raw=False)
    x0 = torch.cat([x[:, None, :], pooled(params["tables"], bags)], dim=1).reshape(x.shape[0], -1)
    return mlp(cross(x0, params["dcn"]), params["top"], last_raw=True).reshape(-1)


def bce(z, y):
    return torch.mean(torch.clamp_min(z, 0.0) - z * y + torch.log1p(torch.exp(-z.abs())))


def dense_leaves(params):
    return [p for k in ("bot", "dcn", "top") for layer in params[k] for p in layer]


def init_state(params):
    """Adagrad's sums of the dense leaves, and each table's row momentum."""
    return {"dense": [torch.zeros_like(p) for p in dense_leaves(params)],
            "tables": [t.new_zeros(t.shape[0]) for t in params["tables"]]}


def loss_and_grads(params, batch):
    """(loss, dense leaves' gradients, each table's summed row gradients)."""
    dense, bags, labels = batch
    leaves = dense_leaves(params) + list(params["tables"])
    for p in leaves:
        p.requires_grad_(True)
    loss = bce(logits(params, dense, bags), labels)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    n = len(leaves) - len(params["tables"])
    return loss.detach(), list(grads[:n]), list(grads[n:])


def train_step(params, state, batch, lr: float, eps: float = 1e-10):
    """One step, in place; returns the loss."""
    loss, g_dense, g_tables = loss_and_grads(params, batch)
    with torch.no_grad():
        for p, a, g in zip(dense_leaves(params), state["dense"], g_dense):
            a.add_(g * g)
            p.sub_(lr * g / (a.sqrt() + eps))
        for table, mom, g in zip(params["tables"], state["tables"], g_tables):
            mom.add_((g * g).mean(dim=1))  # untouched rows: g = 0, no change
            table.sub_(lr * g / (mom.sqrt() + eps)[:, None])
    return float(loss)
