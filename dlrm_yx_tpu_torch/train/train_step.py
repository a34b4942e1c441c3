"""The single-device train and eval steps, multi-step dispatch and
gradient accumulation.

The port of ``apply_gradients``, ``make_train_step``, ``scan_multistep``,
``make_multistep_train_step``, ``make_eval_step`` and
``make_accum_train_step`` in ``dlrm_yx_tpu/train/train_step.py`` (the
reference's hot loop, ``dlrm_s_pytorch.py:1848-1934``): forward -> loss ->
backward -> optimizer step, with sparse embedding updates:

  * the pooled lookups run first, outside autograd (with the gathered rows
    at L=1, for the write-only update);
  * ``torch.autograd.grad`` differentiates the dense graph (MLPs +
    interaction + loss) with respect to the dense params and the pooled
    vectors;
  * the pooled cotangent becomes per-row gradients that
    ``optim/optimizer.sparse_update`` applies to the stores in place, or,
    in the high-L dense regime, ``sparse_update_stream`` applies from the
    pooled cotangent itself (K5/K6). The stores never see a dense gradient
    and autograd never reaches them.

The embedding variants take the same steps: autograd also gives the
gradients of the MD projections (dense params) and of the QR tables'
pooled vectors, whose row gradients (``qr_row_grads``) update the quotient
and remainder tables through ``sparse_update`` (each with no sentinel
tail: ``q_rows`` and ``collisions`` are their sentinels); weighted
pooling scales the row gradients (and the stream route's weights) by
``vw``, and a learned ``vw`` takes ``sparse_update_1d``. Updates are in
place, so every row gradient that reads a table (``qr_row_grads``,
``vw_row_grads``) is taken before that table is updated, as the JAX
package's functional step takes them from the tables before the step.

DLRM-DCNv2's parts: the cross layers (``params["dcn"]``) are dense params,
differentiated and updated with the towers; a batch of fixed multi-hot
bags (``config.multi_hot_sizes``) takes the bag lookup and gives one row
gradient a bag item (``ops/embedding.bag_row_grads``) with the rows the
lookup gathered, so it keeps the write-only update; it never takes the
sorted-stream route, whose layout is ``[T, B, L]``. The train step hands
the bag items' gradients to the optimizer unexpanded
(``embedding.BagRowGrads``): the coalesce-first update sums each row's
items from the pooled cotangent itself (K7, ``ops/coalesce.py``).

HSTU (``models/hstu.py``) has a body of its own, ``hstu_train_body``: the
blocks differentiated by autograd with respect to the dense leaves and the
input tokens' item rows, the sampled-softmax loss (``sampled_softmax``)
taken forward and backward by hand a chunk of positions at a time, AdamW
on the dense leaves and exact row-wise Adagrad on the item table through
the coalesce-first route (``optimizer.coalesced_rows_update``).

Every update is in place: a step returns the params and optimizer state it
was given, updated. Nothing in a step waits for the device; losses come
back as device tensors.

``make_train_step`` is the eager step (an lr from ``lr_fn`` as a float).
Where JAX jits and scans, the port captures: ``make_multistep_train_step``
(N full optimizer steps a dispatch), ``make_accum_train_step`` and
``make_eval_step`` are their bodies built into steps by
``train/capture.py``, which run, on the card, as replays of CUDA graphs,
their lr and stochastic-rounding seed read from device buffers that the
host fills before each replay; with ``capture=False``, and always on the
CPU, the same bodies run eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from dlrm_yx_tpu_torch.config import DLRMConfig, HSTUConfig
from dlrm_yx_tpu_torch.data.batch import Batch, SeqBatch, to_device
from dlrm_yx_tpu_torch.models.hstu import NORM_EPS, count_step, hstu_embeddings, step_context
from dlrm_yx_tpu_torch.models.dlrm import (
    dense_leaves,
    forward_from_pooled,
    forward_logits,
    group_indices,
    lookup_all_groups,
    model_groups,
    nest_dense,
    qr_lookup_all,
    qr_specs,
)
from dlrm_yx_tpu_torch.ops.embedding import (
    bag_row_grads,
    bag_slots,
    flat_row_grads,
    global_row_ids,
    vw_row_grads,
)
from dlrm_yx_tpu_torch.ops.losses import loss_fn, predictions_from_logits
from dlrm_yx_tpu_torch.ops.qr_embedding import qr_row_grads
from dlrm_yx_tpu_torch.optim.lr_policy import lr_or_constant
from dlrm_yx_tpu_torch.ops.hstu_attention import token_positions
from dlrm_yx_tpu_torch.optim.optimizer import (
    DENSE_ACCUM_FACTOR,
    AdamWConfig,
    OptConfig,
    adamw_update,
    coalesced_rows_update,
    finish_dense,
    sparse_update,
    sparse_update_1d,
    sparse_update_stream,
    stream_eligible,
    update_dense_towers,
)
from dlrm_yx_tpu_torch.train import capture as _capture
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.profiling import count_on_device, phase_scope

# a sampled negative equal to the position's positive: the reference's masked logit
MASKED_LOGIT = -5e4
# positions the sampled softmax takes at a time: [2,048, 129, d] candidate rows
SOFTMAX_CHUNK = 2048
# HSTU's dense leaves: AdamW at lr 1e-3, betas (0.9, 0.98), eps 1e-8
HSTU_ADAMW = AdamWConfig()


def _qr_grads(config: DLRMConfig, params: Dict, indices, weights, g_qr_pooled):
    """Per QR table the flat row grads ((qi, gq), (ri, gr)) of its quotient
    and remainder tables, taken from the tables as they are."""
    return [qr_row_grads(q, r, spec, indices[spec.table_id], weights[spec.table_id], g)
            for (q, r), spec, g in zip(params["qr"], qr_specs(config), g_qr_pooled)]


def _update_qr(config: DLRMConfig, opt: OptConfig, params: Dict, opt_state: Dict,
               qr_grads, lr, finish) -> None:
    """The sparse updates of every QR sub-table, in place: natural-layout
    stores with no sentinel tail (their sentinels are ``q_rows`` and
    ``collisions``), routed as the JAX package routes them; ``finish``
    collects the dense branch's K3 finishes."""
    for i, (spec, ((qi, gq), (ri, gr))) in enumerate(zip(qr_specs(config), qr_grads)):
        q, r = params["qr"][i]
        q_acc, r_acc = opt_state["qr"][i] if opt.name != "sgd" else (None, None)
        sparse_update(opt, q, q_acc, qi, gq, lr, spec.q_rows, impl=config.sparse_update_impl,
                      packed=False, finish=finish)
        sparse_update(opt, r, r_acc, ri, gr, lr, spec.collisions,
                      impl=config.sparse_update_impl, packed=False, finish=finish)


def _update_vw(opt: OptConfig, params: Dict, opt_state: Dict, gi: int, g, vidx, vg,
               lr) -> None:
    """The learned pooling weights of group ``gi``, in place."""
    sparse_update_1d(opt, params["vw"][gi], opt_state["vw"][gi] if opt.name != "sgd" else None,
                     vidx, vg, lr, g.total_rows)


def _sparse_update(config: DLRMConfig, opt: OptConfig, store, acc, g, fidx, fg, lr, sr_seed,
                   old_rows, finish) -> None:
    """``sparse_update`` of a group store with the config's routing."""
    sparse_update(
        opt, store, acc, fidx, fg, lr, g.total_rows,
        impl=config.sparse_update_impl,
        stochastic_round=config.stochastic_rounding, sr_seed=sr_seed,
        size_class=g.size_class, dim=g.dim,
        exact_momentum=config.exact_row_momentum,
        old_rows=old_rows, density_hint=config.dup_density_hint, finish=finish,
    )


def _row_grads(config: DLRMConfig, groups, gi: int, batch, g_pooled, vw_g):
    """The flat row gradients (ids [K], grads [K, dim]) of group ``gi``."""
    bags = bag_slots(groups, config.multi_hot_sizes)
    if bags is not None:
        return bag_row_grads(bags[gi], batch.indices, g_pooled)
    g = groups[gi]
    return flat_row_grads(g, group_indices(g, batch.indices), group_indices(g, batch.weights),
                          g_pooled, vw_g)


@torch.no_grad()
def apply_gradients(config: DLRMConfig, opt: OptConfig, groups, params: Dict,
                    opt_state: Dict, batch, g_dense: Dict, g_pooled, lr,
                    raw_rows=None, sr_seed=0, g_qr_pooled=()) -> None:
    """Dense updates of the MLPs (and MD projections, cross layers) and sparse row updates
    of every group store (and QR sub-table, and learned pooling weights)
    from the pooled cotangents, in place. lr: a float or a 0-dim f32 device
    tensor; raw_rows: per-group rows gathered by the forward lookup (L=1
    groups, else None); sr_seed: the stochastic rounding's seed (the step;
    an int or a 0-dim integer device tensor); g_qr_pooled: the QR tables'
    pooled cotangents."""
    with phase_scope("optimizer"):
        update_dense_towers(opt, params, opt_state, g_dense, lr)
        # the dense branch's K3 stores, finished in one launch after the last
        # sparse update: nothing in between reads them (the QR and learned
        # vw grads are taken from the tables before any update, and the
        # stores are disjoint)
        dense = []
        if g_qr_pooled:
            # both sub-tables' grads first: each reads the other table
            _update_qr(config, opt, params, opt_state,
                       _qr_grads(config, params, batch.indices, batch.weights, g_qr_pooled), lr,
                       dense)
        vw = params.get("vw")
        bags = bag_slots(groups, config.multi_hot_sizes)
        for gi, g in enumerate(groups):
            store = params["emb"][gi]
            acc = opt_state["emb"][gi] if opt.name != "sgd" else None
            if bags is not None:
                # unexpanded: the coalesce-first update reads each item's row
                # from the pooled cotangent, every other route expands it
                fidx, fg = bag_row_grads(bags[gi], batch.indices, g_pooled[gi], expand=False)
                old_rows = None
                if raw_rows is not None and raw_rows[gi] is not None:
                    old_rows = raw_rows[gi].reshape(-1, g.dim)
                _sparse_update(config, opt, store, acc, g, fidx, fg, lr, sr_seed, old_rows,
                               dense)
                continue
            idx_g = group_indices(g, batch.indices)
            w_g = group_indices(g, batch.weights)
            vw_g = None if vw is None else vw[gi]
            vw_grads = None
            if config.weighted_pooling == "learned":
                # from the store before its update
                vw_grads = vw_row_grads(g, store, idx_g, w_g, g_pooled[gi])
            t, b, l = idx_g.shape
            use_stream = (
                (config.sparse_update_impl == "stream"
                 or (config.sparse_update_impl == "pallas" and opt.name == "sgd"))
                and stream_eligible(opt, store, g)
                and not config.exact_row_momentum
                and not config.stochastic_rounding
                and t * b * l * DENSE_ACCUM_FACTOR >= g.total_rows // g.pack
            )
            if use_stream:
                # SGD is exact on both routes, so 'pallas' sends its dense
                # regime through the sorted stream as well
                gidx = global_row_ids(g, idx_g)
                w_eff = w_g
                if vw_g is not None:
                    w_eff = w_g * vw_g.index_select(0, gidx.reshape(-1)).reshape(idx_g.shape)
                sparse_update_stream(opt, store, acc, g, gidx, w_eff, g_pooled[gi], lr)
            else:
                fidx, fg = flat_row_grads(g, idx_g, w_g, g_pooled[gi], vw_g)
                old_rows = None
                if raw_rows is not None and raw_rows[gi] is not None:
                    old_rows = raw_rows[gi].reshape(t * b, g.dim)
                _sparse_update(config, opt, store, acc, g, fidx, fg, lr, sr_seed, old_rows,
                               dense)
            if vw_grads is not None:
                _update_vw(opt, params, opt_state, gi, g, *vw_grads, lr)
        finish_dense(dense, lr, opt.eps)


def _dense_grads(config: DLRMConfig, groups, params: Dict, b: Batch, pooled, qr_pooled=()):
    """(loss, dense grads nested as ``params``' dense leaves, pooled
    grads, QR pooled grads) of one batch: the dense graph differentiated
    with respect to the MLPs, the MD projections, the cross layers and the
    pooled vectors."""
    pooled = [p.requires_grad_() for p in pooled]
    qr_pooled = [p.requires_grad_() for p in qr_pooled]
    leaves = [p.detach().requires_grad_() for p in dense_leaves(params)]
    with torch.enable_grad():
        logits = forward_from_pooled({**params, **nest_dense(params, leaves)}, config, groups,
                                     b.dense, pooled, qr_pooled)
        with phase_scope("loss_compute"):
            loss = loss_fn(logits, b.labels, config.loss, config.loss_threshold,
                           config.wbce_weights)
    with phase_scope("backward"):
        grads = torch.autograd.grad(loss, leaves + pooled + qr_pooled)
    n, n_pooled = len(leaves), len(pooled)
    return (loss.detach(), nest_dense(params, grads[:n]), list(grads[n:n + n_pooled]),
            list(grads[n + n_pooled:]))


def _lookups(config: DLRMConfig, groups, params: Dict, b: Batch, want_rows: bool = False):
    """(pooled per group, QR pooled, rows per group or None) of one batch,
    outside autograd."""
    with torch.no_grad():
        hot = config.multi_hot_sizes
        if want_rows:
            pooled, raw_rows = lookup_all_groups(params, groups, b.indices, b.weights,
                                                 want_rows=True, hotness=hot)
        else:
            pooled = lookup_all_groups(params, groups, b.indices, b.weights, hotness=hot)
            raw_rows = None
        qr_pooled = (qr_lookup_all(params, config, b.indices, b.weights)
                     if config.qr_table_ids else [])
    return pooled, qr_pooled, raw_rows


def train_body(config: DLRMConfig, opt: OptConfig):
    """body(params, opt_state, b, lr, sr_seed) -> loss: one optimizer step
    on a device batch ``b``; lr a float or 0-dim f32 device tensor, sr_seed
    an int or 0-dim integer device tensor (the step). The inner step of
    every train step here."""
    groups = model_groups(config)

    def body(params, opt_state, b, lr, sr_seed):
        pooled, qr_pooled, raw_rows = _lookups(config, groups, params, b,
                                               config.write_only_update)
        loss, g_dense, g_pooled, g_qr = _dense_grads(config, groups, params, b, pooled,
                                                     qr_pooled)
        apply_gradients(config, opt, groups, params, opt_state, b, g_dense,
                        g_pooled, lr, raw_rows, sr_seed=sr_seed, g_qr_pooled=g_qr)
        return loss

    return body


def make_train_step(config: DLRMConfig, opt: OptConfig,
                    lr_fn: Optional[Callable[[int], float]] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """Returns step(params, opt_state, batch, iteration) -> (params,
    opt_state, loss), run eagerly. ``params`` / ``opt_state`` live on
    ``device`` (the card unless the caller asks for the CPU) and are
    updated in place; ``batch`` is a ``Batch`` of numpy arrays or tensors;
    ``loss`` is a 0-dim device tensor. lr_fn maps the 0-based iteration to
    the lr (``optim/lr_policy.LRPolicy``); without it the lr is ``opt.lr``
    as float32."""
    body = train_body(config, opt)
    dev = resolve_device(device)
    lr_of = lr_or_constant(lr_fn, opt.lr)

    def step(params, opt_state, batch, iteration):
        loss = body(params, opt_state, to_device(batch, dev), lr_of(iteration), iteration)
        return params, opt_state, loss

    return step


def make_multistep_train_step(config: DLRMConfig, opt: OptConfig, n_steps: int,
                              lr_fn: Optional[Callable[[int], float]] = None,
                              device: Optional[Union[str, torch.device]] = None,
                              capture: Optional[bool] = None):
    """``n_steps`` full optimizer steps a call: the same results as calling
    ``make_train_step``'s step ``n_steps`` times in sequence (each with its
    own lr and SR seed), as one replay of a CUDA graph on the card
    (``capture``, the default there). step(params, opt_state,
    stacked_batch, iteration): every Batch field has a leading [n_steps]
    axis; iteration is the index of the first step. Returns (params,
    opt_state, losses [n_steps])."""
    return _capture.multi_step(train_body(config, opt), n_steps, lr_or_constant(lr_fn, opt.lr),
                               resolve_device(device), capture)


def make_eval_step(config: DLRMConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   capture: Optional[bool] = None):
    """Returns eval(params, batch) -> (predictions [B, 1], loss). ``params``
    is the parameter dict (``models.dlrm``) on ``device`` (the card unless
    the caller asks for the CPU); ``batch`` is a ``Batch`` of numpy arrays
    or tensors. On the card (``capture``, the default there) the step is a
    replay of a CUDA graph over static batch buffers, one graph for each
    batch shape, and the outputs are copies."""
    groups = model_groups(config)

    def body(params, b):
        logits = forward_logits(params, config, groups, b.dense, b.indices, b.weights)
        preds = predictions_from_logits(logits, config.loss_threshold)
        loss = loss_fn(logits, b.labels, config.loss, config.loss_threshold,
                       config.wbce_weights)
        return preds, loss

    return _capture.eval_step(body, resolve_device(device), capture)


def make_accum_train_step(config: DLRMConfig, opt: OptConfig, n_accum: int,
                          lr_fn: Optional[Callable[[int], float]] = None,
                          device: Optional[Union[str, torch.device]] = None,
                          capture: Optional[bool] = None):
    """Gradient accumulation over ``n_accum`` micro-batches with ONE
    optimizer step (--mlperf-grad-accum-iter: the reference steps the
    optimizer every N-th mini-batch, so autograd sums the grads across
    them, dlrm_s_pytorch.py:1925-1932).

    step(params, opt_state, stacked_batch, iteration) -> (params,
    opt_state, loss): every Batch field has a leading [n_accum] axis. Dense
    grads are summed over the micro-batches; every micro-batch's row grads
    (against the stores before the step) are concatenated into one sparse
    update per group, so the Adagrad-family momenta see the accumulated
    gradient once. It never takes the sorted-stream route nor the
    write-only update. The loss is the mean micro-batch loss; the lr is
    ``lr_fn(iteration)`` and the SR seed ``iteration``. QR sub-tables and
    learned pooling weights take one update each over every micro-batch's
    row grads, as in the JAX package. A CUDA-graph replay on the card
    (``capture``, the default there)."""
    dev = resolve_device(device)
    groups = model_groups(config)
    learned = config.weighted_pooling == "learned"

    def body(params, opt_state, batches, lr, seed):
        vw = params.get("vw")
        g_sum = [torch.zeros_like(p) for p in dense_leaves(params)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        fidx_all, fg_all = [[] for _ in groups], [[] for _ in groups]
        vidx_all, vg_all = [[] for _ in groups], [[] for _ in groups]
        g_qr_all = [[] for _ in config.qr_table_ids]
        for m in range(n_accum):
            b = Batch(*(f[m] for f in batches))
            pooled, qr_pooled, _ = _lookups(config, groups, params, b)
            loss, g_dense, g_pooled, g_qr = _dense_grads(config, groups, params, b, pooled,
                                                         qr_pooled)
            with torch.no_grad():
                # every micro-batch's row grads come from the tables before the step
                g_sum = [s + g for s, g in zip(g_sum, dense_leaves(g_dense))]
                loss_sum = loss_sum + loss
                for acc, g in zip(g_qr_all, g_qr):
                    acc.append(g)
                for gi, g in enumerate(groups):
                    fidx, fg = _row_grads(config, groups, gi, b, g_pooled[gi],
                                          None if vw is None else vw[gi])
                    fidx_all[gi].append(fidx)
                    fg_all[gi].append(fg)
                    if learned:
                        idx_g, w_g = group_indices(g, b.indices), group_indices(g, b.weights)
                        vidx, vg = vw_row_grads(g, params["emb"][gi], idx_g, w_g, g_pooled[gi])
                        vidx_all[gi].append(vidx)
                        vg_all[gi].append(vg)
        with torch.no_grad(), phase_scope("optimizer"):
            update_dense_towers(opt, params, opt_state, nest_dense(params, g_sum), lr)
            # one K3 launch after the last sparse update, as in apply_gradients
            dense = []
            if g_qr_all:
                # the micro axis folded into the batch axis, as in JAX: one
                # coalesced update a sub-table over every micro-batch's rows
                def fold(x):  # [n_accum, T, B, L] -> [T, n_accum * B, L]
                    return x.transpose(0, 1).reshape(x.shape[1], -1, x.shape[3])

                grads = _qr_grads(config, params, fold(batches.indices), fold(batches.weights),
                                  [torch.cat(g) for g in g_qr_all])
                _update_qr(config, opt, params, opt_state, grads, lr, dense)
            for gi, g in enumerate(groups):
                _sparse_update(config, opt, params["emb"][gi],
                               opt_state["emb"][gi] if opt.name != "sgd" else None, g,
                               torch.cat(fidx_all[gi]), torch.cat(fg_all[gi]), lr, seed, None,
                               dense)
                if learned:
                    _update_vw(opt, params, opt_state, gi, g, torch.cat(vidx_all[gi]),
                               torch.cat(vg_all[gi]), lr)
            finish_dense(dense, lr, opt.eps)
        return loss_sum / n_accum

    return _capture.one_step(body, lr_or_constant(lr_fn, opt.lr), dev, capture)


def sampled_softmax(config: HSTUConfig, items: torch.Tensor, u: torch.Tensor, b: SeqBatch,
                    row_grads: torch.Tensor):
    """HSTU's sampled-softmax loss over a batch's supervised positions, its
    forward and backward by hand: (loss, dL/du [T, d]), and each position's
    candidate rows' gradient written into ``row_grads`` [T, R + 1, d] (the
    positive, then the R negatives; zero at unsupervised positions).

    At a position with output u (L2-normalised), the candidates' rows x_c
    (the positive's, then the negatives') are L2-normalised (e_c = x_c /
    max(|x_c|, 1e-6)); the logits are u . e_c / temperature, a negative
    equal to the positive masked to -5e4; the loss is the positive's
    -log_softmax, weighted by the position's weight over the weights' sum.
    A chunk of ``SOFTMAX_CHUNK`` positions at a time, in f32, so the
    [T, R + 1, d] candidate rows are never gathered at once."""
    t, d = u.shape
    tau = config.temperature
    w = b.weights.float()
    scale = w / w.sum()
    count_on_device("sampled_softmax.negatives", (w > 0).sum() * config.num_negatives)
    cand = torch.cat([b.positives.long()[:, None], b.negatives.long()], dim=1)
    loss = torch.zeros((), dtype=torch.float32, device=u.device)
    g_u = torch.empty_like(u)
    for c0 in range(0, t, SOFTMAX_CHUNK):
        c1 = min(c0 + SOFTMAX_CHUNK, t)
        ids = cand[c0:c1]
        rows = items.index_select(0, ids.reshape(-1)).view(c1 - c0, -1, d)
        norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
        e = rows / norm.clamp(min=NORM_EPS)
        uc = u[c0:c1]
        logits = torch.bmm(e, uc[:, :, None]).squeeze(-1) / tau
        hit = ids[:, 1:] == ids[:, :1]
        logits[:, 1:].masked_fill_(hit, MASKED_LOGIT)
        logp = torch.log_softmax(logits, dim=1)
        sc = scale[c0:c1]
        loss -= (sc * logp[:, 0]).sum()
        dl = logp.exp_()
        dl[:, 0] -= 1.0
        dl.mul_((sc / tau)[:, None])
        dl[:, 1:].masked_fill_(hit, 0.0)
        g_u[c0:c1] = torch.bmm(dl[:, None, :], e).squeeze(1)
        ge = dl[..., None] * uc[:, None, :]
        # through e = x / max(|x|, eps): the projection off e where the norm
        # is not clamped
        proj = (ge * e).sum(dim=-1, keepdim=True) * (norm > NORM_EPS)
        torch.div(ge - e * proj, norm.clamp(min=NORM_EPS), out=row_grads[c0:c1])
    return loss, g_u


def hstu_train_body(config: HSTUConfig, opt: OptConfig):
    """body(params, opt_state, b, lr, step) -> loss: one HSTU optimizer
    step on a device ``SeqBatch`` ``b``; lr the table's (a float or 0-dim
    f32 device tensor; the dense leaves' is it times ``HSTU_ADAMW.lr`` over
    ``opt.lr``), step the 0-based iteration (int or 0-dim integer tensor:
    AdamW's bias correction takes step + 1)."""
    adam = HSTU_ADAMW
    if opt.name != "rwsadagrad":
        raise ValueError("HSTU trains its table by row-wise Adagrad (--optimizer "
                         "rwsadagrad) and its dense leaves by AdamW")
    d, r = config.embedding_dim, config.num_negatives

    def body(params, opt_state, b, lr, step):
        items = params["items"]
        t = b.ids.shape[0]
        count_step(config, b.offsets, b.weights)
        ctx = step_context(config, b.offsets, b.times)
        ids = b.ids.long()
        with torch.no_grad():
            rows_in = items.index_select(0, ids)
        rows_in.requires_grad_()
        leaves = [p.detach().requires_grad_() for p in dense_leaves(params)]
        with torch.enable_grad():
            u = hstu_embeddings({**params, **nest_dense(params, leaves)}, config, rows_in,
                                token_positions(b.offsets, t), ctx)
        # every item's row gradient: the input tokens', then each position's
        # positive and negatives
        grads = torch.empty((t * (r + 2), d), dtype=torch.float32, device=items.device)
        with torch.no_grad(), phase_scope("loss.sampled_softmax"):
            loss, g_u = sampled_softmax(config, items, u.detach(), b, grads[t:].view(t, r + 1, d))
        with phase_scope("backward"):
            g = torch.autograd.grad(u, leaves + [rows_in], g_u)
        with torch.no_grad(), phase_scope("optimizer"):
            grads[:t] = g[-1]
            # the items in the order grads holds them
            cand = torch.cat([b.positives.long()[:, None], b.negatives.long()], dim=1)
            flat_idx = torch.cat([ids, cand.reshape(-1)])
            step_t = torch.as_tensor(step, device=items.device).float() + 1.0
            adamw_update(adam, dense_leaves(params), list(g[:-1]),
                         dense_leaves(opt_state["adam_m"]), dense_leaves(opt_state["adam_v"]),
                         lr * (adam.lr / opt.lr), step_t)
            held = [grads]
            del grads, g
            coalesced_rows_update(opt, items, opt_state["items"], flat_idx, held, lr,
                                  config.num_items)
        return loss

    return body
