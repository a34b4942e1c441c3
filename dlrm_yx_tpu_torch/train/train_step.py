"""The single-device train and eval steps.

The port of ``apply_gradients``, ``make_train_step`` and ``make_eval_step``
in ``dlrm_yx_tpu/train/train_step.py`` (the reference's hot loop,
``dlrm_s_pytorch.py:1848-1934``): forward -> loss -> backward ->
optimizer step, with sparse embedding updates. PyTorch runs eagerly, so
there is nothing to jit:

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

Every update is in place: the step returns the params and optimizer state
it was given, updated. Nothing in the step waits for the device; the loss
comes back as a device scalar. Not ported yet: gradient accumulation
(``make_accum_train_step``), multi-step dispatch (``scan_multistep``) and
QR / MD / weighted-pooling updates.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import to_device
from dlrm_yx_tpu_torch.models.dlrm import (
    check_supported,
    forward_from_pooled,
    forward_logits,
    group_indices,
    lookup_all_groups,
    model_groups,
)
from dlrm_yx_tpu_torch.ops.embedding import flat_row_grads, global_row_ids
from dlrm_yx_tpu_torch.ops.losses import loss_fn, predictions_from_logits
from dlrm_yx_tpu_torch.optim.optimizer import (
    DENSE_ACCUM_FACTOR,
    OptConfig,
    sparse_update,
    sparse_update_stream,
    stream_eligible,
    update_dense_towers,
)
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.profiling import phase_scope


@torch.no_grad()
def apply_gradients(config: DLRMConfig, opt: OptConfig, groups, params: Dict,
                    opt_state: Dict, batch, g_dense: Dict, g_pooled, lr: float,
                    raw_rows=None) -> None:
    """Dense updates of the MLPs and sparse row updates of every group
    store from the pooled cotangent, in place. raw_rows: per-group rows
    gathered by the forward lookup (L=1 groups, else None)."""
    with phase_scope("optimizer"):
        update_dense_towers(opt, params, opt_state, g_dense, lr)
        for gi, g in enumerate(groups):
            idx_g = group_indices(g, batch.indices)
            w_g = group_indices(g, batch.weights)
            store = params["emb"][gi]
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
                # regime through the sorted stream as well; weighted
                # pooling (unported) would scale w_g by the row weights
                sparse_update_stream(
                    opt, store, opt_state["emb"][gi] if opt.name != "sgd" else None,
                    g, global_row_ids(g, idx_g), w_g, g_pooled[gi], lr)
                continue
            fidx, fg = flat_row_grads(g, idx_g, w_g, g_pooled[gi])
            old_rows = None
            if raw_rows is not None and raw_rows[gi] is not None:
                old_rows = raw_rows[gi].reshape(t * b, g.dim)
            sparse_update(
                opt, store, opt_state["emb"][gi] if opt.name != "sgd" else None,
                fidx, fg, lr, g.total_rows,
                impl=config.sparse_update_impl,
                stochastic_round=config.stochastic_rounding,
                size_class=g.size_class, dim=g.dim,
                exact_momentum=config.exact_row_momentum,
                old_rows=old_rows, density_hint=config.dup_density_hint,
            )


def make_train_step(config: DLRMConfig, opt: OptConfig,
                    lr_fn: Optional[Callable[[int], float]] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """Returns step(params, opt_state, batch, iteration) -> (params,
    opt_state, loss). ``params`` / ``opt_state`` live on ``device`` (the
    card unless the caller asks for the CPU) and are updated in place;
    ``batch`` is a ``Batch`` of numpy arrays or tensors; ``loss`` is a
    0-dim device tensor. lr_fn maps the 0-based iteration to the lr
    (``optim/lr_policy.LRPolicy``); without it the lr is ``opt.lr`` as
    float32."""
    check_supported(config)
    dev = resolve_device(device)
    groups = model_groups(config)
    base_lr = float(np.float32(opt.lr))

    def step(params, opt_state, batch, iteration):
        lr = lr_fn(iteration) if lr_fn is not None else base_lr
        b = to_device(batch, dev)
        with torch.no_grad():
            if config.write_only_update:
                pooled, raw_rows = lookup_all_groups(
                    params, groups, b.indices, b.weights, want_rows=True)
            else:
                pooled = lookup_all_groups(params, groups, b.indices, b.weights)
                raw_rows = None
        pooled = [p.requires_grad_() for p in pooled]
        dense = {k: [(w.detach().requires_grad_(), c.detach().requires_grad_())
                     for w, c in params[k]] for k in ("bot", "top")}
        with torch.enable_grad():
            logits = forward_from_pooled({**params, **dense}, config, groups,
                                         b.dense, pooled)
            with phase_scope("loss_compute"):
                loss = loss_fn(logits, b.labels, config.loss, config.loss_threshold,
                               config.wbce_weights)
        leaves = [t for k in ("bot", "top") for pair in dense[k] for t in pair]
        with phase_scope("backward"):
            grads = torch.autograd.grad(loss, leaves + pooled)
        it = iter(grads)
        g_dense = {k: [(next(it), next(it)) for _ in params[k]] for k in ("bot", "top")}
        g_pooled = list(it)
        apply_gradients(config, opt, groups, params, opt_state, b, g_dense,
                        g_pooled, lr, raw_rows)
        return params, opt_state, loss.detach()

    return step


def make_eval_step(config: DLRMConfig,
                   device: Optional[Union[str, torch.device]] = None):
    """Returns eval(params, batch) -> (predictions [B, 1], loss). ``params``
    is the parameter dict (``models.dlrm``) on ``device`` (the card unless
    the caller asks for the CPU); ``batch`` is a ``Batch`` of numpy arrays
    or tensors, moved to ``device`` when it is not there."""
    dev = resolve_device(device)
    groups = model_groups(config)

    @torch.inference_mode()
    def eval_step(params, batch):
        b = to_device(batch, dev)
        logits = forward_logits(params, config, groups, b.dense, b.indices,
                                b.weights)
        preds = predictions_from_logits(logits, config.loss_threshold)
        loss = loss_fn(logits, b.labels, config.loss, config.loss_threshold,
                       config.wbce_weights)
        return preds, loss

    return eval_step
