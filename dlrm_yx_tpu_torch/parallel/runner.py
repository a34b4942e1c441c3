"""The runner interface that the Trainer drives, and the mesh runners' base.

A runner holds one execution mode's state on its device (``params`` and
``opt_state``; on a mesh, this rank's part) and the steps the Trainer
dispatches, which it builds from the mode's three bodies through
``train/capture.py``:

  * ``train_body(params, opt_state, b, lr, sr_seed)`` -> the loss: one
    optimizer step on a prepared batch ``b``;
  * ``accum_body(params, opt_state, batches, lr, sr_seed)`` -> the mean
    micro-batch loss: one optimizer step over ``n_accum`` stacked
    micro-batches;
  * ``eval_body(params, b)`` -> (predictions [B, 1] of the whole batch, the
    loss).

``train_step`` is one step a call on a prepared batch, or with ``n_accum``
> 1 the accumulation step; ``make_multi_step(n)`` gives n full steps a
dispatch on batches stacked ``[n, ...]``, ``eval_step`` the eval step and
``eager_step()`` one step a call that is never captured
(--collect-execution-graph, its trace named ``graph_name``). Each is a
CUDA-graph replay where ``capture`` says so: on the card, where a mesh's
collectives can be captured (NCCL). A step is built when first asked for,
and nothing is warmed or captured before its first call. ``prepare_batch``
gives a rank its part of a global host batch, ``single_device_params`` the
canonical single-device params (export and quantized serving), and
``save_checkpoint`` / ``load_checkpoint`` write and read the JAX package's
npz checkpoint of the runner's trees.

The single-device runners are ``train/trainer.LocalRunner`` (DLRM) and
``train/trainer.HstuRunner`` (HSTU). ``Runner`` is
the base of the three mesh runners (``parallel/hybrid.py``,
``row_sharded.py``, ``col_sharded.py``; one process a rank, the mesh of the
world's ranks, ``parallel/mesh.py``): their constructor, their train and
accumulation bodies around a mode's forward-backward and sparse updates
with one all-reduce of the loss and the dense grads, and the checkpoint of
their sharded trees, gathered to rank 0 to save and resharded on load. A
mode supplies its plan (``make_plan``), its params and optimizer state
(``init_params``, ``init_opt_state``), ``make_bodies``,
``prepare_batch``, ``reshard`` / ``_to_jax``, ``tables`` and the keys of
the trees that each model rank holds a part of (``sharded_keys``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Union

import torch

from dlrm_yx_tpu_torch.config import DLRMConfig, refuse_dcn_and_bags
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import dense_leaves, model_groups, nest_dense
from dlrm_yx_tpu_torch.ops.losses import loss_fn, predictions_from_logits
from dlrm_yx_tpu_torch.optim.lr_policy import lr_or_constant
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, update_dense_towers
from dlrm_yx_tpu_torch.parallel.mesh import Mesh, make_mesh
from dlrm_yx_tpu_torch.train import capture
from dlrm_yx_tpu_torch.utils.profiling import phase_scope


def all_reduce_dense(mesh: Mesh, loss: torch.Tensor, grads: List[torch.Tensor], params: Dict):
    """One all-reduce (sum over the world) of the loss and the dense grads
    (``dense_leaves`` order); returns (loss, the grads nested as
    ``params``' dense leaves)."""
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
    with phase_scope("allreduce"):
        mesh.all_reduce(flat)
    out, pos = [], 1
    for g in grads:
        out.append(flat[pos: pos + g.numel()].view(g.shape))
        pos += g.numel()
    return flat[0], nest_dense(params, out)


def mesh_train_body(mesh: Mesh, opt: OptConfig, forward_backward, updates):
    """body(params, opt_state, b, lr, sr_seed) -> the global batch's mean
    loss: one optimizer step on the rank's batch ``b``.
    ``forward_backward(params, b)`` -> (the rank's loss share, its dense
    grads in ``dense_leaves`` order, the mode's pieces of the step);
    ``updates(params, opt_state, b, pieces, lr)`` applies the sparse
    updates."""
    def body(params, opt_state, b, lr, _sr_seed):
        share, grads, piece = forward_backward(params, b)
        loss, g_dense = all_reduce_dense(mesh, share, grads, params)
        with torch.no_grad(), phase_scope("optimizer"):
            update_dense_towers(opt, params, opt_state, g_dense, lr)
            updates(params, opt_state, b, piece, lr)
        return loss

    return body


def mesh_accum_body(mesh: Mesh, opt: OptConfig, n_accum: int, forward_backward, updates):
    """body(params, opt_state, batches, lr, sr_seed) -> the mean
    micro-batch loss: ``n_accum`` micro-batches, their dense grads summed,
    one optimizer step; ``updates(params, opt_state, batches, pieces, lr)``
    applies the sparse updates from every micro-batch's pieces."""
    def body(params, opt_state, batches, lr, _sr_seed):
        loss_sum = g_sum = None
        pieces = []
        for i in range(n_accum):
            share, grads, piece = forward_backward(params, Batch(*(f[i] for f in batches)))
            with torch.no_grad():
                loss_sum = share if loss_sum is None else loss_sum + share
                g_sum = grads if g_sum is None else [a + g for a, g in zip(g_sum, grads)]
            pieces.append(piece)
        loss, g_dense = all_reduce_dense(mesh, loss_sum, g_sum, params)
        with torch.no_grad(), phase_scope("optimizer"):
            update_dense_towers(opt, params, opt_state, g_dense, lr)
            updates(params, opt_state, batches, pieces, lr)
        return loss / n_accum

    return body


def mesh_eval_body(mesh: Mesh, config: DLRMConfig, logits_of):
    """body(params, b) -> (predictions [B, 1] of the whole global batch,
    gathered over the world in batch order; the mean of the ranks' mean
    losses); ``logits_of(params, b)`` gives the logits of the rank's tower
    rows."""
    def body(params, b):
        logits = logits_of(params, b)
        preds = predictions_from_logits(logits, config.loss_threshold)
        local = loss_fn(logits, b.labels, config.loss, config.loss_threshold,
                        config.wbce_weights)
        loss = mesh.all_reduce(local.reshape(1).clone())[0] / mesh.size
        return mesh.all_gather_world(preds), loss

    return body


def dense_copy(params: Dict) -> Dict:
    """Copies of ``params``' dense leaves, nested as there."""
    return nest_dense(params, [t.detach().clone() for t in dense_leaves(params)])


def single_device_tables(config: DLRMConfig, params: Dict) -> Dict[int, torch.Tensor]:
    """Each table's rows in the single-device params' group stores (plain
    tables: a mode's ``params_from_single_device`` lays them out)."""
    if config.qr_table_ids or config.md_table_ids or config.weighted_pooling:
        raise NotImplementedError("params_from_single_device lays out plain tables only")
    return {t: store[off: off + n]
            for g, store in zip(model_groups(config), params["emb"])
            for t, n, off in zip(g.table_ids, g.rows, g.row_offsets)}


class Runner:
    """A mesh mode's runner, one per rank (the module docstring); the
    Trainer's interface, which the single-device runners also keep."""

    sharded_keys = ()

    def __init__(self, config: DLRMConfig, opt: OptConfig, data: int = 1,
                 model: Optional[int] = None, lr_fn=None, seed: int = 123, n_accum: int = 1,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Dict] = None, **plan_kw):
        """The mesh of the world's ranks, the mode's plan (``plan_kw``: its
        options), this rank's params (``params``, e.g. from the mode's
        ``params_from_single_device``, in place of ``init_params``' host
        draw), their optimizer state and the mode's bodies."""
        refuse_dcn_and_bags(config, type(self).__name__)
        self.config, self.opt = config, opt
        self.lr_fn = lr_or_constant(lr_fn, opt.lr)
        self.n_accum = max(1, n_accum)
        self.mesh = make_mesh(data, model, device)
        self.device, self.capture = self.mesh.device, self.mesh.capturable
        self.plan = self.make_plan(config, self.mesh.shape["model"], **plan_kw)
        self.params = (self.init_params(config, self.plan, seed, self.mesh.m, self.device)
                       if params is None else params)
        self.opt_state = self.init_opt_state(opt, self.params, self.plan)
        self.train_body, self.accum_body, self.eval_body = self.make_bodies()

    # ------------------------------------------------------------- the steps

    @functools.cached_property
    def train_step(self):
        """step(params, opt_state, batch, iteration) -> (params, opt_state,
        loss): one optimizer step on a prepared batch, or with ``n_accum``
        > 1 the accumulation step on ``n_accum`` stacked micro-batches."""
        if self.n_accum > 1:
            return self._accum_step()
        return capture.one_step(self.train_body, self.lr_fn, self.device, self.capture)

    @functools.cached_property
    def eval_step(self):
        """eval(params, batch) -> (predictions [B, 1] of the whole batch,
        loss) on a prepared batch."""
        return self._eval_step()

    def make_multi_step(self, n_steps: int):
        """``n_steps`` full optimizer steps a dispatch (Trainer
        --steps-per-dispatch); batches stacked ``[n_steps, ...]``; returns
        (params, opt_state, losses [n_steps])."""
        if self.n_accum > 1:
            raise ValueError("multi-step dispatch composes with accum at "
                             "the trainer level, not both at once")
        return self._multi_step(n_steps)

    def eager_step(self):
        """One optimizer step a call, never captured
        (--collect-execution-graph)."""
        return capture.one_step(self.train_body, self.lr_fn, self.device, capture=False)

    def _multi_step(self, n_steps: int):
        return capture.multi_step(self.train_body, n_steps, self.lr_fn, self.device,
                                  self.capture)

    def _accum_step(self):
        return capture.one_step(self.accum_body, self.lr_fn, self.device, self.capture)

    def _eval_step(self):
        return capture.eval_step(self.eval_body, self.device, self.capture)

    @functools.cached_property
    def groups(self):
        """The model's table groups (``models.dlrm.model_groups``)."""
        return model_groups(self.config)

    @property
    def graph_name(self) -> str:
        """The file name of ``eager_step``'s execution-graph trace: every
        rank writes its own."""
        rank = self.mesh.rank
        return "hybrid_step" if rank == 0 else f"hybrid_step.rank{rank}"

    # ------------------------------------------------------------ the state

    def single_device_params(self, params: Dict) -> Dict:
        """The canonical single-device params (``models.dlrm``'s group
        stores, f32) from every rank's shard, on every rank (the JAX CLI's
        ``_gather_params``; a collective)."""
        c = self.config
        if c.qr_table_ids or c.md_table_ids or c.weighted_pooling:
            raise NotImplementedError(
                "canonical export from a mesh runner supports plain tables only "
                "(QR/MD/weighted-pooling variants: train single-device or "
                "export from a checkpoint)")
        tables = self.tables(params)
        emb = []
        for g in model_groups(c):
            store = torch.zeros((g.total_rows, g.dim), dtype=torch.float32, device=self.device)
            for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
                store[off: off + n] = tables[tid][:n]
            emb.append(store)
        return {**dense_copy(params), "emb": emb, "vw": None}

    def _model_shards(self, tree: Dict) -> List[Dict]:
        """The M model shards of a rank's tree, gathered over its model group."""
        if not tree:
            return [{}] * self.mesh.shape["model"]
        gathered = {k: self.mesh.all_gather_model(tree[k].unsqueeze(0))
                    for k in self.sharded_keys if tree.get(k) is not None}
        return [dict(tree, **{k: g[j] for k, g in gathered.items()})
                for j in range(self.mesh.shape["model"])]

    def save_checkpoint(self, path: str, params: Dict, opt_state: Dict, **meta) -> None:
        """Write the JAX package's npz checkpoint of the runner's pytrees, as
        its ``load_checkpoint`` reads them: every rank takes part in the
        gather, rank 0 writes. ``meta``: ``write_checkpoint``'s counters."""
        from dlrm_yx_tpu_torch.train.checkpoint import write_checkpoint
        from dlrm_yx_tpu_torch.utils.logging import is_rank0

        shards, states = self._model_shards(params), self._model_shards(opt_state)
        if is_rank0():
            write_checkpoint(path, *self._to_jax(shards, states), **meta)

    def load_checkpoint(self, path: str, params: Dict, opt_state: Dict) -> Dict:
        """Read a checkpoint of this runner's kind (this package's or the JAX
        package's) and copy this rank's shards into ``params`` /
        ``opt_state`` in place (``reshard``; a captured step stays bound to
        them); returns its meta."""
        from dlrm_yx_tpu_torch.train.checkpoint import (
            _leaves,
            read_leaves,
            read_meta,
            unflatten,
        )

        trees = []
        for name, like in (("params", params), ("opt_state", opt_state)):
            leaves = read_leaves(path, name)
            if len(leaves) != len(_leaves(like)):
                raise ValueError(f"{path}/{name}.npz holds {len(leaves)} leaves, the run has "
                                 f"{len(_leaves(like))}")
            trees.append(unflatten(like, iter(leaves)))
        new = self.reshard(*trees)
        with torch.no_grad():
            for dst, src in zip(_leaves((params, opt_state)), _leaves(new)):
                dst.copy_(src)
        return read_meta(path)
