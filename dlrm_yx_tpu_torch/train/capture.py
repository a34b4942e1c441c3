"""Steps as replays of CUDA graphs: the port's counterpart of ``jax.jit``.

A JAX step is one compiled dispatch, and the JAX package hides even that
behind ``lax.scan`` over N steps (``scan_multistep``). The port's eager step
issues a few hundred launches through Python, the dispatcher and autograd,
and the card idles most of each step. ``GraphStep`` runs a step body as a
replay of a CUDA graph instead:

  * the body reads its batch from static device buffers and its per-step
    scalars (the lr and the stochastic-rounding seed of each of its steps)
    from a static device vector. Before every call the host refills both on
    the current stream: the batch from host arrays through pinned memory, or
    device to device; the scalars (``lr_fn(iteration + i)`` and
    ``iteration + i``) in one pinned, non-blocking copy. Nothing in the body
    reads a value back to the host or copies from it;
  * the first call of each batch shape runs the body eagerly on a side
    stream, as real steps: it builds the kernels, their zeroed scratch and
    the cached index vectors (a wrapper must be called once before it is
    captured, ``ops/_build.zeroed_scratch``). The next call captures the
    body into a graph, which does not execute it, and replays the graph
    once, which does; later calls replay it. One graph per batch shape;
  * the graph is bound to the params and optimizer state it was captured
    with, every tensor of both trees (the stores, QR tables, MD projections
    and pooling weights among them; they are updated in place): a call
    with other tensors raises.
    Its outputs are overwritten by the next replay, so each call returns
    copies;
  * counters count what ran on the card: the capture takes back what the
    body counted while it recorded (nothing ran), the kernel wrappers'
    ``.launches`` and the capturing thread's ``utils.profiling.count``
    counters alike (``sparse_update.<route>``), and every replay adds it
    once. A shape's first call counts ``graph.warm``, its second
    ``graph.capture`` and ``graph.replay``, later ones ``graph.replay``.
    The spans ``step.copy_in`` (the batch and the scalars refilled),
    ``step.warm``, ``step.capture``, ``step.replay`` and ``step.copy_out``
    (the outputs copied) carry the call's first iteration, or an eval
    step's call number, as their ``req``;
  * a failed capture or replay raises: nothing falls back to the eager body
    on the card. Calls that share a kernel's scratch stay in one stream's
    order (``csrc/row_plan.cuh``): the side stream and the capture wait for
    the current stream and the current stream for them.

With ``capture`` off (always on the CPU) the same body runs eagerly on
scalars made for the call, so the CPU runs the same code as the card.

Every step of the port is built here, from a body, by one of three
constructors: ``one_step`` (one call of a train or accumulation body a
dispatch), ``multi_step`` (N full train steps a dispatch) and ``eval_step``.
Each step carries its ``GraphStep`` as ``.graph_step``. ``capture=None``
captures on the card and never on the CPU; a mesh whose collectives cannot
be captured (gloo) passes ``False``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from dlrm_yx_tpu_torch.data.batch import Batch, copy_batch, empty_like_batch, signature, to_device
from dlrm_yx_tpu_torch.utils.profiling import count, phase_scope, thread_counts


def launch_counters() -> Dict[str, Callable]:
    """The kernel wrappers, by name, whose ``.launches`` a capture corrects
    (K3's grouped wrapper has a count of its own beside K3's)."""
    from dlrm_yx_tpu_torch.ops.coalesce import coalesce_finish, coalesce_segments
    from dlrm_yx_tpu_torch.ops.dcn import cross_net
    from dlrm_yx_tpu_torch.ops.dense_finish import (
        rwsadagrad_dense_finish,
        rwsadagrad_dense_finish_many,
    )
    from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
    from dlrm_yx_tpu_torch.ops.sparse_rows_add import sparse_rows_add
    from dlrm_yx_tpu_torch.ops.sparse_rows_overwrite import sparse_rows_overwrite
    from dlrm_yx_tpu_torch.ops.stream_update import sorted_stream_add, sorted_stream_apply

    return {f.__name__: f for f in (fused_interaction, sparse_rows_overwrite,
                                    rwsadagrad_dense_finish, rwsadagrad_dense_finish_many,
                                    sorted_stream_apply, sorted_stream_add, sparse_rows_add,
                                    coalesce_segments, coalesce_finish, cross_net)}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def _copy(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


class _Slot:
    """The static buffers and the graph of one batch shape."""

    def __init__(self, batch: Batch, n_scalars: int, device: torch.device):
        self.batch = empty_like_batch(batch, device)
        # n int64 seeds, then n f32 lrs: one buffer, one copy
        self.scalars = torch.empty(12 * n_scalars, dtype=torch.uint8, device=device)
        self.seeds = self.scalars[:8 * n_scalars].view(torch.int64)
        self.lrs = self.scalars[8 * n_scalars:].view(torch.float32)
        self.warm = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.bound = ()
        self.launched: Dict[str, int] = {}
        self.counted: Dict[str, int] = {}
        self.replays = 0


class GraphStep:
    """``step(params, opt_state, batch, iteration)`` -> the body's output
    (a tensor or a tuple of tensors), where ``body(params, opt_state, batch,
    lrs, seeds)`` runs on device tensors: ``batch`` a ``Batch``, ``lrs``
    [n_scalars] f32 and ``seeds`` [n_scalars] int64 (``lr_fn(iteration +
    i)`` and ``iteration + i``). ``capture`` replays it from a CUDA graph
    (see the module docstring); ``inference`` runs it under
    ``torch.inference_mode``."""

    def __init__(self, body, n_scalars: int, lr_fn: Callable[[int], float],
                 device: torch.device, capture: bool, inference: bool = False):
        if capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.body = body
        self.n_scalars = n_scalars
        self.lr_fn = lr_fn
        self.device = device
        self.capture = capture
        self.inference = inference
        self.calls = 0
        self._slots: Dict[tuple, _Slot] = {}

    def replays(self) -> int:
        """Graph replays so far, over every batch shape."""
        return sum(slot.replays for slot in self._slots.values())

    def _host_scalars(self, iteration: int):
        its = np.arange(iteration, iteration + self.n_scalars, dtype=np.int64)
        lrs = np.array([self.lr_fn(int(i)) for i in its], dtype=np.float32)
        return its, lrs

    def __call__(self, params, opt_state, batch: Batch, iteration: int = 0):
        if self.inference:
            with torch.inference_mode():
                return self._call(params, opt_state, batch, iteration)
        return self._call(params, opt_state, batch, iteration)

    def _call(self, params, opt_state, batch, iteration):
        self.calls += 1
        req = iteration if self.n_scalars else self.calls
        if not self.capture:
            with phase_scope("step.copy_in", req):
                its, lrs = self._host_scalars(iteration)
                args = (params, opt_state, to_device(batch, self.device),
                        torch.from_numpy(lrs).to(self.device), torch.from_numpy(its).to(self.device))
            return self.body(*args)
        key = signature(batch)
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot(batch, self.n_scalars, self.device)
        with phase_scope("step.copy_in", req):
            copy_batch(slot.batch, batch)
            if self.n_scalars:
                its, lrs = self._host_scalars(iteration)
                host = np.concatenate([its.view(np.uint8), lrs.view(np.uint8)])
                slot.scalars.copy_(torch.from_numpy(host).pin_memory(), non_blocking=True)
        args = (params, opt_state, slot.batch, slot.lrs, slot.seeds)
        if not slot.warm:
            count("graph.warm")
            with phase_scope("step.warm", req):
                out = self._warm_up(args)
            slot.warm = True
            return out
        bound = tuple(t.data_ptr() for t in _tensors((params, opt_state)))
        if slot.graph is None:
            count("graph.capture")
            with phase_scope("step.capture", req):
                self._capture(slot, args)
            slot.bound = bound
        elif bound != slot.bound:
            raise ValueError("a captured step is bound to the params and optimizer state it "
                             "was captured with; these are other tensors")
        with phase_scope("step.replay", req):
            slot.graph.replay()
        slot.replays += 1
        count("graph.replay")
        for name, f in launch_counters().items():
            f.launches += slot.launched[name]
        counts = thread_counts()
        for name, n in slot.counted.items():
            counts[name] = counts.get(name, 0) + n
        with phase_scope("step.copy_out", req):
            return _copy(slot.out)

    def _warm_up(self, args):
        """The body run eagerly on a side stream: real steps that build the
        kernels, their scratch and the cached index vectors."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.body(*args)
        current.wait_stream(side)
        for t in out if isinstance(out, tuple) else (out,):
            t.record_stream(current)
        return out

    def _capture(self, slot: _Slot, args):
        counters = launch_counters()
        before = {name: f.launches for name, f in counters.items()}
        counts = thread_counts()
        counted = dict(counts)
        graph = torch.cuda.CUDAGraph()
        # thread-local: the trainer's prefetch thread may allocate and copy
        # on its own stream while this thread captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            slot.out = self.body(*args)
        slot.launched = {name: f.launches - before[name] for name, f in counters.items()}
        for name, f in counters.items():
            f.launches = before[name]
        slot.counted = {k: n - counted.get(k, 0) for k, n in counts.items()
                        if n != counted.get(k, 0)}
        for name, n in slot.counted.items():
            counts[name] -= n
        slot.graph = graph


def _capture(capture: Optional[bool], device: torch.device) -> bool:
    """Capture on the card unless the caller says otherwise; never on the CPU."""
    return device.type == "cuda" if capture is None else capture


def _train_step(graph_step: GraphStep):
    def step(params, opt_state, batch, iteration):
        return params, opt_state, graph_step(params, opt_state, batch, iteration)

    step.graph_step = graph_step
    return step


def one_step(body: Callable, lr_fn: Callable[[int], float], device: torch.device,
             capture: Optional[bool] = None):
    """step(params, opt_state, batch, iteration) -> (params, opt_state,
    loss): one call of a train ``body(params, opt_state, b, lr, sr_seed) ->
    loss`` a dispatch, lr ``lr_fn(iteration)`` and sr_seed ``iteration``
    as 0-dim device tensors. ``batch`` is what the body takes: one batch, or an
    accumulation body's micro-batches stacked ``[n_accum, ...]``."""
    def graph_body(params, opt_state, b, lrs, seeds):
        return body(params, opt_state, b, lrs[0], seeds[0])

    return _train_step(GraphStep(graph_body, 1, lr_fn, device, _capture(capture, device)))


def multi_step(body: Callable, n_steps: int, lr_fn: Callable[[int], float],
               device: torch.device, capture: Optional[bool] = None):
    """``n_steps`` sequential full steps of ``body`` a dispatch (JAX's
    ``lax.scan`` under ``jit``): step(params, opt_state, batches, iteration)
    -> (params, opt_state, losses [n_steps]), every ``batches`` field with a
    leading [n_steps] axis, step i taking ``lr_fn(iteration + i)`` and seed
    ``iteration + i``."""
    def graph_body(params, opt_state, batches, lrs, seeds):
        return torch.stack([body(params, opt_state, type(batches)(*(f[i] for f in batches)),
                                 lrs[i], seeds[i]) for i in range(n_steps)])

    return _train_step(GraphStep(graph_body, n_steps, lr_fn, device,
                                 _capture(capture, device)))


def eval_step(body: Callable, device: torch.device, capture: Optional[bool] = None):
    """eval(params, batch) -> ``body(params, b)``'s outputs, run under
    ``torch.inference_mode``: one graph a batch shape, and its outputs
    copies."""
    graph_step = GraphStep(lambda p, _s, b, _lrs, _seeds: body(p, b), 0, None, device,
                           _capture(capture, device), inference=True)

    def step(params, batch):
        return graph_step(params, None, batch)

    step.graph_step = graph_step
    return step
