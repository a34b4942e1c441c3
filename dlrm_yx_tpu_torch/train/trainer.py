"""The training and serving loop: builds the model, trains and evaluates it.

The port of ``Trainer`` (single device) from ``dlrm_yx_tpu/train/trainer.py``
(the reference's ``run()`` and ``inference()``, ``dlrm_s_pytorch.py:
1674-2117,1018-1162``): the epoch / batch loop with per-print-freq loss
and ms/it lines, the warmup-excluded epoch average, periodic eval with
accuracy (and the full mlperf metric set when asked), and the MLPerf early
stop on accuracy / AUC thresholds. Device losses are fetched only at print
and eval boundaries, so the loop does not wait for the card at every step.

The Trainer drives one runner (``parallel/runner.py``): ``LocalRunner``
(DLRM) or ``HstuRunner`` (HSTU) here on one device, or a mesh runner a rank (``parallel/hybrid.py``,
``row_sharded.py``, ``col_sharded.py``). The runner holds the params and
optimizer state and builds the steps; the Trainer feeds and times them.

Multi-step dispatch (``steps_per_dispatch``: M full optimizer steps a call,
auto-picked by ``_auto_steps_per_dispatch``), gradient accumulation
(``grad_accum_iter``, which turns multi-step off, as in JAX) and the
prefetch thread (``prefetch_depth``) are ported: on the card every train
step, the tail of fewer than M steps included (one step a call), the
accumulation step and the eval step run as replays of CUDA graphs
(``train/capture.py``); the prefetch thread stacks host batches and starts
their copy to the card on a side stream, which the main stream waits for
before it fills a graph's inputs.

Spans (``utils.profiling.phase_scope``, ``req`` the dispatch's first
iteration): ``fit.wait_batch`` (the main thread waits for the next
prepared dispatch), ``fit.dispatch`` (the wait on its staged copy, then the
step), ``fit.drain`` (the losses fetched) and, on the prefetch thread,
``fit.stage`` (stacking and staging). Counters: ``feed.batches`` (prepared
dispatches taken) and ``feed.empty`` (those the prefetch queue did not yet
hold when asked).

Checkpoints (``train/checkpoint.py``, the JAX package's npz format): with
``load_path`` the Trainer restores params, optimizer state and counters in
``__init__``, copying into its own tensors before any step, and ``fit``
skips forward to the saved position; with ``save_path`` each eval that
beats the best accuracy saves one (save-on-best). A train source is a
sequence, a loader (iterable, with ``__len__`` for the skip and
``reshuffle(epoch)`` for a new batch order each epoch) or a zero-argument
factory of an iterable. ``tb_logdir`` writes the JAX trainer's scalars
(``utils/logging.ScalarWriter``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig, HSTUConfig
from dlrm_yx_tpu_torch.data.batch import Batch, SeqBatch, stack_batches, stage_batch
from dlrm_yx_tpu_torch.models.dlrm import DLRM, init_dlrm, model_groups
from dlrm_yx_tpu_torch.models.hstu import init_hstu
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy, lr_or_constant
from dlrm_yx_tpu_torch.optim.optimizer import (
    OptConfig,
    init_adamw_state,
    init_opt_state,
    store_state,
)
from dlrm_yx_tpu_torch.parallel.runner import Runner
from dlrm_yx_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, skip_position
from dlrm_yx_tpu_torch.train.metrics import StreamingAUC, binary_metrics
from dlrm_yx_tpu_torch.train.train_step import (
    make_accum_train_step,
    make_eval_step,
    make_multistep_train_step,
    make_train_step,
    hstu_train_body,
    train_body,
)
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.logging import EventLogger, ScalarWriter, rank0_print
from dlrm_yx_tpu_torch.utils.profiling import StepTimer, count, phase_scope


@dataclasses.dataclass
class TrainerConfig:
    nepochs: int = 1
    print_freq: int = 64
    test_freq: int = 0               # 0 = eval at epoch end only
    mlperf_logging: bool = False     # full metric set + mllog events
    mlperf_acc_threshold: float = 0.0
    mlperf_auc_threshold: float = 0.0
    save_path: str = ""              # checkpoint dir ("" = no saving)
    load_path: str = ""              # resume checkpoint dir
    tb_logdir: str = ""              # TensorBoard/JSONL scalars
    seed: int = 123
    ckpt_backend: str = "npz"        # npz only: orbax is a JAX library
    grad_accum_iter: int = 1         # micro-batches per optimizer step
                                     # (--mlperf-grad-accum-iter)
    steps_per_dispatch: int = 0      # full optimizer steps per dispatch (one
                                     # CUDA-graph replay); 0 = auto-pick the
                                     # largest of 16/8/4/2/1 dividing
                                     # print_freq and test_freq. The loss
                                     # sequence is identical to 1.
    prefetch_depth: int = 2          # host->device staging queue depth
                                     # (background thread); 0 = prepare
                                     # inline (debug)


def _auto_steps_per_dispatch(tcfg: "TrainerConfig") -> int:
    """Largest M in {16,8,4,2} that keeps print/eval boundaries exact
    (M divides print_freq and test_freq when they are set), else 1.
    An EXPLICIT steps_per_dispatch is honored, but crossing multiple
    print/eval boundaries inside one dispatch collapses them into one
    (eval/early-stop checks run less often) — warn loudly."""
    if tcfg.steps_per_dispatch > 0:
        m = tcfg.steps_per_dispatch
        for name, freq in (("print_freq", tcfg.print_freq),
                           ("test_freq", tcfg.test_freq)):
            if freq and freq % m:
                rank0_print(
                    f"WARNING: --steps-per-dispatch {m} does not divide "
                    f"{name} {freq}: boundaries inside one dispatch "
                    "collapse (eval/print/early-stop fire at most once "
                    "per dispatch)"
                )
        return m
    for m in (16, 8, 4, 2):
        if tcfg.print_freq and tcfg.print_freq % m:
            continue
        if tcfg.test_freq and tcfg.test_freq % m:
            continue
        return m
    return 1


def _prefetch_thread(gen, depth: int, device: Optional[torch.device] = None):
    """Run ``gen`` on a background thread into a bounded queue: the host
    batch stacking and the start of its copy to the card overlap the main
    thread's step dispatches. A consumer that stops early (break, early
    stop, exception) closes the generator, which ends the thread and joins
    it: no staging (pinned buffers, copies on the staging stream) and no
    last reference to the Trainer outlives the epoch on another thread
    while the next run captures its graphs. On a CUDA ``device`` the thread
    first makes it its current device: a new thread starts on card 0, and
    a rank of a multi-card world would otherwise stage (and make a CUDA
    context) there."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()
    err: List[BaseException] = []

    def worker():
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            for x in gen:
                while not stop.is_set():
                    try:
                        q.put(x, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced on the main thread
            err.append(e)
        finally:
            # the consumer may have stopped early with the queue full: a
            # blocking put would pin this thread (and every staged batch)
            while not stop.is_set():
                try:
                    q.put(end, timeout=0.5)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            empty = q.empty()
            x = q.get()
            if x is end:
                if err:
                    raise err[0]
                return
            if empty:
                count("feed.empty")
            yield x
    finally:
        stop.set()
        t.join()


def _group_microbatches(it, n):
    """Stack n consecutive Batches along a new leading axis (feeds
    make_accum_train_step); a trailing incomplete group is dropped, like
    the reference only stepping on every n-th mini-batch."""
    while True:
        group = []
        try:
            for _ in range(n):
                group.append(next(it))
        except StopIteration:
            return
        yield stack_batches(group)


class LocalRunner(Runner):
    """The single-device runner: ``init_dlrm``'s params on ``device`` (the
    card unless the caller asks for the CPU), ``init_opt_state``'s state,
    and the steps of ``train/train_step.py``."""

    graph_name = "train_step"

    def __init__(self, config: DLRMConfig, opt: OptConfig, lr_fn=None, seed: int = 123,
                 n_accum: int = 1, device: Optional[Union[str, torch.device]] = None):
        # what the mesh runners' constructor sets, without a mesh or a plan
        self.config, self.opt = config, opt
        self.lr_fn = lr_or_constant(lr_fn, opt.lr)
        self.n_accum = max(1, n_accum)
        self.device = resolve_device(device)
        self.capture = self.device.type == "cuda"
        self.params = DLRM(config, init_dlrm(config, seed=seed, device=self.device)).as_params()
        self.opt_state = init_opt_state(opt, self.params, model_groups(config))
        self.train_body = train_body(config, opt)

    def _multi_step(self, n_steps: int):
        return make_multistep_train_step(self.config, self.opt, n_steps, self.lr_fn, self.device)

    def _accum_step(self):
        return make_accum_train_step(self.config, self.opt, self.n_accum, self.lr_fn,
                                     self.device)

    def _eval_step(self):
        return make_eval_step(self.config, self.device)

    def eager_step(self):
        return make_train_step(self.config, self.opt, self.lr_fn, self.device)

    def prepare_batch(self, b: Batch) -> Batch:
        return b

    def single_device_params(self, params: dict) -> dict:
        return params

    def save_checkpoint(self, path: str, params: dict, opt_state: dict, **meta) -> None:
        save_checkpoint(path, params, opt_state, self.config, **meta)

    def load_checkpoint(self, path: str, params: dict, opt_state: dict) -> dict:
        return load_checkpoint(path, params, opt_state)[2]


class HstuRunner(Runner):
    """The single-device HSTU runner (``models/hstu.py``): ``init_hstu``'s
    params on ``device``, the item table's row momentum and AdamW's moments
    of the dense leaves, and the steps of ``hstu_train_body``. It has no
    table groups, accumulation, eval step or checkpoints."""

    graph_name = "hstu_step"
    groups = ()

    def __init__(self, config: HSTUConfig, opt: OptConfig, lr_fn=None, seed: int = 123,
                 n_accum: int = 1, device: Optional[Union[str, torch.device]] = None):
        if n_accum > 1:
            raise NotImplementedError("HSTU takes no gradient accumulation")
        self.config, self.opt = config, opt
        self.lr_fn = lr_or_constant(lr_fn, opt.lr)
        self.n_accum = 1
        self.device = resolve_device(device)
        self.capture = self.device.type == "cuda"
        self.params = init_hstu(config, seed=seed, device=self.device)
        self.opt_state = {"items": store_state(opt, self.params["items"]),
                          **init_adamw_state(self.params)}
        self.train_body = hstu_train_body(config, opt)

    def _eval_step(self):
        def refused(*_):
            raise NotImplementedError("HSTU has no eval step: serving it (M-FALCON's cached "
                                      "inference) is not ported")
        return refused

    def prepare_batch(self, b: SeqBatch) -> SeqBatch:
        return b

    def single_device_params(self, params: dict) -> dict:
        raise NotImplementedError("HSTU's params are not exported or served")

    def save_checkpoint(self, *_, **__) -> None:
        raise NotImplementedError("HSTU checkpoints are not ported")

    def load_checkpoint(self, *_) -> dict:
        raise NotImplementedError("HSTU checkpoints are not ported")


class Trainer:
    def __init__(
        self,
        config: DLRMConfig,
        opt: OptConfig,
        tcfg: TrainerConfig,
        lr_policy: Optional[LRPolicy] = None,
        device: Optional[Union[str, torch.device]] = None,
        runner=None,
    ):
        """``runner``: the execution mode that holds the params and
        optimizer state (this rank's), builds the steps, prepares the
        batches and names the device (a mesh runner, e.g.
        ``parallel.hybrid.HybridRunner``); without one a ``LocalRunner`` on
        ``device`` (the card unless the caller asks for the CPU) with
        ``init_dlrm(config, tcfg.seed)``'s params, or for an HSTU
        configuration an ``HstuRunner``."""
        self.config = config
        self.opt = opt
        self.tcfg = tcfg
        self.accum = max(1, tcfg.grad_accum_iter)
        local = HstuRunner if isinstance(config, HSTUConfig) else LocalRunner
        self.runner = runner or local(config, opt, lr_policy, tcfg.seed, self.accum, device)
        self.device = self.runner.device
        self.groups = self.runner.groups
        if self.accum > 1 and self.runner.n_accum != self.accum:
            raise ValueError(
                f"runner was built with n_accum={self.runner.n_accum} but "
                f"--mlperf-grad-accum-iter={self.accum}; pass n_accum to the runner")
        self.msteps = 1
        self.multi_step = None
        # single steps (and the tail of a multi-step epoch) take batches
        # stacked one deep; the accumulation step is the runner's
        self.train_step = (self.runner.train_step if self.accum > 1
                           else self.runner.make_multi_step(1))
        if self.accum == 1:
            self.msteps = _auto_steps_per_dispatch(tcfg)
            if self.msteps > 1:
                self.multi_step = self.runner.make_multi_step(self.msteps)
        self.eval_step = self.runner.eval_step
        self.params, self.opt_state = self.runner.params, self.runner.opt_state
        self.events = EventLogger() if tcfg.mlperf_logging else None
        self.writer = ScalarWriter(tcfg.tb_logdir) if tcfg.tb_logdir else None
        self.best_acc = 0.0
        self.best_auc = 0.0
        self.iteration = 0
        self.start_epoch = 0
        self.skip_batches = 0
        if tcfg.ckpt_backend != "npz":
            raise NotImplementedError(
                f"--ckpt-backend {tcfg.ckpt_backend} is not ported: Orbax is a JAX "
                "library; the port writes and reads npz checkpoints")
        if tcfg.load_path:
            self._load(tcfg.load_path)

    def _load(self, path: str) -> None:
        """Restore a checkpoint into the Trainer's own tensors, in place."""
        # validate the optimizer first: a cross-optimizer resume would fail
        # as an opaque leaf-count error, or misread the accumulators
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                ck_opt = json.load(f).get("optimizer")
            if ck_opt is not None and ck_opt != self.opt.name:
                raise ValueError(
                    f"checkpoint {path!r} carries {ck_opt} optimizer state but the run is "
                    f"configured with --optimizer {self.opt.name} — pass --optimizer "
                    f"{ck_opt} (resuming across optimizers would silently misread the "
                    "accumulators)")
        # copied into the runner's own tensors (this rank's shards) in place
        meta = self.runner.load_checkpoint(path, self.params, self.opt_state)
        self.best_acc = meta["metrics"].get("accuracy", 0.0)
        self.iteration = meta["iteration"]
        self._resume_meta = meta
        rank0_print(f"Resumed checkpoint at epoch {meta['epoch']} "
                    f"iteration {meta['iteration']}")

    # ------------------------------------------------------------------ eval

    def evaluate(self, test_batches: Iterable[Batch]) -> dict:
        """Streams eval batches, returns a metric dict. With mlperf_logging:
        full recall/precision/f1/ap/roc_auc/accuracy
        (dlrm_s_pytorch.py:1088-1118); else rounded-prediction accuracy.
        ``streaming_auc`` is always there."""
        if self.events:
            self.events.log_start("eval_start")
        scores: List[np.ndarray] = []
        targets: List[np.ndarray] = []
        sauc = StreamingAUC()
        n_correct = 0
        n_total = 0
        for b in test_batches:
            preds, _ = self.eval_step(self.params, self.runner.prepare_batch(b))
            p = preds.float().cpu().numpy().ravel()
            t = torch.as_tensor(b.labels).cpu().numpy().ravel()
            n_correct += int(((p >= 0.5) == (t > 0.5)).sum())
            n_total += len(t)
            sauc.add(p, t)
            if self.tcfg.mlperf_logging:
                scores.append(p)
                targets.append(t)
        if self.tcfg.mlperf_logging and scores:
            metrics = binary_metrics(np.concatenate(scores), np.concatenate(targets))
        else:
            metrics = {"accuracy": n_correct / max(n_total, 1)}
        metrics["streaming_auc"] = sauc.auc()
        if self.events:
            self.events.log_event("eval_accuracy", metrics.get("accuracy"))
            if "roc_auc" in metrics:
                self.events.log_event("eval_auc", metrics["roc_auc"])
            self.events.log_end("eval_stop")
        return metrics

    # ----------------------------------------------------------------- train

    def _prepare(self, batch: Batch, stream):
        """(batch, event) for a dispatch: on the card with a staging stream,
        a host batch pinned and copied there on it (``stage_batch``); else
        the batch as it is (the step copies it into its inputs); on a mesh,
        this rank's part of it (``runner.prepare_batch``)."""
        batch = self.runner.prepare_batch(batch)
        if stream is None:
            return batch, None
        return stage_batch(batch, self.device, stream)

    def fit(
        self,
        train_batches,
        test_batches: Optional[Callable[[], Iterable[Batch]]] = None,
    ) -> dict:
        """train_batches: a sequence or loader of Batch (iterated once per
        epoch), or a zero-arg factory of an iterable. test_batches: zero-arg
        callable returning an eval iterable. Returns the last eval's
        metrics; stops early when an mlperf threshold is passed
        (dlrm_s_pytorch.py:2053-2083). After a resume, the saved epoch's
        first batches up to the saved iteration are skipped (when the
        source has a length), and dispatch groups start from there: a
        resume at an iteration that is not a multiple of the steps a
        dispatch shifts the print and eval boundaries, as in the JAX
        package (its trainer.py:395)."""
        tcfg = self.tcfg
        nbatches = len(train_batches) if hasattr(train_batches, "__len__") else 0
        if tcfg.load_path and nbatches:
            self.start_epoch, self.skip_batches = skip_position(self._resume_meta, nbatches)
        if self.events:
            self.events.log_start("init_start")
            self.events.log_event("seed", tcfg.seed)
            self.events.log_end("init_stop")
            self.events.log_start("run_start")
        # the prefetch thread copies on this stream while the main thread may
        # capture a graph. Streams of default priority come round-robin from
        # the pool that torch.cuda.graph's capture stream is drawn from, so
        # one of them is that stream: work the thread put on it would join
        # the capture (and a pinned buffer's event recorded there would be
        # a captured node, which the host allocator later fails to query).
        # A high-priority stream comes from another pool.
        staging = (torch.cuda.Stream(self.device, priority=-1)
                   if self.device.type == "cuda" and tcfg.prefetch_depth > 0 else None)
        pending: List[torch.Tensor] = []  # copies of device losses, fetched at boundaries
        pending_n = 0                     # iterations the pending losses cover
        stop = False
        summary = {}
        for epoch in range(self.start_epoch, tcfg.nepochs):
            epoch_timer = StepTimer(warmup_iters=max(1, tcfg.print_freq))
            if self.events:
                self.events.log_start("epoch_start", {"epoch_num": epoch})
            if epoch > 0 and hasattr(train_batches, "reshuffle"):
                # --mlperf-bin-shuffle: a new batch order each epoch
                # (dlrm_data_pytorch.py:383-398)
                train_batches.reshuffle(epoch)
            it_source = iter(train_batches() if callable(train_batches) else train_batches)
            if self.accum > 1:
                it_source = _group_microbatches(it_source, self.accum)
            span_t0 = 0.0

            def host_stream():
                for j, nb in enumerate(it_source):
                    if epoch == self.start_epoch and j < self.skip_batches:
                        continue
                    yield nb

            def drain(req=None):
                """Fetch the pending losses and record their span in the
                epoch timer (at every print, eval and epoch boundary)."""
                nonlocal pending, pending_n
                if not pending:
                    return []
                with phase_scope("fit.drain", req):
                    losses = torch.cat([x.reshape(-1) for x in pending]).cpu().tolist()
                span = time.perf_counter() - span_t0
                epoch_timer.times.extend([span / pending_n] * pending_n)
                pending, pending_n = [], 0
                return losses

            def dispatch_stream():
                """Yields (prepared batch, n_iters, use_multi). With a
                multi-step: M host batches stack into one copy and one
                dispatch; the tail (<M) runs single steps. Each dispatch's
                preparation is the span ``fit.stage`` (on the prefetch
                thread), with the dispatch's first iteration."""
                it = self.iteration

                def prepared(batches, n):
                    """A list of host batches stacked, or an accumulation
                    group as it is, prepared for a dispatch of n steps."""
                    nonlocal it
                    with phase_scope("fit.stage", it):
                        out = self._prepare(stack_batches(batches) if isinstance(batches, list)
                                            else batches, staging)
                    it += n
                    return out

                src = host_stream()
                if self.multi_step is not None:
                    group = []
                    for nb in src:
                        group.append(nb)
                        if len(group) == self.msteps:
                            yield prepared(group, self.msteps), self.msteps, True
                            group = []
                    for nb in group:
                        yield prepared([nb], 1), 1, False
                else:
                    for nb in src:
                        yield prepared([nb] if self.accum == 1 else nb, 1), 1, False

            stream = dispatch_stream()
            if tcfg.prefetch_depth > 0:
                stream = _prefetch_thread(stream, tcfg.prefetch_depth, self.device)
            while True:
                with phase_scope("fit.wait_batch", self.iteration):
                    item = next(stream, None)
                if item is None:
                    break
                (batch, staged), n_it, use_multi = item
                count("feed.batches")
                if not pending:
                    span_t0 = time.perf_counter()
                with phase_scope("fit.dispatch", self.iteration):
                    if staged is not None:
                        # the copy started on the staging stream; its
                        # tensors are read on this one
                        current = torch.cuda.current_stream(self.device)
                        current.wait_event(staged)
                        for t in batch:
                            t.record_stream(current)
                    step_fn = self.multi_step if use_multi else self.train_step
                    self.params, self.opt_state, loss = step_fn(
                        self.params, self.opt_state, batch, self.iteration)
                pending.append(loss)
                pending_n += n_it
                prev_it = self.iteration
                self.iteration += n_it
                if tcfg.print_freq and (
                    self.iteration // tcfg.print_freq > prev_it // tcfg.print_freq
                ):
                    losses = drain(prev_it)
                    ms = epoch_timer.times[-1] * 1e3
                    avg_loss = sum(losses) / max(len(losses), 1)
                    rank0_print(f"Finished training it {self.iteration} of epoch "
                                f"{epoch}, {ms:.2f} ms/it, loss {avg_loss:.6f}")
                    if self.writer:
                        self.writer.add_scalar("Train/Loss", avg_loss, self.iteration)
                if (
                    test_batches is not None
                    and tcfg.test_freq
                    and self.iteration // tcfg.test_freq > prev_it // tcfg.test_freq
                ):
                    drain(prev_it)
                    stop, summary = self._run_eval(test_batches, epoch)
                    if stop:
                        break
            stream.close()  # after an early stop: ends and joins the prefetch thread
            drain()
            if epoch_timer.times:
                rank0_print(f"Epoch {epoch} average: {epoch_timer.mean_ms():.2f} "
                            "ms/it (warmup excluded)")
            if self.events:
                self.events.log_end("epoch_stop", {"epoch_num": epoch})
            if stop:
                break
            if test_batches is not None and not tcfg.test_freq:
                stop, summary = self._run_eval(test_batches, epoch)
                if stop:
                    break
        if self.events:
            self.events.log_end("run_stop")
        return summary

    def _run_eval(self, test_batches, epoch: int):
        metrics = self.evaluate(test_batches())
        acc = metrics.get("accuracy", 0.0)
        auc = metrics.get("roc_auc", metrics.get("streaming_auc", 0.0))
        is_best = acc > self.best_acc
        if is_best:
            self.best_acc = acc
        self.best_auc = max(self.best_auc, auc if np.isfinite(auc) else 0.0)
        rank0_print(f"Testing at it {self.iteration} of epoch {epoch}: "
                    f"accuracy {100 * acc:.3f}%, best {100 * self.best_acc:.3f}%")
        if self.writer:
            self.writer.add_scalar("Test/Acc", acc, self.iteration)
            for k, v in metrics.items():
                if k != "accuracy" and np.isfinite(v):
                    self.writer.add_scalar(f"mlperf-metrics-test/{k}", v, self.iteration)
        if is_best and self.tcfg.save_path:
            if self.device.type == "cuda":
                # the params are read after every queued replay has run
                torch.cuda.synchronize(self.device)
            meta = dict(epoch=epoch, iteration=self.iteration, metrics=metrics,
                        optimizer=self.opt.name)
            # on a mesh, gathered from the model shards; rank 0 writes
            self.runner.save_checkpoint(self.tcfg.save_path, self.params, self.opt_state, **meta)
            rank0_print(f"Saved best checkpoint to {self.tcfg.save_path}")
        stop = False
        if 0 < self.tcfg.mlperf_acc_threshold < self.best_acc:
            rank0_print(f"MLPerf testing accuracy threshold "
                        f"{self.tcfg.mlperf_acc_threshold} reached, stop training")
            stop = True
        if 0 < self.tcfg.mlperf_auc_threshold < self.best_auc:
            rank0_print(f"MLPerf testing AUC threshold "
                        f"{self.tcfg.mlperf_auc_threshold} reached, stop training")
            stop = True
        return stop, metrics
