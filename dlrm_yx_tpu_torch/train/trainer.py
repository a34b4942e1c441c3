"""The training and serving loop: builds the model, trains and evaluates it.

The port of ``Trainer`` (single device) from ``dlrm_yx_tpu/train/trainer.py``
(the reference's ``run()`` and ``inference()``, ``dlrm_s_pytorch.py:
1674-2117,1018-1162``): the epoch / batch loop with per-print-freq loss
and ms/it lines, the warmup-excluded epoch average, periodic eval with
accuracy (and the full mlperf metric set when asked), and the MLPerf early
stop on accuracy / AUC thresholds. Device losses are fetched only at print
and eval boundaries, so the loop does not wait for the card at every step.

One step per call: multi-step dispatch (``--steps-per-dispatch``), the
prefetch thread, checkpoints, gradient accumulation and the TensorBoard
writer are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import DLRM, init_dlrm, model_groups
from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.train.metrics import StreamingAUC, binary_metrics
from dlrm_yx_tpu_torch.train.train_step import make_eval_step, make_train_step
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.logging import EventLogger, rank0_print
from dlrm_yx_tpu_torch.utils.profiling import StepTimer


@dataclasses.dataclass
class TrainerConfig:
    nepochs: int = 1
    print_freq: int = 64
    test_freq: int = 0               # 0 = eval at epoch end only
    mlperf_logging: bool = False     # full metric set + mllog events
    mlperf_acc_threshold: float = 0.0
    mlperf_auc_threshold: float = 0.0
    seed: int = 123


class Trainer:
    def __init__(
        self,
        config: DLRMConfig,
        opt: OptConfig,
        tcfg: TrainerConfig,
        lr_policy: Optional[LRPolicy] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """Parameters come from ``init_dlrm(config, tcfg.seed)`` on
        ``device`` (the card unless the caller asks for the CPU), the
        optimizer state from ``init_opt_state``."""
        self.config = config
        self.opt = opt
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.groups = model_groups(config)
        self.train_step = make_train_step(config, opt, lr_policy, self.device)
        self.eval_step = make_eval_step(config, self.device)
        self.model = DLRM(config, init_dlrm(config, seed=tcfg.seed, device=self.device))
        self.params = self.model.as_params()
        self.opt_state = init_opt_state(opt, self.params, self.groups)
        self.events = EventLogger() if tcfg.mlperf_logging else None
        self.best_acc = 0.0
        self.best_auc = 0.0
        self.iteration = 0

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
            preds, _ = self.eval_step(self.params, b)
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

    def fit(
        self,
        train_batches: Iterable[Batch],
        test_batches: Optional[Callable[[], Iterable[Batch]]] = None,
    ) -> dict:
        """train_batches: a sequence of Batch (iterated once per epoch).
        test_batches: zero-arg callable returning an eval iterable. Returns
        the last eval's metrics; stops early when an mlperf threshold is
        passed (dlrm_s_pytorch.py:2053-2083)."""
        tcfg = self.tcfg
        if self.events:
            self.events.log_start("init_start")
            self.events.log_event("seed", tcfg.seed)
            self.events.log_end("init_stop")
            self.events.log_start("run_start")
        pending: List[torch.Tensor] = []  # device losses, fetched at boundaries
        stop = False
        summary = {}
        for epoch in range(tcfg.nepochs):
            epoch_timer = StepTimer(warmup_iters=max(1, tcfg.print_freq))
            if self.events:
                self.events.log_start("epoch_start", {"epoch_num": epoch})
            span_t0 = 0.0

            def drain():
                """Fetch the pending losses and record their span in the
                epoch timer (at every print, eval and epoch boundary)."""
                nonlocal pending
                if not pending:
                    return []
                losses = [float(v) for v in torch.stack(pending).cpu()]
                span = time.perf_counter() - span_t0
                epoch_timer.times.extend([span / len(pending)] * len(pending))
                pending = []
                return losses

            for batch in train_batches:
                if not pending:
                    span_t0 = time.perf_counter()
                self.params, self.opt_state, loss = self.train_step(
                    self.params, self.opt_state, batch, self.iteration)
                pending.append(loss)
                prev_it = self.iteration
                self.iteration += 1
                if tcfg.print_freq and (
                    self.iteration // tcfg.print_freq > prev_it // tcfg.print_freq
                ):
                    losses = drain()
                    ms = epoch_timer.times[-1] * 1e3
                    avg_loss = sum(losses) / max(len(losses), 1)
                    rank0_print(f"Finished training it {self.iteration} of epoch "
                                f"{epoch}, {ms:.2f} ms/it, loss {avg_loss:.6f}")
                if (
                    test_batches is not None
                    and tcfg.test_freq
                    and self.iteration // tcfg.test_freq > prev_it // tcfg.test_freq
                ):
                    drain()
                    stop, summary = self._run_eval(test_batches, epoch)
                    if stop:
                        break
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
        if acc > self.best_acc:
            self.best_acc = acc
        self.best_auc = max(self.best_auc, auc if np.isfinite(auc) else 0.0)
        rank0_print(f"Testing at it {self.iteration} of epoch {epoch}: "
                    f"accuracy {100 * acc:.3f}%, best {100 * self.best_acc:.3f}%")
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
