"""The serving loop: builds the model and evaluates it over batches.

The port of ``Trainer.__init__`` (single device) and ``Trainer.evaluate``
from ``dlrm_yx_tpu/train/trainer.py`` — the reference's ``inference()``
(``dlrm_s_pytorch.py:1018-1162``). Training (``fit``), the optimizer state,
checkpoints and the mesh runners are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import DLRM, init_dlrm
from dlrm_yx_tpu_torch.train.metrics import StreamingAUC, binary_metrics
from dlrm_yx_tpu_torch.train.train_step import make_eval_step
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.logging import EventLogger


@dataclasses.dataclass
class TrainerConfig:
    mlperf_logging: bool = False     # full metric set + mllog events
    seed: int = 123


class Trainer:
    def __init__(
        self,
        config: DLRMConfig,
        tcfg: TrainerConfig,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """Parameters come from ``init_dlrm(config, tcfg.seed)`` on
        ``device`` (the card unless the caller asks for the CPU)."""
        self.config = config
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.eval_step = make_eval_step(config, self.device)
        self.model = DLRM(config, init_dlrm(config, seed=tcfg.seed, device=self.device))
        self.events = EventLogger() if tcfg.mlperf_logging else None

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
        params = self.model.as_params()
        for b in test_batches:
            preds, _ = self.eval_step(params, b)
            p = preds.float().cpu().numpy().ravel()
            t = np.asarray(b.labels).ravel()
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
