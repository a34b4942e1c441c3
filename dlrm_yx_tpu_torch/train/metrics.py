"""Evaluation metrics: exact + streaming ROC-AUC, accuracy, precision,
recall, F1, average precision.

The port's numpy copy of ``dlrm_yx_tpu/train/metrics.py``, so both packages
score predictions identically. Capability parity with the reference's
sklearn-based eval (``dlrm_s_pytorch.py:1088-1118``: recall/precision/f1/ap/
roc_auc/accuracy on rounded scores) — without sklearn. The exact AUC uses
the tie-averaged rank formula (equivalent to sklearn's trapezoidal ROC AUC);
the streaming variant buckets scores into a fixed histogram so MLPerf-scale
eval runs in O(bins) memory and can be accumulated across eval batches
(histograms add).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def roc_auc_exact(scores: np.ndarray, targets: np.ndarray) -> float:
    """Tie-averaged Mann-Whitney AUC == sklearn.roc_auc_score."""
    s = np.asarray(scores, dtype=np.float64).ravel()
    t = np.asarray(targets).ravel() > 0.5
    n_pos = int(t.sum())
    n_neg = len(t) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    s_sorted = s[order]
    ranks = np.empty(len(s), dtype=np.float64)
    # average ranks over ties
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        ranks[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[t[order]].sum()
    return float((rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


class StreamingAUC:
    """Histogram AUC accumulator.

    add(scores, targets) any number of times (scores in [0, 1]); auc() is
    accurate to ~1/bins. Two instances' .hist arrays sum for distributed
    reduction (the reference instead all_gathers full score vectors,
    dlrm_s_pytorch.py:1067-1069)."""

    def __init__(self, bins: int = 1 << 16):
        self.bins = bins
        self.hist = np.zeros((2, bins), dtype=np.int64)

    def add(self, scores, targets) -> None:
        s = np.clip(np.asarray(scores, np.float64).ravel(), 0.0, 1.0)
        t = np.asarray(targets).ravel() > 0.5
        idx = np.minimum((s * self.bins).astype(np.int64), self.bins - 1)
        self.hist[0] += np.bincount(idx[~t], minlength=self.bins)
        self.hist[1] += np.bincount(idx[t], minlength=self.bins)

    def merge(self, other: "StreamingAUC") -> None:
        self.hist += other.hist

    def auc(self) -> float:
        neg, pos = self.hist[0].astype(np.float64), self.hist[1].astype(np.float64)
        n_neg, n_pos = neg.sum(), pos.sum()
        if n_neg == 0 or n_pos == 0:
            return float("nan")
        neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
        # P(score_pos > score_neg) + 0.5 P(equal-bin)
        wins = (pos * neg_below).sum() + 0.5 * (pos * neg).sum()
        return float(wins / (n_pos * n_neg))


def binary_metrics(scores: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    """Threshold-0.5 classification metrics + AP + exact AUC, matching the
    sklearn calls in the reference's mlperf eval block."""
    s = np.asarray(scores, np.float64).ravel()
    t = (np.asarray(targets).ravel() > 0.5).astype(np.int64)
    pred = (s >= 0.5).astype(np.int64)  # == np.round for [0,1] scores
    tp = int(((pred == 1) & (t == 1)).sum())
    fp = int(((pred == 1) & (t == 0)).sum())
    fn = int(((pred == 0) & (t == 1)).sum())
    tn = int(((pred == 0) & (t == 0)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    accuracy = (tp + tn) / len(t) if len(t) else 0.0
    return {
        "recall": recall,
        "precision": precision,
        "f1": f1,
        "ap": average_precision(s, t),
        "roc_auc": roc_auc_exact(s, t),
        "accuracy": accuracy,
    }


def average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """sklearn average_precision_score: AP = sum_n (R_n - R_{n-1}) P_n over
    descending unique-score thresholds."""
    s = np.asarray(scores, np.float64).ravel()
    t = (np.asarray(targets).ravel() > 0.5).astype(np.float64)
    n_pos = t.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-s, kind="mergesort")
    t_sorted = t[order]
    s_sorted = s[order]
    tp_cum = np.cumsum(t_sorted)
    k = np.arange(1, len(t_sorted) + 1, dtype=np.float64)
    # evaluate only at the last index of each tied score block
    is_threshold = np.concatenate([s_sorted[1:] != s_sorted[:-1], [True]])
    tp_at = tp_cum[is_threshold]
    k_at = k[is_threshold]
    precision = tp_at / k_at
    recall = tp_at / n_pos
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(((recall - recall_prev) * precision).sum())
