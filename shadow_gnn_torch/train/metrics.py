"""Evaluation metrics, dependency-free: a numpy copy of the JAX
package's ``train/metrics.py``.

Re-implements the metric surface of reference ``shaDow/metric.py``
without sklearn/ogb: F1 micro/macro (sigmoid multilabel thresholded at
0.5, or argmax single-label), accuracy, OGB-style accuracy (identical
to accuracy, metric.py:84-93), and OGB link hits@K (fraction of
positive scores above the K-th best negative score).  Includes the
window-averaged ``is_better`` model-selection comparators
(metric.py:106-148).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

METRICS = {
    "f1": ["f1mic", "f1mac"],
    "accuracy": ["accuracy"],
    "accuracy_ogb": ["accuracy"],
    "hits20": ["hits20"],
    "hits50": ["hits50"],
    "hits100": ["hits100"],
}


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int):
    """micro/macro F1 from integer class vectors or binary indicator mats."""
    if y_true.ndim == 1:
        # single-label: per-class TP/FP/FN from confusion counts
        tp = np.zeros(num_classes)
        fp = np.zeros(num_classes)
        fn = np.zeros(num_classes)
        for c in range(num_classes):
            tp[c] = np.sum((y_pred == c) & (y_true == c))
            fp[c] = np.sum((y_pred == c) & (y_true != c))
            fn[c] = np.sum((y_pred != c) & (y_true == c))
    else:
        tp = np.sum((y_pred == 1) & (y_true == 1), axis=0).astype(np.float64)
        fp = np.sum((y_pred == 1) & (y_true == 0), axis=0).astype(np.float64)
        fn = np.sum((y_pred == 0) & (y_true == 1), axis=0).astype(np.float64)
    denom_mic = 2 * tp.sum() + fp.sum() + fn.sum()
    f1mic = 2 * tp.sum() / denom_mic if denom_mic > 0 else 0.0
    denom = 2 * tp + fp + fn
    per_class = np.where(denom > 0, 2 * tp / np.where(denom > 0, denom, 1), 0.0)
    return float(f1mic), float(per_class.mean())


def hits_at_k(pos_pred: np.ndarray, neg_pred: np.ndarray, k: int) -> float:
    """OGB linkproppred Evaluator semantics."""
    if neg_pred.size < k:
        return 1.0
    kth = np.sort(neg_pred)[-k]
    return float((pos_pred > kth).mean())


class Metrics:
    """calc + is_better dispatch per dataset metric name."""

    def __init__(self, name_data: str, is_sigmoid: bool, metric: str,
                 window_size: int):
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        self.name_data = name_data
        self.is_sigmoid = is_sigmoid
        self.name = metric
        self.window_size = window_size
        self.metric_term = (METRICS[metric][0], "max")

    def calc(self, y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
        if self.name == "f1":
            if not self.is_sigmoid:
                yt = np.argmax(y_true, axis=1)
                yp = np.argmax(y_pred, axis=1)
                c = y_true.shape[1]
            else:
                yt = (y_true > 0.5).astype(np.int64)
                yp = (y_pred > 0.5).astype(np.int64)
                c = y_true.shape[1]
            mic, mac = f1_scores(yt, yp, c)
            return {"f1mic": mic, "f1mac": mac}
        if self.name in ("accuracy", "accuracy_ogb"):
            yt = np.argmax(y_true, axis=1)
            yp = np.argmax(y_pred, axis=1)
            return {"accuracy": float((yt == yp).mean())}
        if self.name.startswith("hits"):
            k = int(self.name[4:])
            y_true = y_true.reshape(-1)
            y_pred = y_pred.reshape(-1)
            return {self.name: hits_at_k(y_pred[y_true == 1],
                                         y_pred[y_true == 0], k)}
        raise NotImplementedError(self.name)

    def is_better(self, loss_all: Sequence[float], loss_min_hist: float,
                  metric_all: Sequence[float], metric_max_hist: float):
        """window-averaged improvement test (metric.py:106-148)."""
        w_m = list(metric_all[-self.window_size:])
        w_l = list(loss_all[-self.window_size:])
        m_avg = sum(w_m) / len(w_m)
        l_avg = sum(w_l) / len(w_l)
        if m_avg > metric_max_hist:
            return True, l_avg, m_avg
        return False, loss_min_hist, metric_max_hist
