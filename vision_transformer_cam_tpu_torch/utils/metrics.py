"""Metrics: sklearn-exact average precision on the host (numpy only; the
port's own copy of what the trainer needs from the JAX package's
utils/metrics.py).

The reference computes mAP as the mean over samples of sklearn's
average_precision_score.
"""

from __future__ import annotations

import numpy as np


def average_precision(y_true, y_score):
    """Exact reimplementation of sklearn.metrics.average_precision_score for
    binary labels: AP = sum_n (R_n - R_{n-1}) * P_n over distinct-score
    thresholds in decreasing order."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    order = np.argsort(-y_score, kind="mergesort")
    y_true, y_score = y_true[order], y_score[order]
    # indices where the score changes (group ties together), plus the end
    distinct = np.where(np.diff(y_score))[0]
    boundaries = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[boundaries]
    fps = (boundaries + 1) - tps
    total_pos = tps[-1]
    if total_pos == 0:
        return 0.0
    precision = tps / (tps + fps)
    recall = tps / total_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def compute_mAP(labels, outputs):
    """Per-sample AP over samples with >=1 positive label.
    Returns the list of APs (caller accumulates / means them)."""
    y_true = np.asarray(labels)
    y_pred = np.asarray(outputs)
    ap = []
    for i in range(y_true.shape[0]):
        if np.sum(y_true[i]) > 0:
            ap.append(average_precision(y_true[i], y_pred[i]))
    return ap
