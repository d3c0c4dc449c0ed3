"""Metrics: sklearn-exact average precision, multi-hot F1, confusion-matrix
mIoU, on the host (numpy only; the port's own copy of the JAX package's
utils/metrics.py).

The reference computes mAP as the mean over samples of sklearn
average_precision_score (utils.py:248-262), F1 via sklearn f1_score on
top-k-by-label-count multi-hot predictions (utils.py:166-178 — whose
accumulator bug, `f1_score_i += f1_score_i` on a freshly overwritten variable,
we deliberately do NOT replicate), and mIoU via a bincount confusion matrix
(utils.py:30-77).
"""

from __future__ import annotations

import numpy as np


def average_precision(y_true, y_score):
    """Exact reimplementation of sklearn.metrics.average_precision_score for
    binary labels: AP = sum_n (R_n - R_{n-1}) * P_n over distinct-score
    thresholds in decreasing order (utils.py:258)."""
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
    """utils.py:248-262: per-sample AP over samples with >=1 positive label.
    Returns the list of APs (caller accumulates / means them)."""
    y_true = np.asarray(labels)
    y_pred = np.asarray(outputs)
    ap = []
    for i in range(y_true.shape[0]):
        if np.sum(y_true[i]) > 0:
            ap.append(average_precision(y_true[i], y_pred[i]))
    return ap


def f1_multihot(y_true, y_pred):
    """sklearn.metrics.f1_score(binary) on multi-hot vectors:
    2TP / (2TP + FP + FN); 0 when denominator is 0."""
    y_true = np.asarray(y_true).astype(bool)
    y_pred = np.asarray(y_pred).astype(bool)
    tp = np.sum(y_true & y_pred)
    fp = np.sum(~y_true & y_pred)
    fn = np.sum(y_true & ~y_pred)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def topk_multihot(pred, label_counts, num_classes):
    """utils.py:166-171: per-sample top-(#GT labels) multi-hot prediction.
    pred: [B, C] scores; label_counts: [B] ints."""
    pred = np.asarray(pred)
    out = np.zeros_like(pred)
    for i in range(pred.shape[0]):
        k = int(label_counts[i])
        if k > 0:
            idx = np.argpartition(-pred[i], k - 1)[:k]
            out[i, idx] = 1.0
    return out


class ConfusionMatrix:
    """Semantic-segmentation confusion matrix (utils.py:30-77).

    Uses num_classes + 1 bins (background = 0, classes 1..num_classes) exactly
    like the reference; pixels with GT outside [0, n) (e.g. VOC ignore label
    255) are dropped.
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.mat = None

    def update(self, a, b):
        a = np.asarray(a).ravel().astype(np.int64)
        b = np.asarray(b).ravel().astype(np.int64)
        n = self.num_classes + 1
        if self.mat is None:
            self.mat = np.zeros((n, n), dtype=np.int64)
        # GT outside [0, n) is dropped like the reference (utils.py:43);
        # predictions outside [0, n) are ALSO dropped — a documented
        # divergence: the reference would crash in bincount (utils.py:44)
        # when pseudo-seg filler classes 21+p (validate.py:146) reach it.
        k = (a >= 0) & (a < n) & (b >= 0) & (b < n)
        inds = n * a[k] + b[k]
        self.mat += np.bincount(inds, minlength=n ** 2).reshape(n, n)

    def reset(self):
        if self.mat is not None:
            self.mat[:] = 0

    def compute(self):
        if self.mat is None:
            raise ValueError(
                "ConfusionMatrix.compute(): no samples accumulated — "
                "update() was never called (empty val split?)")
        h = self.mat.astype(np.float64)
        acc_global = np.diag(h).sum() / max(h.sum(), 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(h) / h.sum(1)
            iu = np.diag(h) / (h.sum(1) + h.sum(0) - np.diag(h))
        return acc_global, acc, iu

    def get_mIOU(self):
        _, _, iu = self.compute()
        return float(np.nanmean(iu) * 100)

    def __str__(self):
        acc_global, acc, iu = self.compute()
        return ("global correct: {:.3f}\n"
                "average row correct: {}\n"
                "IoU: {}\n"
                "mean IoU: {:.3f}").format(
            acc_global * 100,
            ["{:.3f}".format(i) for i in (acc * 100).tolist()],
            ["{:.3f}".format(i) for i in (iu * 100).tolist()],
            np.nanmean(iu) * 100)
