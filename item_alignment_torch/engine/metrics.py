"""Evaluation metrics, a copy of ``item_alignment_tpu/engine/metrics.py``
(numpy only):

- the per-threshold precision/recall/F1 sweep;
- ``find_best_f1_and_threshold``, the exact best-F1 cut.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def precision_recall_f1(
    labels: np.ndarray, preds: np.ndarray
) -> Tuple[float, float, float]:
    labels = np.asarray(labels).astype(bool)
    preds = np.asarray(preds).astype(bool)
    tp = float(np.sum(preds & labels))
    fp = float(np.sum(preds & ~labels))
    fn = float(np.sum(~preds & labels))
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return precision, recall, f1


def threshold_sweep(
    labels: np.ndarray,
    probs: np.ndarray,
    thresholds: Sequence[float] = tuple(round(0.1 * i, 1) for i in range(1, 10)),
) -> List[Dict[str, float]]:
    """P/R/F1 at each threshold (reference sweeps 0.1..0.9)."""
    out = []
    for thr in thresholds:
        p, r, f1 = precision_recall_f1(labels, probs >= thr)
        out.append({"threshold": float(thr), "precision": p, "recall": r, "f1": f1})
    return out


def find_best_f1_and_threshold(
    labels: np.ndarray, scores: np.ndarray
) -> Tuple[float, float, float, float]:
    """Exact best-F1 threshold search by sorting scores descending and
    sweeping every cut point (reference ``finetune_bert.py:72-106``).

    Returns (best_f1, best_precision, best_recall, best_threshold).
    """
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores).astype(np.float64)
    order = np.argsort(-scores)
    labels_sorted = labels[order]
    scores_sorted = scores[order]
    total_pos = labels.sum()
    best = (0.0, 0.0, 0.0, -1.0)
    tp = 0
    for i in range(len(scores_sorted)):
        tp += labels_sorted[i]
        if i + 1 < len(scores_sorted) and scores_sorted[i + 1] == scores_sorted[i]:
            continue  # same score: cut must include all ties
        n_pred = i + 1
        precision = tp / n_pred
        recall = tp / total_pos if total_pos > 0 else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
        if f1 > best[0]:
            thr = (scores_sorted[i] + scores_sorted[i + 1]) / 2 \
                if i + 1 < len(scores_sorted) else scores_sorted[i]
            best = (float(f1), float(precision), float(recall), float(thr))
    return best


def accuracy(labels: np.ndarray, preds: np.ndarray) -> float:
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    return float((labels == preds).mean()) if len(labels) else 0.0
