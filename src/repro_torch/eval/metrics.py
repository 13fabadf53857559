"""CTR evaluation metrics (industry standard set), in numpy.

The port's copy of ``repro/eval/metrics.py`` (it imports nothing of the
reference).

* AUC — rank-based (Fawcett 2006), ties by midrank; the paper's primary
  comparison metric (Fig. 5/7).
* log-loss (per-sample NLL) — the paper's training objective, reported
  per sample so datasets of different size compare;
* calibration ratio — mean predicted CTR / empirical CTR; online ad
  systems require this near 1.0 (bids are priced off predicted CTR).
* normalised entropy (He et al. 2014, the Facebook baseline the paper
  cites) — log-loss normalised by the entropy of the base rate.
"""
from __future__ import annotations

import numpy as np


def auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Fawcett 2006), ties handled by midrank."""
    y_true = np.asarray(y_true).ravel()
    scores = np.asarray(scores).ravel()
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    n = len(scores)
    i = 0
    r = 1.0
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (r + r + (j - i))
        r += j - i + 1
        i = j + 1
    n_pos = y_true.sum()
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def log_loss(y: np.ndarray, p: np.ndarray, eps: float = 1e-7) -> float:
    y = np.asarray(y, np.float64).ravel()
    p = np.clip(np.asarray(p, np.float64).ravel(), eps, 1 - eps)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def calibration_ratio(y: np.ndarray, p: np.ndarray) -> float:
    """mean(predicted CTR) / mean(empirical CTR) — 1.0 is perfectly
    calibrated; inf when the batch has no clicks."""
    y = np.asarray(y, np.float64).ravel()
    p = np.asarray(p, np.float64).ravel()
    clicks = y.sum()
    return float(p.sum() / clicks) if clicks else float("inf")


def bucketed_calibration(y: np.ndarray, p: np.ndarray,
                         edges: np.ndarray) -> np.ndarray:
    """Per-score-bucket :func:`calibration_ratio`: predictions are
    binned by ``edges`` (B+1 ascending bucket boundaries; values clamp
    into the end buckets) and each bucket's ratio is computed from its
    own (y, p) slice — ``inf`` where a bucket has no clicks, including
    empty buckets. Returns shape (B,). This is the per-bucket view the
    drift monitor compares against its train-time reference."""
    y = np.asarray(y, np.float64).ravel()
    p = np.asarray(p, np.float64).ravel()
    edges = np.asarray(edges, np.float64)
    nb = edges.size - 1
    idx = np.clip(np.searchsorted(edges, p, side="right") - 1, 0, nb - 1)
    sum_p = np.bincount(idx, weights=p, minlength=nb)
    sum_y = np.bincount(idx, weights=y, minlength=nb)
    return np.array([
        calibration_ratio(np.asarray([sy]), np.asarray([sp]))
        for sy, sp in zip(sum_y, sum_p)])


def normalized_entropy(y: np.ndarray, p: np.ndarray) -> float:
    y = np.asarray(y, np.float64).ravel()
    base = y.mean()
    if base in (0.0, 1.0):
        return float("inf")
    h_base = -(base * np.log(base) + (1 - base) * np.log(1 - base))
    return log_loss(y, p) / h_base


def report(y: np.ndarray, p: np.ndarray) -> dict:
    return {
        "auc": auc(np.asarray(y), np.asarray(p)),
        "log_loss": log_loss(y, p),
        "calibration": calibration_ratio(y, p),
        "normalized_entropy": normalized_entropy(y, p),
    }
