"""Streaming metrics (counterpart of ``euler_tpu/nn/metrics.py``)."""

from __future__ import annotations

import numpy as np
import torch


def f1_counts(labels, predictions) -> torch.Tensor:
    """Per-batch [tp, fp, fn] for micro-F1 accumulation; inputs binarize
    as ``!= 0``."""
    labels = (labels != 0).to(torch.float32)
    predictions = (predictions != 0).to(torch.float32)
    tp = torch.sum(predictions * labels)
    fp = torch.sum(predictions * (1.0 - labels))
    fn = torch.sum((1.0 - predictions) * labels)
    return torch.stack([tp, fp, fn])


def f1_from_counts(counts) -> float:
    """Micro-F1 from accumulated [tp, fp, fn]."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    tp, fp, fn = np.asarray(counts, dtype=np.float64)
    eps = 1e-7
    precision = tp / (eps + tp + fp)
    recall = tp / (eps + tp + fn)
    return float(2.0 * precision * recall / (precision + recall + eps))


def mrr(logits, neg_logits) -> torch.Tensor:
    """Mean reciprocal rank of the positive among its negatives.
    ``logits`` [..., 1, 1], ``neg_logits`` [..., 1, k]; a tie counts
    against the positive (``neg >= pos``), as in the JAX package."""
    rank = 1.0 + (neg_logits >= logits).sum(-1).to(logits.dtype)
    return (1.0 / rank).mean()


AUC_BINS = 200


def auc_counts(labels, scores, nbins: int = AUC_BINS) -> torch.Tensor:
    """Per-batch [2, nbins] histograms of the scores (row 0 the
    negatives', row 1 the positives'), for streaming AUC: scores clipped
    to [0, 1 - 1e-7], bin ``int(score * nbins)``; labels binarize as
    ``!= 0``."""
    labels = (labels.reshape(-1) != 0).to(torch.float32)
    scores = scores.reshape(-1).clamp(0.0, 1.0 - 1e-7)
    bins = (scores * nbins).to(torch.int64)
    pos = torch.zeros(nbins, device=scores.device).index_add_(0, bins, labels)
    neg = torch.zeros(nbins, device=scores.device).index_add_(
        0, bins, 1.0 - labels)
    return torch.stack([neg, pos])


def auc_from_counts(counts) -> float:
    """Trapezoidal AUC from accumulated [2, nbins] histograms: for each
    positive, the negatives in lower bins plus half of those in its own;
    0.5 when a class is absent."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    neg, pos = np.asarray(counts, dtype=np.float64)
    p_tot, n_tot = pos.sum(), neg.sum()
    if p_tot == 0 or n_tot == 0:
        return 0.5
    neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    wins = np.sum(pos * (neg_below + 0.5 * neg))
    return float(wins / (p_tot * n_tot))


def accuracy(labels, predictions) -> torch.Tensor:
    """The share of rows whose argmax label is the argmax prediction (the
    first maximum on ties, as ``jnp.argmax``)."""
    return (labels.argmax(-1) == predictions.argmax(-1)).to(
        torch.float32).mean()
