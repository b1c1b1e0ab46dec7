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
