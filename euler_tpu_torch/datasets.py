"""Synthetic benchmark graphs at the reference's scales, built in memory.

The port's copy of ``euler_tpu.datasets.build_synthetic``: the same numpy
RNG calls in the same order, so one seed gives the same graph in both
packages. Where the JAX package writes ``.dat`` partitions for its C++
engine, this returns the arrays that ``graph.Graph`` takes.

Layout convention (matches the examples' training flags): dense feature
slot 0 = labels (multi-/one-hot), slot 1 = input features.
"""

from __future__ import annotations

import numpy as np

PPI = dict(num_nodes=56944, avg_degree=15, feature_dim=50, label_dim=121,
           multilabel=True)


def build_synthetic(
    num_nodes: int,
    avg_degree: int,
    feature_dim: int,
    label_dim: int,
    multilabel: bool = True,
    max_degree: int = 60,
    seed: int = 7,
) -> dict:
    """Graph arrays for ``graph.Graph(**arrays)``: one node type, one edge
    type, node weight 1.0, neighbors deduplicated in first-seen order with
    weight 1.0 (the JAX builder's ``{str(d): 1.0}`` dict), labels in dense
    slot 0 and ``standard_normal().round(3)`` features in slot 1."""
    rng = np.random.default_rng(seed)
    degrees = rng.poisson(avg_degree, num_nodes).clip(1, max_degree)
    counts = np.zeros(num_nodes, np.int64)
    nbr_rows = []
    labels = np.zeros((num_nodes, label_dim), np.float32)
    features = np.zeros((num_nodes, feature_dim), np.float32)
    for nid in range(num_nodes):
        nbrs = list(dict.fromkeys(
            rng.integers(0, num_nodes, degrees[nid]).tolist()
        ))
        if multilabel:
            labels[nid] = rng.integers(0, 2, label_dim)
        else:
            labels[nid, rng.integers(0, label_dim)] = 1.0
        features[nid] = rng.standard_normal(feature_dim).round(3)
        nbr_rows.append(nbrs)
        counts[nid] = len(nbrs)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.fromiter(
        (d for row in nbr_rows for d in row), np.int64, int(indptr[-1])
    )
    return {
        "indptr": indptr,
        "indices": indices,
        "weights": np.ones(len(indices), np.float32),
        "node_weights": np.ones(num_nodes, np.float32),
        "node_types": np.zeros(num_nodes, np.int32),
        "dense_features": [labels, features],
    }
