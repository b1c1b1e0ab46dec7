"""Feature gather ops on the host (counterpart of
``euler_tpu/ops/feature.py``): dense rows as the graph returns them, and
sparse (uint64 id-list) features padded and masked, ready for the masked
embedding lookup of ``nn.layers.SparseEmbedding``."""

from __future__ import annotations

import numpy as np


def get_dense_feature(g, nodes, feature_ids, dimensions):
    """[n, sum(dimensions)] float32 (zero-padded per slot)."""
    return g.get_dense_feature(nodes, feature_ids, dimensions)


def get_edge_dense_feature(g, src, dst, types, feature_ids, dimensions):
    return g.get_edge_dense_feature(src, dst, types, feature_ids, dimensions)


def get_sparse_feature(g, nodes, feature_ids, max_len, default_values=None,
                       edge=None):
    """Padded sparse (id-list) node features.

    Args:
      max_len: per-slot pad length (int or list). Longer rows are cut.
      default_values: per-slot fill id of the padding positions (default
        0; pass max_id + 1 for the reference's padding id).
      edge: an optional (src, dst, types) triple: gather the edges'
        features instead of the nodes' (engine client only).

    Returns per slot: (ids [n, max_len] int64, mask [n, max_len] float32),
    the rows' values first and then the padding, under a mask of 1 on the
    values. One vectorized pass a slot, so the whole table of a graph
    (``models.base.upload_sparse_tables``) is cheap to build."""
    nslots = len(feature_ids)
    if isinstance(max_len, int):
        max_len = [max_len] * nslots
    if default_values is None:
        default_values = [0] * nslots
    if edge is not None:
        raw = g.get_edge_sparse_feature(*edge, feature_ids)
    else:
        raw = g.get_sparse_feature(nodes, feature_ids)
    out = []
    for k in range(nslots):
        values, counts = raw[k]
        counts = np.asarray(counts, np.int64)
        length = max_len[k]
        ids = np.full((len(counts), length), default_values[k], np.int64)
        mask = np.zeros((len(counts), length), np.float32)
        col = np.arange(length)
        take = col[None, :] < np.minimum(counts, length)[:, None]
        start = np.cumsum(counts) - counts
        ids[take] = np.asarray(values, np.int64)[
            (start[:, None] + col[None, :])[take]]
        mask[take] = 1.0
        out.append((ids, mask))
    return out
