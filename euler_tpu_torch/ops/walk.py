"""Random walks on the host and skip-gram pair enumeration (counterpart
of ``euler_tpu/ops/walk.py``): the walk is one call into the engine
client, the pairs numpy, with the reference kernel's order
(``tf_euler/kernels/gen_pair_op.cc``) and its exact, unpadded pair count.
On the device the walks are ``graph/device.py``'s ``random_walk`` and
the biased walks."""

from __future__ import annotations

import numpy as np


def random_walk(g, nodes, edge_types, walk_len, p=1.0, q=1.0,
                default_node=-1):
    """[n, walk_len+1] int64 node2vec walks (column 0 = start)."""
    return g.random_walk(nodes, edge_types, walk_len, p, q, default_node)


def pair_count(path_len: int, left_win: int, right_win: int) -> int:
    """Exact number of skip-gram pairs per path (the reference's static
    shape function, ``tf_euler/ops/walk_ops.cc``)."""
    count = path_len * (left_win + right_win)
    for i in range(min(left_win, path_len)):
        count -= left_win - i
    for i in range(min(right_win, path_len)):
        count -= right_win - i
    return count


def pair_indices(path_len: int, left_win: int, right_win: int):
    """(target, context) position index arrays, int32, in the reference
    kernel's order: positions j = 0..len-1, left contexts j-1, j-2, ...,
    then right contexts j+1, j+2, ... The order decides which pair lands
    in which row of a batch."""
    blocks = []
    for j in range(path_len):
        for k in range(left_win):
            if j - k - 1 >= 0:
                blocks.append((j, j - k - 1))
        for k in range(right_win):
            if j + k + 1 < path_len:
                blocks.append((j, j + k + 1))
    tgt = np.array([b[0] for b in blocks], dtype=np.int32)
    ctx = np.array([b[1] for b in blocks], dtype=np.int32)
    return tgt, ctx


def gen_pair(paths, left_win_size: int, right_win_size: int) -> np.ndarray:
    """[batch, pair_count, 2] (target, context) pairs of int64 paths."""
    paths = np.asarray(paths, dtype=np.int64)
    if paths.ndim == 1:
        paths = paths[None, :]
    batch, path_len = paths.shape
    tgt_idx, ctx_idx = pair_indices(path_len, left_win_size, right_win_size)
    if len(tgt_idx) == 0:
        return np.zeros((batch, 0, 2), dtype=np.int64)
    return np.stack([paths[:, tgt_idx], paths[:, ctx_idx]], axis=-1)
