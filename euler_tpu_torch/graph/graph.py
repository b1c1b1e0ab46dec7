"""An in-memory graph over CSR arrays.

Device-sampling training reads the graph once, at init, to build the
device tables (adjacency slabs, root sampler, feature and label tables).
This class answers exactly those reads, with the C++ engine client's
method names and return conventions (``euler_tpu/graph/graph.py``), so the
table builders in ``graph/device.py`` and ``models/base.py`` are the
engine-facing code they are in the JAX package. Porting the engine client
itself (``.dat`` loading, host sampling, remote mode) is later work.

Like the engine (``eg_graph.cc``), each (node, edge type) neighbor group
is stored sorted ascending by id, so slabs built here match slabs built
from the engine row for row.
"""

from __future__ import annotations

import numpy as np


class Graph:
    """Node ids are ``0 .. num_nodes-1``. ``indptr`` [num_nodes *
    edge_type_num + 1] delimits the (node, edge type) groups in node-major
    order over ``indices`` (neighbor ids) and ``weights``.
    ``dense_features`` holds one ``[num_nodes, dim]`` float32 array per
    dense feature slot."""

    def __init__(
        self,
        indptr,
        indices,
        weights,
        node_weights,
        node_types,
        dense_features=(),
        edge_type_num: int = 1,
    ):
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        weights = np.asarray(weights, np.float32)
        self.num_nodes = len(node_weights)
        self.edge_type_num = edge_type_num
        if len(indptr) != self.num_nodes * edge_type_num + 1:
            raise ValueError(
                f"indptr has {len(indptr)} entries; {self.num_nodes} nodes x "
                f"{edge_type_num} edge types need "
                f"{self.num_nodes * edge_type_num + 1}"
            )
        if len(indices) != indptr[-1] or len(weights) != indptr[-1]:
            raise ValueError("indices/weights must have indptr[-1] entries")
        group = np.repeat(
            np.arange(len(indptr) - 1), np.diff(indptr)
        )
        order = np.lexsort((indices, group))  # by group, then id
        self._indptr = indptr
        self._indices = indices[order]
        self._weights = weights[order]
        self._node_weights = np.asarray(node_weights, np.float32)
        self._node_types = np.asarray(node_types, np.int32)
        self._dense = [np.asarray(f, np.float32) for f in dense_features]

    @property
    def max_node_id(self) -> int:
        return self.num_nodes - 1

    def _known(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        return ids, (ids >= 0) & (ids < self.num_nodes)

    def get_full_neighbor(self, ids, edge_types, sorted: bool = False):
        """Ragged full adjacency ``(nbr_ids i64, weights f32, types i32,
        row_counts i32)``: per id, its groups of ``edge_types`` in the
        order given (``sorted=True`` merges them by id, earlier types
        first on ties). Unknown ids and edge types have no neighbors."""
        ids, known = self._known(ids)
        ets = np.asarray(
            [e for e in map(int, edge_types) if 0 <= e < self.edge_type_num],
            np.int64,
        )
        # one (id, edge type) group per pair, id-major, types as given
        groups = (ids[:, None] * self.edge_type_num + ets[None, :]).reshape(-1)
        pair_known = np.repeat(known, len(ets))
        starts = np.zeros(len(groups), np.int64)
        lens = np.zeros(len(groups), np.int64)
        g = groups[pair_known]
        starts[pair_known] = self._indptr[g]
        lens[pair_known] = self._indptr[g + 1] - self._indptr[g]
        out_off = np.zeros(len(groups) + 1, np.int64)
        np.cumsum(lens, out=out_off[1:])
        src = (
            np.arange(out_off[-1]) - np.repeat(out_off[:-1], lens)
            + np.repeat(starts, lens)
        )
        nbr, w = self._indices[src], self._weights[src]
        t = np.repeat(np.tile(ets, len(ids)), lens).astype(np.int32)
        counts = lens.reshape(len(ids), len(ets)).sum(1).astype(np.int32)
        if sorted:
            row = np.repeat(np.arange(len(ids)), counts)
            o = np.lexsort((nbr, row))  # stable: earlier types win ties
            nbr, w, t = nbr[o], w[o], t[o]
        return nbr, w, t, counts

    def node_weights(self, ids) -> np.ndarray:
        """Per-node sampling weights, 0 for unknown ids."""
        ids, known = self._known(ids)
        out = np.zeros(len(ids), np.float32)
        out[known] = self._node_weights[ids[known]]
        return out

    def node_types(self, ids) -> np.ndarray:
        """Per-node types, -1 for unknown ids."""
        ids, known = self._known(ids)
        out = np.full(len(ids), -1, np.int32)
        out[known] = self._node_types[ids[known]]
        return out

    def get_dense_feature(self, ids, fids, dims) -> np.ndarray:
        """``[n, sum(dims)]`` float32: slot ``fids[k]`` cut or zero-padded
        to ``dims[k]`` columns; unknown ids and slots give zeros."""
        ids, known = self._known(ids)
        out = np.zeros((len(ids), int(np.sum(dims))), np.float32)
        col = 0
        for f, d in zip(fids, dims):
            f, d = int(f), int(d)
            if 0 <= f < len(self._dense):
                table = self._dense[f]
                w = min(d, table.shape[1])
                out[known, col:col + w] = table[ids[known], :w]
            col += d
        return out
