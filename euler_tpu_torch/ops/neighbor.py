"""Neighbor ops on the host (counterpart of ``euler_tpu/ops/neighbor.py``):
fanout sampling through the engine client and the padded multi-hop
adjacency. The multi-hop result is padded and masked COO, the layout the
port's sparse aggregators (``nn/sparse_aggregators.py``) take; the device
form is ``graph/device.py``'s ``multi_hop_neighbor``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def sample_neighbor(g, nodes, edge_types, count, default_node=-1):
    return g.sample_neighbor(nodes, edge_types, count, default_node)


def sample_fanout(g, nodes, edge_types, counts, default_node=-1):
    """Multi-hop weighted fanout; one fused native call for all hops.

    Returns (ids_per_hop, weights_per_hop, types_per_hop) like the
    reference: ids_per_hop[0] is the flattened input, hop h has
    n * prod(counts[:h]) rows.
    """
    return g.sample_fanout(nodes, edge_types, counts, default_node)


@dataclasses.dataclass
class MultiHop:
    """One hop of padded multi-hop adjacency.

    nodes:      [max_nodes] int64 node ids of the *next* hop (padded with
                default_node).
    num_nodes:  true count before padding.
    adj_src:    [max_edges] int32 — index into the *current* hop's node
                array for each edge.
    adj_dst:    [max_edges] int32 — index into `nodes` for each edge.
    adj_w:      [max_edges] float32 edge weight (0 on padding).
    num_edges:  true count before padding.
    """

    nodes: np.ndarray
    num_nodes: int
    adj_src: np.ndarray
    adj_dst: np.ndarray
    adj_w: np.ndarray
    num_edges: int

    @property
    def adj(self) -> dict:
        """Adjacency dict for the sparse aggregators
        (``nn.sparse_aggregators``): keys src/dst/w/mask, where mask
        marks real (non-padding) edges."""
        mask = (
            np.arange(len(self.adj_src), dtype=np.float32) < self.num_edges
        ).astype(np.float32)
        return {
            "src": self.adj_src,
            "dst": self.adj_dst,
            "w": self.adj_w,
            "mask": mask,
        }


def get_multi_hop_neighbor(
    g,
    nodes,
    edge_types,
    max_nodes_per_hop=None,
    max_edges_per_hop=None,
    default_node=-1,
    exact=False,
):
    """Full-neighbor multi-hop expansion with per-hop dedup.

    Args:
      g: Graph.
      nodes: 1-D int64 root node ids.
      edge_types: per-hop list of edge-type lists.
      max_nodes_per_hop / max_edges_per_hop: per-hop static pad sizes. When
        None, arrays are exact-size (host-only use); when set, arrays are
        padded (and raise if the true size exceeds the cap) so the device
        step sees static shapes.
      exact: check the caps (and raise past them) but keep every array at
        its exact size, unpadded: one id's serving block
        (``SupervisedGCN.sample_serve_block``), which the serving layout
        pads once for a whole bucket.

    Returns (roots, hops): roots is the flattened input ids; hops is a list
    of MultiHop, one per entry of edge_types.
    """
    cur = np.asarray(nodes, dtype=np.int64).reshape(-1)
    roots = cur
    hops: list[MultiHop] = []
    for h, et in enumerate(edge_types):
        nbr, w, _, counts = g.get_full_neighbor(cur, et)
        uniq, inv = np.unique(nbr, return_inverse=True)
        src = np.repeat(np.arange(len(cur), dtype=np.int32), counts)
        dst = inv.astype(np.int32)
        n_nodes, n_edges = len(uniq), len(nbr)
        if max_nodes_per_hop is not None:
            cap = max_nodes_per_hop[h]
            if n_nodes > cap:
                raise ValueError(
                    f"hop {h}: {n_nodes} unique neighbors > cap {cap}"
                )
        if max_nodes_per_hop is not None and not exact:
            uniq = np.concatenate(
                [uniq, np.full(cap - n_nodes, default_node, dtype=np.int64)]
            )
        if max_edges_per_hop is not None:
            cap = max_edges_per_hop[h]
            if n_edges > cap:
                raise ValueError(f"hop {h}: {n_edges} edges > cap {cap}")
        if max_edges_per_hop is not None and not exact:
            pad = cap - n_edges
            # Padding edges point at slot 0 with weight 0: they contribute
            # nothing to weighted segment sums.
            src = np.concatenate([src, np.zeros(pad, dtype=np.int32)])
            dst = np.concatenate([dst, np.zeros(pad, dtype=np.int32)])
            w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])
        hops.append(
            MultiHop(
                nodes=uniq,
                num_nodes=n_nodes,
                adj_src=src,
                adj_dst=dst,
                adj_w=w.astype(np.float32, copy=False),
                num_edges=n_edges,
            )
        )
        cur = uniq[:n_nodes] if max_nodes_per_hop is not None else uniq
    return roots, hops
