"""Segment-op aggregators over padded COO adjacency, the full-neighbor
GCN path (counterpart of ``euler_tpu/nn/sparse_aggregators.py``).

The adjacency is the padded COO of ``graph.device.multi_hop_neighbor``
(``src``/``dst`` index the current/next hop's node arrays, ``mask`` is
1.0 on real edges) or ScalableGCN's slab rows. Aggregation is a segment
sum over ``src``; padding edges carry mask 0 and add nothing. Each module
is called as ``agg(self_emb [n, d], neigh_emb [m, d], adj)``. Plain
PyTorch on every device, as the JAX package runs these in XLA ops.

The segment sum is ``index_add``: in edge order on the CPU, in atomic
order on CUDA, so there sums agree with the CPU's within float32
rounding, not bit for bit, and a row's bits may change from run to run.
Within ``deterministic_sums()`` (the models' embed steps, so serving and
export) it is deterministic on every device, as the JAX package's
``segment_sum`` is: the real edges are stably sorted by ``src`` (padding
edges, mask 0, after them all) and each segment is summed over its real
edges in edge order from 0 (``torch.segment_reduce`` on ``[E, d]`` rows:
one sequential sum a segment and column on CUDA, never atomics). A
segment's sum then depends only on its own real edges, in their order,
not on where its rows sit, on padding, or on what else is in the batch,
so a served row is bit-stable however its bucket is filled. Padding
edges are skipped, not summed: a serving bucket parks them all on one
sink row, which one thread would otherwise walk edge by edge. On the
CPU the two sums agree bit for bit but for the sign of a zero sum.
Training keeps ``index_add``, cheaper on the card by its sort.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.nn.layers import Dense


_local = threading.local()


@contextlib.contextmanager
def deterministic_sums():
    """Within this block, on this thread, every segment sum is the
    deterministic one (see the module docstring)."""
    prev = getattr(_local, "on", False)
    _local.on = True
    try:
        yield
    finally:
        _local.on = prev


def _gather_sum(values, adj_src, num_nodes: int, edge_mask=None):
    """``[num_nodes, *values.shape[1:]]`` sums of ``values`` rows by
    ``adj_src`` (int32 or int64), empty segments 0: the segment sum.
    ``values`` must be 0 where ``edge_mask`` is (padding edges add
    nothing). Within ``deterministic_sums`` each segment is summed over
    its unmasked edges in edge order. Neither its sort nor its sum reads
    a value back to the host, so a CUDA graph can capture it:
    ``unsafe=True`` skips ``segment_reduce``'s checks, which would; the
    lengths count the real edges, which the sort puts first, and the sum
    reads no row past them."""
    if not getattr(_local, "on", False):
        out = values.new_zeros((num_nodes, *values.shape[1:]))
        return out.index_add(0, adj_src, values)
    key = adj_src.long()
    if edge_mask is not None:
        key = torch.where(edge_mask > 0, key, num_nodes)
    order = torch.sort(key, stable=True).indices
    lengths = torch.zeros(num_nodes + 1, dtype=torch.int64,
                          device=key.device).index_add_(
        0, key, torch.ones_like(key))[:num_nodes]
    rows = values.index_select(0, order)
    # [E, 1], not [E]: a 1-D segment_reduce is CUB's tree reduction,
    # whose loads follow the segment's alignment
    out = torch.segment_reduce(rows.reshape(rows.shape[0], -1), "sum",
                               lengths=lengths, unsafe=True)
    return out.reshape(num_nodes, *values.shape[1:])


def _degree(adj_src, edge_mask, num_nodes: int):
    return _gather_sum(edge_mask, adj_src, num_nodes, edge_mask)


def _messages(neigh_emb, adj):
    """Each edge's neighbor row, zeroed on padding edges."""
    return neigh_emb.index_select(0, adj["dst"]) * adj["mask"][:, None]


class GCNAggregator(nn.Module):
    """``(self + sum(neigh) / max(deg, 1e-7)) @ W`` (the self row not
    normalized), or with ``renorm`` ``(self + sum(neigh)) / (1 + deg) @
    W``; one bias-free Dense with ``activation``. Binary adjacency."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Optional[Callable] = torch.relu,
                 renorm: bool = False):
        super().__init__()
        self.renorm = renorm
        self.dense = Dense(in_dim, dim, activation, use_bias=False)

    def forward(self, self_emb, neigh_emb, adj):
        n = self_emb.shape[0]
        deg = _degree(adj["src"], adj["mask"], n)[:, None]
        agg = _gather_sum(_messages(neigh_emb, adj), adj["src"], n,
                          adj["mask"])
        if self.renorm:
            agg = (self_emb + agg) / (1.0 + deg)
        else:
            agg = self_emb + agg / deg.clamp(min=1e-7)
        return self.dense(agg)


class MeanAggregator(nn.Module):
    """Bias-free self Dense plus bias-free Dense of the neighbor mean
    (``sum / max(deg, 1e-7)``), each with ``activation``; with ``concat``
    each is half width and the two are concatenated."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Optional[Callable] = torch.relu,
                 concat: bool = False):
        super().__init__()
        self.concat = concat
        out = dim // 2 if concat else dim
        self.self_dense = Dense(in_dim, out, activation, use_bias=False)
        self.neigh_dense = Dense(in_dim, out, activation, use_bias=False)

    def forward(self, self_emb, neigh_emb, adj):
        n = self_emb.shape[0]
        deg = _degree(adj["src"], adj["mask"], n)[:, None]
        agg = (_gather_sum(_messages(neigh_emb, adj), adj["src"], n,
                           adj["mask"]) / deg.clamp(min=1e-7))
        from_self = self.self_dense(self_emb)
        from_neigh = self.neigh_dense(agg)
        if self.concat:
            return torch.cat([from_self, from_neigh], dim=1)
        return from_self + from_neigh


def segment_softmax(logits, segments, num_segments: int, mask):
    """Softmax of edge logits within each ``segments`` group; masked edges
    (``mask`` 0) get probability 0. Masked logits become float32's
    lowest value; an empty segment's max (-inf) becomes 0; the
    denominator is clamped at 1e-16. The max is a shift the softmax does
    not depend on, so no gradient flows through it."""
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(mask > 0, logits, neg)
    seg_max = torch.full((num_segments,), float("-inf"), dtype=logits.dtype,
                         device=logits.device).scatter_reduce(
        0, segments.long(), masked.detach(), "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.exp(masked - seg_max.index_select(0, segments)) * mask
    denom = _gather_sum(e, segments, num_segments, mask)
    return e / denom.index_select(0, segments).clamp(min=1e-16)


class SingleAttentionAggregator(nn.Module):
    """One GAT-style head: a shared bias-free projection ``dense`` (to
    ``dim``), scalar gates ``self_gate`` on the self rows and ``all_gate``
    on the neighbor rows, ``leaky_relu(self_w[src] + all_w[dst])``
    softmaxed per source node, the weighted neighbor sum added to the
    projected self row. With ``renorm`` each node's softmax also takes a
    virtual self-edge (logit from ``all_gate`` on its own projection) and
    the self row is not added separately. ``activation`` last."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Optional[Callable] = torch.relu,
                 renorm: bool = False):
        super().__init__()
        self.activation = activation
        self.renorm = renorm
        self.dense = Dense(in_dim, dim, use_bias=False)
        self.self_gate = Dense(dim, 1, use_bias=False)
        self.all_gate = Dense(dim, 1, use_bias=False)

    def forward(self, self_emb, neigh_emb, adj):
        src, dst, edge_mask = adj["src"], adj["dst"], adj["mask"]
        n = self_emb.shape[0]
        from_self = self.dense(self_emb)          # [n, dim]
        from_all = self.dense(neigh_emb)          # [m, dim]
        self_w = self.self_gate(from_self)[:, 0]  # [n]
        all_w = self.all_gate(from_all)[:, 0]     # [m]
        logits = F.leaky_relu(self_w.index_select(0, src)
                              + all_w.index_select(0, dst))
        if self.renorm:
            self_logits = F.leaky_relu(self_w
                                       + self.all_gate(from_self)[:, 0])
            ext_src = torch.cat([src, torch.arange(
                n, dtype=src.dtype, device=src.device)])
            ext_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
            coef = segment_softmax(
                torch.cat([logits, self_logits]), ext_src, n, ext_mask)
            msgs = torch.cat([from_all.index_select(0, dst),
                              from_self]) * coef[:, None]
            out = _gather_sum(msgs, ext_src, n, ext_mask)
        else:
            coef = segment_softmax(logits, src, n, edge_mask)
            msgs = from_all.index_select(0, dst) * coef[:, None]
            out = from_self + _gather_sum(msgs, src, n, edge_mask)
        if self.activation is not None:
            out = self.activation(out)
        return out


class AttentionAggregator(nn.Module):
    """``num_heads`` single heads of ``dim // num_heads``, concatenated."""

    def __init__(self, in_dim: int, dim: int, num_heads: int = 4,
                 activation: Optional[Callable] = torch.relu,
                 renorm: bool = False):
        super().__init__()
        self.heads = nn.ModuleList(
            SingleAttentionAggregator(in_dim, dim // num_heads, activation,
                                      renorm)
            for _ in range(num_heads))

    def forward(self, self_emb, neigh_emb, adj):
        return torch.cat([h(self_emb, neigh_emb, adj) for h in self.heads],
                         dim=1)


AGGREGATORS = {
    "gcn": GCNAggregator,
    "mean": MeanAggregator,
    "attention": AttentionAggregator,
}


def get(name: str):
    return AGGREGATORS.get(name)
