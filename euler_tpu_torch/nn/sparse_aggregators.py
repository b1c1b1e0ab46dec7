"""Segment-op aggregators over padded COO adjacency, the full-neighbor
GCN path (counterpart of ``euler_tpu/nn/sparse_aggregators.py``).

The adjacency is the padded COO of ``graph.device.multi_hop_neighbor``
(``src``/``dst`` index the current/next hop's node arrays, ``mask`` is
1.0 on real edges) or ScalableGCN's slab rows. Aggregation is a segment
sum over ``src`` (``index_add``); padding edges carry mask 0 and add
nothing. Each module is called as ``agg(self_emb [n, d], neigh_emb
[m, d], adj)``. Plain PyTorch on every device, as the JAX package runs
these in XLA ops: on CUDA ``index_add`` adds in atomic order, so sums
agree with the CPU's within float32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.nn.layers import Dense


def _gather_sum(values, adj_src, num_nodes: int):
    """``[num_nodes, *values.shape[1:]]`` sums of ``values`` rows by
    ``adj_src`` (int32 or int64), empty segments 0: the segment sum."""
    out = values.new_zeros((num_nodes, *values.shape[1:]))
    return out.index_add(0, adj_src, values)


def _degree(adj_src, edge_mask, num_nodes: int):
    return _gather_sum(edge_mask, adj_src, num_nodes)


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
        agg = _gather_sum(_messages(neigh_emb, adj), adj["src"], n)
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
        agg = (_gather_sum(_messages(neigh_emb, adj), adj["src"], n)
               / deg.clamp(min=1e-7))
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
    denom = _gather_sum(e, segments, num_segments)
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
            coef = segment_softmax(
                torch.cat([logits, self_logits]), ext_src, n,
                torch.cat([edge_mask, edge_mask.new_ones(n)]))
            msgs = torch.cat([from_all.index_select(0, dst),
                              from_self]) * coef[:, None]
            out = _gather_sum(msgs, ext_src, n)
        else:
            coef = segment_softmax(logits, src, n, edge_mask)
            msgs = from_all.index_select(0, dst) * coef[:, None]
            out = from_self + _gather_sum(msgs, src, n)
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
