"""Node encoders (counterpart of ``euler_tpu/nn/encoders.py``).

Feature dicts per node set: ``'ids'`` [n] int ids for the id-embedding
path, ``'dense'`` [n, feature_dim] float32 and ``'sparse'``, one
padded ``(ids [n, L], mask [n, L])`` pair a sparse slot (after
``models.base.gather_consts`` has replaced the ``'gids'`` indices with
rows of the device tables). ``SageEncoder`` takes the per-hop
list; hop h has n * prod(fanouts[:h]) rows, grouped by parent in
row-major order. ``GCNEncoder`` takes the per-hop list and one padded
COO adjacency a hop (``graph.device.multi_hop_neighbor``).
``ScalableSageEncoder`` takes the roots' rows, their fanout's rows and the
stale neighbor rows read from the stores; ``AttEncoder`` the [B, n, F]
sequence of each root and its sampled neighbors; ``SparseSageEncoder``
the per-hop lists of sparse ``(ids, mask)`` pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.nn import aggregators as dense_aggs
from euler_tpu_torch.nn import sparse_aggregators as sparse_aggs
from euler_tpu_torch.nn.layers import Dense, Embedding, SparseEmbedding


class ShallowEncoder(nn.Module):
    """An id embedding (``max_id >= 0``: ``Embedding(max_id + 2, ...)``),
    the dense features and one ``SparseEmbedding(max_id_k + 2, ...)`` a
    sparse slot (``sparse_feature_max_ids``), combined by ``"add"`` (the
    embeddings at ``dim`` plus a bias-free Dense of the features to
    ``dim``) or ``"concat"`` (the embeddings at ``embedding_dim``, in the
    order id, features, sparse slots, then a bias-free Dense to ``dim``
    when ``dim`` is set). With no embedding and no ``dim`` it is the
    features themselves, without parameters: the GraphSAGE towers'
    input."""

    def __init__(self, dim: Optional[int] = None, feature_dim: int = 0,
                 max_id: int = -1, embedding_dim: int = 16,
                 sparse_feature_max_ids: Sequence[int] = (),
                 combiner: str = "concat"):
        super().__init__()
        if combiner not in ("add", "concat"):
            raise ValueError(f"combiner must be 'add' or 'concat', got "
                             f"{combiner!r}")
        if combiner == "add" and dim is None:
            raise ValueError("the 'add' combiner needs dim")
        self.dim = dim
        self.feature_dim = feature_dim
        self.max_id = max_id
        self.embedding_dim = embedding_dim
        self.combiner = combiner
        emb_dim = dim if combiner == "add" else embedding_dim
        self.embedding = (Embedding(max_id + 2, emb_dim) if max_id >= 0
                          else None)
        self.sparse_embeddings = nn.ModuleList(
            SparseEmbedding(m + 2, emb_dim) for m in sparse_feature_max_ids)
        # flax's single Dense_0: the features' Dense under "add", the
        # projection of the concatenation under "concat"
        if combiner == "add":
            dense_in = feature_dim
        else:
            dense_in = self._concat_dim if dim is not None else 0
        self.dense = (Dense(dense_in, dim, use_bias=False) if dense_in
                      else None)

    @property
    def _concat_dim(self) -> int:
        n_emb = (self.max_id >= 0) + len(self.sparse_embeddings)
        return self.feature_dim + self.embedding_dim * n_emb

    @property
    def output_dim(self) -> int:
        return self.dim if self.dim is not None else self._concat_dim

    def forward(self, feats: dict):
        embeddings = []
        if self.embedding is not None:
            embeddings.append(self.embedding(feats["ids"]))
        if self.feature_dim:
            dense = feats["dense"]
            if self.combiner == "add":
                dense = self.dense(dense)
            embeddings.append(dense)
        for emb, (ids, mask) in zip(self.sparse_embeddings,
                                    feats.get("sparse", ())):
            embeddings.append(emb(ids, mask))
        if self.combiner == "add":
            return sum(embeddings)
        out = (torch.cat(embeddings, dim=-1) if len(embeddings) > 1
               else embeddings[0])
        if self.dense is not None:
            out = self.dense(out)
        return out


def _dense_aggregators(in_dim: int, num_layers: int, dim: int,
                       aggregator: str, concat: bool) -> nn.ModuleList:
    """One dense aggregator a layer: layer 0 reads ``in_dim``-wide rows,
    later layers ``dim``; ReLU on all layers but the last; ``concat``
    passed to every class but the GCN aggregator, which has no concat
    form."""
    agg_cls = dense_aggs.get(aggregator)
    if agg_cls is None:
        raise ValueError(
            f"aggregator {aggregator!r} is not ported; have "
            f"{sorted(dense_aggs.AGGREGATORS)}"
        )
    kw = {} if agg_cls is dense_aggs.GCNAggregator else {"concat": concat}
    return nn.ModuleList(
        agg_cls(
            in_dim if layer == 0 else dim,
            dim,
            activation=torch.relu if layer < num_layers - 1 else None,
            **kw,
        )
        for layer in range(num_layers)
    )


class SageEncoder(nn.Module):
    """GraphSAGE aggregation over sampled fanouts: layer l aggregates hop
    h with hop h+1 for every hop still open; ReLU on all layers but the
    last."""

    def __init__(self, in_dim: int, fanouts: Sequence[int], dim: int,
                 aggregator: str = "mean", concat: bool = False):
        super().__init__()
        self.fanouts = list(fanouts)
        self.aggregators = _dense_aggregators(in_dim, len(self.fanouts), dim,
                                              aggregator, concat)

    def forward(self, hidden: list):
        n = len(self.fanouts)
        if len(hidden) != n + 1:
            raise ValueError(
                f"SageEncoder with {n} fanouts needs {n + 1} hops, got "
                f"{len(hidden)}"
            )
        for agg in self.aggregators:
            next_hidden = []
            for hop in range(len(hidden) - 1):
                d = hidden[hop].shape[-1]
                neigh = hidden[hop + 1].reshape(-1, self.fanouts[hop], d)
                next_hidden.append(agg(hidden[hop], neigh))
            hidden = next_hidden
        return hidden[0]


class SparseSageEncoder(nn.Module):
    """Sparse-feature GraphSAGE: per-slot ``SparseEmbedding`` lookups,
    concatenated, feed a ``SageEncoder``. ``forward`` takes the per-hop
    list of per-slot ``(ids, mask)`` rows (hop h sized batch *
    prod(fanouts[:h])). Each slot's table has ``feature_dims[k] + 2``
    rows (the feature's ids, its padding id and one spare), unless
    ``shared_embeddings`` passes modules built and registered by the
    caller: then every tower given them looks up the same tables, and
    this module holds them without registering them again, so the
    parameters (and their optimizer moments) exist once."""

    def __init__(self, fanouts: Sequence[int], dim: int,
                 feature_dims: Sequence[int] = (), aggregator: str = "mean",
                 concat: bool = False, embedding_dim: int = 16,
                 shared_embeddings: Optional[Sequence[SparseEmbedding]]
                 = None):
        super().__init__()
        if shared_embeddings is not None:
            self.sparse_embeddings = None
            self._shared = tuple(shared_embeddings)  # a tuple registers none
        else:
            self.sparse_embeddings = nn.ModuleList(
                SparseEmbedding(d + 2, embedding_dim) for d in feature_dims)
        in_dim = sum(e.dim for e in self.embeddings)
        self.sage = SageEncoder(in_dim, fanouts, dim, aggregator, concat)

    @property
    def embeddings(self):
        if self.sparse_embeddings is None:
            return self._shared
        return tuple(self.sparse_embeddings)

    def forward(self, hops: list):
        hidden = [
            torch.cat([emb(ids, mask)
                       for emb, (ids, mask) in zip(self.embeddings, hop)],
                      dim=-1)
            for hop in hops
        ]
        return self.sage(hidden)


class GCNEncoder(nn.Module):
    """Full-neighbor multi-hop GCN over padded COO adjacency: layer l
    aggregates hop h with hop h+1 through ``adjs[h]`` for hops
    0..num_layers-1-l, with the sparse aggregator ``aggregator``
    (``nn.sparse_aggregators``); ReLU on all layers but the last, and
    with ``use_residual`` each layer's input row added to its output.
    Layer 0 reads ``in_dim``-wide rows, later layers ``dim``."""

    def __init__(self, in_dim: int, num_layers: int, dim: int,
                 aggregator: str = "gcn", use_residual: bool = False):
        super().__init__()
        agg_cls = sparse_aggs.get(aggregator)
        if agg_cls is None:
            raise ValueError(
                f"aggregator {aggregator!r} is not a sparse aggregator; "
                f"have {sorted(sparse_aggs.AGGREGATORS)}")
        self.num_layers = num_layers
        self.use_residual = use_residual
        self.aggregators = nn.ModuleList(
            agg_cls(
                in_dim if layer == 0 else dim,
                dim,
                activation=torch.relu if layer < num_layers - 1 else None,
            )
            for layer in range(num_layers)
        )

    def forward(self, hidden: list, adjs: list):
        n = self.num_layers
        if len(hidden) != n + 1 or len(adjs) != n:
            raise ValueError(
                f"GCNEncoder with {n} layers needs {n + 1} hops and {n} "
                f"adjacencies, got {len(hidden)} and {len(adjs)}")
        for agg in self.aggregators:
            next_hidden = []
            for hop in range(len(hidden) - 1):
                h = agg(hidden[hop], hidden[hop + 1], adjs[hop])
                if self.use_residual:
                    h = hidden[hop] + h
                next_hidden.append(h)
            hidden = next_hidden
        return hidden[0]


class ScalableSageEncoder(nn.Module):
    """GraphSAGE with historical-embedding stores: layer 0 aggregates the
    roots' rows with their sampled fanout's; layer l > 0 aggregates the
    roots' layer l-1 embeddings with the stale neighbor embeddings read
    from store l-1, so a step samples one hop only. The store reads and
    writes live in ``models.base.ScalableStoreModel``'s step; this is the
    pure function."""

    def __init__(self, in_dim: int, fanout: int, num_layers: int, dim: int,
                 aggregator: str = "mean", concat: bool = False):
        super().__init__()
        self.fanout = fanout
        self.num_layers = num_layers
        self.aggregators = _dense_aggregators(in_dim, num_layers, dim,
                                              aggregator, concat)

    def forward(self, node_feat, neigh_feat, store_reads: list):
        """``node_feat`` [B, d0], ``neigh_feat`` [B*fanout, d0],
        ``store_reads`` ``num_layers - 1`` tensors [B*fanout, dim].
        Returns (final [B, dim], the node embeddings of every layer)."""
        node_emb, neigh_emb = node_feat, neigh_feat
        node_embeddings = []
        for layer, agg in enumerate(self.aggregators):
            d = node_emb.shape[-1]
            node_emb = agg(node_emb, neigh_emb.reshape(-1, self.fanout, d))
            node_embeddings.append(node_emb)
            if layer < self.num_layers - 1:
                neigh_emb = store_reads[layer]
        return node_emb, node_embeddings


class _AttHead(nn.Module):
    """One all-pairs attention head over [B, n, F]: ``seq_fts = seq @ W``
    (no bias), logits ``f1_i + f2_j`` from two width-1 Denses of
    ``seq_fts``, a row softmax of their leaky ReLU (slope 0.01, flax's),
    the weighted sum of ``seq_fts`` plus a bias, then ELU.

    The leaky ReLU is flax's ``where(x >= 0, x, 0.01 x)``, whose slope at
    exactly 0 is 1 (``F.leaky_relu``'s is 0.01). Logits of exactly 0 are
    common: the default row's features are zeros, and the gates' biases
    start at zero."""

    def __init__(self, in_dim: int, out_size: int):
        super().__init__()
        self.fts = Dense(in_dim, out_size, use_bias=False)
        self.f1 = Dense(out_size, 1)
        self.f2 = Dense(out_size, 1)
        self.bias = nn.Parameter(torch.zeros(out_size))

    def forward(self, seq):
        seq_fts = self.fts(seq)                                 # [B, n, out]
        logits = self.f1(seq_fts) + self.f2(seq_fts).transpose(1, 2)
        logits = torch.where(logits >= 0, logits, 0.01 * logits)
        coefs = torch.softmax(logits, dim=-1)
        return F.elu(torch.bmm(coefs, seq_fts) + self.bias)


class AttEncoder(nn.Module):
    """GAT attention over each root's sampled neighborhood, the [B, n, F]
    sequence (the root at position 0): ``head_num`` hidden heads of
    ``hidden_dim``, concatenated, then ``head_num`` output heads of
    ``out_dim``, averaged; returns position 0. ``heads[:head_num]`` are
    the hidden round and ``heads[head_num:]`` the output round, as flax
    numbers them ``_AttHead_0`` to ``_AttHead_{2 head_num - 1}``."""

    def __init__(self, in_dim: int, head_num: int = 1, hidden_dim: int = 256,
                 out_dim: int = 1):
        super().__init__()
        self.head_num = head_num
        self.heads = nn.ModuleList(
            [_AttHead(in_dim, hidden_dim) for _ in range(head_num)]
            + [_AttHead(hidden_dim * head_num, out_dim)
               for _ in range(head_num)])

    def forward(self, seq):
        hidden, out = self.heads[:self.head_num], self.heads[self.head_num:]
        h1 = torch.cat([head(seq) for head in hidden], dim=-1)
        return (sum(head(h1) for head in out) / self.head_num)[:, 0, :]
