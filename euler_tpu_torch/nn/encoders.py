"""Node encoders (counterpart of ``euler_tpu/nn/encoders.py``).

Feature dicts per node set: ``'ids'`` [n] int ids for the id-embedding
path, ``'dense'`` [n, feature_dim] float32 (after
``models.base.gather_consts`` has replaced the ``'gids'`` indices with
rows of the device feature table). ``SageEncoder`` takes the per-hop
list; hop h has n * prod(fanouts[:h]) rows, grouped by parent in
row-major order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch.nn import aggregators as dense_aggs
from euler_tpu_torch.nn.layers import Dense, Embedding


class ShallowEncoder(nn.Module):
    """An id embedding (``max_id >= 0``: ``Embedding(max_id + 2, ...)``)
    and the dense features, combined by ``"add"`` (the embedding at
    ``dim`` plus a bias-free Dense of the features to ``dim``) or
    ``"concat"`` (the embedding at ``embedding_dim`` beside the features,
    then a bias-free Dense to ``dim`` when ``dim`` is set). With neither
    an id path nor ``dim`` it is the features themselves, without
    parameters: the GraphSAGE towers' input. Sparse-feature slots
    (``SparseEmbedding``) are not ported."""

    def __init__(self, dim: Optional[int] = None, feature_dim: int = 0,
                 max_id: int = -1, embedding_dim: int = 16,
                 sparse_feature_max_ids: Sequence[int] = (),
                 combiner: str = "concat"):
        super().__init__()
        if sparse_feature_max_ids:
            raise NotImplementedError(
                "sparse-feature slots (SparseEmbedding) are not ported")
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
        return self.feature_dim + (self.embedding_dim if self.max_id >= 0
                                   else 0)

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
        if self.combiner == "add":
            return sum(embeddings)
        out = (torch.cat(embeddings, dim=-1) if len(embeddings) > 1
               else embeddings[0])
        if self.dense is not None:
            out = self.dense(out)
        return out


class SageEncoder(nn.Module):
    """GraphSAGE aggregation over sampled fanouts: layer l aggregates hop
    h with hop h+1 for every hop still open; ReLU on all layers but the
    last."""

    def __init__(self, in_dim: int, fanouts: Sequence[int], dim: int,
                 aggregator: str = "mean", concat: bool = False):
        super().__init__()
        agg_cls = dense_aggs.get(aggregator)
        if agg_cls is None:
            raise ValueError(
                f"aggregator {aggregator!r} is not ported; have "
                f"{sorted(dense_aggs.AGGREGATORS)}"
            )
        self.fanouts = list(fanouts)
        n = len(self.fanouts)
        self.aggregators = nn.ModuleList(
            agg_cls(
                in_dim if layer == 0 else dim,
                dim,
                activation=torch.relu if layer < n - 1 else None,
                concat=concat,
            )
            for layer in range(n)
        )

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
