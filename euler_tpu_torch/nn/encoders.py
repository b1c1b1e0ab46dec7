"""Node encoders (counterpart of ``euler_tpu/nn/encoders.py``).

Feature dicts per node set: ``'dense'`` [n, feature_dim] float32 (after
``models.base.gather_consts`` has replaced the ``'gids'`` indices with
rows of the device feature table). ``SageEncoder`` takes the per-hop
list; hop h has n * prod(fanouts[:h]) rows, grouped by parent in
row-major order.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from euler_tpu_torch.nn import aggregators as dense_aggs


class ShallowEncoder(nn.Module):
    """The dense-feature path of the JAX ShallowEncoder (concat combiner,
    no id or sparse embeddings, no projection): the node's dense
    features, unchanged. It has no parameters."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.feature_dim = feature_dim

    @property
    def output_dim(self) -> int:
        return self.feature_dim

    def forward(self, feats: dict):
        return feats["dense"]


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
