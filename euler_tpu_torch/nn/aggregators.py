"""Dense (fanout-shaped) aggregators for sampled-neighbor encoders
(counterpart of ``euler_tpu/nn/aggregators.py``). Inputs are
(self_embedding [n, d], neigh_embedding [n, fanout, d])."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from euler_tpu_torch.nn.layers import Dense


class GCNAggregator(nn.Module):
    """One bias-free Dense with ``activation`` over the mean of the self
    row and its neighbors (``[self; neigh]``)."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Optional[Callable] = torch.relu):
        super().__init__()
        self.dense = Dense(in_dim, dim, activation, use_bias=False)

    def forward(self, self_emb, neigh_emb):
        all_emb = torch.cat([self_emb[:, None, :], neigh_emb], dim=1)
        return self.dense(all_emb.mean(dim=1))


class _BaseAggregator(nn.Module):
    """Bias-free self and neighbor Denses, each with ``activation``,
    summed (or concatenated, half width each, when ``concat``). The
    neighbor Dense reads ``aggregate(neigh_emb)``, whose width
    ``_aggregate_dim`` gives."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Optional[Callable] = torch.relu,
                 concat: bool = False):
        super().__init__()
        self.concat = concat
        agg_dim = self._aggregate_dim(in_dim, dim)
        if concat:
            if dim % 2:
                raise ValueError("dim must be even when concat=True")
            dim //= 2
        self.self_dense = Dense(in_dim, dim, activation, use_bias=False)
        self.neigh_dense = Dense(agg_dim, dim, activation, use_bias=False)

    def _aggregate_dim(self, in_dim: int, dim: int) -> int:
        return in_dim

    def aggregate(self, neigh_emb):
        raise NotImplementedError

    def forward(self, self_emb, neigh_emb):
        from_self = self.self_dense(self_emb)
        from_neigh = self.neigh_dense(self.aggregate(neigh_emb))
        if self.concat:
            return torch.cat([from_self, from_neigh], dim=1)
        return from_self + from_neigh


class MeanAggregator(_BaseAggregator):
    def aggregate(self, neigh_emb):
        return neigh_emb.mean(dim=1)


class _PoolAggregator(_BaseAggregator):
    """A pooling Dense (with bias and ReLU, to the full ``dim`` even under
    ``concat``) on every neighbor row, then a pool over the fanout."""

    def _aggregate_dim(self, in_dim: int, dim: int) -> int:
        self.pool_dense = Dense(in_dim, dim, torch.relu)
        return dim


class MeanPoolAggregator(_PoolAggregator):
    def aggregate(self, neigh_emb):
        return self.pool_dense(neigh_emb).mean(dim=1)


class MaxPoolAggregator(_PoolAggregator):
    def aggregate(self, neigh_emb):
        return self.pool_dense(neigh_emb).amax(dim=1)


AGGREGATORS = {
    "gcn": GCNAggregator,
    "mean": MeanAggregator,
    "meanpool": MeanPoolAggregator,
    "maxpool": MaxPoolAggregator,
}


def get(name: str):
    return AGGREGATORS.get(name)
