"""Dense (fanout-shaped) aggregators for sampled-neighbor encoders
(counterpart of ``euler_tpu/nn/aggregators.py``). Inputs are
(self_embedding [n, d], neigh_embedding [n, fanout, d])."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from euler_tpu_torch.nn.layers import Dense


class _BaseAggregator(nn.Module):
    """Bias-free self and neighbor Denses, each with ``activation``,
    summed (or concatenated, half width each, when ``concat``)."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Optional[Callable] = torch.relu,
                 concat: bool = False):
        super().__init__()
        self.concat = concat
        if concat:
            if dim % 2:
                raise ValueError("dim must be even when concat=True")
            dim //= 2
        self.self_dense = Dense(in_dim, dim, activation, use_bias=False)
        self.neigh_dense = Dense(in_dim, dim, activation, use_bias=False)

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


AGGREGATORS = {"mean": MeanAggregator}


def get(name: str):
    return AGGREGATORS.get(name)
