"""Core layers (counterpart of ``euler_tpu/nn/layers.py``)."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal draws a normal truncated at +-2 std and divides the
# std by this (the std of the unit normal truncated at +-2), so the kept
# draws have variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """In-place flax ``lecun_normal`` init of a ``[out, in]`` weight."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(
        weight, std=std, a=-2 * std, b=2 * std, generator=generator
    )


class Dense(nn.Module):
    """``activation(x @ W + b)``; lecun-normal kernel and zero bias at
    init, like flax's ``nn.Dense``."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Optional[Callable] = None,
                 use_bias: bool = True):
        super().__init__()
        self.linear = nn.Linear(in_dim, dim, bias=use_bias)
        self.activation = activation
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            lecun_normal_(self.linear.weight, generator)
            if self.linear.bias is not None:
                self.linear.bias.zero_()

    def forward(self, x):
        y = self.linear(x)
        if self.activation is not None:
            y = self.activation(y)
        return y


class Embedding(nn.Module):
    """Id embedding table ``[num, dim]``; ids are clipped into
    ``[0, num-1]`` (callers size it max_id+2, the last row the default
    id's). Init is flax's ``truncated_normal(stddev)``: a unit normal
    truncated at +-2, scaled. The gradient is dense, as optax's Adam
    decays the moments of every row each step."""

    def __init__(self, num: int, dim: int, stddev: float = 0.1):
        super().__init__()
        self.stddev = stddev
        self.embeddings = nn.Parameter(torch.empty(num, dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            nn.init.trunc_normal_(self.embeddings, std=self.stddev,
                                  a=-2 * self.stddev, b=2 * self.stddev,
                                  generator=generator)

    def forward(self, ids):
        ids = ids.clamp(0, self.embeddings.shape[0] - 1)
        return F.embedding(ids, self.embeddings)
