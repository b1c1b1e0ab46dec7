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


class SparseEmbedding(Embedding):
    """Masked combine over padded sparse-id features
    (``ops.feature.get_sparse_feature``'s ``(ids [n, L], mask [n, L])``):
    each row's ``table[ids]`` weighted by the mask and summed over L
    (``combiner="sum"``, the reference's default) or divided by
    ``max(sum(mask), 1)`` (``"mean"``). Ids are clipped into
    ``[0, num-1]``. Init as ``Embedding``'s, at flax's stddev 0.0002."""

    def __init__(self, num: int, dim: int, combiner: str = "sum",
                 stddev: float = 0.0002):
        if combiner not in ("sum", "mean"):
            raise ValueError(f"unknown combiner {combiner}")
        super().__init__(num, dim, stddev)
        self.combiner = combiner

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def forward(self, ids, mask):
        num = self.embeddings.shape[0]
        shape = ids.shape
        ids = ids.clamp(0, num - 1).reshape(-1, shape[-1])
        mask = mask.reshape(-1, shape[-1])
        # a masked position adds 0 whatever row it reads: row i's go to
        # row i mod num, not to the padding id, which every padded
        # position of a batch shares and whose one segment would
        # serialize the backward's segmented sum on CUDA
        spread = torch.arange(ids.shape[0], dtype=ids.dtype,
                              device=ids.device)[:, None] % num
        ids = torch.where(mask != 0, ids, spread)
        # one bag of L a row, weighted by the mask: no [n, L, dim] tensor
        total = F.embedding_bag(ids, self.embeddings, mode="sum",
                                per_sample_weights=mask)
        mask = mask.reshape(shape)
        total = total.reshape(*shape[:-1], -1)
        if self.combiner == "mean":
            total = total / mask.sum(-1, keepdim=True).clamp(min=1.0)
        return total
