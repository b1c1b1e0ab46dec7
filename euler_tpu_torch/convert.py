"""Carry the JAX package's weights across to the port."""

from __future__ import annotations

import numpy as np
import torch


def _kernel(k) -> torch.Tensor:
    # flax kernels are [in, out]; nn.Linear weights are [out, in]
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).T))


def params_from_flax(params) -> dict:
    """State dict of ``graphsage._SupervisedSageModule`` from the params
    tree of the flax ``_SupervisedSageModule`` (nested dicts of arrays):
    ``encoder/MeanAggregator_{l}/Dense_0/Dense_0/kernel`` is layer l's
    self Dense, ``.../Dense_1/Dense_0/kernel`` its neighbor Dense, and
    ``predict/{kernel,bias}`` the classifier."""
    enc = params["encoder"]
    sd = {}
    layer = 0
    while f"MeanAggregator_{layer}" in enc:
        agg = enc[f"MeanAggregator_{layer}"]
        prefix = f"encoder.aggregators.{layer}"
        sd[f"{prefix}.self_dense.linear.weight"] = _kernel(
            agg["Dense_0"]["Dense_0"]["kernel"]
        )
        sd[f"{prefix}.neigh_dense.linear.weight"] = _kernel(
            agg["Dense_1"]["Dense_0"]["kernel"]
        )
        layer += 1
    sd["predict.linear.weight"] = _kernel(params["predict"]["kernel"])
    sd["predict.linear.bias"] = torch.from_numpy(
        np.array(params["predict"]["bias"])
    )
    return sd
