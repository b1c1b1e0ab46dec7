"""Carry the JAX package's weights across to the port."""

from __future__ import annotations

import numpy as np
import torch


def _kernel(k) -> torch.Tensor:
    # flax kernels are [in, out]; nn.Linear weights are [out, in]
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).T))


def _encoder(enc, prefix: str) -> dict:
    """``encoder/MeanAggregator_{l}/Dense_0/Dense_0/kernel`` is layer l's
    self Dense, ``.../Dense_1/Dense_0/kernel`` its neighbor Dense."""
    sd = {}
    layer = 0
    while f"MeanAggregator_{layer}" in enc:
        agg = enc[f"MeanAggregator_{layer}"]
        p = f"{prefix}.aggregators.{layer}"
        sd[f"{p}.self_dense.linear.weight"] = _kernel(
            agg["Dense_0"]["Dense_0"]["kernel"]
        )
        sd[f"{p}.neigh_dense.linear.weight"] = _kernel(
            agg["Dense_1"]["Dense_0"]["kernel"]
        )
        layer += 1
    return sd


def _shallow(enc, prefix: str) -> dict:
    """A ShallowEncoder: ``Embedding_0/embeddings`` is the id table as it
    stands ([num, dim] on both sides), ``Dense_0/Dense_0/kernel`` the
    features' Dense ("add") or the projection ("concat")."""
    sd = {}
    if "Embedding_0" in enc:
        sd[f"{prefix}.embedding.embeddings"] = torch.from_numpy(
            np.array(enc["Embedding_0"]["embeddings"]))
    if "Dense_0" in enc:
        sd[f"{prefix}.dense.linear.weight"] = _kernel(
            enc["Dense_0"]["Dense_0"]["kernel"])
    return sd


def params_from_flax(params) -> dict:
    """State dict of a port module from the params tree of its flax
    counterpart (nested dicts of arrays): the SageEncoder towers
    ``encoder`` (and ``context_encoder`` of the unsupervised module), for
    the supervised module the classifier ``predict/{kernel,bias}``, and
    for LINE and Node2Vec the ShallowEncoders ``target`` (and
    ``context``)."""
    sd = {}
    for tower in ("encoder", "context_encoder"):
        if tower in params:
            sd.update(_encoder(params[tower], tower))
    for tower in ("target", "context"):
        if tower in params:
            sd.update(_shallow(params[tower], tower))
    if "predict" in params:
        sd["predict.linear.weight"] = _kernel(params["predict"]["kernel"])
        sd["predict.linear.bias"] = torch.from_numpy(
            np.array(params["predict"]["bias"])
        )
    return sd
