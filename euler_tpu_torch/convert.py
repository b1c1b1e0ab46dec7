"""Carry the JAX package's weights and store state across to the port."""

from __future__ import annotations

import re

import numpy as np
import torch


def _kernel(k) -> torch.Tensor:
    # flax kernels are [in, out]; nn.Linear weights are [out, in]
    return torch.from_numpy(np.array(np.asarray(k).T, order="C"))


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _linear(tree, prefix: str) -> dict:
    """A flax ``nn.Dense`` (``kernel``, optional ``bias``) as the port
    ``Dense`` at ``prefix``."""
    sd = {_join(prefix, "linear.weight"): _kernel(tree["kernel"])}
    if "bias" in tree:
        sd[_join(prefix, "linear.bias")] = torch.from_numpy(
            np.array(tree["bias"]))
    return sd


# the port attribute of each ``Dense_i`` (the JAX package's Dense, holding
# one flax ``Dense_0``) of an aggregator, by class name. flax names
# submodules in creation order: a pool aggregator's pooling Dense comes
# first, an attention head's shared projection before its two gates. The
# dense and the sparse aggregators of one name have the same tree.
_AGG_DENSES = {
    "GCNAggregator": ("dense",),
    "MeanAggregator": ("self_dense", "neigh_dense"),
    "MeanPoolAggregator": ("pool_dense", "self_dense", "neigh_dense"),
    "MaxPoolAggregator": ("pool_dense", "self_dense", "neigh_dense"),
    "SingleAttentionAggregator": ("dense", "self_gate", "all_gate"),
}


def _aggregator(cls: str, tree, prefix: str = "") -> dict:
    """An aggregator of flax class ``cls`` as the port's at ``prefix``;
    ``AttentionAggregator``'s heads ``SingleAttentionAggregator_{h}``
    become ``heads.{h}``."""
    sd = {}
    if cls == "AttentionAggregator":
        for key, head in tree.items():
            h = key.rsplit("_", 1)[1]
            sd.update(_aggregator("SingleAttentionAggregator", head,
                                  _join(prefix, f"heads.{h}")))
        return sd
    for i, attr in enumerate(_AGG_DENSES[cls]):
        sd.update(_linear(tree[f"Dense_{i}"]["Dense_0"],
                          _join(prefix, attr)))
    return sd


def _encoder(enc, prefix: str) -> dict:
    """A SageEncoder or GCNEncoder: ``{Cls}_{l}`` is layer l's
    aggregator, the port's ``aggregators.{l}``."""
    sd = {}
    for key, tree in enc.items():
        cls, layer = re.fullmatch(r"(\w+Aggregator)_(\d+)", key).groups()
        sd.update(_aggregator(cls, tree, f"{prefix}.aggregators.{layer}"))
    return sd


def _scalable_aggregator_class(tree) -> str:
    """The class of a ScalableGCN layer ``aggs_{l}`` (named for its
    attribute, not its class), from its tree: attention heads, two
    Denses (mean) or one (gcn)."""
    if "SingleAttentionAggregator_0" in tree:
        return "AttentionAggregator"
    return "MeanAggregator" if "Dense_1" in tree else "GCNAggregator"


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
    counterpart (nested dicts of arrays): the SageEncoder or GCNEncoder
    towers ``encoder`` (and ``context_encoder`` of the unsupervised
    GraphSAGE), the classifier ``predict/{kernel,bias}``, the
    ShallowEncoders ``node_encoder`` (GCN), ``target`` and ``context``
    (LINE, Node2Vec), and ScalableGCN's layers ``aggs_{l}``."""
    sd = {}
    for tower in ("encoder", "context_encoder"):
        if tower in params:
            sd.update(_encoder(params[tower], tower))
    for tower in ("node_encoder", "target", "context"):
        if tower in params:
            sd.update(_shallow(params[tower], tower))
    for key, tree in params.items():
        m = re.fullmatch(r"aggs_(\d+)", key)
        if m:
            sd.update(_aggregator(_scalable_aggregator_class(tree), tree,
                                  f"aggs.{m.group(1)}"))
    if "predict" in params:
        sd.update(_linear(params["predict"], "predict"))
    return sd


def load_stores(state: dict, stores, grad_stores) -> None:
    """Copy a JAX ScalableStoreModel state's ``stores`` and
    ``grad_stores`` (arrays of ``[max_id+2, dim]``, one a store) into a
    port state's, in place."""
    for name, arrays in (("stores", stores), ("grad_stores", grad_stores)):
        if len(arrays) != len(state[name]):
            raise ValueError(f"{name}: {len(arrays)} arrays for "
                             f"{len(state[name])} stores")
        with torch.no_grad():
            for t, a in zip(state[name], arrays):
                t.copy_(torch.from_numpy(np.array(a, np.float32)))
