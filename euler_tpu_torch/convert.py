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


def _att_head(tree, prefix: str) -> dict:
    """A GAT attention head: the bias-free projection ``Dense_0``, the
    two width-1 gates ``Dense_1`` and ``Dense_2`` (flax ``nn.Dense``s,
    not wrapped) and the output ``bias``."""
    sd = {}
    for i, attr in enumerate(("fts", "f1", "f2")):
        sd.update(_linear(tree[f"Dense_{i}"], f"{prefix}.{attr}"))
    sd[f"{prefix}.bias"] = torch.from_numpy(np.array(tree["bias"]))
    return sd


def _encoder(enc, prefix: str) -> dict:
    """A SageEncoder, GCNEncoder or ScalableSageEncoder: ``{Cls}_{l}`` is
    layer l's aggregator, the port's ``aggregators.{l}``. An AttEncoder:
    ``_AttHead_{i}`` is the port's ``heads.{i}`` (the hidden round first,
    then the output round)."""
    sd = {}
    for key, tree in enc.items():
        head = re.fullmatch(r"_AttHead_(\d+)", key)
        if head:
            sd.update(_att_head(tree, f"{prefix}.heads.{head.group(1)}"))
            continue
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


def _array(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _shallow(enc, prefix: str) -> dict:
    """A ShallowEncoder: ``Embedding_0/embeddings`` is the id table as it
    stands ([num, dim] on both sides), ``SparseEmbedding_{k}`` slot k's
    table, ``Dense_0/Dense_0/kernel`` the features' Dense ("add") or the
    projection ("concat")."""
    sd = {}
    if "Embedding_0" in enc:
        sd[f"{prefix}.embedding.embeddings"] = _array(
            enc["Embedding_0"]["embeddings"])
    for key, tree in enc.items():
        m = re.fullmatch(r"SparseEmbedding_(\d+)", key)
        if m:
            sd[f"{prefix}.sparse_embeddings.{m.group(1)}.embeddings"] = (
                _array(tree["embeddings"]))
    if "Dense_0" in enc:
        sd[f"{prefix}.dense.linear.weight"] = _kernel(
            enc["Dense_0"]["Dense_0"]["kernel"])
    return sd


def _typed_dense(tree, prefix: str) -> dict:
    """An LsHNE ``TypedDense``: ``kernel [T, in, out]`` and ``bias [T,
    out]``, as they stand."""
    return {f"{prefix}.kernel": _array(tree["kernel"]),
            f"{prefix}.bias": _array(tree["bias"])}


def _sparse_models(params) -> dict:
    """The LsHNE and LasGNN trees, and a SparseSageEncoder's own:
    ``feature_embeddings_{k}``/``sparse_embeddings_{k}`` (the shared
    tables, once) become ``{name}.{k}.embeddings``; ``src_hidden_{v}``,
    ``src_out_{v}``, ``tar_hidden``, ``tar_out`` the TypedDenses;
    ``att_vec`` as it stands; ``towers_{g}_{m}/sage`` (or ``sage``) a
    SparseSageEncoder's SageEncoder; ``attentions_{g}/kernel`` a
    DotAttention's; ``target_ff`` and ``context_ff`` flax Denses."""
    sd = {}
    for key, tree in params.items():
        m = re.fullmatch(r"(feature_embeddings|sparse_embeddings)_(\d+)", key)
        if m:
            sd[f"{m.group(1)}.{m.group(2)}.embeddings"] = _array(
                tree["embeddings"])
        m = re.fullmatch(r"(src_hidden|src_out)_(\d+)", key)
        if m:
            sd.update(_typed_dense(tree, f"{m.group(1)}.{m.group(2)}"))
        if key in ("tar_hidden", "tar_out"):
            sd.update(_typed_dense(tree, key))
        if key == "att_vec":
            sd[key] = _array(tree)
        m = re.fullmatch(r"towers_(\d+)_(\d+)", key)
        if m:
            sd.update(_encoder(tree["sage"],
                               f"towers.{m.group(1)}.{m.group(2)}.sage"))
        if key == "sage":
            sd.update(_encoder(tree, "sage"))
        m = re.fullmatch(r"attentions_(\d+)", key)
        if m:
            sd[f"attentions.{m.group(1)}.kernel"] = _array(tree["kernel"])
        if key in ("target_ff", "context_ff"):
            sd.update(_linear(tree, key))
    return sd


def params_from_flax(params) -> dict:
    """State dict of a port module from the params tree of its flax
    counterpart (nested dicts of arrays): the SageEncoder, GCNEncoder,
    ScalableSageEncoder or AttEncoder towers ``encoder`` (and
    ``context_encoder`` of the unsupervised GraphSAGE), the classifier
    ``predict/{kernel,bias}``, the ShallowEncoders ``node_encoder`` (GCN,
    GraphSAGE, ScalableSage; ``context_node_encoder`` of the
    unsupervised GraphSAGE), ``target`` and ``context`` (LINE, Node2Vec),
    ScalableGCN's layers ``aggs_{l}``, and the trees of LsHNE, LasGNN and
    SparseSageEncoder (``_sparse_models``)."""
    sd = _sparse_models(params)
    for tower in ("encoder", "context_encoder"):
        if tower in params:
            sd.update(_encoder(params[tower], tower))
    for tower in ("node_encoder", "context_node_encoder", "target",
                  "context"):
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
    """Copy a JAX ScalableStoreModel state's (ScalableGCN, ScalableSage)
    ``stores`` and ``grad_stores`` (arrays of ``[max_id+2, dim]``, one a
    store, or padded to a mesh's model axis by ``pad_tables_for_mesh``)
    into a port state's, in place; a row-sharded port state
    (``parallel.mesh.RowShard``) takes its own rows of the padded
    arrays."""
    for name, arrays in (("stores", stores), ("grad_stores", grad_stores)):
        if len(arrays) != len(state[name]):
            raise ValueError(f"{name}: {len(arrays)} arrays for "
                             f"{len(state[name])} stores")
        with torch.no_grad():
            for t, a in zip(state[name], arrays):
                a = torch.from_numpy(np.array(a, np.float32))
                if hasattr(t, "load_full"):
                    t.load_full(a.to(t.device))
                else:
                    t.copy_(a)


def state_from_checkpoint_arrays(restored: dict, state: dict) -> dict:
    """Load a JAX ``Checkpointer.restore`` turned to numpy (its
    ``params`` tree and, for a ScalableStoreModel, its ``stores`` and
    ``grad_stores``) into a port training state of the same model, in
    place, and return it: the parameters strictly into the module
    (``params_from_flax``), the stores with ``load_stores``. The
    optimizer's moments stay as they are: evaluating a JAX-trained model
    or exporting its embeddings reads only the parameters."""
    state["module"].load_state_dict(params_from_flax(restored["params"]),
                                    strict=True)
    if "stores" in restored:
        load_stores(state, restored["stores"], restored["grad_stores"])
    return state
