"""LasGNN: multi-metapath SparseSage towers with dot attention and a
cosine logit (counterpart of ``euler_tpu/models/lasgnn.py``).

A batch is a label and node-id groups: group 0 the target (one node a
row), the others its context. Each group is encoded by one
``SparseSageEncoder`` a metapath, every tower looking up one shared set of
sparse embeddings; the metapath embeddings are combined by dot-product
attention, and the target's and context's cosine, times 5, feeds a
sigmoid loss with streaming AUC.

In device-sampling mode the batch carries the labels, the
group ids and a seed, and each (group, metapath) fanout is drawn on the
device (``device.sample_fanout``: a two-hop fanout over two slabs is one
launch of the chained kernel on CUDA tensors, even when the hops read
different edge types and so slabs of different widths). Each fanout
takes a Philox stream of its own, ``(g << 8) | m``, as the JAX module
keys it with ``fold_in``. The module also takes host-given groups
(``{"groups": ...}``), so it can be held against the flax module without
any sampling. On the host (``device_sampling=False``) ``sample`` builds
those groups through the engine client: one ``sample_fanout`` a (group,
metapath) and each hop's padded sparse rows gathered on the host.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn import metrics
from euler_tpu_torch.nn.encoders import SparseSageEncoder
from euler_tpu_torch.nn.layers import Dense, SparseEmbedding
from euler_tpu_torch.ops import feature as feature_ops


class DotAttention(nn.Module):
    """Dot-product attention over the second-to-last axis: ``kernel [M,
    dim]``; inputs [..., M, dim] -> [..., dim], weighted by the softmax of
    ``sum(inputs * kernel, -1)``. Init as flax's
    ``variance_scaling(0.36, "fan_in", "uniform")`` over the kernel's
    shape, so fan_in is M."""

    def __init__(self, num_values: int, dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_values, dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        limit = math.sqrt(3.0 * 0.36 / self.kernel.shape[0])
        with torch.no_grad():
            self.kernel.uniform_(-limit, limit, generator=generator)

    def forward(self, inputs):
        coef = torch.softmax((inputs * self.kernel).sum(-1), dim=-1)
        return (inputs * coef[..., None]).sum(-2)


class _LasGNNModule(nn.Module):
    """The shared sparse embeddings (``feature_dims[k] + 2`` rows of 16),
    one ``SparseSageEncoder`` a (group, metapath), one ``DotAttention`` a
    group, and the target and context Denses. ``group_adj_keys``: per
    group, per metapath, one ``consts["adj"]`` key a hop."""

    def __init__(self, metapath_counts: Sequence[int],
                 group_sizes: Sequence[int], fanouts: Sequence[int],
                 dim: int, feature_dims: Sequence[int],
                 aggregator: str = "mean", concat: bool = False,
                 group_adj_keys: Sequence = (), generator=None):
        super().__init__()
        self.group_sizes = list(group_sizes)
        self.fanouts = list(fanouts)
        self.group_adj_keys = [[list(m) for m in g] for g in group_adj_keys]
        # registered here once; every tower looks them up
        self.sparse_embeddings = nn.ModuleList(
            SparseEmbedding(d + 2, 16) for d in feature_dims)
        self.towers = nn.ModuleList(
            nn.ModuleList(
                SparseSageEncoder(fanouts, dim, aggregator=aggregator,
                                  concat=concat,
                                  shared_embeddings=self.sparse_embeddings)
                for _ in range(m))
            for m in metapath_counts)
        self.attentions = nn.ModuleList(
            DotAttention(m, dim) for m in metapath_counts)
        n_ctx = sum(self.group_sizes[1:])
        self.target_ff = Dense(self.group_sizes[0] * dim, dim)
        self.context_ff = Dense(n_ctx * dim, dim)
        for m in self.modules():
            if isinstance(m, (Dense, SparseEmbedding, DotAttention)):
                m.reset_parameters(generator)

    def _device_groups(self, batch, consts, only_target: bool = False):
        """Per group, per metapath, ``{"hops": [per-hop sparse rows]}``,
        the fanout of ``batch[f"group{g}"]`` drawn here on the Philox
        stream ``(g << 8) | m`` of ``batch["seed"]`` (or the injected
        per-hop uniforms ``batch["u"][(g, m)]``)."""
        u = batch.get("u") or {}
        groups = []
        n_groups = 1 if only_target else len(self.group_adj_keys)
        for g in range(n_groups):
            flat = batch[f"group{g}"].reshape(-1)
            per_metapath = []
            for m, hop_keys in enumerate(self.group_adj_keys[g]):
                ids = device_graph.sample_fanout(
                    [consts["adj"][k] for k in hop_keys], flat,
                    self.fanouts,
                    device_graph.stream_words(batch["seed"], (g << 8) | m),
                    u=u.get((g, m)))
                per_metapath.append(
                    {"hops": [base.sparse_rows(consts, h) for h in ids]})
            groups.append(per_metapath)
        return groups

    def _groups(self, batch, consts, only_target: bool = False):
        if "groups" in batch:
            return batch["groups"]
        return self._device_groups(batch, consts, only_target)

    def _group_embedding(self, groups, g: int):
        """[B, n_g * dim]: group g's metapath towers, combined by its
        attention and flattened. A hop is its sparse rows, or a host
        batch's ``{"sparse": rows}``."""
        n_g = self.group_sizes[g]
        embs = [tower([h["sparse"] if isinstance(h, dict) else h
                       for h in groups[g][m]["hops"]])
                for m, tower in enumerate(self.towers[g])]
        stack = torch.stack([e.reshape(-1, n_g, e.shape[-1]) for e in embs],
                            dim=-2)                        # [B, n_g, M, dim]
        combined = self.attentions[g](stack)                  # [B, n_g, dim]
        return combined.reshape(combined.shape[0], -1)

    def embed(self, batch, consts=None):
        """The target group's embedding alone (the context towers are not
        run, and the batch may hold only ``group0``)."""
        groups = self._groups(batch, consts, only_target=True)
        return self.target_ff(self._group_embedding(groups, 0))

    def forward(self, batch, consts=None):
        groups = self._groups(batch, consts)
        target = self.target_ff(self._group_embedding(groups, 0))
        context = self.context_ff(torch.cat(
            [self._group_embedding(groups, g)
             for g in range(1, len(self.towers))], dim=-1))
        tn = target / torch.sqrt((target * target).sum(-1, keepdim=True)
                                 + 1e-12)
        cn = context / torch.sqrt((context * context).sum(-1, keepdim=True)
                                  + 1e-12)
        logit = (tn * cn).sum(-1, keepdim=True) * 5.0
        label = batch["label"]
        loss = F.binary_cross_entropy_with_logits(logit, label)
        return base.ModelOutput(
            embedding=target, loss=loss, metric_name="auc",
            metric=metrics.auc_counts(label, torch.sigmoid(logit)))


class LasGNN(base.Model):
    """LasGNN, sampled on the device or on the host (``device_sampling``).
    Its inputs are structured, ``{"label": [B, 1], "groups": [[B, n_g] ids
    a group]}``, group 0 the target (n_0 = 1); ``device_sample_batch`` and
    ``sample`` take that dict. The JAX model builds no roots sampler, so
    batches come from the caller, through ``make_train_step`` or
    ``train.train``, not ``train.make_scan_train``."""

    metric_name = "auc"

    def __init__(
        self,
        metapaths_of_groups: Sequence[Sequence[Sequence[Sequence[int]]]],
        fanouts: Sequence[int],
        dim: int,
        feature_ixs: Sequence[int],
        feature_dims: Sequence[int],
        group_sizes: Sequence[int],
        max_id: int = -1,
        aggregator: str = "mean",
        concat: bool = False,
        sparse_max_len: int = 16,
        device_sampling: bool = False,
    ):
        if device_sampling and max_id < 0:
            raise ValueError(
                "device_sampling=True requires max_id >= 0 (the "
                "adjacency/feature tables are sized max_id+2)")
        self.metapaths_of_groups = [[[list(h) for h in m] for m in g]
                                    for g in metapaths_of_groups]
        self.fanouts = list(fanouts)
        self.feature_ixs = list(feature_ixs)
        self.feature_dims = list(feature_dims)
        self.group_sizes = list(group_sizes)
        self.max_id = max_id
        self.sparse_max_len = sparse_max_len
        # the device tables are the sampling mode's: a host batch carries
        # its sparse rows
        self.device_features = self.device_sampling = bool(device_sampling)
        # the seeds of sample_embed's draws, one a batch
        self._embed_seed = itertools.count(1)
        self._module_kwargs = dict(
            metapath_counts=tuple(len(m) for m in metapaths_of_groups),
            group_sizes=tuple(group_sizes), fanouts=tuple(fanouts), dim=dim,
            feature_dims=tuple(feature_dims), aggregator=aggregator,
            concat=concat,
            group_adj_keys=[[[self.adj_key(h) for h in m] for m in g]
                            for g in self.metapaths_of_groups])

    def make_module(self, generator=None) -> _LasGNNModule:
        return _LasGNNModule(**self._module_kwargs, generator=generator)

    def build_consts(self, graph, device) -> dict:
        """One slab a distinct hop edge-type set and the sparse tables
        (padding id ``feature_dims[k] + 1``)."""
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        hops = [h for g in self.metapaths_of_groups for m in g for h in m]
        self.add_sampling_consts(consts, graph, hops, device)
        consts["sparse"] = base.upload_sparse_tables(
            graph, self.max_id, self.feature_ixs, self.sparse_max_len,
            [d + 1 for d in self.feature_dims], device)
        return consts

    def _ids(self, ids, dev):
        """Group ids clipped into the tables' max_id+2 rows, int32 on
        ``dev``."""
        if isinstance(ids, torch.Tensor):
            return ids.to(dev).clamp(0, self.max_id + 1).to(torch.int32)
        ids = np.clip(np.asarray(ids, np.int64), 0, self.max_id + 1)
        return torch.as_tensor(ids.astype(np.int32), device=dev)

    def device_sample_batch(self, inputs, seed: int, device=None) -> dict:
        """The per-step payload from ``{"label", "groups"}`` (numpy arrays
        or tensors): ``label`` [B, 1] float32, ``group{g}`` ids clipped
        into the tables, and the integer seed of the step's fanouts."""
        dev = resolve_device(device)
        label = torch.as_tensor(inputs["label"], dtype=torch.float32,
                                device=dev).reshape(-1, 1)
        batch = {"label": label, "seed": int(seed)}
        for g, ids in enumerate(inputs["groups"]):
            batch[f"group{g}"] = self._ids(ids, dev)
        return batch

    def _hop_inputs(self, graph, ids) -> dict:
        """One hop's host inputs: each slot's padded sparse rows (padding
        id ``feature_dims[k] + 1``)."""
        return {"sparse": feature_ops.get_sparse_feature(
            graph, ids, self.feature_ixs, self.sparse_max_len,
            default_values=[d + 1 for d in self.feature_dims])}

    def _host_metapaths(self, graph, ids, metapaths) -> list:
        """``{"hops": [per-hop inputs]}`` of each metapath's
        ``sample_fanout`` from ``ids`` (the default row max_id+1 where a
        node has no pick)."""
        out = []
        for metapath in metapaths:
            ids_per_hop, _, _ = graph.sample_fanout(
                ids, metapath, self.fanouts, self.max_id + 1)
            out.append({"hops": [self._hop_inputs(graph, h)
                                 for h in ids_per_hop]})
        return out

    def sample(self, graph, inputs) -> dict:
        """The batch of ``{"label", "groups"}``: in device-sampling mode
        the clipped group ids and a fresh seed; on the host each (group,
        metapath)'s fanout through the engine, with its sparse rows."""
        if self.device_sampling:
            label = np.asarray(inputs["label"], np.float32).reshape(-1, 1)
            batch = {"label": label}
            for g, ids in enumerate(inputs["groups"]):
                batch[f"group{g}"] = np.clip(
                    np.asarray(ids, np.int64), 0, self.max_id + 1
                ).astype(np.int32)
            batch["seed"] = self._next_seed()
            return batch
        label = np.asarray(inputs["label"], dtype=np.float32).reshape(-1, 1)
        groups = [
            self._host_metapaths(
                graph, np.asarray(ids, dtype=np.int64).reshape(-1),
                metapaths)
            for ids, metapaths in zip(inputs["groups"],
                                      self.metapaths_of_groups)]
        return {"label": label, "groups": groups}

    def sample_host_embed(self, graph, inputs) -> dict:
        """The target group alone: no context is sampled for an
        export."""
        ids = np.asarray(inputs, dtype=np.int64).reshape(-1)
        return {"groups": [self._host_metapaths(
            graph, ids, self.metapaths_of_groups[0])]}

    def serving_layout(self, max_batch: int) -> base.ServingLayout:
        """Leaf by leaf: a block is one target's fanout, hop h
        ``prod(fanouts[:h])`` rows a metapath. A served row is one
        target, so the target group must be one id a row."""
        if self.group_sizes[0] != 1:
            raise ValueError(
                f"LasGNN serves one target id a row; its target group has "
                f"{self.group_sizes[0]} ids a row")
        return base.ServingLayout(max_batch)

    def device_embed_batch(self, ids, device=None) -> dict:
        """The batch that embeds ``ids`` as targets (``module.embed``),
        with a fresh fanout seed each call."""
        dev = resolve_device(device)
        return {"group0": self._ids(ids, dev).reshape(
                    -1, self.group_sizes[0]),
                "seed": next(self._embed_seed)}
