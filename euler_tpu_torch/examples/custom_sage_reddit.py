"""Build-your-own-GraphSAGE on (synthetic) Reddit from the primitive ops,
on the card (counterpart of ``examples/custom_sage_reddit.py``).

Reference equivalent: examples/gcn_sage_reddit.py — that example's point
is not the model (it re-implements mean-aggregator GraphSAGE) but the
EXTENSION API: a user model composed from the framework's primitives
(custom aggregator layer -> custom encoder -> custom model) rather than
the model zoo. The same recipe here, the PyTorch way: the model is a
(host sample phase, ``nn.Module``) pair —

  sample(graph, roots): ops.sample_fanout + graph.get_dense_feature
                        (numpy, runs in prefetch threads)
  _CustomSage(nn.Module): per-layer mean aggregation + softmax loss
                        (on the card)

``params_from_flax`` carries the JAX example's trained parameters across.

    python -m euler_tpu_torch.examples.custom_sage_reddit [--steps 2000]
        [--data_dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch import Graph, ops
from euler_tpu_torch.datasets import REDDIT, build_reddit
from euler_tpu_torch.examples.sage import fit
from euler_tpu_torch.models import base
from euler_tpu_torch.nn import metrics
from euler_tpu_torch.nn.layers import Dense


class MeanAggregator(nn.Module):
    """Neighbors-only mean aggregation (reference gcn_sage_reddit.py
    MeanAggregator: reduce_mean over the fanout axis, then dense)."""

    def __init__(self, in_dim: int, dim: int, use_activation: bool = True):
        super().__init__()
        self.dense = Dense(in_dim, dim, use_bias=False)
        self.use_activation = use_activation

    def forward(self, neigh):  # [batch, fanout, dim_in]
        out = self.dense(neigh.mean(1))
        return F.relu(out) if self.use_activation else out


class _CustomSage(nn.Module):
    """The reference example's SageEncoder + softmax decoder: layer L
    aggregates hop h+1 into hop h for every remaining hop, no self/concat
    path (unlike the zoo's SageEncoder)."""

    def __init__(self, fanouts, feature_dim: int, dim: int,
                 num_classes: int, generator=None):
        super().__init__()
        self.fanouts = tuple(fanouts)
        n = len(self.fanouts)
        self.aggs = nn.ModuleList(
            MeanAggregator(feature_dim if layer == 0 else dim, dim,
                           use_activation=layer < n - 1)
            for layer in range(n))
        self.predict = Dense(dim, num_classes)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def embed(self, batch, consts=None):
        hidden = batch["hops"]  # per-hop [n_h, feature_dim] features
        for layer, agg in enumerate(self.aggs):
            hidden = [
                agg(hidden[hop + 1].reshape(
                    hidden[hop].shape[0], self.fanouts[hop], -1))
                for hop in range(len(self.aggs) - layer)
            ]
        return hidden[0]

    def forward(self, batch, consts=None):
        embedding = self.embed(batch)
        logits = self.predict(embedding)
        labels = batch["labels"]
        loss = -(labels * F.log_softmax(logits, -1)).sum(-1).mean()
        preds = F.one_hot(logits.argmax(-1), logits.shape[-1])
        return base.ModelOutput(
            embedding=embedding,
            loss=loss,
            metric_name="f1",
            metric=metrics.f1_counts(labels, preds),
        )


class CustomSage(base.Model):
    metric_name = "f1"
    device_features = False
    device_sampling = False

    def __init__(self, fanouts, dim, feature_idx, feature_dim, label_idx,
                 label_dim, edge_type=(0,)):
        super().__init__()
        self.fanouts = tuple(fanouts)
        self.dim = dim
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.edge_types = [list(edge_type)] * len(fanouts)

    def make_module(self, generator=None) -> _CustomSage:
        return _CustomSage(self.fanouts, self.feature_dim, self.dim,
                           self.label_dim, generator)

    def sample(self, graph, inputs) -> dict:
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        ids_per_hop, _, _ = ops.sample_fanout(
            graph, roots, self.edge_types, list(self.fanouts)
        )
        hops = [
            graph.get_dense_feature(
                ids, [self.feature_idx], [self.feature_dim]
            )
            for ids in ids_per_hop
        ]
        labels = graph.get_dense_feature(
            roots, [self.label_idx], [self.label_dim]
        )
        return {"hops": hops, "labels": labels}


def params_from_flax(params) -> dict:
    """The JAX example's ``_CustomSage`` parameters (a flax tree of numpy
    arrays: ``MeanAggregator_<layer>/Dense_0/kernel``, ``Dense_0/kernel``
    and ``bias``) as a state dict of this ``_CustomSage``."""

    def weight(k):
        # flax kernels are [in, out]; nn.Linear weights are [out, in]
        return torch.from_numpy(np.array(np.asarray(k).T, order="C"))

    sd = {}
    for key, tree in params.items():
        if key.startswith("MeanAggregator_"):
            layer = key.rsplit("_", 1)[1]
            sd[f"aggs.{layer}.dense.linear.weight"] = weight(
                tree["Dense_0"]["kernel"])
    sd["predict.linear.weight"] = weight(params["Dense_0"]["kernel"])
    sd["predict.linear.bias"] = torch.from_numpy(
        np.array(params["Dense_0"]["bias"]))
    return sd


def build_model(feature_dim: int = REDDIT["feature_dim"],
                label_dim: int = REDDIT["label_dim"]) -> CustomSage:
    """The example's model at Reddit's widths (or the given ones)."""
    return CustomSage(
        fanouts=[4, 4],
        dim=64,
        feature_idx=1,
        feature_dim=feature_dim,
        label_idx=0,
        label_dim=label_dim,
    )


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="/tmp/euler_tpu_reddit")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    build_reddit(args.data_dir)
    graph = Graph(directory=args.data_dir)
    try:
        _, history = fit(build_model(), graph, args.steps, args.batch_size,
                         0.03, args.device)
    finally:
        graph.close()
    print("final:", history[-1])
    return history


if __name__ == "__main__":
    main()
