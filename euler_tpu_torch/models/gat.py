"""GAT, supervised (counterpart of ``euler_tpu/models/gat.py``).

Device-sampling mode: the batch is root ids and a seed; ``nb_num``
neighbors of each root are drawn on the device (the single-hop kernel on
CUDA slabs), and the [B, nb_num + 1, F] sequence of the root and its
neighbors is gathered from the device feature table and run through
``nn.encoders.AttEncoder``, whose output is the logits. The module also
takes host-given ``{"seq_ids": ...}`` batches, so it can be held against
the flax module. On the host (``device_sampling=False``) ``sample``
draws the neighbors through the engine client and ships either the
sequence's ids (``{"seq_ids": ...}``, features on the device) or its
host-gathered features and labels (``{"seq": [B, nb_num + 1, F],
"labels": ...}``), as the JAX package's host path does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn import metrics
from euler_tpu_torch.nn.encoders import AttEncoder
from euler_tpu_torch.nn.layers import Dense


class _GATModule(nn.Module):
    def __init__(
        self,
        head_num: int,
        hidden_dim: int,
        num_classes: int,
        feature_dim: int,
        sigmoid_loss: bool = True,
        nb_num: int = 5,
        adj_key: str = "",
        generator=None,
    ):
        super().__init__()
        self.sigmoid_loss = sigmoid_loss
        self.nb_num = nb_num
        self.adj_key = adj_key
        self.encoder = AttEncoder(feature_dim, head_num, hidden_dim,
                                  num_classes)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def _seq_ids(self, batch, consts):
        """[B, nb_num + 1] int32: given (``"seq_ids"``), or each root
        followed by ``nb_num`` neighbors drawn here with the step's Philox
        words (``batch["u"]``, [B, nb_num], injects uniforms in their
        place)."""
        if "seq_ids" in batch:
            return batch["seq_ids"]
        roots = batch["roots"]
        nbrs = device_graph.neighbor_draw(
            consts["adj"][self.adj_key], roots, self.nb_num,
            device_graph.seed_words(batch["seed"]), u=batch.get("u"))
        return torch.cat([roots[:, None], nbrs], dim=1)

    def _logits(self, batch, consts, seq_ids):
        """The encoder over the host-gathered ``batch["seq"]``, or over
        the feature rows of ``seq_ids`` cast to float32 (a bfloat16 table
        narrows only the table and its gather)."""
        if "seq" in batch:
            return self.encoder(batch["seq"])
        seq = consts["features"].index_select(0, seq_ids.reshape(-1))
        return self.encoder(
            seq.reshape(*seq_ids.shape, -1).to(torch.float32))

    def embed(self, batch, consts=None):
        seq_ids = None if "seq" in batch else self._seq_ids(batch, consts)
        return self._logits(batch, consts, seq_ids)

    def forward(self, batch, consts=None):
        seq_ids = None if "seq" in batch else self._seq_ids(batch, consts)
        logits = self._logits(batch, consts, seq_ids)
        labels = base.lookup_labels(
            batch, consts, None if seq_ids is None else seq_ids[:, 0])
        loss, predictions = base.supervised_decoder(logits, labels,
                                                    self.sigmoid_loss)
        return base.ModelOutput(
            embedding=logits, loss=loss, metric_name="f1",
            metric=metrics.f1_counts(labels, predictions))


class GAT(base.Model):
    """GAT over device-resident features, labels and adjacency
    (``device_features=True, device_sampling=True``), or over
    host-sampled batches (``device_sampling=False``, the features on the
    host or in device tables): each root attends over itself and
    ``nb_num`` neighbors drawn from ``edge_type`` with ``head_num``
    heads. Roots of ``train_node_type`` are drawn on the device, so
    ``train.make_scan_train`` drives the device mode."""

    metric_name = "f1"

    def __init__(
        self,
        label_idx: int,
        label_dim: int,
        feature_idx: int,
        feature_dim: int,
        max_id: int = -1,
        head_num: int = 1,
        hidden_dim: int = 128,
        nb_num: int = 5,
        edge_type=0,
        num_classes: Optional[int] = None,
        sigmoid_loss: bool = True,
        device_features: bool = False,
        feature_dtype: Optional[str] = None,
        device_sampling: bool = False,
        train_node_type: int = -1,
    ):
        self.device_features, self.device_sampling = base.check_device_mode(
            "GAT", device_features, device_sampling, feature_idx, max_id)
        self.feature_dtype = feature_dtype
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.max_id = max_id
        self.nb_num = nb_num
        self.train_node_type = train_node_type
        self.edge_type = ([edge_type] if np.isscalar(edge_type)
                          else list(edge_type))
        self._module_kwargs = dict(
            head_num=head_num,
            hidden_dim=hidden_dim,
            num_classes=num_classes or label_dim,
            feature_dim=feature_dim,
            sigmoid_loss=sigmoid_loss,
            nb_num=nb_num,
            adj_key=self.adj_key(self.edge_type),
        )

    def make_module(self, generator=None) -> _GATModule:
        return _GATModule(**self._module_kwargs, generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        return self.add_sampling_consts(consts, graph, [self.edge_type],
                                        device,
                                        roots_type=self.train_node_type)

    def sample(self, graph, inputs) -> dict:
        """Host mode: ``nb_num`` neighbors of each root through the
        engine's ``sample_neighbor`` (unknown or unsampleable picks are the
        default row), then the [B, nb_num + 1] sequence's table rows
        (``"seq_ids"``, device features) or its features and the roots'
        labels gathered from ``graph``."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        b = len(roots)
        default = self.max_id + 1 if self.max_id >= 0 else -1
        nbrs, _, _ = graph.sample_neighbor(roots, self.edge_type,
                                           self.nb_num, default)
        if self.device_features:
            seq_ids = np.concatenate(
                [roots.reshape(b, 1), nbrs.reshape(b, self.nb_num)], axis=1)
            return {"seq_ids": np.clip(seq_ids, 0, self.max_id + 1)
                    .astype(np.int32)}
        node_feats = graph.get_dense_feature(
            roots, [self.feature_idx], [self.feature_dim]
        ).reshape(b, 1, self.feature_dim)
        nbr_feats = graph.get_dense_feature(
            nbrs.reshape(-1), [self.feature_idx], [self.feature_dim]
        ).reshape(b, self.nb_num, self.feature_dim)
        return {"seq": np.concatenate([node_feats, nbr_feats], axis=1),
                "labels": graph.get_dense_feature(
                    roots, [self.label_idx], [self.label_dim])}
