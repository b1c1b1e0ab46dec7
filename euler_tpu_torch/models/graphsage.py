"""Supervised GraphSAGE (counterpart of ``euler_tpu/models/graphsage.py``).

Device-sampling mode is the main path: the batch is root ids and a seed,
the [f1, f2] fanout is drawn on the device (the chained two-hop kernel on
CUDA), and features and labels are gathered from device tables. The
module also takes a ``{"hops": [{"gids": ...}, ...]}`` batch, so it can be
held against the flax module without any sampling. Host-sampling mode
needs the engine client, which is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn import metrics
from euler_tpu_torch.nn.encoders import SageEncoder, ShallowEncoder
from euler_tpu_torch.nn.layers import Dense


class _SupervisedSageModule(nn.Module):
    def __init__(
        self,
        fanouts: Sequence[int],
        dim: int,
        num_classes: int,
        feature_dim: int,
        aggregator: str = "mean",
        concat: bool = False,
        sigmoid_loss: bool = True,
        hop_adj_keys: Sequence[str] = (),
        generator=None,
    ):
        super().__init__()
        self.fanouts = list(fanouts)
        self.sigmoid_loss = sigmoid_loss
        self.hop_adj_keys = list(hop_adj_keys)
        self.node_encoder = ShallowEncoder(feature_dim)
        self.encoder = SageEncoder(
            self.node_encoder.output_dim, fanouts, dim, aggregator, concat
        )
        self.predict = Dense(dim, num_classes)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def _hops(self, batch, consts):
        """Per-hop node sets: given (``"hops"``), or drawn here on the
        device from the adjacency slabs (``"roots"`` + ``"seed"``, and
        optionally injected per-hop uniforms ``"u"``)."""
        if "hops" in batch:
            return batch["hops"]
        adjs = [consts["adj"][k] for k in self.hop_adj_keys]
        ids = device_graph.sample_fanout(
            adjs, batch["roots"], self.fanouts,
            device_graph.seed_words(batch["seed"]), u=batch.get("u"),
        )
        return [{"gids": i} for i in ids]

    def _embed_hops(self, hops, consts):
        hidden = [
            self.node_encoder(base.gather_consts(f, consts)) for f in hops
        ]
        return self.encoder(hidden)

    def forward(self, batch, consts=None):
        hops = self._hops(batch, consts)
        embedding = self._embed_hops(hops, consts)
        logits = self.predict(embedding)
        labels = base.lookup_labels(consts, hops[0]["gids"])
        loss, predictions = base.supervised_decoder(
            logits, labels, self.sigmoid_loss
        )
        return base.ModelOutput(
            embedding=embedding,
            loss=loss,
            metric_name="f1",
            metric=metrics.f1_counts(labels, predictions),
        )


class SupervisedGraphSage(base.Model):
    """Supervised node classification over device-resident features,
    labels and adjacency (``device_features=True, device_sampling=True``,
    the JAX package's flagship configuration)."""

    def __init__(
        self,
        label_idx: int,
        label_dim: int,
        metapath: Sequence[Sequence[int]],
        fanouts: Sequence[int],
        dim: int,
        feature_idx: int = -1,
        feature_dim: int = 0,
        aggregator: str = "mean",
        concat: bool = False,
        max_id: int = -1,
        num_classes: Optional[int] = None,
        sigmoid_loss: bool = True,
        device_features: bool = False,
        device_sampling: bool = False,
        train_node_type: int = -1,
    ):
        if not (device_features and device_sampling):
            raise NotImplementedError(
                "euler_tpu_torch runs SupervisedGraphSage with "
                "device_features=True and device_sampling=True; host "
                "sampling needs the graph engine client, not ported yet"
            )
        if feature_idx < 0 or max_id < 0:
            raise ValueError(
                "device features need feature_idx >= 0 and max_id >= 0 (the "
                "feature/label tables are sized max_id+2)"
            )
        if len(metapath) != len(fanouts):
            raise ValueError("metapath needs one edge-type set per fanout")
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.metapath = [list(m) for m in metapath]
        self.fanouts = list(fanouts)
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.max_id = max_id
        self.train_node_type = train_node_type
        self._module_kwargs = dict(
            fanouts=tuple(fanouts),
            dim=dim,
            num_classes=num_classes or label_dim,
            feature_dim=feature_dim,
            aggregator=aggregator,
            concat=concat,
            sigmoid_loss=sigmoid_loss,
            hop_adj_keys=tuple(self.adj_key(m) for m in self.metapath),
        )

    def make_module(self, generator=None) -> _SupervisedSageModule:
        return _SupervisedSageModule(**self._module_kwargs,
                                     generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        return self.add_sampling_consts(
            consts, graph, self.metapath, device,
            roots_type=self.train_node_type,
        )
