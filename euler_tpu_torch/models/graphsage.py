"""GraphSAGE, supervised and unsupervised, and ScalableSage (counterpart
of ``euler_tpu/models/graphsage.py``).

Device-sampling mode is the main path: the batch is root ids and a seed,
the fanouts are drawn on the device (over slabs, the chained two-hop
kernel on CUDA and the single-hop kernel for the unsupervised model's
positives; over alias tables, the plain alias draw), and features and
labels are gathered from device tables. The modules also
take host-given node sets (``{"hops": ...}``, ``{"src_hops": ...,
"pos_hops": ..., "neg_hops": ...}``), so they can be held against the flax
modules without any sampling. ScalableSage draws one hop a step through
the single-hop kernel and reads deeper layers from the stores of
``models.base.ScalableStoreModel``; its module also takes host-given
``{"node_feats": ..., "neigh_feats": ..., "node_ids": ..., "neigh_ids":
...}`` batches. Every model here also samples on the host
(``device_sampling=False``): ``sample(graph, inputs)`` draws the fanouts
through the engine client and gathers the features (and labels) on the
host, or with ``device_features=True`` ships the nodes' table rows for
device gathers, as the JAX package's host path does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from torch import nn

from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn import metrics
from euler_tpu_torch.nn.encoders import (ScalableSageEncoder, SageEncoder,
                                         ShallowEncoder)
from euler_tpu_torch.nn.layers import Dense, Embedding


def _sampled_hops(consts, adj_keys, roots, fanouts, words, u,
                  use_id: bool = False):
    """The fanout of ``roots`` drawn on the device from the adjacencies
    (slabs or alias tables) ``consts["adj"][k]`` of ``adj_keys`` with the
    Philox stream ``words``
    (or the injected per-hop uniforms ``u``), as ``{"gids": ids}`` node
    sets, one a hop (and ``"ids"`` under ``use_id``)."""
    adjs = [consts["adj"][k] for k in adj_keys]
    ids = device_graph.sample_fanout(adjs, roots, fanouts, words, u=u)
    return [base.id_feats(i, use_id) for i in ids]


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
        sparse_feature_max_ids: Sequence[int] = (),
        max_id: int = -1,
        embedding_dim: int = 16,
        generator=None,
    ):
        super().__init__()
        self.fanouts = list(fanouts)
        self.sigmoid_loss = sigmoid_loss
        self.hop_adj_keys = list(hop_adj_keys)
        # use_id: an id embedding (max_id >= 0) beside the features
        self.use_id = max_id >= 0
        self.node_encoder = ShallowEncoder(
            feature_dim=feature_dim, max_id=max_id,
            embedding_dim=embedding_dim,
            sparse_feature_max_ids=sparse_feature_max_ids)
        self.encoder = SageEncoder(
            self.node_encoder.output_dim, fanouts, dim, aggregator, concat
        )
        self.predict = Dense(dim, num_classes)
        for m in self.modules():
            if isinstance(m, (Dense, Embedding)):
                m.reset_parameters(generator)

    def _hops(self, batch, consts):
        """Per-hop node sets: given (``"hops"``), or drawn here on the
        device from the adjacency slabs (``"roots"`` + ``"seed"``, and
        optionally injected per-hop uniforms ``"u"``)."""
        if "hops" in batch:
            return batch["hops"]
        return _sampled_hops(consts, self.hop_adj_keys, batch["roots"],
                             self.fanouts,
                             device_graph.seed_words(batch["seed"]),
                             batch.get("u"), self.use_id)

    def _embed_hops(self, hops, consts):
        hidden = [
            self.node_encoder(base.gather_consts(f, consts)) for f in hops
        ]
        return self.encoder(hidden)

    def embed(self, batch, consts=None):
        return self._embed_hops(self._hops(batch, consts), consts)

    def forward(self, batch, consts=None):
        hops = self._hops(batch, consts)
        embedding = self._embed_hops(hops, consts)
        logits = self.predict(embedding)
        labels = base.lookup_labels(batch, consts, hops[0].get("gids"))
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
    the JAX package's flagship configuration), or over host-sampled
    batches (``device_sampling=False``: fanouts from the engine client in
    ``sample``, features and labels from it too or, with
    ``device_features=True``, from the device tables). ``feature_dtype``
    ("bfloat16") narrows the feature table; ``set_sampling_options``
    chooses capped slabs or alias tables. Sparse slots
    (``sparse_feature_idx``, with their max ids) add one
    ``SparseEmbedding`` each to the node encoder, over padded device
    tables; ``use_id`` adds an id embedding of ``embedding_dim``."""

    metric_name = "f1"

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
        feature_dtype: Optional[str] = None,
        sparse_feature_idx: Sequence[int] = (),
        sparse_feature_max_ids: Sequence[int] = (),
        sparse_max_len: int = 16,
        use_id: bool = False,
        embedding_dim: int = 16,
    ):
        self.device_features, self.device_sampling = base.check_device_mode(
            "SupervisedGraphSage", device_features, device_sampling,
            feature_idx, max_id, metapath, fanouts,
            has_sparse=bool(sparse_feature_idx))
        self.default_node = max_id + 1 if max_id >= 0 else -1
        self.sparse_feature_idx = list(sparse_feature_idx)
        self.sparse_feature_max_ids = list(sparse_feature_max_ids)
        self.sparse_max_len = sparse_max_len
        self.feature_dtype = feature_dtype
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.metapath = [list(m) for m in metapath]
        self.fanouts = list(fanouts)
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.max_id = max_id
        self.train_node_type = train_node_type
        self.use_id = use_id
        self._module_kwargs = dict(
            fanouts=tuple(fanouts),
            dim=dim,
            num_classes=num_classes or label_dim,
            feature_dim=feature_dim if feature_idx >= 0 else 0,
            aggregator=aggregator,
            concat=concat,
            sigmoid_loss=sigmoid_loss,
            hop_adj_keys=tuple(self.adj_key(m) for m in self.metapath),
            sparse_feature_max_ids=tuple(sparse_feature_max_ids),
            max_id=max_id if use_id else -1,
            embedding_dim=embedding_dim,
        )

    def make_module(self, generator=None) -> _SupervisedSageModule:
        return _SupervisedSageModule(**self._module_kwargs,
                                     generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        return self.add_sampling_consts(
            consts, graph, self.metapath, device,
            roots_type=self.train_node_type,
        )

    def sample(self, graph, inputs) -> dict:
        """Host mode: the fanout of ``inputs`` through the engine's
        ``sample_fanout`` (unknown or unsampleable picks are
        ``default_node``), each hop's inputs and, with host features, the
        roots' labels gathered from ``graph``."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        inputs = np.asarray(inputs, dtype=np.int64).reshape(-1)
        ids_per_hop, _, _ = graph.sample_fanout(
            inputs, self.metapath, self.fanouts, self.default_node)
        return self._batch_from_hops(graph, inputs, ids_per_hop)

    def _batch_from_hops(self, graph, inputs, ids_per_hop) -> dict:
        hops = [self.host_node_inputs(graph, ids) for ids in ids_per_hop]
        if self.device_features:  # labels read from the device table
            return {"hops": hops}
        return {"hops": hops, "labels": graph.get_dense_feature(
            inputs, [self.label_idx], [self.label_dim])}

    def sample_start(self, graph, inputs):
        """The non-blocking half of ``sample`` (``train``'s
        ``sampler_depth`` pipeline): the whole fanout submitted as one
        async op of a remote graph, whose hop chain runs on the client's
        dispatcher pool. A graph without the async path (local, or its
        pool of async ops full) samples in full here."""
        if self.device_sampling:
            return self.sample(graph, inputs)
        inputs = np.asarray(inputs, dtype=np.int64).reshape(-1)
        submit = getattr(graph, "sample_fanout_async", None)
        handle = (submit(inputs, self.metapath, self.fanouts,
                         self.default_node) if submit is not None else None)
        if handle is None:
            return self.sample(graph, inputs)
        return (inputs, handle)

    def sample_finish(self, graph, pending) -> dict:
        if not (isinstance(pending, tuple) and len(pending) == 2
                and hasattr(pending[1], "take")):
            return pending  # sample_start built the batch already
        inputs, handle = pending
        ids_per_hop, _, _ = handle.take()
        return self._batch_from_hops(graph, inputs, ids_per_hop)


class _ScalableSageModule(nn.Module):
    """ScalableSage's forward over one expanded batch: the roots' rows and
    their 1-hop fanout's through the node encoder, then
    ``ScalableSageEncoder`` with the store reads."""

    def __init__(
        self,
        fanout: int,
        num_layers: int,
        dim: int,
        num_classes: int,
        feature_dim: int,
        aggregator: str = "mean",
        concat: bool = False,
        sigmoid_loss: bool = True,
        max_id: int = -1,
        embedding_dim: int = 16,
        generator=None,
    ):
        super().__init__()
        self.sigmoid_loss = sigmoid_loss
        self.node_encoder = ShallowEncoder(feature_dim=feature_dim,
                                           max_id=max_id,
                                           embedding_dim=embedding_dim)
        self.encoder = ScalableSageEncoder(self.node_encoder.output_dim,
                                           fanout, num_layers, dim,
                                           aggregator, concat)
        self.predict = Dense(dim, num_classes)
        for m in self.modules():
            if isinstance(m, (Dense, Embedding)):
                m.reset_parameters(generator)

    def forward_train(self, batch, store_reads, consts=None):
        """(loss, f1 counts, every layer's node embeddings, the last)."""
        node_feat = self.node_encoder(
            base.gather_consts(batch["node_feats"], consts))
        neigh_feat = self.node_encoder(
            base.gather_consts(batch["neigh_feats"], consts))
        emb, node_embeddings = self.encoder(node_feat, neigh_feat,
                                            store_reads)
        logits = self.predict(emb)
        labels = base.lookup_labels(batch, consts, batch["node_ids"])
        loss, predictions = base.supervised_decoder(logits, labels,
                                                    self.sigmoid_loss)
        return (loss, metrics.f1_counts(labels, predictions),
                node_embeddings, emb)

    def forward(self, batch, store_reads, consts=None):
        loss, f1c, _, emb = self.forward_train(batch, store_reads, consts)
        return base.ModelOutput(embedding=emb, loss=loss, metric_name="f1",
                                metric=f1c)


class ScalableSage(base.ScalableStoreModel):
    """ScalableSage: GraphSAGE whose receptive field is one sampled hop a
    step. ``fanout`` neighbors of each root are drawn on the device (the
    single-hop kernel on CUDA slabs); layer l > 0 reads the neighbors'
    stale layer l-1 embeddings from the stores. Roots of
    ``train_node_type`` are drawn on the device, so
    ``train.make_scan_train`` drives it; on the host (``device_sampling
    =False``) the engine draws the hop in ``sample``. Evaluation uses the
    same one hop plus stale stores as training."""

    metric_name = "f1"

    def __init__(
        self,
        label_idx: int,
        label_dim: int,
        edge_type: Sequence[int],
        fanout: int,
        num_layers: int,
        dim: int,
        max_id: int,
        aggregator: str = "mean",
        concat: bool = False,
        feature_idx: int = -1,
        feature_dim: int = 0,
        use_id: bool = False,
        embedding_dim: int = 16,
        store_learning_rate: float = 0.001,
        store_init_maxval: float = 0.05,
        num_classes: Optional[int] = None,
        sigmoid_loss: bool = True,
        device_features: bool = False,
        feature_dtype: Optional[str] = None,
        device_sampling: bool = False,
        train_node_type: int = -1,
    ):
        self.device_features, self.device_sampling = base.check_device_mode(
            "ScalableSage", device_features, device_sampling, feature_idx,
            max_id)
        self.feature_dtype = feature_dtype
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.edge_type = list(edge_type)
        self.fanout = fanout
        self.num_layers = num_layers
        self.dim = dim
        self.max_id = max_id
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.use_id = use_id
        self.store_learning_rate = store_learning_rate
        self.store_init_maxval = store_init_maxval
        self.train_node_type = train_node_type
        self._module_kwargs = dict(
            fanout=fanout,
            num_layers=num_layers,
            dim=dim,
            num_classes=num_classes or label_dim,
            feature_dim=feature_dim,
            aggregator=aggregator,
            concat=concat,
            sigmoid_loss=sigmoid_loss,
            max_id=max_id if use_id else -1,
            embedding_dim=embedding_dim,
        )

    def make_module(self, generator=None) -> _ScalableSageModule:
        return _ScalableSageModule(**self._module_kwargs,
                                   generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        return self.add_sampling_consts(consts, graph, [self.edge_type],
                                        device,
                                        roots_type=self.train_node_type)

    def _expand_batch(self, batch, consts):
        """The device expansion: ``fanout`` neighbors of each root drawn
        from the ``edge_type`` adjacency with the step's Philox words
        (``batch["u"]``, [B, fanout], injects uniforms in their place)."""
        if "roots" not in batch:
            return batch
        roots = batch["roots"]
        neigh = device_graph.neighbor_draw(
            consts["adj"][self.adj_key(self.edge_type)], roots, self.fanout,
            device_graph.seed_words(batch["seed"]), u=batch.get("u"),
        ).reshape(-1)
        return {
            "node_feats": base.id_feats(roots, self.use_id),
            "neigh_feats": base.id_feats(neigh, self.use_id),
            "node_ids": roots,
            "neigh_ids": neigh,
        }

    def sample(self, graph, inputs) -> dict:
        """Host mode: ``fanout`` neighbors of each root through the
        engine's ``sample_fanout`` (unknown or unsampleable picks are the
        default row max_id+1), both node sets' inputs, their store rows
        (ids clipped into the stores) and, with host features, the roots'
        labels."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        ids_per_hop, _, _ = graph.sample_fanout(
            roots, [self.edge_type], [self.fanout], self.max_id + 1)
        neigh = ids_per_hop[1]
        batch = {
            "node_feats": self.host_node_inputs(graph, roots),
            "neigh_feats": self.host_node_inputs(graph, neigh),
            "node_ids": np.clip(roots, 0, self.max_id + 1),
            "neigh_ids": np.clip(neigh, 0, self.max_id + 1),
        }
        if not self.device_features:
            batch["labels"] = graph.get_dense_feature(
                roots, [self.label_idx], [self.label_dim])
        return batch


# The Philox streams of one unsupervised step, in the order of the JAX
# module's split(PRNGKey(seed), 5): stream i is device.stream_words(seed, i)
UNSUP_STREAMS = ("pos", "neg", "src_hops", "pos_hops", "neg_hops")


class _UnsupervisedSageModule(nn.Module):
    """Target and context towers (ShallowEncoder, SageEncoder) over the
    same input layout, and the negative-sampling decoder."""

    def __init__(
        self,
        fanouts: Sequence[int],
        dim: int,
        feature_dim: int,
        aggregator: str = "mean",
        concat: bool = False,
        xent_loss: bool = False,
        hop_adj_keys: Sequence[str] = (),
        pos_adj_key: str = "",
        num_negs: int = 5,
        max_id: int = -1,
        embedding_dim: int = 16,
        shared_negs: bool = False,
        generator=None,
    ):
        super().__init__()
        self.fanouts = list(fanouts)
        self.xent_loss = xent_loss
        self.hop_adj_keys = list(hop_adj_keys)
        self.pos_adj_key = pos_adj_key
        self.num_negs = num_negs
        self.shared_negs = shared_negs
        self.use_id = max_id >= 0
        enc = dict(feature_dim=feature_dim, max_id=max_id,
                   embedding_dim=embedding_dim)
        self.node_encoder = ShallowEncoder(**enc)
        self.encoder = SageEncoder(
            self.node_encoder.output_dim, fanouts, dim, aggregator, concat
        )
        self.context_node_encoder = ShallowEncoder(**enc)
        self.context_encoder = SageEncoder(
            self.context_node_encoder.output_dim, fanouts, dim, aggregator,
            concat,
        )
        for m in self.modules():
            if isinstance(m, (Dense, Embedding)):
                m.reset_parameters(generator)

    def _encode(self, hops, context: bool, consts):
        node_encoder, encoder = (
            (self.context_node_encoder, self.context_encoder) if context
            else (self.node_encoder, self.encoder)
        )
        return encoder([node_encoder(base.gather_consts(f, consts))
                        for f in hops])

    def _all_hops(self, batch, consts):
        """(src_hops, pos_hops, neg_hops): given, or drawn here on the
        device from ``"roots"`` + ``"seed"``: the positives one draw from
        each root's neighbors (the single-hop kernel on CUDA), the
        negatives ``num_negs`` typed draws per root from
        ``consts["negs"]``, and the fanout of each set, each draw on its
        own Philox stream (``UNSUP_STREAMS``). ``batch["u"]``, a dict
        keyed by stream name, injects uniforms in place of a stream's:
        [B, 1] for ``"pos"``, (u1, u2) for ``"neg"``, one [rows, count]
        array per hop for the fanouts."""
        if "src_hops" in batch:
            return (batch["src_hops"], batch.get("pos_hops"),
                    batch.get("neg_hops"))
        roots = batch["roots"]
        words = {
            name: device_graph.stream_words(batch["seed"], i)
            for i, name in enumerate(UNSUP_STREAMS)
        }
        u = batch.get("u") or {}
        pos = device_graph.neighbor_draw(
            consts["adj"][self.pos_adj_key], roots, 1, words["pos"],
            u=u.get("pos"),
        ).reshape(-1)
        negs = device_graph.sample_node(
            consts["negs"], roots.shape[0] * self.num_negs,
            u=u.get("neg"), seed_words=words["neg"],
        )
        return tuple(
            _sampled_hops(consts, self.hop_adj_keys, ids, self.fanouts,
                          words[name], u.get(name), self.use_id)
            for name, ids in (("src_hops", roots), ("pos_hops", pos),
                              ("neg_hops", negs))
        )

    def embed(self, batch, consts=None):
        """Target-tower embeddings of the batch's roots."""
        src_hops, _, _ = self._all_hops(batch, consts)
        return self._encode(src_hops, False, consts)

    def forward(self, batch, consts=None):
        src_hops, pos_hops, neg_hops = self._all_hops(batch, consts)
        emb = self._encode(src_hops, False, consts)
        emb_pos = self._encode(pos_hops, True, consts)
        emb_negs = self._encode(neg_hops, True, consts)
        b, d = emb.shape
        if self.shared_negs:
            # every root against all of the batch's negatives
            loss, mrr = base.shared_negs_decoder(
                emb.reshape(b, 1, d), emb_pos.reshape(b, 1, d), emb_negs,
                self.xent_loss)
        else:
            loss, mrr = base.unsupervised_decoder(
                emb.reshape(b, 1, d), emb_pos.reshape(b, 1, d),
                emb_negs.reshape(b, -1, d), self.xent_loss,
            )
        return base.ModelOutput(
            embedding=emb, loss=loss, metric_name="mrr", metric=mrr
        )


class GraphSage(base.Model):
    """Unsupervised GraphSAGE over device-resident features and adjacency
    (``device_features=True, device_sampling=True``) or over host-sampled
    batches (``device_sampling=False``, features from the host or the
    device tables): positives are one neighbor of each root (edge
    types ``edge_type``), negatives are ``num_negs`` typed draws
    (``node_type``) per root; with ``shared_negs`` every root is scored
    against all of the batch's negatives (``base.shared_negs_decoder``),
    which the JAX package sets on its module. ``use_id`` adds an id
    embedding of ``embedding_dim`` to both towers."""

    metric_name = "mrr"
    batch_loss = "sum"

    def __init__(
        self,
        node_type: int,
        edge_type: Sequence[int],
        max_id: int,
        metapath: Sequence[Sequence[int]],
        fanouts: Sequence[int],
        dim: int,
        num_negs: int = 5,
        feature_idx: int = -1,
        feature_dim: int = 0,
        aggregator: str = "mean",
        concat: bool = False,
        xent_loss: bool = False,
        device_features: bool = False,
        device_sampling: bool = False,
        feature_dtype: Optional[str] = None,
        use_id: bool = False,
        embedding_dim: int = 16,
        shared_negs: bool = False,
    ):
        self.device_features, self.device_sampling = base.check_device_mode(
            "GraphSage", device_features, device_sampling, feature_idx,
            max_id, metapath, fanouts)
        self.default_node = max_id + 1
        self.feature_dtype = feature_dtype
        self.node_type = node_type
        self.edge_type = list(edge_type)
        self.metapath = [list(m) for m in metapath]
        self.fanouts = list(fanouts)
        self.num_negs = num_negs
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.max_id = max_id
        self.use_id = use_id
        self._module_kwargs = dict(
            fanouts=tuple(fanouts),
            dim=dim,
            feature_dim=feature_dim if feature_idx >= 0 else 0,
            aggregator=aggregator,
            concat=concat,
            xent_loss=xent_loss,
            hop_adj_keys=tuple(self.adj_key(m) for m in self.metapath),
            pos_adj_key=self.adj_key(self.edge_type),
            num_negs=num_negs,
            max_id=max_id if use_id else -1,
            embedding_dim=embedding_dim,
            shared_negs=shared_negs,
        )

    def make_module(self, generator=None) -> _UnsupervisedSageModule:
        return _UnsupervisedSageModule(**self._module_kwargs,
                                       generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        # typed negatives; the scan loop's roots share the same table
        return self.add_sampling_consts(
            consts, graph, self.metapath + [self.edge_type], device,
            negs_type=self.node_type, roots_type=self.node_type,
        )

    def _host_hops(self, graph, ids) -> list:
        ids_per_hop, _, _ = graph.sample_fanout(
            ids, self.metapath, self.fanouts, self.default_node)
        return [self.host_node_inputs(graph, hop) for hop in ids_per_hop]

    def sample(self, graph, inputs) -> dict:
        """Host mode: positives through the engine's ``sample_neighbor``,
        negatives through its ``sample_node``, and the fanout of each
        set, with their features, from ``graph``."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        inputs = np.asarray(inputs, dtype=np.int64).reshape(-1)
        pos, _, _ = graph.sample_neighbor(inputs, self.edge_type, 1,
                                          self.default_node)
        negs = graph.sample_node(len(inputs) * self.num_negs, self.node_type)
        return {
            "src_hops": self._host_hops(graph, inputs),
            "pos_hops": self._host_hops(graph, pos.reshape(-1)),
            "neg_hops": self._host_hops(graph, negs),
        }

    def sample_host_embed(self, graph, inputs) -> dict:
        inputs = np.asarray(inputs, dtype=np.int64).reshape(-1)
        return {"src_hops": self._host_hops(graph, inputs)}
