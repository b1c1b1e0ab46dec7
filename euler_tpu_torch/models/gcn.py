"""GCN models: the full-neighbor SupervisedGCN and ScalableGCN
(counterpart of ``euler_tpu/models/gcn.py``).

In device-sampling mode the batch is root ids (and a seed, unused:
nothing here draws). SupervisedGCN expands the roots' full neighborhoods
on the device, hop by hop with dedup, up to static node caps
(``graph.device.multi_hop_neighbor``); ScalableGCN takes each root's slab
row as its 1-hop neighborhood and reads deeper layers from stale stores
(``models.base.ScalableStoreModel``). Aggregation is the segment-op
aggregators of ``nn.sparse_aggregators``. No kernel of the port runs on
these paths: as in the JAX package, they are gathers, a sort, a cumsum
and segment sums. The modules also take host-given node sets and
adjacencies (``{"hops": ..., "adjs": ...}``; ``{"node_feats": ...,
"neigh_feats": ..., "node_ids": ..., "neigh_ids": ..., "adj": ...}``), so
they can be held against the flax modules. On the host
(``device_sampling=False``) ``sample(graph, inputs)`` builds those
layouts through the engine client (``ops.neighbor.get_multi_hop_neighbor``,
padded to the same caps, which raises where a hop outgrows its cap, as
the JAX host path does), with the features gathered on the host or, with
``device_features=True``, read from the device tables by ``"gids"``. A
server's per-id block (``sample_serve_block``) is that expansion at its
exact size, and ``serving_layout`` joins blocks with offsets into hop
arrays of fixed caps (``models.base.HopLayout``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn import metrics, sparse_aggregators
from euler_tpu_torch.nn.encoders import GCNEncoder, ShallowEncoder
from euler_tpu_torch.nn.layers import Dense, Embedding
from euler_tpu_torch.ops import neighbor as neighbor_ops


def _node_encoder(dim, use_residual, feature_dim, max_id, embedding_dim,
                  sparse_feature_max_ids=()):
    """The ShallowEncoder of both GCN modules: at ``dim`` with the "add"
    combiner under ``use_residual`` (the residual adds rows of equal
    width), else "concat" without a projection; one SparseEmbedding a
    sparse slot."""
    return ShallowEncoder(
        dim=dim if use_residual else None, feature_dim=feature_dim,
        max_id=max_id, embedding_dim=embedding_dim,
        sparse_feature_max_ids=sparse_feature_max_ids,
        combiner="add" if use_residual else "concat")


def _init(module, generator) -> None:
    for m in module.modules():
        if isinstance(m, (Dense, Embedding)):
            m.reset_parameters(generator)


class _SupervisedGCNModule(nn.Module):
    def __init__(
        self,
        num_layers: int,
        dim: int,
        num_classes: int,
        feature_dim: int,
        aggregator: str = "gcn",
        use_residual: bool = False,
        sigmoid_loss: bool = True,
        max_id: int = -1,
        embedding_dim: int = 16,
        hop_adj_keys: Sequence[str] = (),
        node_caps: Sequence[int] = (),
        sparse_feature_max_ids: Sequence[int] = (),
        generator=None,
    ):
        super().__init__()
        self.sigmoid_loss = sigmoid_loss
        self.use_id = max_id >= 0
        self.hop_adj_keys = list(hop_adj_keys)
        self.node_caps = list(node_caps)
        self.node_encoder = _node_encoder(dim, use_residual, feature_dim,
                                          max_id, embedding_dim,
                                          sparse_feature_max_ids)
        self.encoder = GCNEncoder(self.node_encoder.output_dim, num_layers,
                                  dim, aggregator, use_residual)
        self.predict = Dense(dim, num_classes)
        _init(self, generator)

    def _hops_adjs(self, batch, consts):
        """(hop feature dicts, adjacency dicts): given (``"hops"`` +
        ``"adjs"``), or expanded here on the device from the slabs in
        ``consts`` (``"roots"``)."""
        if "hops" in batch:
            return batch["hops"], batch["adjs"]
        adjs = [consts["adj"][k] for k in self.hop_adj_keys]
        hops = device_graph.multi_hop_neighbor(adjs, batch["roots"],
                                               self.node_caps)
        node_sets = [batch["roots"]] + [h["nodes"] for h in hops]
        return [base.id_feats(i, self.use_id) for i in node_sets], hops

    def _forward(self, batch, consts):
        hops, adjs = self._hops_adjs(batch, consts)
        hidden = [self.node_encoder(base.gather_consts(f, consts))
                  for f in hops]
        return self.encoder(hidden, adjs), hops

    def embed(self, batch, consts=None):
        return self._forward(batch, consts)[0]

    def forward(self, batch, consts=None):
        embedding, hops = self._forward(batch, consts)
        logits = self.predict(embedding)
        labels = base.lookup_labels(batch, consts, hops[0].get("gids"))
        loss, predictions = base.supervised_decoder(logits, labels,
                                                    self.sigmoid_loss)
        return base.ModelOutput(
            embedding=embedding, loss=loss, metric_name="f1",
            metric=metrics.f1_counts(labels, predictions))


class SupervisedGCN(base.Model):
    """Full-neighbor GCN over device-resident features, labels and slabs,
    or over host-expanded batches (``device_sampling=False``).
    ``max_nodes_per_hop`` are the static unique-node caps of both
    expansions (on the device a hop past its cap drops its largest ids;
    on the host it raises, as in the JAX package); ``max_edges_per_hop``
    are the host expansion's edge caps. ``max_degree`` caps the slab's
    width.

    The JAX model builds no roots sampler, so ``train.make_scan_train``
    drives neither it nor this one: roots come with each batch
    (``device_sample_batch``, or ``sample_node`` over a sampler the
    caller builds)."""

    metric_name = "f1"
    # the expansion walks the 2-D slab's rows
    alias_sampling_ok = False

    def __init__(
        self,
        label_idx: int,
        label_dim: int,
        metapath: Sequence[Sequence[int]],
        dim: int,
        max_nodes_per_hop: Sequence[int],
        max_edges_per_hop: Sequence[int],
        aggregator: str = "gcn",
        feature_idx: int = -1,
        feature_dim: int = 0,
        max_id: int = -1,
        use_id: bool = False,
        embedding_dim: int = 16,
        sparse_feature_idx: Sequence[int] = (),
        sparse_feature_max_ids: Sequence[int] = (),
        sparse_max_len: int = 16,
        use_residual: bool = False,
        num_classes: Optional[int] = None,
        sigmoid_loss: bool = True,
        device_features: bool = False,
        feature_dtype: Optional[str] = None,
        device_sampling: bool = False,
        max_degree: Optional[int] = None,
    ):
        self.device_features, self.device_sampling = base.check_device_mode(
            "SupervisedGCN", device_features, device_sampling, feature_idx,
            max_id)
        if len(max_nodes_per_hop) != len(metapath):
            raise ValueError("max_nodes_per_hop needs one cap a hop")
        self.feature_dtype = feature_dtype
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.metapath = [list(m) for m in metapath]
        self.max_nodes_per_hop = list(max_nodes_per_hop)
        self.max_edges_per_hop = list(max_edges_per_hop)
        self.max_degree = max_degree
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.max_id = max_id
        self.use_id = use_id
        self.sparse_feature_idx = list(sparse_feature_idx)
        self.sparse_feature_max_ids = list(sparse_feature_max_ids)
        self.sparse_max_len = sparse_max_len
        self._module_kwargs = dict(
            num_layers=len(self.metapath),
            dim=dim,
            num_classes=num_classes or label_dim,
            feature_dim=feature_dim if feature_idx >= 0 else 0,
            aggregator=aggregator,
            use_residual=use_residual,
            sigmoid_loss=sigmoid_loss,
            max_id=max_id if use_id else -1,
            embedding_dim=embedding_dim,
            hop_adj_keys=tuple(self.adj_key(m) for m in self.metapath),
            node_caps=tuple(self.max_nodes_per_hop),
            sparse_feature_max_ids=tuple(sparse_feature_max_ids),
        )

    def make_module(self, generator=None) -> _SupervisedGCNModule:
        return _SupervisedGCNModule(**self._module_kwargs,
                                    generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        return self.add_sampling_consts(consts, graph, self.metapath, device,
                                        max_degree=self.max_degree)

    def sample(self, graph, inputs) -> dict:
        """Host mode: the roots' full multi-hop neighborhoods through the
        engine (``get_multi_hop_neighbor`` padded to
        ``max_nodes_per_hop``/``max_edges_per_hop``; a hop past a cap
        raises), each node set's inputs, the hops' adjacencies and, with
        host features, the roots' labels."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        return self._host_batch(graph, inputs, exact=False)

    def sample_serve_block(self, graph, nid: int) -> dict:
        """One id's serving block: ``sample``'s layout at the expansion's
        exact size (padding a block to the caps of a whole training batch
        would cache hundreds of thousands of rows an id); a hop past its
        cap still raises. ``serving_layout`` pads once a bucket."""
        return self._host_batch(graph, [nid], exact=True)

    def _host_batch(self, graph, inputs, exact: bool) -> dict:
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        roots, hops = neighbor_ops.get_multi_hop_neighbor(
            graph, roots, self.metapath,
            max_nodes_per_hop=self.max_nodes_per_hop,
            max_edges_per_hop=self.max_edges_per_hop,
            default_node=self.max_id + 1 if self.max_id >= 0 else -1,
            exact=exact)
        batch = {
            "hops": [self.host_node_inputs(graph, roots)]
            + [self.host_node_inputs(graph, h.nodes) for h in hops],
            "adjs": [h.adj for h in hops],
        }
        if not self.device_features:
            batch["labels"] = graph.get_dense_feature(
                roots, [self.label_idx], [self.label_dim])
        return batch

    def serving_layout(self, max_batch: int) -> base.HopLayout:
        """Exact-size blocks joined with offsets (``base.HopLayout``): the
        roots' hop ``max_batch`` rows, hop k the model's own cap, each
        with a sink row; each hop's edges the model's edge cap. A bucket
        thus holds any one block, as a training batch would."""
        n = len(self.metapath)
        caps = {"node0": max_batch + 1}
        for h in range(n):
            caps[f"node{h + 1}"] = self.max_nodes_per_hop[h] + 1
            caps[f"edge{h}"] = self.max_edges_per_hop[h]
        indexes = {}
        for h in range(n):
            indexes[("adjs", h, "src")] = f"node{h}"
            indexes[("adjs", h, "dst")] = f"node{h + 1}"

        def space_of(path):
            if path[0] == "hops":
                return f"node{path[1]}"
            if path[0] == "adjs":
                return f"edge{path[1]}"
            return "node0"  # the roots' labels

        return base.HopLayout(max_batch, space_of, caps, indexes,
                              [f"edge{h}" for h in range(n)])


class _ScalableGCNModule(nn.Module):
    """ScalableGCN's forward over one expanded batch: the 1-hop adjacency
    for every layer, layer l+1's neighbor rows read from store l."""

    def __init__(
        self,
        num_layers: int,
        dim: int,
        num_classes: int,
        feature_dim: int,
        aggregator: str = "gcn",
        use_residual: bool = False,
        sigmoid_loss: bool = True,
        max_id: int = -1,
        embedding_dim: int = 16,
        generator=None,
    ):
        super().__init__()
        agg_cls = sparse_aggregators.get(aggregator)
        if agg_cls is None:
            raise ValueError(
                f"aggregator {aggregator!r} is not a sparse aggregator; "
                f"have {sorted(sparse_aggregators.AGGREGATORS)}")
        self.num_layers = num_layers
        self.use_residual = use_residual
        self.sigmoid_loss = sigmoid_loss
        self.node_encoder = _node_encoder(dim, use_residual, feature_dim,
                                          max_id, embedding_dim)
        in_dim = self.node_encoder.output_dim
        self.aggs = nn.ModuleList(
            agg_cls(in_dim if layer == 0 else dim, dim,
                    activation=torch.relu if layer < num_layers - 1
                    else None)
            for layer in range(num_layers))
        self.predict = Dense(dim, num_classes)
        _init(self, generator)

    def forward_train(self, batch, store_reads, consts=None):
        """(loss, f1 counts, every layer's node embeddings, the last)."""
        node_emb = self.node_encoder(
            base.gather_consts(batch["node_feats"], consts))
        neigh_emb = self.node_encoder(
            base.gather_consts(batch["neigh_feats"], consts))
        node_embeddings = []
        for layer, agg in enumerate(self.aggs):
            h = agg(node_emb, neigh_emb, batch["adj"])
            if self.use_residual:
                h = node_emb + h
            node_emb = h
            node_embeddings.append(node_emb)
            if layer < self.num_layers - 1:
                neigh_emb = store_reads[layer]
        logits = self.predict(node_emb)
        labels = base.lookup_labels(batch, consts, batch["node_ids"])
        loss, predictions = base.supervised_decoder(logits, labels,
                                                    self.sigmoid_loss)
        return (loss, metrics.f1_counts(labels, predictions),
                node_embeddings, node_emb)

    def forward(self, batch, store_reads, consts=None):
        loss, f1c, _, emb = self.forward_train(batch, store_reads, consts)
        return base.ModelOutput(embedding=emb, loss=loss, metric_name="f1",
                                metric=f1c)


class ScalableGCN(base.ScalableStoreModel):
    """ScalableGCN: each step takes only the roots' 1-hop neighborhoods
    (their slab rows, capped at ``max_neighbors`` wide); deeper layers
    read stale neighbor embeddings from the stores. Roots of
    ``train_node_type`` are drawn on the device, so
    ``train.make_scan_train`` drives it; on the host (``device_sampling
    =False``) ``sample`` expands each root's whole 1-hop neighborhood,
    deduplicated, through the engine. Evaluation uses the same 1-hop
    plus stale-store approximation as training."""

    metric_name = "f1"
    # the expansion gathers whole slab rows
    alias_sampling_ok = False

    def __init__(
        self,
        label_idx: int,
        label_dim: int,
        edge_type: Sequence[int],
        num_layers: int,
        dim: int,
        max_id: int,
        max_neighbors: int,
        max_edges: Optional[int] = None,
        aggregator: str = "gcn",
        feature_idx: int = -1,
        feature_dim: int = 0,
        use_id: bool = False,
        embedding_dim: int = 16,
        use_residual: bool = False,
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
            "ScalableGCN", device_features, device_sampling, feature_idx,
            max_id)
        if max_id < 0:
            raise ValueError("ScalableGCN needs max_id >= 0 (its tables "
                             "and stores are sized max_id+2)")
        self.feature_dtype = feature_dtype
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.edge_type = list(edge_type)
        self.num_layers = num_layers
        self.dim = dim
        self.max_id = max_id
        self.max_neighbors = max_neighbors
        # the host expansion's per-root edge cap (times the batch)
        self.max_edges = (max_edges if max_edges is not None
                          else max_neighbors * 4)
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.use_id = use_id
        self.store_learning_rate = store_learning_rate
        self.store_init_maxval = store_init_maxval
        self.train_node_type = train_node_type
        self._module_kwargs = dict(
            num_layers=num_layers,
            dim=dim,
            num_classes=num_classes or label_dim,
            feature_dim=feature_dim if feature_idx >= 0 else 0,
            aggregator=aggregator,
            use_residual=use_residual,
            sigmoid_loss=sigmoid_loss,
            max_id=max_id if use_id else -1,
            embedding_dim=embedding_dim,
        )

    def make_module(self, generator=None) -> _ScalableGCNModule:
        return _ScalableGCNModule(**self._module_kwargs,
                                  generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        # max_neighbors bounds the slab's width too: a hub must not widen
        # every batch to B x the graph's max degree
        return self.add_sampling_consts(
            consts, graph, [self.edge_type], device,
            roots_type=self.train_node_type, max_degree=self.max_neighbors)

    def _expand_batch(self, batch, consts):
        """The device expansion: each root's slab row is its 1-hop
        neighborhood, padded to W and masked by degree, with no dedup
        (``dst`` is ``arange(B*W)``; a neighbor in two rows is read
        twice, and its store gradients add)."""
        if "roots" not in batch:
            return batch
        slab = consts["adj"][self.adj_key(self.edge_type)]
        roots = batch["roots"]
        rows = roots.long()
        b, width = roots.shape[0], slab["nbr"].shape[1]
        dev = roots.device
        flat = slab["nbr"].index_select(0, rows).reshape(-1)
        mask = (torch.arange(width, dtype=torch.int32, device=dev)[None, :]
                < slab["deg"].index_select(0, rows)[:, None])
        return {
            "node_feats": base.id_feats(roots, self.use_id),
            "neigh_feats": base.id_feats(flat, self.use_id),
            "node_ids": roots,
            "neigh_ids": flat,
            "adj": {
                "src": torch.arange(b, dtype=torch.int32,
                                    device=dev).repeat_interleave(width),
                "dst": torch.arange(b * width, dtype=torch.int32,
                                    device=dev),
                "mask": mask.reshape(-1).to(torch.float32),
            },
        }

    def sample(self, graph, inputs) -> dict:
        """Host mode: the roots' full 1-hop neighborhood through the
        engine, deduplicated, padded to ``batch * max_neighbors`` nodes
        and ``batch * max_edges`` edges (past either it raises), both node
        sets' inputs, their store rows and, with host features, the roots'
        labels."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        return self._host_batch(graph, inputs, capped=True)

    def sample_serve_block(self, graph, nid: int) -> dict:
        """One id's serving block: ``sample``'s layout over the id's whole
        1-hop neighborhood at its exact size. ``sample`` at one root would
        cap it at ``max_neighbors`` nodes and raise past them (for some
        two ids in five of ppi's at ``max_neighbors`` 16); a bucket holds
        ``max_batch`` times that (``serving_layout``)."""
        return self._host_batch(graph, [nid], capped=False)

    def _host_batch(self, graph, inputs, capped: bool) -> dict:
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        b = len(roots)
        roots_out, hops = neighbor_ops.get_multi_hop_neighbor(
            graph, roots, [self.edge_type],
            max_nodes_per_hop=[b * self.max_neighbors] if capped else None,
            max_edges_per_hop=[b * self.max_edges] if capped else None,
            default_node=self.max_id + 1)
        hop = hops[0]
        batch = {
            "node_feats": self.host_node_inputs(graph, roots_out),
            "neigh_feats": self.host_node_inputs(graph, hop.nodes),
            "node_ids": np.clip(roots_out, 0, self.max_id + 1),
            "neigh_ids": np.clip(hop.nodes, 0, self.max_id + 1),
            "adj": hop.adj,
        }
        if not self.device_features:
            batch["labels"] = graph.get_dense_feature(
                roots, [self.label_idx], [self.label_dim])
        return batch

    def serving_layout(self, max_batch: int) -> base.HopLayout:
        """Exact-size blocks joined with offsets (``base.HopLayout``) at
        ``sample``'s caps for ``max_batch`` roots: ``max_batch`` roots,
        ``max_batch * max_neighbors`` neighbors (each with a sink row) and
        ``max_batch * max_edges`` edges."""
        def space_of(path):
            if path[0] == "adj":
                return "edge0"
            return "node1" if path[0] in ("neigh_feats", "neigh_ids") \
                else "node0"

        return base.HopLayout(
            max_batch, space_of,
            caps={"node0": max_batch + 1,
                  "node1": max_batch * self.max_neighbors + 1,
                  "edge0": max_batch * self.max_edges},
            indexes={("adj", "src"): "node0", ("adj", "dst"): "node1"},
            edge_spaces=["edge0"])
