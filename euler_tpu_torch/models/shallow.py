"""Shallow network-embedding models: LINE and Node2Vec (counterpart of
``euler_tpu/models/shallow.py``).

In device-sampling mode the batch is root ids and a seed.
LINE's positives are one neighbor draw per root (the single-hop kernel on
a slab held as CUDA tensors); Node2Vec walks on the device
(``device.random_walk``: one single-hop launch a step; the biased walks
``biased_random_walk`` over a sorted slab and ``alias_biased_random_walk``
over sorted alias tables, plain PyTorch) and cuts the walks into
skip-gram pairs with ``ops.walk.pair_indices``. Negatives are Philox node
draws. The modules also take host-given node sets (``{"src": ..., "pos":
..., "negs": ...}`` feature dicts), so they can be held against the flax
modules without any sampling. On the host (``device_sampling=False``)
``sample`` builds those node sets through the engine client: LINE's
positives one ``sample_neighbor`` draw a root, Node2Vec's the engine's
p/q ``random_walk`` cut into pairs by ``ops.walk.gen_pair``, the
negatives ``sample_node`` draws, as the JAX package's host path does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn.encoders import ShallowEncoder
from euler_tpu_torch.nn.layers import Dense, Embedding
from euler_tpu_torch.ops import walk as walk_ops

# The Philox streams of one step, in the order of the JAX module's
# split(PRNGKey(seed)): stream i is device.stream_words(seed, i)
SHALLOW_STREAMS = ("walk", "neg")


class _ShallowUnsupModule(nn.Module):
    """Target (and, unless ``share_context``, context) ShallowEncoders and
    the negative-sampling decoder. LINE when ``walk_len`` is 0, Node2Vec
    otherwise; p = q = 1 takes the plain walk, other p/q the biased walks
    over the id-sorted table ``adj_key`` names."""

    def __init__(
        self,
        dim: int,
        feature_dim: int = 0,
        max_id: int = -1,
        embedding_dim: int = 16,
        combiner: str = "add",
        xent_loss: bool = False,
        num_negs: int = 5,
        share_context: bool = False,
        adj_key: str = "",
        walk_len: int = 0,
        left_win: int = 0,
        right_win: int = 0,
        has_features: bool = False,
        walk_p: float = 1.0,
        walk_q: float = 1.0,
        walk_trials: int = 0,
        sparse_feature_max_ids: Sequence[int] = (),
        has_sparse: bool = False,
        generator=None,
    ):
        super().__init__()
        kw = dict(dim=dim, feature_dim=feature_dim, max_id=max_id,
                  embedding_dim=embedding_dim, combiner=combiner,
                  sparse_feature_max_ids=tuple(sparse_feature_max_ids))
        self.target = ShallowEncoder(**kw)
        self.context = None if share_context else ShallowEncoder(**kw)
        self.max_id = max_id
        self.xent_loss = xent_loss
        self.num_negs = num_negs
        self.adj_key = adj_key
        self.walk_len = walk_len
        self.has_features = has_features
        self.has_sparse = has_sparse
        self.walk_p = walk_p
        self.walk_q = walk_q
        self.walk_trials = walk_trials
        tgt, ctx = walk_ops.pair_indices(walk_len + 1, left_win, right_win)
        # the pair positions live beside the parameters, outside the
        # state dict, so a step indexes the walks without a host copy
        self.register_buffer("pair_tgt", torch.from_numpy(tgt).long(),
                             persistent=False)
        self.register_buffer("pair_ctx", torch.from_numpy(ctx).long(),
                             persistent=False)
        for m in self.modules():
            if isinstance(m, (Dense, Embedding)):
                m.reset_parameters(generator)

    def _context(self, feats):
        return (self.target if self.context is None else self.context)(feats)

    def _feats(self, ids) -> dict:
        f = {}
        if self.max_id >= 0:
            f["ids"] = ids
        if self.has_features or self.has_sparse:
            f["gids"] = ids
        return f

    def _walks(self, adj, roots, words, u):
        biased = self.walk_p != 1.0 or self.walk_q != 1.0
        if not biased:
            return device_graph.random_walk(adj, roots, self.walk_len, words,
                                            u=u)
        if not self.adj_key.endswith("_sorted"):
            raise ValueError(
                "biased walks (walk_p/walk_q != 1) need an id-sorted "
                "adjacency: build consts with add_sampling_consts("
                "sorted=True) and pass the matching adj_key(et, sorted=True)")
        if "off" in adj:
            return device_graph.alias_biased_random_walk(
                adj, roots, self.walk_len, self.walk_p, self.walk_q,
                trials=self.walk_trials or None, seed_words=words, u=u)
        return device_graph.biased_random_walk(
            adj, roots, self.walk_len, self.walk_p, self.walk_q, words, u=u)

    def _inputs(self, batch, consts):
        """(src, pos, negs) encoder inputs: given, or drawn here from
        ``"roots"`` + ``"seed"`` on the Philox streams of
        ``SHALLOW_STREAMS``. ``batch["u"]``, keyed by stream name,
        injects uniforms: for ``"walk"`` LINE's [B, 1] (or the alias pair)
        and Node2Vec's per-step list (as the walk functions take it), for
        ``"neg"`` the node sampler's (u1, u2)."""
        if "src" in batch:
            return batch["src"], batch.get("pos"), batch.get("negs")
        roots = batch["roots"]
        words = {name: device_graph.stream_words(batch["seed"], i)
                 for i, name in enumerate(SHALLOW_STREAMS)}
        u = batch.get("u") or {}
        adj = consts["adj"][self.adj_key]
        if self.walk_len > 0:
            paths = self._walks(adj, roots, words["walk"], u.get("walk"))
            src = paths[:, self.pair_tgt].reshape(-1)
            pos = paths[:, self.pair_ctx].reshape(-1)
        else:
            src = roots
            pos = device_graph.neighbor_draw(adj, roots, 1, words["walk"],
                                             u=u.get("walk")).reshape(-1)
        negs = device_graph.sample_node(
            consts["negs"], src.shape[0] * self.num_negs, u=u.get("neg"),
            seed_words=words["neg"])
        return self._feats(src), self._feats(pos), self._feats(negs)

    def embed(self, batch, consts=None):
        """Target-tower embeddings of the batch's source nodes."""
        src, _, _ = self._inputs(batch, consts)
        return self.target(base.gather_consts(src, consts))

    def forward(self, batch, consts=None):
        src, pos, negs = self._inputs(batch, consts)
        emb = self.target(base.gather_consts(src, consts))  # [B, d]
        emb_pos = self._context(base.gather_consts(pos, consts))
        emb_negs = self._context(base.gather_consts(negs, consts))
        b = emb.shape[0]
        loss, mrr = base.unsupervised_decoder(
            emb.reshape(b, 1, -1), emb_pos.reshape(b, 1, -1),
            emb_negs.reshape(b, self.num_negs, -1), self.xent_loss)
        return base.ModelOutput(embedding=emb, loss=loss, metric_name="mrr",
                                metric=mrr)


class _ShallowUnsupervised(base.Model):
    """Shared host plumbing of LINE and Node2Vec: in device-sampling mode
    the adjacency of ``edge_type`` (id-sorted when ``adj_sorted``), typed
    negatives and roots of ``node_type``, the id embedding (``use_id``),
    an optional device feature table and sparse slots
    (``sparse_feature_idx``, one ``SparseEmbedding`` each, over padded
    device tables or host gathers); on the host, the (src, pos, negs)
    node sets of ``sample``."""

    metric_name = "mrr"
    batch_loss = "sum"
    adj_sorted = False  # Node2Vec sets True for biased (p/q != 1) walks

    def __init__(
        self,
        node_type: int,
        max_id: int,
        feature_idx: int = -1,
        feature_dim: int = 0,
        use_id: bool = True,
        sparse_feature_idx: Sequence[int] = (),
        sparse_feature_max_ids: Sequence[int] = (),
        sparse_max_len: int = 16,
        num_negs: int = 5,
        device_features: bool = False,
        feature_dtype: Optional[str] = None,
        device_sampling: bool = False,
    ):
        name = type(self).__name__
        if max_id < 0:
            raise ValueError(f"{name} needs max_id >= 0 (its tables are "
                             "sized max_id+2)")
        self.device_features = base.resolve_device_features(
            device_features, feature_idx, max_id,
            has_sparse=bool(sparse_feature_idx))
        # the id embedding needs no feature table: device sampling runs
        # with use_id alone, and needs device features only for features
        if device_sampling and not self.device_features and (
                feature_idx >= 0 or sparse_feature_idx):
            raise ValueError(
                "device_sampling with dense/sparse features requires "
                "device_features=True (the tables must be on the card)")
        self.device_sampling = bool(device_sampling)
        self.feature_dtype = feature_dtype
        self.node_type = node_type
        self.max_id = max_id
        self.feature_idx = feature_idx
        self.feature_dim = feature_dim
        self.use_id = use_id
        self.num_negs = num_negs
        self.sparse_feature_idx = list(sparse_feature_idx)
        self.sparse_feature_max_ids = list(sparse_feature_max_ids)
        self.sparse_max_len = sparse_max_len

    def _module_common(self) -> dict:
        return dict(
            feature_dim=self.feature_dim if self.feature_idx >= 0 else 0,
            max_id=self.max_id if self.use_id else -1,
            num_negs=self.num_negs,
            has_features=self.device_features and self.feature_idx >= 0,
            sparse_feature_max_ids=tuple(self.sparse_feature_max_ids),
            has_sparse=self.device_features and bool(
                self.sparse_feature_idx),
        )

    def make_module(self, generator=None) -> _ShallowUnsupModule:
        return _ShallowUnsupModule(**self._module_kwargs,
                                   generator=generator)

    def build_consts(self, graph, device) -> dict:
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        return self.add_sampling_consts(
            consts, graph, [self.edge_type], device,
            negs_type=self.node_type, roots_type=self.node_type,
            sorted=self.adj_sorted,
        )

    def _pack(self, graph, src, pos, negs) -> dict:
        return {"src": self.host_node_inputs(graph, src),
                "pos": self.host_node_inputs(graph, pos),
                "negs": self.host_node_inputs(graph, negs)}

    def sample_host_embed(self, graph, inputs) -> dict:
        """The sources alone: an export draws nothing."""
        return {"src": self.host_node_inputs(graph, inputs)}

    def device_embed_batch(self, ids, device=None) -> dict:
        return {"src": self.node_inputs(ids, device)}


class LINE(_ShallowUnsupervised):
    """LINE (reference ``models/line.py``): positives are one neighbor
    draw per root; order 1 shares the target encoder as context, order 2
    has a context encoder of its own."""

    def __init__(
        self,
        node_type: int,
        edge_type: Sequence[int],
        max_id: int,
        dim: int,
        order: int = 1,
        combiner: str = "add",
        xent_loss: bool = False,
        embedding_dim: int = 16,
        **kwargs,
    ):
        super().__init__(node_type, max_id, **kwargs)
        if order not in (1, 2, "first", "second"):
            raise ValueError(f"LINE order must be 1 or 2, got {order}")
        self.edge_type = list(edge_type)
        self._module_kwargs = dict(
            dim=dim, embedding_dim=embedding_dim, combiner=combiner,
            xent_loss=xent_loss, share_context=order in (1, "first"),
            adj_key=self.adj_key(self.edge_type), **self._module_common(),
        )

    def sample(self, graph, inputs) -> dict:
        """Host mode: each root's positive one ``sample_neighbor`` draw
        (the default row where it has none), ``num_negs`` negatives a
        root from ``sample_node``."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        src = np.asarray(inputs, dtype=np.int64).reshape(-1)
        pos, _, _ = graph.sample_neighbor(src, self.edge_type, 1,
                                          self.max_id + 1)
        negs = graph.sample_node(len(src) * self.num_negs, self.node_type)
        return self._pack(graph, src, pos.reshape(-1), negs)


class Node2Vec(_ShallowUnsupervised):
    """Node2Vec (reference ``models/node2vec.py``): walks, then skip-gram
    pairs, then shallow encoders. ``batch_size_ratio`` is the pair count
    per root, the batch multiplier ``run_loop`` applies."""

    def __init__(
        self,
        node_type: int,
        edge_type: Sequence[int],
        max_id: int,
        dim: int,
        walk_len: int = 3,
        walk_p: float = 1.0,
        walk_q: float = 1.0,
        left_win_size: int = 1,
        right_win_size: int = 1,
        combiner: str = "add",
        xent_loss: bool = False,
        embedding_dim: int = 16,
        walk_trials: int = 0,
        **kwargs,
    ):
        super().__init__(node_type, max_id, **kwargs)
        if walk_trials < 0:
            raise ValueError(f"walk_trials must be >= 0 (0 = library "
                             f"default), got {walk_trials}")
        self.edge_type = list(edge_type)
        self.walk_len = walk_len
        self.walk_p = walk_p
        self.walk_q = walk_q
        # biased walks on the card test parent membership over id-sorted
        # rows; p = q = 1 keeps the plain draw, as the reference does
        self.adj_sorted = self.device_sampling and (walk_p != 1.0
                                                    or walk_q != 1.0)
        self.left_win_size = left_win_size
        self.right_win_size = right_win_size
        self.batch_size_ratio = walk_ops.pair_count(
            walk_len + 1, left_win_size, right_win_size)
        self._module_kwargs = dict(
            dim=dim, embedding_dim=embedding_dim, combiner=combiner,
            xent_loss=xent_loss,
            adj_key=self.adj_key(self.edge_type, sorted=self.adj_sorted),
            walk_len=walk_len, left_win=left_win_size,
            right_win=right_win_size, walk_p=walk_p, walk_q=walk_q,
            walk_trials=walk_trials, **self._module_common(),
        )

    def sample(self, graph, inputs) -> dict:
        """Host mode: the engine's p/q ``random_walk`` from each root (the
        default row past a dead end), its skip-gram pairs in the reference
        kernel's order, ``num_negs`` negatives a pair from
        ``sample_node``."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        paths = walk_ops.random_walk(graph, roots, self.edge_type,
                                     self.walk_len, p=self.walk_p,
                                     q=self.walk_q,
                                     default_node=self.max_id + 1)
        flat = walk_ops.gen_pair(paths, self.left_win_size,
                                 self.right_win_size).reshape(-1, 2)
        src, pos = flat[:, 0], flat[:, 1]
        negs = graph.sample_node(len(src) * self.num_negs, self.node_type)
        return self._pack(graph, src, pos, negs)
