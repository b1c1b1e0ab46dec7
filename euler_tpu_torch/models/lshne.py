"""LsHNE: multi-view heterogeneous-graph walk embedding (counterpart of
``euler_tpu/models/lshne.py``).

Per view, metapath walks are cut into skip-gram pairs; sources, positives
and typed negatives run through per-node-type DNN towers over sparse-id
features, and a masked cosine softmax loss is taken against the
negatives, with a cross-view attention embedding trained beside it.

In device-sampling mode the batch is root ids and a seed. Each
walk step is one ``device.neighbor_draw`` over its step's slab (on CUDA
tensors one launch of the single-hop kernel at [B, 1]), the pairs are
fixed positions of the walks (``ops.walk.pair_indices``), and the
negatives are ``device.sample_node_with_src`` draws, plain PyTorch. Each
(view, metapath) walk and each view's negatives take a Philox stream of
their own, as the JAX module keys them apart with ``fold_in``: two equal
metapaths must not walk the same walk. The module also takes host-given
views (``{"views": ..., "root": ...}`` node dicts), so it can be held
against the flax module without any sampling. On the host
(``device_sampling=False``) ``sample`` builds those views through the
engine client: each metapath walk one ``random_walk`` call, the pairs
``ops.walk.gen_pair``'s, the typed negatives ``sample_node_with_src``,
and each node's sparse rows and type gathered on the host.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn.layers import _TRUNC_STD, SparseEmbedding
from euler_tpu_torch.ops import feature as feature_ops
from euler_tpu_torch.ops import walk as walk_ops

EPS = 1e-8
# rows a block of TypedDense's grouped product; each type's rows are
# padded to a whole number of blocks
TYPE_BLOCK = 128


class TypedDense(nn.Module):
    """Per-node-type dense layer: ``kernel [T, in, out]``, ``bias [T,
    out]``; row i computes ``x[i] @ kernel[t_i] + bias[t_i]`` with its type
    clamped into [0, T-1]. Init as flax's: lecun-normal over fan_in = T *
    in (flax counts the leading axis as receptive field), zero bias.

    The product runs grouped by type, never gathering a weight matrix a
    row: the rows are sorted by type, each type's run padded to whole
    blocks of ``TYPE_BLOCK`` rows, and one batched product takes each
    block with its type's kernel. The block count has a static bound
    (rows / TYPE_BLOCK + T), and the types are counted by an integer
    ``index_add_``, so the forward makes no host sync and a CUDA graph
    can capture it (the serving bucket)."""

    def __init__(self, num_types: int, in_dim: int, features: int):
        super().__init__()
        self.num_types = num_types
        self.kernel = nn.Parameter(torch.empty(num_types, in_dim, features))
        self.bias = nn.Parameter(torch.zeros(num_types, features))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        std = math.sqrt(1.0 / (self.num_types * self.kernel.shape[1]))
        std /= _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.bias.zero_()

    def forward(self, x, type_idx):
        n, in_dim = x.shape
        blk, num_types = TYPE_BLOCK, self.num_types
        t = type_idx.reshape(-1).long().clamp(0, num_types - 1)
        # bincount would size its output by a host read of max(t)
        counts = torch.zeros(num_types, dtype=torch.int64,
                             device=x.device).index_add_(
            0, t, torch.ones_like(t))
        padded = (counts + blk - 1) // blk * blk
        pad_end = torch.cumsum(padded, 0)
        start = torch.cumsum(counts, 0) - counts
        order = torch.argsort(t, stable=True)
        ts = t[order]
        # each row's slot: its type's padded start plus its rank in type
        slot = torch.empty_like(t)
        slot[order] = (pad_end - padded)[ts] + torch.arange(
            n, device=x.device) - start[ts]
        n_blocks = -(-n // blk) + num_types
        buf = x.new_zeros(n_blocks * blk, in_dim).index_copy(0, slot, x)
        block_type = torch.searchsorted(
            pad_end, torch.arange(n_blocks, device=x.device) * blk,
            right=True).clamp(max=num_types - 1)
        y = torch.bmm(buf.view(n_blocks, blk, in_dim),
                      self.kernel.index_select(0, block_type))
        return (y.reshape(n_blocks * blk, -1).index_select(0, slot)
                + self.bias.index_select(0, t))


def _cosine(a, b):
    """Cosine over the last axis, keepdim; ``sqrt(x + EPS)`` keeps the
    gradient finite for all-zero rows (nodes whose features are all
    padding)."""
    prod = (a * b).sum(-1, keepdim=True)
    na = torch.sqrt((a * a).sum(-1, keepdim=True) + EPS)
    nb = torch.sqrt((b * b).sum(-1, keepdim=True) + EPS)
    return prod / (na * nb)


class _LsHNEModule(nn.Module):
    """The per-view source towers, the shared target tower, the sparse
    embeddings and the attention vector of LsHNE; in device-sampling mode
    also the walks, pairs and negatives (``view_adj_keys``: per view, per
    metapath, one ``consts["adj"]`` key a step)."""

    def __init__(self, view_num: int, dim: int, num_negs: int,
                 src_type_num: int, sparse_feature_dims: Sequence[int],
                 feature_embedding_dim: int = 16, hidden_dim: int = 256,
                 gamma: float = 5.0, view_adj_keys: Sequence = (),
                 left_win: int = 1, right_win: int = 1,
                 default_node: int = -1, generator=None):
        super().__init__()
        self.view_num = view_num
        self.dim = dim
        self.num_negs = num_negs
        self.gamma = gamma
        self.view_adj_keys = [[list(p) for p in v] for v in view_adj_keys]
        self.left_win = left_win
        self.right_win = right_win
        self.default_node = default_node
        self.feature_embeddings = nn.ModuleList(
            SparseEmbedding(d, feature_embedding_dim, combiner="sum")
            for d in sparse_feature_dims)
        in_dim = feature_embedding_dim * len(sparse_feature_dims)
        self.src_hidden = nn.ModuleList(
            TypedDense(src_type_num, in_dim, hidden_dim)
            for _ in range(view_num))
        self.src_out = nn.ModuleList(
            TypedDense(src_type_num, hidden_dim, dim)
            for _ in range(view_num))
        self.tar_hidden = TypedDense(src_type_num, in_dim, hidden_dim)
        self.tar_out = TypedDense(src_type_num, hidden_dim, dim)
        self.att_vec = nn.Parameter(torch.empty(view_num, dim))
        # the Philox streams of a step: each view's metapath walks, then
        # its negatives
        self.walk_streams, self.neg_streams = [], []
        stream = 0
        for patterns in self.view_adj_keys:
            self.walk_streams.append(
                list(range(stream, stream + len(patterns))))
            self.neg_streams.append(stream + len(patterns))
            stream += len(patterns) + 1
        # the pair positions of each walk length, beside the parameters
        # and outside the state dict, so a step indexes without a copy
        for length in {len(p) for v in self.view_adj_keys for p in v}:
            ti, ci = walk_ops.pair_indices(length + 1, left_win, right_win)
            self.register_buffer(f"pair_tgt_{length}",
                                 torch.from_numpy(ti).long(),
                                 persistent=False)
            self.register_buffer(f"pair_ctx_{length}",
                                 torch.from_numpy(ci).long(),
                                 persistent=False)
        for m in self.modules():
            if isinstance(m, (SparseEmbedding, TypedDense)):
                m.reset_parameters(generator)
        with torch.no_grad():
            nn.init.trunc_normal_(self.att_vec, std=0.1, a=-0.2, b=0.2,
                                  generator=generator)

    def _features(self, node):
        return torch.cat([emb(ids, mask) for emb, (ids, mask) in
                          zip(self.feature_embeddings, node["sparse"])],
                         dim=-1)

    def encode_src(self, node, view: int):
        x, t = self._features(node), node["types"]
        return self.src_out[view](self.src_hidden[view](x, t), t)

    def encode_tar(self, node):
        x, t = self._features(node), node["types"]
        return self.tar_out(self.tar_hidden(x, t), t)

    def att_embedding(self, node, view_emb=None, view: int = -1):
        """The source encodings of every view, combined by a softmax over
        ``sum(encoding * att_vec[v])``; ``view_emb`` stands in for view
        ``view``'s encoding."""
        views = [view_emb if i == view and view_emb is not None
                 else self.encode_src(node, i) for i in range(self.view_num)]
        stack = torch.stack(views, dim=1)                      # [B, V, dim]
        w = torch.softmax((stack * self.att_vec).sum(-1), dim=-1)
        return torch.einsum("bv,bvd->bd", w, stack)

    def _decode(self, emb, emb_pos, emb_negs, mask):
        """(masked loss, mrr): softmax cross-entropy of ``gamma`` times
        the positive's cosine against the negatives', summed over the
        pairs under ``mask``; mrr ranks the positive by ``neg >= pos``."""
        pos_cos = _cosine(emb, emb_pos)                        # [B, 1]
        neg_cos = _cosine(emb[:, None, :], emb_negs)[..., 0]   # [B, negs]
        logits = self.gamma * torch.cat([pos_cos, neg_cos], dim=-1)
        per_pair = -torch.log_softmax(logits, dim=-1)[:, 0]
        loss = (per_pair * mask).sum()
        rank = 1.0 + (neg_cos >= pos_cos).sum(-1).to(emb.dtype)
        mrr = (mask / rank).sum() / mask.sum().clamp(min=1.0)
        return loss, mrr

    def _dev_node(self, ids, consts):
        """A node dict gathered from the device tables: each sparse slot's
        rows and the type (the default row's -1 clipped to 0)."""
        return {"sparse": base.sparse_rows(consts, ids),
                "types": consts["tsampler"]["types"].index_select(
                    0, ids).clamp(min=0)}

    def _device_views(self, batch, consts):
        """(views, root) drawn here from ``"roots"`` + ``"seed"``: per view,
        each metapath's walk (one neighbor draw a step), its skip-gram
        pairs, a mask that drops pairs touching the default node, and
        ``num_negs`` typed negatives a source (a default source draws as
        node 0). ``batch["u"]`` injects uniforms: ``{"walk": [[per-step
        list] a metapath] a view, "neg": [(u1, u2)] a view}``."""
        roots, seed = batch["roots"], batch["seed"]
        u = batch.get("u") or {}
        views = []
        for v, patterns in enumerate(self.view_adj_keys):
            srcs, poss = [], []
            for pi, step_keys in enumerate(patterns):
                words = device_graph.stream_words(
                    seed, self.walk_streams[v][pi])
                paths = device_graph.random_walk(
                    [consts["adj"][k] for k in step_keys], roots,
                    len(step_keys), words,
                    u=u["walk"][v][pi] if "walk" in u else None)
                length = len(step_keys)
                srcs.append(paths[:, getattr(self, f"pair_tgt_{length}")])
                poss.append(paths[:, getattr(self, f"pair_ctx_{length}")])
            src = torch.cat(srcs, dim=1).reshape(-1)
            pos = torch.cat(poss, dim=1).reshape(-1)
            mask = ((src != self.default_node)
                    & (pos != self.default_node)).to(torch.float32)
            safe_src = torch.where(src == self.default_node, 0, src)
            negs = device_graph.sample_node_with_src(
                consts["tsampler"], safe_src, self.num_negs,
                device_graph.stream_words(seed, self.neg_streams[v]),
                u=u["neg"][v] if "neg" in u else None).reshape(-1)
            views.append({"src": self._dev_node(src, consts),
                          "pos": self._dev_node(pos, consts),
                          "negs": self._dev_node(negs, consts),
                          "mask": mask})
        return views, self._dev_node(roots, consts)

    def _views_and_root(self, batch, consts):
        if "views" in batch:
            return batch["views"], batch["root"]
        return self._device_views(batch, consts)

    def embed(self, batch, consts=None):
        """The attention embedding of the roots (``"root"`` given, or
        ``"roots"`` gathered from the device tables)."""
        if "root" in batch:
            return self.att_embedding(batch["root"])
        return self.att_embedding(self._dev_node(batch["roots"], consts))

    def forward(self, batch, consts=None):
        views, root = self._views_and_root(batch, consts)
        total, mrrs = 0.0, []
        for v, view in enumerate(views):
            emb = self.encode_src(view["src"], v)
            emb_pos = self.encode_tar(view["pos"])
            emb_negs = self.encode_tar(view["negs"]).reshape(
                emb.shape[0], self.num_negs, self.dim)
            mask = view["mask"]
            loss_v, _ = self._decode(emb, emb_pos, emb_negs, mask)
            emb_att = self.att_embedding(view["src"], emb, v)
            loss_att, mrr = self._decode(emb_att, emb_pos, emb_negs, mask)
            total = total + loss_v + loss_att
            mrrs.append(mrr)
        return base.ModelOutput(
            embedding=self.att_embedding(root), loss=total,
            metric_name="mrr", metric=torch.stack(mrrs).mean())


class LsHNE(base.Model):
    """Multi-view LsHNE, sampled on the device or on the host
    (``device_sampling``). ``path_patterns``: per view, a list of
    metapaths, each a per-step list of edge-type lists. In
    device-sampling mode roots of ``node_type`` (-1: all) are drawn on the
    device, so ``train.make_scan_train`` drives it.
    ``sparse_feature_dims`` sizes each slot's embedding table; padding is
    id 0 under a zero mask."""

    metric_name = "mrr"
    batch_loss = "sum"

    def __init__(
        self,
        node_type: int,
        path_patterns: Sequence[Sequence[Sequence[Sequence[int]]]],
        max_id: int,
        dim: int,
        sparse_feature_dims: Sequence[int],
        feature_ids: Sequence[int],
        feature_embedding_dim: int = 16,
        sparse_max_len: int = 16,
        walk_len: int = 3,
        left_win_size: int = 1,
        right_win_size: int = 1,
        num_negs: int = 5,
        gamma: float = 5.0,
        src_type_num: int = 20,
        device_sampling: bool = False,
    ):
        if len(path_patterns) < 1:
            raise ValueError("need at least one view")
        if device_sampling and max_id < 0:
            raise ValueError("LsHNE needs max_id >= 0 (its tables are "
                             "sized max_id+2)")
        # the device tables are the sampling mode's: a host batch carries
        # its sparse rows and types
        self.device_features = self.device_sampling = bool(device_sampling)
        self.node_type = node_type
        self.path_patterns = [[[list(s) for s in p] for p in v]
                              for v in path_patterns]
        self.max_id = max_id
        self.src_type_num = src_type_num
        self.walk_len = walk_len
        self.left_win_size = left_win_size
        self.right_win_size = right_win_size
        self.num_negs = num_negs
        self.feature_ids = list(feature_ids)
        self.sparse_max_len = sparse_max_len
        self.gamma = gamma
        self._module_kwargs = dict(
            view_num=len(path_patterns), dim=dim, num_negs=num_negs,
            src_type_num=src_type_num,
            sparse_feature_dims=tuple(sparse_feature_dims),
            feature_embedding_dim=feature_embedding_dim, gamma=gamma,
            view_adj_keys=[[[self.adj_key(s) for s in p] for p in v]
                           for v in self.path_patterns],
            left_win=left_win_size, right_win=right_win_size,
            default_node=max_id + 1)

    def make_module(self, generator=None) -> _LsHNEModule:
        return _LsHNEModule(**self._module_kwargs, generator=generator)

    def build_consts(self, graph, device) -> dict:
        """Per-step slabs, the roots sampler, the typed negative sampler
        (``tsampler``) and the sparse tables; none on the host."""
        consts = super().build_consts(graph, device)
        if not self.device_sampling:
            return consts
        steps = [s for v in self.path_patterns for p in v for s in p]
        self.add_sampling_consts(consts, graph, steps, device,
                                 roots_type=self.node_type)
        consts["tsampler"] = device_graph.tensors(
            device_graph.build_typed_node_sampler(
                graph, self.src_type_num, self.max_id), device)
        consts["sparse"] = base.upload_sparse_tables(
            graph, self.max_id, self.feature_ids, self.sparse_max_len,
            [0] * len(self.feature_ids), device)
        return consts

    def _node_inputs(self, graph, ids) -> dict:
        """One node set's host inputs: each slot's padded sparse rows
        (padding id 0) and the node type clipped at 0, a negative id read
        as node 0."""
        ids = np.asarray(ids).reshape(-1)
        safe = np.where(ids < 0, 0, ids)
        return {
            "sparse": feature_ops.get_sparse_feature(
                graph, safe, self.feature_ids, self.sparse_max_len,
                default_values=[0] * len(self.feature_ids)),
            "types": np.clip(graph.node_types(safe), 0, None)
            .astype(np.int32),
        }

    def sample(self, graph, inputs) -> dict:
        """Host mode: per view, each metapath's walk from every root
        through the engine's ``random_walk`` (-1 past a dead end), its
        skip-gram pairs, a mask of the pairs with no -1, ``num_negs``
        typed negatives a source from ``sample_node_with_src`` (a -1
        source draws as node 0), and every node set's inputs."""
        if self.device_sampling:
            return super().sample(graph, inputs)
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        views = []
        for patterns in self.path_patterns:
            pairs = np.concatenate([
                walk_ops.gen_pair(
                    graph.random_walk(roots, list(pattern), p=1.0, q=1.0,
                                      default_node=-1),
                    self.left_win_size, self.right_win_size)
                for pattern in patterns], axis=1).reshape(-1, 2)
            src, pos = pairs[:, 0], pairs[:, 1]
            negs = graph.sample_node_with_src(np.where(src < 0, 0, src),
                                              self.num_negs)
            views.append({
                "src": self._node_inputs(graph, src),
                "pos": self._node_inputs(graph, pos),
                "negs": self._node_inputs(graph, negs),
                "mask": ((src != -1) & (pos != -1)).astype(np.float32),
            })
        return {"views": views, "root": self._node_inputs(graph, roots)}

    def sample_host_embed(self, graph, inputs) -> dict:
        return {"root": self._node_inputs(
            graph, np.asarray(inputs, dtype=np.int64))}

    def device_embed_batch(self, ids, device=None) -> dict:
        ids = np.clip(np.asarray(ids, np.int64).reshape(-1), 0,
                      self.max_id + 1).astype(np.int32)
        return {"roots": torch.as_tensor(
            ids, device=resolve_device(device))}
