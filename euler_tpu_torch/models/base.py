"""Model base class and shared device-side pieces (counterpart of
``euler_tpu/models/base.py``).

A model is a host-side driver (config, table building, state) plus an
``nn.Module`` whose forward takes one batch and the device tables
(``consts``) and returns a ``ModelOutput``. In device-sampling mode the
whole batch is root ids and a seed: the fanout is drawn on the device
from the adjacency slabs in ``consts``, and feature and label rows are
gathered from device tables. In host-sampling mode
(``device_sampling=False``, every model) ``sample(graph, inputs)`` draws
the fanout through the engine client into a numpy batch, which
``to_device`` uploads: with ``device_features=False`` the features and
labels are gathered on the host too; with ``device_features=True`` the
batch carries only the nodes' table rows (``"gids"``) and the features
and labels are read from the device tables, as the JAX package's
``node_inputs`` lays it out.

Unlike the JAX package's pure ``(state, batch) -> state`` step, the port's
train step updates the module's parameters and the optimizer's moments
in place.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.nn import metrics, sparse_aggregators
from euler_tpu_torch.ops import feature as feature_ops
from euler_tpu_torch.parallel.mesh import RowShard, shard_state


@dataclasses.dataclass
class ModelOutput:
    embedding: Any
    loss: Any
    metric_name: str
    metric: Any  # f1 counts [tp, fp, fn], or a scalar (mrr)


def supervised_decoder(logits, labels, sigmoid_loss: bool):
    """Loss + hard predictions: the elementwise mean of binary
    cross-entropy with logits and ``floor(sigmoid + 0.5)``, or softmax
    cross-entropy and the one-hot argmax."""
    if sigmoid_loss:
        loss = F.binary_cross_entropy_with_logits(logits, labels)
        predictions = torch.floor(torch.sigmoid(logits) + 0.5)
    else:
        loss = -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
        predictions = F.one_hot(
            logits.argmax(-1), logits.shape[-1]
        ).to(logits.dtype)
    return loss, predictions


def unsupervised_decoder(emb, emb_pos, emb_negs, xent_loss: bool):
    """Negative-sampling loss and mrr. ``emb``/``emb_pos`` [B, 1, d],
    ``emb_negs`` [B, num_negs, d]. With ``xent_loss`` the summed sigmoid
    cross-entropy of the positive logit against 1 and the negative logits
    against 0; else ``-sum(logit - logsumexp(neg_logits))``."""
    logits = torch.einsum("bid,bjd->bij", emb, emb_pos)  # [B, 1, 1]
    neg_logits = torch.einsum("bid,bjd->bij", emb, emb_negs)  # [B, 1, n]
    return _negative_sampling_loss(logits, neg_logits, xent_loss)


def shared_negs_decoder(emb, emb_pos, emb_negs, xent_loss: bool):
    """``unsupervised_decoder`` with negatives shared by the whole batch
    (the reference's UnsupervisedModelV2): ``emb_negs`` [n, d], each
    root scored against all n."""
    logits = torch.einsum("bid,bjd->bij", emb, emb_pos)  # [B, 1, 1]
    neg_logits = torch.einsum("bid,nd->bin", emb, emb_negs)  # [B, 1, n]
    return _negative_sampling_loss(logits, neg_logits, xent_loss)


def _negative_sampling_loss(logits, neg_logits, xent_loss: bool):
    mrr = metrics.mrr(logits, neg_logits)
    if xent_loss:
        loss = F.binary_cross_entropy_with_logits(
            logits, torch.ones_like(logits), reduction="sum"
        ) + F.binary_cross_entropy_with_logits(
            neg_logits, torch.zeros_like(neg_logits), reduction="sum"
        )
    else:
        neg_cost = torch.logsumexp(neg_logits, dim=2, keepdim=True)
        loss = -torch.sum(logits - neg_cost)
    return loss, mrr


def upload_sparse_tables(graph, max_id: int, feature_idxs, max_len: int,
                         default_values, device) -> list:
    """Padded sparse-feature tables of every node (rows 0..max_id+1, row
    max_id+1 the default/padding row) on ``device``: one ``{"ids": [N+2,
    max_len] int32, "mask": [N+2, max_len] float32}`` a slot, for the
    device gathers of ``gather_consts`` (every model family that reads
    sparse features on the device shares them)."""
    all_ids = np.arange(max_id + 2, dtype=np.int64)
    tables = feature_ops.get_sparse_feature(
        graph, all_ids, list(feature_idxs), max_len,
        default_values=list(default_values))
    return [
        {"ids": torch.as_tensor(ids.astype(np.int32), device=device),
         "mask": torch.as_tensor(mask, device=device)}
        for ids, mask in tables
    ]


def sparse_rows(consts: dict, ids) -> list:
    """The ``(ids, mask)`` rows at ``ids`` of every sparse table."""
    return [(t["ids"].index_select(0, ids), t["mask"].index_select(0, ids))
            for t in consts["sparse"]]


def gather_consts(feats: dict, consts: dict) -> dict:
    """Replace one node set's ``'gids'`` indices with rows gathered from
    the device tables: the dense feature rows and, when the consts hold
    sparse tables, the padded ``(ids, mask)`` rows of each slot. A
    reduced-precision table (``feature_dtype="bfloat16"``) is cast back
    to float32 after the gather, so the module's math is unchanged and
    only the table's bytes and the gather traffic shrink."""
    if not consts or "gids" not in feats:
        return feats
    feats = dict(feats)
    if "features" in consts:
        feats["dense"] = consts["features"].index_select(
            0, feats["gids"]).to(torch.float32)
    if "sparse" in consts and "sparse" not in feats:
        feats["sparse"] = sparse_rows(consts, feats["gids"])
    return feats


def _feature_table_dtype(name: str) -> torch.dtype:
    """The ``torch`` dtype of a feature-table dtype name (``"bfloat16"``,
    ``"float16"``, ``"float32"``); anything else raises, naming both
    places the name comes from."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(
            f"bad feature table dtype {name!r} (from the feature_dtype "
            "kwarg or EULER_TPU_FEATURE_DTYPE; use a floating dtype name "
            "like 'bfloat16')"
        )
    return dtype


def resolve_device_features(device_features: bool, feature_idx: int,
                            max_id: int, has_sparse: bool = False) -> bool:
    """A model's ``device_features`` request, as the JAX package resolves
    it: off, silently, when the model has no dense (or, with
    ``has_sparse``, sparse) features; an error when ``max_id`` is unset,
    since the tables would have one row and every id would read it."""
    if not device_features or (feature_idx < 0 and not has_sparse):
        return False
    if max_id < 0:
        raise ValueError(
            "device_features=True requires max_id >= 0 (the feature/label "
            "tables are sized max_id+2)")
    return True


def check_device_mode(name, device_features, device_sampling, feature_idx,
                      max_id, metapath=(), fanouts=(),
                      has_sparse: bool = False) -> tuple:
    """``(device_features, device_sampling)`` of a feature model: device
    features as ``resolve_device_features`` leaves them; device sampling
    only over device feature tables (the drawn ids are read by device
    gathers). Host sampling takes either. One edge-type set a hop."""
    device_features = resolve_device_features(device_features, feature_idx,
                                              max_id, has_sparse)
    if device_sampling and not device_features:
        raise ValueError(
            f"{name}: device_sampling=True requires device_features=True "
            "over a feature table (feature_idx >= 0 or sparse slots) and "
            "max_id >= 0: the sampled ids are read by device gathers")
    if len(metapath) != len(fanouts):
        raise ValueError("metapath needs one edge-type set per fanout")
    return device_features, bool(device_sampling)


def to_device(batch, device=None):
    """A host batch (numpy arrays in nested dicts, lists and tuples) as
    tensors on ``device`` (the card unless ``"cpu"`` is asked for).
    Arrays go through pinned memory with ``non_blocking=True`` on a CUDA
    device, so the copy overlaps the host work that follows. The engine's
    uint64 ids arrive as int64 (its default node -1 stays -1), since
    torch does little arithmetic on uint64; other leaves pass through."""
    dev = resolve_device(device)

    def up(x):
        if isinstance(x, dict):
            return {k: up(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(up(v) for v in x)
        if not isinstance(x, np.ndarray):
            return x
        t = torch.from_numpy(np.ascontiguousarray(host_leaf(x)))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    return up(batch)


def batch_leaves(batch, path=()) -> list:
    """The numpy arrays of a host batch as ``(path, array)`` pairs, in
    the batch's own order (dict keys as inserted, list and tuple items in
    turn); other leaves are left out."""
    if isinstance(batch, dict):
        return [leaf for k, v in batch.items()
                for leaf in batch_leaves(v, path + (k,))]
    if isinstance(batch, (list, tuple)):
        return [leaf for i, v in enumerate(batch)
                for leaf in batch_leaves(v, path + (i,))]
    return [(path, batch)] if isinstance(batch, np.ndarray) else []


def batch_with_leaves(batch, leaves: list):
    """``batch`` with its numpy arrays replaced, in ``batch_leaves``
    order, by ``leaves`` (tensors, say); other leaves are kept."""
    it = iter(leaves)

    def swap(x):
        if isinstance(x, dict):
            return {k: swap(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(swap(v) for v in x)
        return next(it) if isinstance(x, np.ndarray) else x

    out = swap(batch)
    if next(it, None) is not None:
        raise ValueError("more leaves than the batch has arrays")
    return out


def concat_blocks(blocks: list):
    """Host batches of one root each (``sample_host_embed(graph,
    [nid])``) as one batch of ``len(blocks)`` roots: each array leaf
    concatenated along its first axis, in block order. Hop k of a block
    holds its root's ``prod(fanouts[:k])`` picks, so the rows of hop k
    come out root-major, as ``len(blocks)`` roots sampled at once lay
    them out, and the module reshapes them the same way."""
    parts = [batch_leaves(b) for b in blocks]
    return batch_with_leaves(blocks[0], [
        np.concatenate([p[i][1] for p in parts], axis=0)
        for i in range(len(parts[0]))])


def host_leaf(x: np.ndarray) -> np.ndarray:
    """A host leaf as it goes up: the engine's uint64 ids as int64, as
    ``to_device`` uploads them."""
    return x.view(np.int64) if x.dtype == np.uint64 else x


def _block_leaves(blocks: list) -> list:
    """``batch_leaves`` of each block; raises unless the blocks agree on
    every leaf's path, trailing shape and dtype (rows may differ)."""
    parts = [batch_leaves(b) for b in blocks]
    first = [(q, x.shape[1:], x.dtype) for q, x in parts[0]]
    for p in parts[1:]:
        if [(q, x.shape[1:], x.dtype) for q, x in p] != first:
            raise ValueError("the blocks of one dispatch differ in layout, "
                             "row width or dtype")
    return parts


class ServingLayout:
    """How ``serve.EmbedServer`` joins per-id host blocks
    (``Model.sample_serve_block``) into one bucket whose shapes stay fixed
    for the server's life, so that one captured forward serves every
    dispatch and row i of its embedding is block i's, whatever else the
    bucket holds.

    This one, every model's default, joins leaf by leaf: each leaf of
    each block concatenated along its first axis in block order, padded
    to ``max_batch`` blocks by repeating the first (``concat_blocks``'s
    rows). Each leaf must hold one row, or a fixed number of rows, per id
    (hop k of a fanout holds ``prod(fanouts[:k])``)."""

    def __init__(self, max_batch: int):
        self.max_batch = int(max_batch)

    def split(self, blocks: list) -> list:
        """The forwards that serve ``blocks``: lists of blocks, in
        request order."""
        return [blocks[i:i + self.max_batch]
                for i in range(0, len(blocks), self.max_batch)]

    def signature(self, blocks: list) -> tuple:
        """``(path, shape, dtype str)`` of each leaf of the bucket that
        ``blocks`` (one forward's) fill, in ``batch_leaves`` order."""
        parts = _block_leaves(blocks)
        parts += [parts[0]] * (self.max_batch - len(parts))
        return tuple(
            (path, (sum(p[i][1].shape[0] for p in parts),) + x.shape[1:],
             host_leaf(x).dtype.str)
            for i, (path, x) in enumerate(parts[0]))

    def write(self, blocks: list, out: list) -> list:
        """Write the bucket of ``blocks`` into ``out`` (arrays of
        ``signature``'s shapes, in its order) and return how many leading
        rows of each leaf hold it: here every row."""
        parts = [batch_leaves(b) for b in blocks]
        parts += [parts[0]] * (self.max_batch - len(parts))
        for i, buf in enumerate(out):
            np.concatenate([host_leaf(p[i][1]) for p in parts], axis=0,
                           out=buf)
        return [len(buf) for buf in out]


class HopLayout(ServingLayout):
    """Blocks whose rows differ from id to id (the GCN family's exact-size
    expansions), joined with offsets into hop arrays of fixed caps.

    ``space_of(path)`` names a leaf's row space: node spaces (a hop's
    nodes, their inputs) and ``edge_spaces`` (a hop's adjacency).
    ``caps`` gives each space's rows in the bucket. ``indexes`` maps an
    index leaf's path to the space it indexes: each block's index leaf is
    shifted by that space's rows in the blocks before it (a block's
    ``src`` gets its base row in the current hop, its ``dst`` its base in
    the next). A node space keeps its last row free, a sink; past the
    blocks' rows, an edge space holds padding edges, each index leaf at
    its space's sink and every other leaf (``w``, ``mask``) 0, so no
    padding edge reaches a real row's segment. The other rows of a node
    space are left as they were (zeros, or an earlier dispatch's rows):
    no real row reads them, and only the rows the blocks fill go up.

    A forward takes blocks while every space has room and at most
    ``max_batch`` blocks; a dispatch past that splits into more forwards,
    in request order. A block that would not fit an empty bucket raises
    (SupervisedGCN's sampling raises first, past the model's own caps,
    which the caps here hold)."""

    def __init__(self, max_batch: int, space_of, caps: dict, indexes: dict,
                 edge_spaces):
        super().__init__(max_batch)
        self.space_of = space_of
        self.caps = dict(caps)
        self.hop_indexes = dict(indexes)
        self.edge_spaces = set(edge_spaces)

    def _room(self, space) -> int:
        return self.caps[space] - (space not in self.edge_spaces)

    def _rows(self, leaves) -> dict:
        """One block's rows in each space (its first leaf there)."""
        rows = {}
        for path, x in leaves:
            rows.setdefault(self.space_of(path), len(x))
        return rows

    def split(self, blocks: list) -> list:
        groups, cur, used = [], [], {}
        for blk in blocks:
            rows = self._rows(batch_leaves(blk))
            for s, r in rows.items():
                if r > self._room(s):
                    raise ValueError(
                        f"{s}: one id's {r} rows > the bucket's "
                        f"{self._room(s)}")
            if cur and (len(cur) == self.max_batch or any(
                    used.get(s, 0) + r > self._room(s)
                    for s, r in rows.items())):
                groups.append(cur)
                cur, used = [], {}
            cur.append(blk)
            for s, r in rows.items():
                used[s] = used.get(s, 0) + r
        return groups + [cur]

    def signature(self, blocks: list) -> tuple:
        parts = _block_leaves(blocks)
        return tuple(
            (path, (self.caps[self.space_of(path)],) + x.shape[1:],
             host_leaf(x).dtype.str)
            for path, x in parts[0])

    def write(self, blocks: list, out: list) -> list:
        parts = [batch_leaves(b) for b in blocks]
        rows = [self._rows(p) for p in parts]
        staged = []
        for i, buf in enumerate(out):
            path = parts[0][i][0]
            space = self.space_of(path)
            xs = [host_leaf(p[i][1]) for p in parts]
            used = sum(len(x) for x in xs)
            if used > self._room(space):
                raise ValueError(
                    f"{used} rows of {path} past the bucket's "
                    f"{self._room(space)}: split the dispatch first")
            np.concatenate(xs, axis=0, out=buf[:used])
            target = self.hop_indexes.get(path)
            if target is not None:
                counts = np.array([r.get(target, 0) for r in rows])
                buf[:used] += np.repeat(np.cumsum(counts) - counts,
                                        [len(x) for x in xs]).astype(
                                            buf.dtype)
            if space in self.edge_spaces:
                buf[used:] = 0 if target is None else self.caps[target] - 1
                used = len(buf)
            staged.append(used)
        return staged


def id_feats(ids, use_id: bool) -> dict:
    """One node set's encoder inputs in device-sampling mode: the
    feature-table indices ``"gids"``, which double as embedding ids
    (``"ids"``) under ``use_id``."""
    return {"gids": ids, "ids": ids} if use_id else {"gids": ids}


def write_rows_last_wins(table, ids, rows) -> None:
    """``table[ids] = rows`` in place, where an id repeated in ``ids``
    takes the row of its last occurrence, as the JAX package's
    ``.at[ids].set(rows)`` does on the CPU. Every occurrence of an id
    writes that same row, so the write is deterministic on CUDA too, and
    takes no host sync. A row-sharded table (``parallel.mesh.RowShard``)
    writes the rows it owns."""
    if isinstance(table, RowShard):
        table.write_rows_last_wins(ids, rows, write_rows_last_wins)
        return
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((table.shape[0],), -1, dtype=torch.int64,
                      device=ids.device)
    last.scatter_reduce_(0, ids, pos, reduce="amax")
    table.index_copy_(0, ids, rows.index_select(0, last.index_select(0, ids)))


def lookup_labels(batch: dict, consts: dict, root_ids):
    """Labels for a supervised batch: the host-gathered ``"labels"`` when
    the batch carries them, else rows of the device label table at
    ``root_ids``."""
    if "labels" in batch:
        return batch["labels"]
    if not consts:
        raise ValueError(
            "the batch has no 'labels' and no consts tables were passed: a "
            "device-features batch must be applied with state['consts'] "
            "(from Model.init_state)"
        )
    return consts["labels"].index_select(0, root_ids)


class Model:
    """Host-side model driver. Subclasses set the table configuration
    (``max_id``, ``feature_idx``/``feature_dim``, ``label_idx``/
    ``label_dim``) and ``make_module(generator)``."""

    max_id: int = -1
    feature_idx: int = -1
    feature_dim: int = 0
    label_idx: int = -1
    label_dim: int = 0
    # sparse (uint64 id-list) slots, their max ids and the pad length
    sparse_feature_idx: tuple = ()
    sparse_feature_max_ids: tuple = ()
    sparse_max_len: int = 16
    use_id: bool = False  # an id-embedding input ("ids") per node set
    # the feature table's dtype name (None: float32), e.g. "bfloat16"
    feature_dtype: Optional[str] = None
    # device adjacency form, set with set_sampling_options: a max_degree
    # cap on the slab's width, or the exact flat-CSR alias tables
    sampling_max_degree: Optional[int] = None
    sampling_alias: bool = False
    # families whose device pipeline reads the 2-D slab itself (the
    # full-neighborhood GCN walks adj["nbr"]) set this False
    alias_sampling_ok: bool = True
    # the modes: both True, host sampling over device tables
    # (device_features only) or host sampling with host features (neither)
    device_features: bool = True
    device_sampling: bool = True
    batch_size_ratio: int = 1
    # how the loss reduces over a batch's rows: "mean", or "sum" (the
    # negative-sampling losses); a mesh reduces the ranks' losses and
    # gradients the same way
    batch_loss: str = "mean"

    def make_module(self, generator=None) -> torch.nn.Module:
        raise NotImplementedError

    def _next_seed(self) -> int:
        """The next seed of the batches this driver makes itself (1, 2,
        ...): ``next`` on one ``itertools.count`` is atomic, so prefetch
        workers never share one."""
        return next(self.__dict__.setdefault("_seeds", itertools.count(1)))

    # ---- the host phase (counterpart of the JAX base.py:206-228) ----
    def sample(self, graph, inputs) -> dict:
        """One training batch of root ids ``inputs`` as numpy arrays on
        the host (``train.train``'s prefetch workers call it; the
        training thread uploads it with ``to_device``). In
        device-sampling mode it is the clipped roots and a fresh seed;
        host-sampling models draw their fanouts through ``graph``."""
        if not self.device_sampling:
            raise NotImplementedError(
                f"{type(self).__name__} has no host sample()")
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        return {
            "roots": np.clip(roots, 0, self.max_id + 1).astype(np.int32),
            "seed": self._next_seed(),
        }

    def sample_host_embed(self, graph, inputs) -> dict:
        """The host batch that embeds ``inputs`` (the JAX package's
        ``sample_embed(graph, inputs)``): the training batch unless the
        model needs less."""
        return self.sample(graph, inputs)

    # ---- serving (``serve.EmbedServer``) ----
    def sample_serve_block(self, graph, nid: int) -> dict:
        """One id's serving block, which ``serving_layout`` joins into
        buckets: ``sample_host_embed(graph, [nid])`` unless the model's
        layout pads it itself."""
        return self.sample_host_embed(graph, np.array([nid], np.int64))

    def serving_layout(self, max_batch: int) -> ServingLayout:
        """How a server's per-id blocks join into its fixed bucket: leaf
        by leaf, unless the model's blocks need offsets or caps."""
        return ServingLayout(max_batch)

    # ---- split sampling (``train``'s ``sampler_depth`` pipeline) ----
    # ``sample_start`` submits a step's graph queries without waiting and
    # returns a pending token; ``sample_finish`` blocks on it and builds
    # the batch. By default start samples in full and finish unwraps, so
    # every model is correct; a model with an async path
    # (SupervisedGraphSage) overrides both.
    def sample_start(self, graph, inputs):
        return self.sample(graph, inputs)

    def sample_finish(self, graph, pending) -> dict:
        return pending

    def sample_embed(self, ids, device=None, graph=None) -> dict:
        """The batch that embeds ``ids`` (``module.embed``), on
        ``device``: ``device_embed_batch`` in device-sampling mode, else
        ``sample_host_embed`` from ``graph``, uploaded."""
        if self.device_sampling:
            return self.device_embed_batch(ids, device)
        return to_device(self.sample_host_embed(graph, ids), device)

    def device_embed_batch(self, ids, device=None) -> dict:
        """The device-sampling batch that embeds ``ids``: the training
        batch with a fresh seed, unless the model needs less."""
        return self.device_sample_batch(ids, self._next_seed(), device)

    def host_node_inputs(self, graph, ids) -> dict:
        """One node set's encoder inputs for a host batch, as numpy arrays
        (the JAX package's ``node_inputs``): ``"ids"`` (clipped into the
        tables' max_id+2 rows) under ``use_id``; with device features the
        table rows ``"gids"`` (the same clip), else the dense rows
        (``"dense"``) and the padded sparse slots (``"sparse"``) gathered
        from ``graph``."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        feats = {}
        if self.use_id or self.device_features:
            clipped = np.clip(ids, 0, self.max_id + 1).astype(np.int32)
        if self.use_id:
            feats["ids"] = clipped
        if self.feature_idx >= 0:
            if self.device_features:
                feats["gids"] = clipped
            else:
                feats["dense"] = graph.get_dense_feature(
                    ids, [self.feature_idx], [self.feature_dim])
        if self.sparse_feature_idx:
            if self.device_features:
                feats.setdefault("gids", clipped)
            else:
                feats["sparse"] = feature_ops.get_sparse_feature(
                    graph, ids, list(self.sparse_feature_idx),
                    self.sparse_max_len,
                    default_values=[m + 1
                                    for m in self.sparse_feature_max_ids])
        return feats

    def set_sampling_options(
        self, max_degree: Optional[int] = None, alias: bool = False
    ) -> None:
        """Choose the device adjacency form before ``init_state``:
        ``max_degree`` caps the padded slab's width (each row keeps its
        heaviest neighbors, which changes hub distributions); ``alias``
        switches to the exact flat-CSR alias tables (no truncation, O(E)
        memory), the form for power-law graphs."""
        if alias and max_degree is not None:
            raise ValueError(
                "alias sampling is exact: max_degree does not apply"
            )
        if alias and not self.alias_sampling_ok:
            raise ValueError(
                f"{type(self).__name__} walks the 2-D adjacency slab "
                "(full-neighborhood aggregation) — alias sampling does "
                "not apply; use max_degree to bound slab width instead"
            )
        self.sampling_max_degree = max_degree
        self.sampling_alias = alias

    @staticmethod
    def adj_key(edge_types, sorted: bool = False) -> str:
        """consts['adj'] key for one edge-type set; ``sorted`` names the
        id-sorted table the biased walks need."""
        return ("et" + "_".join(map(str, edge_types))
                + ("_sorted" if sorted else ""))

    def add_sampling_consts(
        self,
        consts: dict,
        graph,
        edge_type_sets,
        device,
        negs_type: Optional[int] = None,
        roots_type: Optional[int] = None,
        max_degree: Optional[int] = None,
        sorted: bool = False,
    ) -> dict:
        """Upload the device-sampling tables: one adjacency per distinct
        edge-type set, in the form ``set_sampling_options`` chose (a slab,
        unpacked ``nbr``/``cum``/``sampleable``, which the CUDA kernels
        read directly, capped at ``max_degree`` or else
        ``sampling_max_degree``; or alias tables), and the typed node
        samplers for negatives (``negs_type``) and roots
        (``roots_type``), one shared table when the types match. An
        adjacency already in ``consts["adj"]`` under its key is kept as
        given, so a caller may hand in a slab it built itself.

        ``sorted`` builds id-sorted tables under their own keys
        (``adj_key(et, sorted=True)``) for the biased walks. A sorted slab
        that the cap would truncate is not built: biased walks over
        truncated rows are distorted (the JAX package measured a mean
        TVD of 0.35 on hub-parent steps), so the guard warns and builds
        the exact sorted alias tables instead, from one fetch."""
        # a cap given here means the caller reads the slab: never alias
        use_alias = self.sampling_alias and max_degree is None
        if max_degree is None:
            max_degree = self.sampling_max_degree
        adj = consts.setdefault("adj", {})
        for et in edge_type_sets:
            k = self.adj_key(et, sorted=sorted)
            if k in adj:
                continue
            if use_alias:
                table = device_graph.build_alias_adjacency(
                    graph, et, self.max_id, sorted=sorted)
            elif sorted and max_degree is not None:
                pre = device_graph._fetch_flat_csr(graph, et, self.max_id,
                                                   65536, sorted=True)
                trunc = int((pre[0] > max_degree).sum())
                if trunc:
                    warnings.warn(
                        f"add_sampling_consts: sorted slab for edge types "
                        f"{list(et)} would truncate {trunc} rows at "
                        f"max_degree={max_degree}; biased walks on a "
                        "truncated slab are distorted, so this walk "
                        "adjacency switches to the exact alias+rejection "
                        "form")
                    table = device_graph.build_alias_adjacency(
                        graph, et, self.max_id, sorted=True,
                        _prefetched=pre)
                else:
                    table = device_graph.build_adjacency(
                        graph, et, self.max_id, max_degree=max_degree,
                        sorted=True, _prefetched=pre)
            else:
                table = device_graph.build_adjacency(
                    graph, et, self.max_id, max_degree=max_degree,
                    sorted=sorted)
            adj[k] = device_graph.tensors(table, device)
        if negs_type is not None:
            consts["negs"] = device_graph.tensors(
                device_graph.build_node_sampler(graph, negs_type,
                                                self.max_id),
                device,
            )
        if roots_type is not None:
            if negs_type == roots_type:
                consts["roots"] = consts["negs"]
            else:
                consts["roots"] = device_graph.tensors(
                    device_graph.build_node_sampler(
                        graph, roots_type, self.max_id
                    ),
                    device,
                )
        return consts

    def device_sample_batch(self, inputs, seed: int, device=None) -> dict:
        """The whole per-step payload in device-sampling mode: root ids
        (clipped into the tables) and the integer seed of the step's
        neighbor draws."""
        roots = np.asarray(inputs, dtype=np.int64).reshape(-1)
        roots = np.clip(roots, 0, self.max_id + 1).astype(np.int32)
        return {
            "roots": torch.as_tensor(roots, device=resolve_device(device)),
            "seed": int(seed),
        }

    def node_inputs(self, ids, device=None) -> dict:
        """One node set's encoder inputs from its ids, on ``device`` (the
        card unless ``"cpu"`` is asked for): ``"ids"`` for the
        id-embedding path (``use_id``) and ``"gids"`` for the device
        feature tables (``feature_idx >= 0`` or sparse slots), both
        clipped into the tables' max_id+2 rows. ``host_node_inputs``
        gathers the features themselves on the host."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        clipped = torch.as_tensor(
            np.clip(ids, 0, self.max_id + 1).astype(np.int32),
            device=resolve_device(device))
        feats = {}
        if self.use_id:
            feats["ids"] = clipped
        if self.feature_idx >= 0 or self.sparse_feature_idx:
            feats["gids"] = clipped
        return feats

    def build_consts(self, graph, device) -> dict:
        """Device-resident lookup tables, uploaded once at init. Row
        max_id+1 is the default/padding node (zeros). The feature table
        takes ``feature_dtype``, else the process-wide
        ``EULER_TPU_FEATURE_DTYPE`` (converted on the host, so the upload
        moves the narrow bytes); labels stay float32, as loss targets.
        Sparse slots (``sparse_feature_idx``) get padded tables whose
        padding id is each slot's max id + 1. A host-features model has
        none."""
        if not self.device_features:
            return {}
        n = self.max_id + 2
        ids = np.arange(n, dtype=np.int64)
        consts = {}
        if self.feature_idx >= 0:
            table = torch.as_tensor(graph.get_dense_feature(
                ids, [self.feature_idx], [self.feature_dim]))
            dtype = self.feature_dtype or os.environ.get(
                "EULER_TPU_FEATURE_DTYPE")
            if dtype:
                table = table.to(_feature_table_dtype(dtype))
            consts["features"] = table.to(device)
        if self.label_idx >= 0:
            consts["labels"] = torch.as_tensor(
                graph.get_dense_feature(ids, [self.label_idx],
                                        [self.label_dim]),
                device=device,
            )
        if self.sparse_feature_idx:
            consts["sparse"] = upload_sparse_tables(
                graph, self.max_id, self.sparse_feature_idx,
                self.sparse_max_len,
                [m + 1 for m in self.sparse_feature_max_ids], device)
        return consts

    def init_state(self, graph, optimizer, device=None, seed: int = 0,
                   mesh=None):
        """{"module", "optimizer", "consts"} on ``device`` (the card
        unless ``"cpu"`` is asked for). ``optimizer`` builds a
        ``torch.optim.Optimizer`` from the parameters
        (``train.get_optimizer``); ``seed`` seeds the parameter init.
        Under a ``mesh`` the tables are padded and row-sharded over its
        model axis and the parameters broadcast from rank 0
        (``parallel.mesh.shard_state``)."""
        dev = resolve_device(device)
        consts = self.build_consts(graph, dev)
        gen = torch.Generator().manual_seed(seed)
        module = self.make_module(gen).to(dev)
        state = {
            "module": module,
            "optimizer": optimizer(module.parameters()),
            "consts": consts,
        }
        return state if mesh is None else shard_state(state, mesh)

    def make_train_step(self, mesh=None):
        """``step(state, batch) -> (loss, metric)``: forward, backward
        and one optimizer step, updating ``state`` in place. The
        gradients of the step stay in the parameters' ``.grad``. Under a
        ``mesh`` the batch is this rank's slice of the global batch: the
        gradients are all-reduced before the step and the loss and
        metric returned are the global batch's."""

        def train_step(state, batch):
            module, opt = state["module"], state["optimizer"]
            opt.zero_grad(set_to_none=True)
            out = module(batch, state["consts"])
            out.loss.backward()
            loss, metric = out.loss, out.metric
            if mesh is not None:
                scale = mesh.loss_scale(self.batch_loss)
                mesh.reduce_grads([p.grad for p in module.parameters()
                                   if p.grad is not None], scale)
                loss = mesh.reduce_loss(loss, scale)
                metric = mesh.reduce_metric(self.metric_name, metric)
            opt.step()
            return loss.detach(), metric.detach()

        return train_step

    def make_embed_step(self):
        """``embed(state, batch) -> embeddings`` without gradients: the
        module's ``embed`` over one batch with the state's tables, its
        segment sums deterministic (``nn.sparse_aggregators``), so a row
        is bit-stable wherever it sits in the batch."""

        def embed_step(state, batch):
            with torch.no_grad(), sparse_aggregators.deterministic_sums():
                return state["module"].embed(batch, state["consts"])

        return embed_step

    def make_eval_step(self):
        """``eval(state, batch) -> (loss, metric)``: the module's forward
        over one batch with the state's tables, without gradients or
        updates."""

        def eval_step(state, batch):
            with torch.no_grad():
                out = state["module"](batch, state["consts"])
            return out.loss, out.metric

        return eval_step


def _grads_or_zeros(loss, tensors, retain_graph: bool = False) -> list:
    """d(loss)/d(tensors), zeros where ``loss`` does not reach a tensor
    (optax updates every leaf, so a torch optimizer must see a zero
    gradient there, not none)."""
    grads = torch.autograd.grad(loss, tensors, retain_graph=retain_graph,
                                allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, tensors)]


class ScalableStoreModel(Model):
    """Shared training machinery of the Scalable{GCN,Sage} family
    (counterpart of the JAX package's ``ScalableStoreModel``).

    Each step expands only the 1-hop neighborhood; layer l+1 reads stale
    neighbor embeddings from store l. The state holds, beside the module
    and its optimizer, ``num_layers - 1`` ``stores`` and ``grad_stores``
    (``[max_id+2, dim]`` float32 each; stores start uniform in [0,
    ``store_init_maxval``)) and a second Adam at ``store_learning_rate``
    over the same parameters, with moments of its own. One step, in this
    order:

    1. read the stale gradients at ``node_ids``, then zero those rows;
    2. one forward with the store reads at ``neigh_ids`` as leaves;
    3. d(loss) and d(store_loss) by (parameters, reads), both at the old
       parameters, where store_loss = sum(emb_l * stale_l) over the first
       ``num_layers - 1`` layer embeddings;
    4. the main Adam steps on d(loss), then the store Adam on d(store_loss);
    5. ``grad_stores[neigh_ids] += d(loss + store_loss)/d(reads)``,
       duplicate ids adding;
    6. ``stores[node_ids] = emb`` (detached); a root drawn twice keeps
       the row of its last occurrence (``write_rows_last_wins``).

    Subclasses set ``num_layers``, ``dim``, ``max_id``,
    ``store_learning_rate`` and ``store_init_maxval``, and give a module
    with ``forward_train(batch, store_reads, consts) -> (loss, metric,
    node_embeddings, emb)`` and ``forward(batch, store_reads, consts) ->
    ModelOutput`` over batches with ``node_ids``/``neigh_ids``
    (``_expand_batch`` turns a device-sampling batch into one)."""

    num_layers: int = 1
    dim: int = 0
    store_learning_rate: float = 0.001
    store_init_maxval: float = 0.05

    def init_state(self, graph, optimizer, device=None, seed: int = 0,
                   mesh=None):
        """``Model.init_state``'s state plus ``stores``, ``grad_stores``
        and ``store_optimizer``; the stores' uniforms come from the same
        generator as the parameters, after them. Under a ``mesh`` the
        stores are padded and row-sharded with the tables."""
        dev = resolve_device(device)
        consts = self.build_consts(graph, dev)
        gen = torch.Generator().manual_seed(seed)
        module = self.make_module(gen).to(dev)
        shape = (self.max_id + 2, self.dim)
        stores = [
            (torch.rand(shape, generator=gen)
             * self.store_init_maxval).to(dev)
            for _ in range(1, self.num_layers)
        ]
        state = {
            "module": module,
            "optimizer": optimizer(module.parameters()),
            "consts": consts,
            "stores": stores,
            "grad_stores": [torch.zeros(shape, device=dev) for _ in stores],
            "store_optimizer": torch.optim.Adam(
                module.parameters(), lr=self.store_learning_rate),
        }
        return state if mesh is None else shard_state(state, mesh)

    def _expand_batch(self, batch, consts):
        """Hook: a device-sampling batch (roots + seed) in the
        ``node_ids``/``neigh_ids`` layout. Default: as given."""
        return batch

    def make_train_step(self, mesh=None):
        """``step(state, batch) -> (loss, metric)``, updating ``state`` in
        place; the parameters' ``.grad`` keeps d(loss)/d(params).

        Under a ``mesh`` the batch is this rank's slice of the global
        batch and the step is the global batch's, as the JAX package's
        sharded step: the gradients of the loss and of the store loss (a
        sum over rows) are all-reduced, and the store bookkeeping takes
        the ids and rows of every data row, gathered in rank order, so a
        root drawn on two ranks keeps the later rank's row and every data
        replica of a store shard stays equal."""
        scale = 1.0 if mesh is None else mesh.loss_scale(self.batch_loss)
        # the store loss sums over the batch's rows
        store_scale = 1.0 if mesh is None else mesh.loss_scale("sum")
        # the global loss's d/d(reads) over this rank's: the data rows'
        # share of ``scale`` (its model columns hold equal reads)
        read_scale = 1.0 if mesh is None else scale * mesh.shape["model"]

        def everyone(t):
            return t if mesh is None else mesh.all_gather(t, "data")

        def train_step(state, batch):
            module, consts = state["module"], state["consts"]
            batch = self._expand_batch(batch, consts)
            node_ids = batch["node_ids"].long()
            neigh_ids = batch["neigh_ids"].long()
            reads = [s.index_select(0, neigh_ids).requires_grad_()
                     for s in state["stores"]]
            stale = [gs.index_select(0, node_ids)
                     for gs in state["grad_stores"]]
            all_nodes = everyone(node_ids) if reads else node_ids
            for gs in state["grad_stores"]:
                gs.index_fill_(0, all_nodes, 0.0)
            loss, metric, node_embs, _ = module.forward_train(batch, reads,
                                                              consts)
            params = list(module.parameters())
            n = len(params)
            g_main = _grads_or_zeros(loss, params + reads,
                                     retain_graph=bool(reads))
            updates = [(state["optimizer"], g_main)]
            if reads:
                store_loss = sum((emb * g).sum()
                                 for emb, g in zip(node_embs, stale))
                g_store = _grads_or_zeros(store_loss, params + reads)
                updates.append((state["store_optimizer"], g_store))
                all_neigh = everyone(neigh_ids)
                for gs, gm, gss in zip(state["grad_stores"], g_main[n:],
                                       g_store[n:]):
                    gs.index_add_(0, all_neigh,
                                  everyone(gm * read_scale + gss))
            if mesh is not None:
                mesh.reduce_grads(g_main[:n], scale)
                if reads:
                    mesh.reduce_grads(g_store[:n], store_scale)
            for opt, grads in updates:
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
            for p, g in zip(params, g_main):  # .grad keeps d(loss)
                p.grad = g
            for s, emb in zip(state["stores"], node_embs):
                write_rows_last_wins(s, all_nodes, everyone(emb.detach()))
            if mesh is not None:
                loss = mesh.reduce_loss(loss, scale)
                metric = mesh.reduce_metric(self.metric_name, metric)
            return loss.detach(), metric.detach()

        return train_step

    def _apply_with_stores(self, state, batch):
        batch = self._expand_batch(batch, state["consts"])
        neigh_ids = batch["neigh_ids"].long()
        reads = [s.index_select(0, neigh_ids) for s in state["stores"]]
        with torch.no_grad():
            return state["module"](batch, reads, state["consts"])

    def make_eval_step(self):
        """``eval(state, batch) -> (loss, metric)`` over the stores, without
        gradients or updates."""

        def eval_step(state, batch):
            out = self._apply_with_stores(state, batch)
            return out.loss, out.metric

        return eval_step

    def make_embed_step(self):
        """``embed(state, batch) -> embeddings`` over the stores, its
        segment sums deterministic (as ``Model.make_embed_step``'s)."""

        def embed_step(state, batch):
            with sparse_aggregators.deterministic_sums():
                return self._apply_with_stores(state, batch).embedding

        return embed_step
