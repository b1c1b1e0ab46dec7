"""Model base class and shared device-side pieces (counterpart of
``euler_tpu/models/base.py``).

A model is a host-side driver (config, table building, state) plus an
``nn.Module`` whose forward takes one batch and the device tables
(``consts``) and returns a ``ModelOutput``. In device-sampling mode the
whole batch is root ids and a seed: the fanout is drawn on the device
from the adjacency slabs in ``consts``, and feature and label rows are
gathered from device tables.

Unlike the JAX package's pure ``(state, batch) -> state`` step, the port's
train step updates the module's parameters and the optimizer's moments
in place.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.nn import metrics


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


def gather_consts(feats: dict, consts: dict) -> dict:
    """Replace one node set's ``'gids'`` indices with rows gathered from
    the device feature table. A reduced-precision table
    (``feature_dtype="bfloat16"``) is cast back to float32 after the
    gather, so the module's math is unchanged and only the table's bytes
    and the gather traffic shrink."""
    if not consts or "gids" not in feats:
        return feats
    feats = dict(feats)
    if "features" in consts:
        feats["dense"] = consts["features"].index_select(
            0, feats["gids"]).to(torch.float32)
    return feats


def _feature_table_dtype(name: str) -> torch.dtype:
    """The ``torch`` dtype of a feature-table dtype name (``"bfloat16"``,
    ``"float16"``, ``"float32"``); anything else raises."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(
            f"bad feature table dtype {name!r} (from the feature_dtype "
            "kwarg; use a floating dtype name like 'bfloat16')"
        )
    return dtype


def lookup_labels(consts: dict, root_ids):
    """Labels for a supervised batch, gathered from the device label
    table at ``root_ids`` (host-gathered labels come with host sampling,
    which waits for the engine client)."""
    if not consts:
        raise ValueError(
            "no consts tables were passed: a device-features batch must be "
            "applied with state['consts'] (from Model.init_state)"
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

    def make_module(self, generator=None) -> torch.nn.Module:
        raise NotImplementedError

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
        (``roots_type``), one shared table when the types match.

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
        feature table (``feature_idx >= 0``), both clipped into the
        tables' max_id+2 rows. Host-gathered features (``"dense"``,
        ``"sparse"``) come with the engine client."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        clipped = torch.as_tensor(
            np.clip(ids, 0, self.max_id + 1).astype(np.int32),
            device=resolve_device(device))
        feats = {}
        if self.use_id:
            feats["ids"] = clipped
        if self.feature_idx >= 0:
            feats["gids"] = clipped
        return feats

    def build_consts(self, graph, device) -> dict:
        """Device-resident lookup tables, uploaded once at init. Row
        max_id+1 is the default/padding node (zeros). The feature table
        takes ``feature_dtype`` (converted on the host, so the upload
        moves the narrow bytes); labels stay float32, as loss targets."""
        n = self.max_id + 2
        ids = np.arange(n, dtype=np.int64)
        consts = {}
        if self.feature_idx >= 0:
            table = torch.as_tensor(graph.get_dense_feature(
                ids, [self.feature_idx], [self.feature_dim]))
            if self.feature_dtype:
                table = table.to(_feature_table_dtype(self.feature_dtype))
            consts["features"] = table.to(device)
        if self.label_idx >= 0:
            consts["labels"] = torch.as_tensor(
                graph.get_dense_feature(ids, [self.label_idx],
                                        [self.label_dim]),
                device=device,
            )
        return consts

    def init_state(self, graph, optimizer, device=None, seed: int = 0):
        """{"module", "optimizer", "consts"} on ``device`` (the card
        unless ``"cpu"`` is asked for). ``optimizer`` builds a
        ``torch.optim.Optimizer`` from the parameters
        (``train.get_optimizer``); ``seed`` seeds the parameter init."""
        dev = resolve_device(device)
        consts = self.build_consts(graph, dev)
        gen = torch.Generator().manual_seed(seed)
        module = self.make_module(gen).to(dev)
        return {
            "module": module,
            "optimizer": optimizer(module.parameters()),
            "consts": consts,
        }

    def make_train_step(self):
        """``step(state, batch) -> (loss, metric)``: forward, backward
        and one optimizer step, updating ``state`` in place. The
        gradients of the step stay in the parameters' ``.grad``."""

        def train_step(state, batch):
            module, opt = state["module"], state["optimizer"]
            opt.zero_grad(set_to_none=True)
            out = module(batch, state["consts"])
            out.loss.backward()
            opt.step()
            return out.loss.detach(), out.metric.detach()

        return train_step

    def make_embed_step(self):
        """``embed(state, batch) -> embeddings`` without gradients: the
        module's ``embed`` over one batch with the state's tables."""

        def embed_step(state, batch):
            with torch.no_grad():
                return state["module"].embed(batch, state["consts"])

        return embed_step


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
    6. ``stores[node_ids] = emb`` (detached).

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

    def init_state(self, graph, optimizer, device=None, seed: int = 0):
        """``Model.init_state``'s state plus ``stores``, ``grad_stores``
        and ``store_optimizer``; the stores' uniforms come from the same
        generator as the parameters, after them."""
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
        return {
            "module": module,
            "optimizer": optimizer(module.parameters()),
            "consts": consts,
            "stores": stores,
            "grad_stores": [torch.zeros(shape, device=dev) for _ in stores],
            "store_optimizer": torch.optim.Adam(
                module.parameters(), lr=self.store_learning_rate),
        }

    def _expand_batch(self, batch, consts):
        """Hook: a device-sampling batch (roots + seed) in the
        ``node_ids``/``neigh_ids`` layout. Default: as given."""
        return batch

    def make_train_step(self):
        """``step(state, batch) -> (loss, metric)``, updating ``state`` in
        place; the parameters' ``.grad`` keeps d(loss)/d(params)."""

        def train_step(state, batch):
            module, consts = state["module"], state["consts"]
            batch = self._expand_batch(batch, consts)
            node_ids = batch["node_ids"].long()
            neigh_ids = batch["neigh_ids"].long()
            reads = [s.index_select(0, neigh_ids).requires_grad_()
                     for s in state["stores"]]
            stale = [gs.index_select(0, node_ids)
                     for gs in state["grad_stores"]]
            for gs in state["grad_stores"]:
                gs.index_fill_(0, node_ids, 0.0)
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
                for gs, gm, gss in zip(state["grad_stores"], g_main[n:],
                                       g_store[n:]):
                    gs.index_add_(0, neigh_ids, gm + gss)
            for opt, grads in updates:
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
            for p, g in zip(params, g_main):  # .grad keeps d(loss)
                p.grad = g
            for s, emb in zip(state["stores"], node_embs):
                s.index_copy_(0, node_ids, emb.detach())
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
        """``embed(state, batch) -> embeddings`` over the stores."""

        def embed_step(state, batch):
            return self._apply_with_stores(state, batch).embedding

        return embed_step
