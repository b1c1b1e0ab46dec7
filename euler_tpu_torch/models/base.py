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
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import device as device_graph


@dataclasses.dataclass
class ModelOutput:
    embedding: Any
    loss: Any
    metric_name: str
    metric: Any  # f1 counts [tp, fp, fn]


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


def gather_consts(feats: dict, consts: dict) -> dict:
    """Replace one node set's ``'gids'`` indices with rows gathered from
    the device feature table."""
    if not consts or "gids" not in feats:
        return feats
    feats = dict(feats)
    if "features" in consts:
        feats["dense"] = consts["features"].index_select(0, feats["gids"])
    return feats


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

    def make_module(self, generator=None) -> torch.nn.Module:
        raise NotImplementedError

    @staticmethod
    def adj_key(edge_types) -> str:
        """consts['adj'] key for one edge-type set."""
        return "et" + "_".join(map(str, edge_types))

    def add_sampling_consts(
        self,
        consts: dict,
        graph,
        edge_type_sets,
        device,
        roots_type: Optional[int] = None,
    ) -> dict:
        """Upload the device-sampling tables: one adjacency slab per
        distinct edge-type set (unpacked ``nbr``/``cum``/``sampleable``,
        which the CUDA kernel reads directly) and, when ``roots_type`` is
        given, the root sampler."""
        adj = consts.setdefault("adj", {})
        for et in edge_type_sets:
            k = self.adj_key(et)
            if k not in adj:
                adj[k] = device_graph.tensors(
                    device_graph.build_adjacency(graph, et, self.max_id),
                    device,
                )
        if roots_type is not None:
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

    def build_consts(self, graph, device) -> dict:
        """Device-resident lookup tables, uploaded once at init. Row
        max_id+1 is the default/padding node (zeros)."""
        n = self.max_id + 2
        ids = np.arange(n, dtype=np.int64)
        consts = {}
        if self.feature_idx >= 0:
            consts["features"] = torch.as_tensor(
                graph.get_dense_feature(
                    ids, [self.feature_idx], [self.feature_dim]
                ),
                device=device,
            )
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
