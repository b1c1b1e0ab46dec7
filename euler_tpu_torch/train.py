"""Training loops (counterpart of ``euler_tpu/train.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.nn import metrics

OPTIMIZERS = {
    # optax.adam's defaults are torch's: b1 0.9, b2 0.999, eps 1e-8 added
    # outside the square root
    "adam": torch.optim.Adam,
}


def get_optimizer(name: str, lr: float):
    """A factory ``params -> torch.optim.Optimizer`` (the part optax's
    ``init`` plays), for ``Model.init_state``."""
    if name not in OPTIMIZERS:
        raise ValueError(
            f"optimizer {name!r} is not ported; have {sorted(OPTIMIZERS)}"
        )
    return functools.partial(OPTIMIZERS[name], lr=lr)


def _metric_value(name: str, acc) -> float:
    if name == "f1":
        return metrics.f1_from_counts(acc)
    if name == "auc":
        return metrics.auc_from_counts(acc)
    return float(acc[0] / max(acc[1], 1))  # running mean


def _metric_accumulate(name: str, acc, value):
    value = np.asarray(value)
    if name in ("f1", "auc"):
        return acc + value
    return np.array([acc[0] + float(value), acc[1] + 1.0])


def _metric_zero(name: str):
    if name == "f1":
        return np.zeros(3)
    if name == "auc":
        return np.zeros((2, metrics.AUC_BINS))
    return np.zeros(2)


def make_scan_train(model, inner_steps: int, batch_size: int):
    """Fully-device training, ``inner_steps`` steps per call.

    Requires a device-sampling model (its consts carry the adjacency slabs
    and the ``roots`` sampler). Returns ``scan_fn(state, seed) -> (state,
    losses [inner_steps])``: roots are drawn on the device from a
    ``torch.Generator`` seeded with ``seed``, and step i's neighbor draws
    are keyed by the host integer ``seed * inner_steps + i``, so the loop
    never waits for the device. ``state`` is updated in place."""
    step = model.make_train_step()

    def scan_fn(state, seed: int):
        sampler = state["consts"]["roots"]
        gen = torch.Generator(device=sampler["ids"].device)
        gen.manual_seed(seed)
        losses = []
        for i in range(inner_steps):
            roots = device_graph.sample_node(sampler, batch_size,
                                             generator=gen)
            loss, _ = step(state, {"roots": roots,
                                   "seed": seed * inner_steps + i})
            losses.append(loss)
        return state, torch.stack(losses)

    return scan_fn


def evaluate(model, graph, source_iter, state, device=None, seed: int = 0,
             log_fn=None) -> dict:
    """Streaming evaluation over an iterator of batches of model inputs
    (root ids, or a structured item such as LasGNN's ``{"label",
    "groups"}``), on one device: batch i is ``model.device_sample_batch(
    item, seed + i)`` on ``device`` (the card unless ``"cpu"`` is asked
    for), where ``state`` must live, run through
    ``model.make_eval_step()``. f1 accumulates its [tp, fp, fn] counts over
    the batches and auc its score histograms, any other metric (mrr) a
    running mean of the batch values. Returns ``{metric_name: value,
    "loss": mean batch loss}`` and passes ``"eval: {...}"`` to ``log_fn``
    when given.

    ``graph`` is kept for the JAX package's signature: every port model
    samples on the device, and host sampling (``model.sample``) waits for
    the engine client. Multi-process evaluation is not ported."""
    name = model.metric_name
    dev = resolve_device(device)
    eval_fn = model.make_eval_step()
    acc = _metric_zero(name)
    losses = []
    for i, ids in enumerate(source_iter):
        loss, metric = eval_fn(state, model.device_sample_batch(
            ids, seed + i, device=dev))
        acc = _metric_accumulate(name, acc, metric.cpu().numpy())
        losses.append(float(loss))
    result = {name: _metric_value(name, acc), "loss": float(np.mean(losses))}
    if log_fn is not None:
        log_fn(f"eval: {result}")
    return result


def save_embedding(model, max_id: int, state, batch_size: int = 1024,
                   device=None) -> np.ndarray:
    """The ``[max_id+1, dim]`` embeddings of ids 0..max_id, as a numpy
    array: ``model.make_embed_step()`` over chunks of ``batch_size`` ids
    (the last chunk padded with id 0 and cut), on ``device`` (the card
    unless ``"cpu"`` is asked for), where ``state`` must live."""
    dev = resolve_device(device)
    embed = model.make_embed_step()
    ids = np.arange(max_id + 1, dtype=np.int64)
    padded = np.concatenate(
        [ids, np.zeros((-len(ids)) % batch_size, dtype=np.int64)])
    chunks = [
        embed(state, model.sample_embed(padded[i:i + batch_size], dev))
        for i in range(0, len(padded), batch_size)
    ]
    return torch.cat(chunks).cpu().numpy()[:len(ids)]
