"""Training loops (counterpart of ``euler_tpu/train.py``)."""

from __future__ import annotations

import functools

import torch

from euler_tpu_torch.graph import device as device_graph

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
