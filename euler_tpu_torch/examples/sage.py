"""Self-contained supervised GraphSAGE on (synthetic) PPI, on the card
(counterpart of ``examples/sage.py``).

Reference equivalent: examples/sage.py:80-98 — batch 512, fanouts
[10, 10], dim 256, Adam 0.01, 2000 steps, streaming micro-F1. The data is
the synthetic PPI-scale graph (``datasets.build_ppi``); point
``--data_dir`` at converted ``.dat`` partitions of the real PPI instead
(``python -m euler_tpu_torch.graph.convert``).

    python -m euler_tpu_torch.examples.sage [--steps 2000] [--data_dir DIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from euler_tpu_torch import Graph
from euler_tpu_torch import train as train_lib
from euler_tpu_torch.datasets import PPI, build_ppi
from euler_tpu_torch.models import SupervisedGraphSage


def build_model(feature_dim: int = PPI["feature_dim"],
                label_dim: int = PPI["label_dim"],
                max_id: int = PPI["num_nodes"] - 1) -> SupervisedGraphSage:
    """The example's model at PPI's widths (or the given ones)."""
    return SupervisedGraphSage(
        label_idx=0,
        label_dim=label_dim,
        metapath=[[0], [0]],
        fanouts=[10, 10],
        dim=256,
        feature_idx=1,
        feature_dim=feature_dim,
        max_id=max_id,
    )


def fit(model, graph, steps: int, batch_size: int, learning_rate: float,
        device=None):
    """``train.train`` with the example's roots (``batch_size`` nodes of
    any type a step) and prefetch settings; ``(state, history)``."""

    def source(step):
        return np.asarray(graph.sample_node(batch_size, -1))

    return train_lib.train(
        model,
        graph,
        source,
        num_steps=steps,
        optimizer="adam",
        learning_rate=learning_rate,
        log_every=100,
        prefetch_threads=4,
        prefetch_depth=3,
        device=device,
    )


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="/tmp/euler_tpu_ppi")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    build_ppi(args.data_dir)
    graph = Graph(directory=args.data_dir)
    try:
        _, history = fit(build_model(), graph, args.steps, args.batch_size,
                         0.01, args.device)
    finally:
        graph.close()
    print("final:", history[-1])
    return history


if __name__ == "__main__":
    main()
