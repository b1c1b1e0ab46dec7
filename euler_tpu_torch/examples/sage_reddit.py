"""Supervised GraphSAGE on (synthetic) Reddit, on the card (counterpart
of ``examples/sage_reddit.py``).

Reference equivalent: examples/sage_reddit.py:80-97 — batch 1000,
fanouts [4, 4], dim 64, Adam 0.03, 2000 steps, softmax classes. Synthetic
data at Reddit's scale (232,965 nodes, 602-dim features, 41 classes;
``datasets.build_reddit``) — see ``examples/sage.py`` for why.

    python -m euler_tpu_torch.examples.sage_reddit [--steps 2000]
        [--data_dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging

from euler_tpu_torch import Graph
from euler_tpu_torch.datasets import REDDIT, build_reddit
from euler_tpu_torch.examples.sage import fit
from euler_tpu_torch.models import SupervisedGraphSage


def build_model(feature_dim: int = REDDIT["feature_dim"],
                label_dim: int = REDDIT["label_dim"],
                max_id: int = REDDIT["num_nodes"] - 1) -> SupervisedGraphSage:
    """The example's model at Reddit's widths (or the given ones)."""
    return SupervisedGraphSage(
        label_idx=0,
        label_dim=label_dim,
        metapath=[[0], [0]],
        fanouts=[4, 4],
        dim=64,
        feature_idx=1,
        feature_dim=feature_dim,
        max_id=max_id,
        sigmoid_loss=False,
    )


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="/tmp/euler_tpu_reddit")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    build_reddit(args.data_dir)
    graph = Graph(directory=args.data_dir)
    try:
        _, history = fit(build_model(), graph, args.steps, args.batch_size,
                         0.03, args.device)
    finally:
        graph.close()
    print("final:", history[-1])
    return history


if __name__ == "__main__":
    main()
