"""Full-node-count dress rehearsal of the real-Reddit data path, on the
card (counterpart of ``scripts/reddit_dress_rehearsal.py``).

Companion to ``ppi_dress_rehearsal`` for the DGL npz format: builds a
replica of the DGL reddit release files at the REAL node count and
feature shape — 232,965 nodes, [N, 602] float32 feature array, 41
classes, node_types 1/2/3 at the real split proportions (~66% train /
~10% val / ~24% test), scipy-CSR self-loop adjacency — and drives them
end-to-end the way a user with the real files would:

    datasets.prepare_reddit -> .dat partitions + {train,val,test}.id
    -> reddit_main --mode train
    -> --mode evaluate --id_file val.id

One reduction, the JAX script's: average degree defaults to 25 (26
entries per row with the self loop — 6.06M directed edges at full node
count) instead of the real ~492 (114.6M); the file FORMATS and every
array shape the reader touches are exact. --avg-degree raises it.
Labels are a fixed linear function of the features, so val accuracy
above the majority class's (``majority_acc``) proves the model learns
from the prepared files. The summary line carries the card's name and
power limit as ``nvidia-smi`` gives them.

    python -m euler_tpu_torch.scripts.reddit_dress_rehearsal
        [--num-nodes N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from euler_tpu_torch.scripts.ppi_dress_rehearsal import card


# the defaults: the real node count and feature shape, the JAX script's
# average degree, one epoch at the reference's batch
NUM_NODES = 232965
AVG_DEGREE = 25
EPOCHS = 1
BATCH_SIZE = 1000


def write_replica(data_dir: str, num_nodes: int, avg_degree: int,
                  feature_dim: int = 602, num_classes: int = 41,
                  seed: int = 0) -> dict:
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    w = rng.standard_normal((feature_dim, num_classes)) / np.sqrt(feature_dim)
    labels = np.argmax(feats @ w, axis=1).astype(np.int64)
    # real split proportions: ~66% train / 10% val / 24% test, 1-based
    u = rng.random(num_nodes)
    node_types = np.where(u < 0.66, 1, np.where(u < 0.76, 2, 3)).astype(
        np.int64
    )
    os.makedirs(data_dir, exist_ok=True)
    np.savez(
        os.path.join(data_dir, "reddit_data.npz"),
        feature=feats,
        node_ids=np.arange(num_nodes, dtype=np.int64),
        label=labels,
        node_types=node_types,
    )
    # CSR with avg_degree random neighbors per row plus the self loop
    # (the DGL file is the self-loop variant)
    deg = avg_degree
    indices = rng.integers(0, num_nodes, num_nodes * deg, dtype=np.int32)
    indices = np.concatenate(
        [indices.reshape(num_nodes, deg),
         np.arange(num_nodes, dtype=np.int32)[:, None]],
        axis=1,
    ).reshape(-1)
    indptr = np.arange(num_nodes + 1, dtype=np.int64) * (deg + 1)
    adj = sp.csr_matrix(
        (np.ones(len(indices), np.float32), indices, indptr),
        shape=(num_nodes, num_nodes),
    )
    sp.save_npz(os.path.join(data_dir, "reddit_self_loop_graph.npz"), adj)
    # majority-class accuracy on the val split: the strongest
    # label-marginal-only predictor; the learned model must clear it by
    # a margin (the test gate)
    val_labels = labels[node_types == 2]
    counts = np.bincount(val_labels, minlength=num_classes)
    return {
        "train": int((node_types == 1).sum()),
        "val": int((node_types == 2).sum()),
        "test": int((node_types == 3).sum()),
        "edges": int(len(indices)),
        "majority_acc": round(float(counts.max() / max(len(val_labels), 1)),
                              4),
    }


def prepare(workdir: str, num_nodes: int, avg_degree: int) -> dict:
    """The replica's files under ``workdir/dgl`` and their preparation
    into ``workdir/dat``: the summary's splits and seconds."""
    from euler_tpu_torch.datasets import prepare_reddit

    summary: dict = {}
    t0 = time.time()
    summary["splits"] = write_replica(os.path.join(workdir, "dgl"),
                                      num_nodes, avg_degree)
    summary["write_replica_s"] = round(time.time() - t0, 1)
    t1 = time.time()
    prepare_reddit(os.path.join(workdir, "dgl"),
                   os.path.join(workdir, "dat"), num_partitions=2)
    summary["prepare_reddit_s"] = round(time.time() - t1, 1)
    return summary


def train_and_evaluate(workdir: str, num_nodes: int, epochs: int,
                       batch_size: int, device=None) -> dict:
    """``reddit_main`` train, then evaluate on ``val.id``, over the
    prepared ``workdir/dat``: the summary's seconds, exit codes and val
    metrics."""
    from euler_tpu_torch import reddit_main

    out = os.path.join(workdir, "dat")
    model_dir = os.path.join(workdir, "ck")
    summary: dict = {}
    common = [
        "--data_dir", out, "--model_dir", model_dir,
        "--model", "graphsage_supervised",
        "--max_id", str(num_nodes - 1),
        "--batch_size", str(batch_size), "--dim", "64",
        "--fanouts", "4,4", "--train_edge_type", "0",
        "--num_epochs", str(epochs), "--log_steps", "20",
    ]
    t2 = time.time()
    rc = reddit_main.run(common + ["--mode", "train"], device)
    summary["train_s"] = round(time.time() - t2, 1)
    summary["train_rc"] = rc
    if rc == 0:
        t3 = time.time()
        rc = reddit_main.run(
            common + [
                "--mode", "evaluate",
                "--id_file", os.path.join(out, "val.id"),
            ], device)
        summary["evaluate_s"] = round(time.time() - t3, 1)
        summary["evaluate_rc"] = rc
        eval_json = os.path.join(model_dir, "eval.json")
        if rc == 0 and os.path.exists(eval_json):
            with open(eval_json) as f:
                summary["val_metrics"] = json.load(f)
    return summary


def run(num_nodes: int, avg_degree: int, epochs: int, batch_size: int,
        workdir: str | None = None, device=None) -> dict:
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="reddit_rehearsal_")
    summary: dict = {"num_nodes": num_nodes, "card": card(device)}
    try:
        summary.update(prepare(workdir, num_nodes, avg_degree))
        summary.update(train_and_evaluate(workdir, num_nodes, epochs,
                                          batch_size, device))
        return summary
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-nodes", type=int, default=NUM_NODES)
    ap.add_argument("--avg-degree", type=int, default=AVG_DEGREE)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary = run(args.num_nodes, args.avg_degree, args.epochs,
                  args.batch_size, args.workdir, args.device)
    print(json.dumps(summary))
    ok = summary.get("train_rc") == 0 and summary.get("evaluate_rc") == 0
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
