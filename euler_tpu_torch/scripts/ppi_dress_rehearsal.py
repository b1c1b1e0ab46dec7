"""Full-scale dress rehearsal of the real-PPI data path, on the card
(counterpart of ``scripts/ppi_dress_rehearsal.py``).

The real GraphSAGE PPI release is not downloaded here, so this script
builds a FULL-SIZE synthetic replica of the release layout — 56944
nodes, 50-dim feats.npy, 121-dim multilabel class_map, ~818k node-link
edges, the real split PROPORTIONS (~79% train / ~11% val / ~10% test,
drawn per node so exact counts vary), identity id_map, a few unannotated
nodes to exercise the drop path — and drives it end-to-end exactly the
way a user with the real files would: ``datasets.prepare_ppi`` -> .dat
partitions -> ``ppi_main`` training -> id-file evaluation:

    python -m euler_tpu_torch.scripts.ppi_dress_rehearsal [--num-nodes N]
        [--epochs E] [--device cuda|cpu]

Labels are a fixed random linear function of the features, so val F1
above the all-positive predictor's (``allpos_f1``) proves the model
learns from the prepared files, not just that the pipeline executes.
The summary line carries the card's name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def write_replica(prefix: str, num_nodes: int, num_links: int,
                  feature_dim: int = 50, label_dim: int = 121,
                  val_frac: float = 0.114, test_frac: float = 0.097,
                  seed: int = 0) -> dict:
    """GraphSAGE-release-format files at ``prefix``; returns split sizes."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    np.save(prefix + "-feats.npy", feats)

    # labels: thresholded random projection of the features -> learnable
    w = rng.standard_normal((feature_dim, label_dim)) / np.sqrt(feature_dim)
    logits = feats @ w
    labels = (logits > 0).astype(float)

    u = rng.random(num_nodes)
    is_val = u < val_frac
    is_test = (u >= val_frac) & (u < val_frac + test_frac)
    nodes = []
    drop = set(
        rng.choice(num_nodes, size=max(2, num_nodes // 20000), replace=False)
        .tolist()
    )
    for i in range(num_nodes):
        if i in drop:  # unannotated rows: prepare_ppi must drop them
            nodes.append({"id": i})
        else:
            nodes.append(
                {"id": i, "val": bool(is_val[i]), "test": bool(is_test[i])}
            )
    src = rng.integers(0, num_nodes, num_links)
    dst = rng.integers(0, num_nodes, num_links)
    links = [
        {"source": int(s), "target": int(t)}
        for s, t in zip(src, dst) if s != t
    ]
    with open(prefix + "-G.json", "w") as f:
        json.dump({"nodes": nodes, "links": links}, f)
    with open(prefix + "-id_map.json", "w") as f:
        json.dump({str(i): i for i in range(num_nodes)}, f)
    with open(prefix + "-class_map.json", "w") as f:
        json.dump({str(i): labels[i].tolist() for i in range(num_nodes)}, f)
    kept = ~np.isin(np.arange(num_nodes), list(drop))
    # trivial-predictor micro-F1 on the val labels — predicting every
    # label positive scores 2p/(1+p); a model that learned the linear
    # label function must clear it by a margin (the test gate)
    p = float(labels[kept & is_val].mean())
    return {
        "train": int((kept & ~is_val & ~is_test).sum()),
        "val": int((kept & is_val).sum()),
        "test": int((kept & is_test).sum()),
        "links": len(links),
        "allpos_f1": round(2 * p / (1 + p), 4),
    }


def card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (its first line), or ``"cpu"`` for a run on the CPU."""
    if device is not None and str(device).startswith("cpu"):
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run(num_nodes: int, num_links: int, epochs: int, batch_size: int,
        dim: int, workdir: str | None = None, device=None) -> dict:
    from euler_tpu_torch import ppi_main
    from euler_tpu_torch.datasets import prepare_ppi

    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="ppi_rehearsal_")
    prefix = os.path.join(workdir, "ppi")
    out = os.path.join(workdir, "dat")
    model_dir = os.path.join(workdir, "ck")
    summary: dict = {"num_nodes": num_nodes, "card": card(device)}
    try:
        t0 = time.time()
        summary["splits"] = write_replica(prefix, num_nodes, num_links)
        summary["write_replica_s"] = round(time.time() - t0, 1)

        t1 = time.time()
        prepare_ppi(prefix, out, num_partitions=2)
        summary["prepare_ppi_s"] = round(time.time() - t1, 1)

        common = [
            "--data_dir", out, "--model_dir", model_dir,
            "--model", "graphsage_supervised",
            "--max_id", str(num_nodes - 1),
            "--batch_size", str(batch_size), "--dim", str(dim),
            "--fanouts", "10,10", "--train_edge_type", "0",
            "--num_epochs", str(epochs), "--log_steps", "20",
        ]
        t2 = time.time()
        rc = ppi_main.run(common + ["--mode", "train"], device)
        summary["train_s"] = round(time.time() - t2, 1)
        summary["train_rc"] = rc
        if rc == 0:
            t3 = time.time()
            rc = ppi_main.run(
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
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-nodes", type=int, default=56944)
    ap.add_argument("--num-links", type=int, default=818716)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--workdir", default=None,
                    help="keep artifacts here instead of a temp dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary = run(args.num_nodes, args.num_links, args.epochs,
                  args.batch_size, args.dim, args.workdir, args.device)
    print(json.dumps(summary))
    ok = summary.get("train_rc") == 0 and summary.get("evaluate_rc") == 0
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
