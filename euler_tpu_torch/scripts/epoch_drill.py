#!/usr/bin/env python
"""Live delta-flip drill (DEPLOY.md "Rolling graph refresh"); counterpart
of the JAX package's ``scripts/epoch_drill.py``.

The capstone proof for the snapshot-epoch layer (_native/eg_epoch): a
GraphSAGE training run over a LIVE 2-shard cluster keeps training while
every shard merges a delta and flips to the new snapshot mid-run — with
the sampler_depth=2 async ring holding steps in flight across each flip
— and the drill asserts

  * zero failed calls — the flips are invisible to the data plane
    (`calls_failed` and `delta_loads_failed` both zero, exactly one
    flip and one drain per shard on the ledger),
  * loss parity on the unchanged subgraph — a pre-flip fan-out whose
    2-hop closure provably avoids every mutated node is re-assembled
    after the flips: features AND the resulting loss are bit-identical
    (the compared forward on ``--device`` sums segments without atomics,
    ``nn.sparse_aggregators.deterministic_sums``),
  * the mutation landed — mutated nodes read the new feature rows,
  * closure — post-flip remote reads are bit-identical to a fresh
    LOCAL load of base + the same delta (`Graph(directory=..,
    delta=..)`), the property every other epoch guarantee reduces to.

The training step runs on ``--device`` (``cuda`` unless ``cpu`` is
asked for) under ``torch.optim.Adam``. Smoke mode (`--smoke`) runs a
small planted graph and a short run; the full drill scales it up. Exit
code is the verdict.

    python -m euler_tpu_torch.scripts.epoch_drill [--smoke] [--device cpu]
"""

import argparse
import os
import sys
import time
from collections import deque

import numpy as np

NUM_SHARDS = 2
FDIM = 8
K_COMM = 4


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="small/fast config")
    p.add_argument("--num_nodes", type=int, default=4000)
    p.add_argument("--train_steps", type=int, default=120)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="where the model trains (cuda unless cpu)")
    return p.parse_args(argv)


def _planted_node(nid, info, mutated=None):
    """Reconstruct one node dict exactly as build_planted packed it
    (same field order and dtypes, so pack_block bytes match and
    make_delta emits ONLY the mutated records)."""
    communities = info["communities"]
    labels = np.zeros(K_COMM)
    labels[communities[nid]] = 1.0
    feats = info["features"][nid]
    if mutated is not None and nid in mutated:
        feats = feats + np.float32(1.5)
    return {
        "node_id": nid,
        "node_type": 0,
        "node_weight": 1.0,
        "neighbor": {
            "0": {str(int(d)): 1.0 for d in info["neighbors"][nid]}
        },
        "uint64_feature": {},
        "float_feature": {
            "0": labels.tolist(),
            "1": np.asarray(feats, dtype=np.float32).tolist(),
        },
        "binary_feature": {},
        "edge": [],
    }


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.smoke:
        args.num_nodes = min(args.num_nodes, 1200)
        args.train_steps = min(args.train_steps, 40)

    import shutil
    import tempfile


    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.datasets import build_planted
    from euler_tpu_torch.device import resolve_device
    from euler_tpu_torch.graph import Graph, GraphService, native
    from euler_tpu_torch.graph.convert import make_delta, pack_delta
    from euler_tpu_torch.models import SupervisedGraphSage
    from euler_tpu_torch.models.base import batch_leaves, to_device
    from euler_tpu_torch.nn.sparse_aggregators import deterministic_sums

    dev = resolve_device(args.device)

    t_start = time.monotonic()
    failures: list = []

    def check(ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            failures.append(what)

    tmp = tempfile.mkdtemp(prefix="epoch_drill_")
    data = os.path.join(tmp, "data")
    reg = os.path.join(tmp, "reg")
    os.makedirs(reg)
    _, info = build_planted(
        data, num_nodes=args.num_nodes, num_communities=K_COMM,
        feature_dim=FDIM, avg_degree=6, num_partitions=NUM_SHARDS,
        seed=23,
    )
    n = args.num_nodes

    # ---- eval roots + their 2-hop closure: the UNCHANGED subgraph ----
    # Every node a fan-out from these roots can possibly draw lives in
    # the closure, so mutating only nodes OUTSIDE it makes the parity
    # claim exact, not statistical.
    eval_roots = np.arange(8, dtype=np.int64)
    closure = set(int(r) for r in eval_roots)
    frontier = list(closure)
    for _ in range(2):
        nxt = []
        for s in frontier:
            for d in info["neighbors"][s]:
                d = int(d)
                if d not in closure:
                    closure.add(d)
                    nxt.append(d)
        frontier = nxt
    mutated = sorted(set(range(n)) - closure)[: max(50, n // 10)]
    if len(mutated) < 20:
        print(f"drill config error: only {len(mutated)} nodes outside "
              f"the eval closure ({len(closure)}/{n}) — grow num_nodes")
        return 1

    # ---- the delta: feature refresh on the mutated set ----
    mset = set(mutated)
    old_nodes = [_planted_node(i, info) for i in range(n)]
    new_nodes = [_planted_node(i, info, mutated=mset) for i in range(n)]
    rm_n, rm_e, blob = make_delta(
        old_nodes, new_nodes,
        {"node_type_num": 1, "edge_type_num": 1,
         "node_uint64_feature_num": 0, "node_float_feature_num": 2,
         "node_binary_feature_num": 0, "edge_uint64_feature_num": 0,
         "edge_float_feature_num": 0, "edge_binary_feature_num": 0},
    )
    dpath = os.path.join(tmp, "part.delta.1")
    with open(dpath, "wb") as f:
        f.write(pack_delta(1, rm_n, rm_e, blob))

    print(f"== epoch drill: {args.train_steps} steps over a live "
          f"{NUM_SHARDS}-shard cluster, {len(mutated)} nodes mutated "
          f"behind a {len(closure)}-node eval closure ==")

    services = [
        GraphService(data, s, NUM_SHARDS, registry=reg)
        for s in range(NUM_SHARDS)
    ]
    try:
        native.reset_counters()
        g = Graph(mode="remote", registry=reg, retries=4,
                  neighbor_cache_mb=0)
        model = SupervisedGraphSage(
            label_idx=0, label_dim=K_COMM, metapath=[[0], [0]],
            fanouts=[5, 5], dim=16, feature_idx=1, feature_dim=FDIM,
            max_id=n - 1, sigmoid_loss=False,
        )
        opt = train_lib.get_optimizer("adam", 0.01)  # torch.optim.Adam
        train_step = model.make_train_step()  # updates the state in place
        eval_fwd = model.make_eval_step()  # no gradient, no update

        def step(state, batch):
            loss, metric = train_step(state, to_device(batch, dev))
            return state, loss, metric

        def eval_step(state, batch):
            # the compared forward: segment sums without atomics, so a
            # batch gives the same bits every time, on the card too
            with deterministic_sums():
                loss, metric = eval_fwd(state, to_device(batch, dev))
            return state, loss, metric

        rng = np.random.default_rng(7)
        native.lib().eg_seed(1234)
        rng.integers(0, n, args.batch)  # the JAX drill's init batch draw
        state = model.init_state(g, opt, device=dev, seed=0)

        # pre-flip capture: one fan-out from the eval roots; its hop ids
        # are frozen, its features re-read before and after the flips
        ids_per_hop, _, _ = g.sample_fanout(
            eval_roots, model.metapath, model.fanouts, -1
        )
        drawn = {int(i) for hop in ids_per_hop for i in np.asarray(hop)}
        check(drawn <= closure,
              f"eval fan-out stayed inside the closure "
              f"({len(drawn)} drawn ids)")
        batch_pre = model._batch_from_hops(g, eval_roots, ids_per_hop)
        feats_mut_pre = g.get_dense_feature(
            np.array(mutated[:16], dtype=np.int64), [1], [FDIM]
        )

        # ---- train through both flips, depth-2 ring in flight ----
        flip_steps = {args.train_steps // 3: 0,
                      args.train_steps // 2: 1}
        losses = []
        inflight = deque()
        submitted = 0
        while len(losses) < args.train_steps:
            while (submitted < args.train_steps
                   and len(inflight) < 2):
                shard = flip_steps.get(submitted)
                if shard is not None:
                    ep = g.load_delta(dpath, shard=shard)
                    print(f"  step {submitted}: shard {shard} flipped "
                          f"to epoch {ep} (mid-flight)")
                roots = rng.integers(0, n, args.batch).astype(np.int64)
                inflight.append(model.sample_start(g, roots))
                submitted += 1
            batch = model.sample_finish(g, inflight.popleft())
            state, loss, _ = step(state, batch)
            losses.append(float(loss))

        # ---- verdict ----
        check(all(np.isfinite(x) for x in losses),
              "every loss finite across both flips")
        check(float(np.mean(losses[-5:])) < losses[0],
              f"net training progress ({losses[0]:.3f} -> "
              f"{float(np.mean(losses[-5:])):.3f})")

        # data plane never saw the flips
        ctr = native.counters()
        check(ctr["calls_failed"] == 0,
              f"zero failed calls (calls_failed={ctr['calls_failed']})")
        check(ctr["delta_loads_failed"] == 0,
              "zero refused delta loads")
        # ledger: one flip per shard; every retired epoch drains once
        # its in-flight pins release
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            ctr = native.counters()
            if ctr["epoch_drains"] == ctr["epoch_flips"] == NUM_SHARDS:
                break
            g.sample_neighbor(eval_roots, [0], 2, default_node=-1)
            time.sleep(0.05)
        check(ctr["epoch_flips"] == NUM_SHARDS,
              f"exactly one flip per shard "
              f"(epoch_flips={ctr['epoch_flips']})")
        check(ctr["epoch_drains"] == NUM_SHARDS,
              f"every retired epoch drained "
              f"(epoch_drains={ctr['epoch_drains']})")
        check(all(g.shard_epoch(s) == 1 for s in range(NUM_SHARDS))
              and g.epoch() == 1,
              "client passively observed both flips (epoch 1 everywhere)")
        check(g.cache_gen >= 1,
              f"cache generation bumped (cache_gen={g.cache_gen})")

        # loss parity on the unchanged subgraph: same hop ids, features
        # re-read post-flip, same frozen state -> bit-identical loss
        batch_post = model._batch_from_hops(g, eval_roots, ids_per_hop)
        pre_leaves = batch_leaves(batch_pre)
        post_leaves = batch_leaves(batch_post)
        same = len(pre_leaves) == len(post_leaves) and all(
            pa == pb and np.array_equal(a, b)
            for (pa, a), (pb, b) in zip(pre_leaves, post_leaves)
        )
        check(same, "unchanged-subgraph batch bit-identical across flips")
        _, loss_pre, _ = eval_step(state, batch_pre)
        _, loss_post, _ = eval_step(state, batch_post)
        check(float(loss_pre) == float(loss_post),
              f"loss parity on unchanged subgraph "
              f"({float(loss_pre):.6f} == {float(loss_post):.6f})")

        # the mutation landed: mutated rows read the refreshed features
        feats_mut_post = g.get_dense_feature(
            np.array(mutated[:16], dtype=np.int64), [1], [FDIM]
        )
        check(np.array_equal(feats_mut_post,
                             feats_mut_pre + np.float32(1.5)),
              "mutated nodes serve the refreshed feature rows")

        # closure: remote post-flip == fresh local base+delta, bit for bit
        fresh = Graph(directory=data, delta=dpath)
        try:
            probe = np.array(
                mutated[:16] + sorted(closure)[:16], dtype=np.int64
            )
            check(fresh.epoch() == 1, "fresh merged load sits at epoch 1")
            check(np.array_equal(
                      g.get_dense_feature(probe, [1], [FDIM]),
                      fresh.get_dense_feature(probe, [1], [FDIM])),
                  "post-flip reads bit-identical to fresh merged load")
        finally:
            fresh.close()
        g.close()
    finally:
        for s in services:
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"== epoch drill {'FAIL' if failures else 'OK'} "
          f"({time.monotonic() - t_start:.1f}s) ==")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
