#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one NVIDIA GPU.

    python3 scripts/torch_step_profile.py [--model graphsage_supervised]
        [--aggregator mean] [--feature_dtype bfloat16] [--alias]
        [--walk_p 1 --walk_q 1] [--steps 20] [--top 15]

``--model graphsage_supervised`` (the default, the ppi recipe) and
``--model graphsage`` build the full synthetic PPI graph and train, at
full width (dim 256, batch 512, fanouts [10, 10], Adam 0.01),
``SupervisedGraphSage`` or the unsupervised ``GraphSage`` with
``run_loop --model graphsage``'s defaults (5 negatives, concat, sigmoid
cross-entropy). ``--model reddit`` trains ``bench.py``'s reddit recipe
(batch 1,000, fanouts [4, 4], dim 64, Adam 0.03, 602 features, 41
one-hot labels) on the synthetic Reddit graph; with ``--feature_dtype
bfloat16`` its feature table is bfloat16 (reddit_bf16), and with
``--alias`` it runs on the power-law graph ``REDDIT_HEAVYTAIL`` over
alias tables (reddit_heavytail). ``--model node2vec`` trains ``Node2Vec``
with ``run_loop --model node2vec --device_sampling``'s defaults (dim 256,
id embeddings, walk_len 5, windows 5/5, 15,360 roots a step, 5
negatives, sigmoid cross-entropy, Adam 0.01) on the PPI graph, biased
with ``--walk_p``/``--walk_q`` (over the sorted slab), and with
``--alias`` on ``REDDIT_HEAVYTAIL`` over sorted alias tables;
``--model line`` trains ``LINE`` (order 1, 512 roots) on the PPI graph.
``--model gcn`` trains ``SupervisedGCN`` with ``run_loop --model gcn
--device_sampling``'s defaults (dim 256, metapath [[0], [0]], caps
[5,120, 51,200], batch 512, Adam 0.01) on the PPI graph, its roots drawn
by ``sample_node`` over node type 0 each step (the model builds no roots
sampler); ``--model scalable_gcn`` trains ``ScalableGCN`` (2 layers, dim
256, slab rows of 10, store lr 0.001) through ``make_scan_train``.
``--aggregator`` picks the aggregator of the GCN models (mean, gcn,
attention) and of the GraphSAGE models (mean, gcn, meanpool, maxpool).

Runs one warmup chunk of ``train.make_scan_train``, times one chunk, then
profiles one chunk with ``torch.profiler`` (CPU + CUDA activities).
Prints the card, the wall time per step with and without the profiler,
the device time per step summed over kernels, the kernel launches per
step, the device busy share (device time / profiled wall time), the
device time of the gathers (``index_select`` and indexing kernels) and
of the copies and dtype casts, the kernels by device time and, wherever
they rank, the port's own draw kernels; then the launches and device
time of one node-sampler draw alone, for the roots and (graphsage, the
walk models) the Philox negatives, (node2vec) of one walk alone, (gcn)
of one full-neighbor expansion alone, and (scalable_gcn) of the store
bookkeeping's ops alone at the step's shapes (the two store reads, the
zeroing, the scatter-add of the read gradients, the write-back).
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="graphsage_supervised",
                    choices=["graphsage_supervised", "graphsage", "reddit",
                             "node2vec", "line", "gcn", "scalable_gcn"])
    ap.add_argument("--aggregator", default="mean",
                    choices=["mean", "gcn", "attention", "meanpool",
                             "maxpool"])
    ap.add_argument("--feature_dtype", default=None,
                    help="the feature table's dtype, e.g. bfloat16")
    ap.add_argument("--alias", action="store_true",
                    help="reddit or node2vec on the power-law graph over "
                    "alias tables")
    ap.add_argument("--walk_p", type=float, default=1.0)
    ap.add_argument("--walk_q", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if args.alias and args.model not in ("reddit", "node2vec"):
        ap.error("--alias goes with --model reddit or node2vec")
    if (args.walk_p, args.walk_q) != (1.0, 1.0) and args.model != "node2vec":
        ap.error("--walk_p/--walk_q go with --model node2vec")
    gcn_family = args.model in ("gcn", "scalable_gcn")
    if args.aggregator in (("meanpool", "maxpool") if gcn_family
                           else ("attention",)):
        ap.error(f"--aggregator {args.aggregator} does not go with --model "
                 f"{args.model}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_profile: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import (PPI, REDDIT, REDDIT_HEAVYTAIL,
                                          build_powerlaw, build_synthetic)
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.graph import device as device_graph
    from euler_tpu_torch.models import (LINE, GraphSage, Node2Vec,
                                        ScalableGCN, SupervisedGCN,
                                        SupervisedGraphSage)

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; model {args.model}, "
          f"aggregator {args.aggregator}, "
          f"feature_dtype {args.feature_dtype}, alias {args.alias}, walk_p "
          f"{args.walk_p}, walk_q {args.walk_q}", flush=True)
    t0 = time.perf_counter()
    if args.model == "reddit":
        batch, lr = 1000, 0.03
        graph = Graph(**(build_powerlaw(**REDDIT_HEAVYTAIL) if args.alias
                         else build_synthetic(**REDDIT)))
        model = SupervisedGraphSage(
            label_idx=0, label_dim=REDDIT["label_dim"], metapath=[[0], [0]],
            fanouts=[4, 4], dim=64, feature_idx=1,
            feature_dim=REDDIT["feature_dim"], max_id=graph.max_node_id,
            device_features=True, device_sampling=True,
            feature_dtype=args.feature_dtype)
        if args.alias:
            model.set_sampling_options(alias=True)
    elif args.model in ("node2vec", "line"):
        graph = Graph(**(build_powerlaw(**REDDIT_HEAVYTAIL) if args.alias
                         else build_synthetic(**PPI)))
        common = dict(node_type=-1, edge_type=[0], max_id=graph.max_node_id,
                      dim=256, num_negs=5, xent_loss=True,
                      device_sampling=True)
        if args.model == "line":
            batch, lr = 512, 0.01
            model = LINE(order=1, **common)
        else:
            model = Node2Vec(walk_len=5, walk_p=args.walk_p,
                             walk_q=args.walk_q, left_win_size=5,
                             right_win_size=5, **common)
            batch, lr = 512 * model.batch_size_ratio, 0.01
            if args.alias:
                model.set_sampling_options(alias=True)
    elif gcn_family:
        batch, lr = 512, 0.01
        graph = Graph(**build_synthetic(**PPI))
        common = dict(label_idx=0, label_dim=121, dim=256,
                      aggregator=args.aggregator, feature_idx=1,
                      feature_dim=50, max_id=graph.max_node_id,
                      device_features=True, device_sampling=True,
                      feature_dtype=args.feature_dtype)
        if args.model == "gcn":
            model = SupervisedGCN(
                metapath=[[0], [0]], max_nodes_per_hop=[5120, 51200],
                max_edges_per_hop=[51200, 512000], **common)
        else:
            model = ScalableGCN(edge_type=[0], num_layers=2,
                                max_neighbors=10, train_node_type=0,
                                **common)
    else:
        batch, lr = 512, 0.01
        graph = Graph(**build_synthetic(**PPI))
        common = dict(metapath=[[0], [0]], fanouts=[10, 10], dim=256,
                      feature_idx=1, feature_dim=50,
                      aggregator=args.aggregator,
                      max_id=graph.max_node_id, device_features=True,
                      device_sampling=True, feature_dtype=args.feature_dtype)
        if args.model == "graphsage":
            model = GraphSage(node_type=0, edge_type=[0], num_negs=5,
                              concat=True, xent_loss=True, **common)
        else:
            model = SupervisedGraphSage(label_idx=0, label_dim=121, **common)
    print(f"graph {graph.num_nodes} nodes built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    state = model.init_state(graph, train.get_optimizer("adam", lr))
    if args.model == "gcn":
        sampler = device_graph.tensors(
            device_graph.build_node_sampler(graph, 0, graph.max_node_id),
            "cuda")
        scan = _roots_scan(model, sampler, args.steps, batch)
    else:
        sampler = state["consts"]["roots"]
        scan = train.make_scan_train(model, args.steps, batch)
    state, _ = scan(state, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = scan(state, 1)
    torch.cuda.synchronize()
    print(f"wall {(time.perf_counter() - t0) / args.steps * 1e3:.4f} "
          "ms/step (not profiled)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, losses = scan(state, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = _per_kernel(prof)
    device_us = sum(us for us, _ in per_kernel.values())
    launches = sum(n for _, n in per_kernel.values())
    print(f"wall {wall / args.steps * 1e3:.4f} ms/step (profiled), device "
          f"{device_us / args.steps / 1e3:.4f} ms/step summed over "
          f"{launches / args.steps:.1f} kernel launches/step, busy share "
          f"{device_us / 1e6 / wall:.4f}, final loss {float(losses[-1]):.5f}")
    for what, words in (("gathers (index_select, indexing)",
                         ("scatter_gather", "index_elementwise",
                          "indexSelect")),
                        ("copies and dtype casts", ("direct_copy",))):
        group = [(us, n) for name, (us, n) in per_kernel.items()
                 if any(w in name.split("(")[0] for w in words)]
        print(f"{what}: {sum(us for us, _ in group) / args.steps:.3f} device "
              f"us/step over {sum(n for _, n in group) / args.steps:.1f} "
              "launches/step")
    print(f"{'device us/step':>15} {'calls/step':>10}  kernel")
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    for name, (us, n) in top[:args.top]:
        print(f"{us / args.steps:15.3f} {n / args.steps:10.1f}  {name[:100]}")
    for name, (us, n) in top:  # the hand-written kernels, by their names
        if "fanout2_kernel" in name or "sample_neighbor_kernel" in name:
            print(f"{us / args.steps:15.3f} {n / args.steps:10.1f}  "
                  f"{name[:100]} (port kernel)")
    # the node samplers alone, at the step's shapes: the batch's roots
    # from the generator, and (graphsage) 5 negatives a root from Philox
    draws = {"roots": lambda: device_graph.sample_node(
        sampler, batch, generator=torch.Generator(device="cuda"))}
    if args.model == "graphsage":
        draws["negatives"] = lambda: device_graph.sample_node(
            sampler, 5 * batch, seed_words=device_graph.stream_words(1, 1))
    if args.model in ("node2vec", "line"):
        pairs = batch * getattr(model, "batch_size_ratio", 1)
        draws["negatives"] = lambda: device_graph.sample_node(
            sampler, 5 * pairs, seed_words=device_graph.stream_words(1, 1))
    if args.model == "node2vec":
        roots = device_graph.sample_node(
            sampler, batch, generator=torch.Generator(device="cuda"))
        draws["walk"] = lambda: state["module"]._walks(
            state["consts"]["adj"][state["module"].adj_key], roots,
            device_graph.stream_words(1, 0), None)
    if gcn_family:
        roots = device_graph.sample_node(
            sampler, batch, generator=torch.Generator(device="cuda"))
    if args.model == "gcn":
        module = state["module"]
        adjs = [state["consts"]["adj"][k] for k in module.hop_adj_keys]
        draws["expansion"] = lambda: device_graph.multi_hop_neighbor(
            adjs, roots, module.node_caps)
    if args.model == "scalable_gcn":
        draws["store bookkeeping"] = _store_ops(model, state, roots)
    for name, draw in draws.items():
        draw()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            draw()
            torch.cuda.synchronize()
        per = _per_kernel(prof)
        what = {"walk": "one walk",
                "expansion": "one multi_hop_neighbor expansion",
                "store bookkeeping": "the store bookkeeping's ops"}.get(
                    name, f"sample_node ({name})")
        print(f"{what}: {sum(n for _, n in per.values())} "
              f"launches, {sum(us for us, _ in per.values()):.3f} device us")
    return 0


def _roots_scan(model, sampler, steps: int, batch: int):
    """``make_scan_train``'s loop for a model whose consts carry no roots
    sampler: ``batch`` roots drawn by ``sample_node`` over ``sampler``
    each step, then ``model.make_train_step()``."""
    from euler_tpu_torch.graph import device as device_graph

    step = model.make_train_step()

    def scan(state, seed: int):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        losses = []
        for i in range(steps):
            roots = device_graph.sample_node(sampler, batch, generator=gen)
            losses.append(step(state, {"roots": roots,
                                       "seed": seed * steps + i})[0])
        return state, torch.stack(losses)

    return scan


def _store_ops(model, state, roots):
    """A callable running ScalableStoreModel's store bookkeeping alone on
    the state's stores at one batch's ids: the reads at the neighbors and
    the stale gradients at the nodes, the zeroing, the scatter-add of
    [neighbors, dim] gradients and the write-back of [nodes, dim] rows."""
    batch = model._expand_batch({"roots": roots}, state["consts"])
    node_ids = batch["node_ids"].long()
    neigh_ids = batch["neigh_ids"].long()
    dim = state["stores"][0].shape[1]
    g = torch.ones(neigh_ids.shape[0], dim, device="cuda")
    emb = torch.ones(node_ids.shape[0], dim, device="cuda")

    def ops():
        for s, gs in zip(state["stores"], state["grad_stores"]):
            s.index_select(0, neigh_ids)
            gs.index_select(0, node_ids)
            gs.index_fill_(0, node_ids, 0.0)
            gs.index_add_(0, neigh_ids, g)
            s.index_copy_(0, node_ids, emb)

    return ops


def _per_kernel(prof) -> dict:
    """{kernel name: [device us, launches]} of a profile: device-side
    events only (a CPU op carries its kernels' device time too), and no
    user annotations (the optimizer's range spans its kernels and the
    gaps between them)."""
    from torch.autograd import DeviceType

    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            per_kernel[e.name][0] += e.time_range.elapsed_us()
            per_kernel[e.name][1] += 1
    return per_kernel


if __name__ == "__main__":
    sys.exit(main())
