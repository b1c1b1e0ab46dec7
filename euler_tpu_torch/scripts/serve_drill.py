#!/usr/bin/env python
"""Closed-loop serving load drill (DEPLOY.md "Serving runbook");
counterpart of the JAX package's ``scripts/serve_drill.py``.

The capstone proof for serving: a trained checkpoint served over a
LIVE 2-shard graph cluster sustains a closed-loop client fleet with

  * bounded tail latency — exact p99 (SLOTracker window) under the
    configured SLO,
  * shedding under pressure — the tiny queue_cap forces BUSY rejects
    that clients absorb with retry+backoff; the drill asserts the
    `serve_busy_rejects` counter moved ON A LIVE SCRAPE (the frontend's
    `stats` op), not via in-process peeking,
  * bit-exact answers — a post-drill spot check pins served rows
    against EmbedServer.embed_direct (the no-batching reference path)
    for ids that just went through coalesced mixed-traffic batches,
  * zero worker deaths — every client thread completes its quota and
    the dispatcher/frontend shut down cleanly.

The model trains and serves on ``--device`` (``cuda`` unless ``cpu`` is
asked for; on the card each dispatch replays one captured CUDA graph).
Smoke mode (`--smoke`) runs a small planted graph, a short training run,
16 clients x 12 requests; the full drill scales all of it up. Exit code
is the verdict.

    python -m euler_tpu_torch.scripts.serve_drill [--smoke] [--device cpu]
"""

import argparse
import os
import random
import sys
import threading
import time

import numpy as np

NUM_SHARDS = 2


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="small/fast config")
    p.add_argument("--clients", type=int, default=16,
                   help="concurrent closed-loop clients (>= 16 is the "
                        "acceptance bar)")
    p.add_argument("--requests", type=int, default=40,
                   help="successful embeds each client must complete")
    p.add_argument("--num_nodes", type=int, default=2000)
    p.add_argument("--train_steps", type=int, default=30)
    p.add_argument("--slo_ms", type=float, default=2000.0,
                   help="p99 bound asserted at the end (generous: the "
                        "drill runs on whatever host it is given)")
    p.add_argument("--queue_cap", type=int, default=4,
                   help="tiny on purpose: the drill must *provoke* "
                        "shedding, not avoid it")
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_us", type=int, default=2000)
    p.add_argument("--device", default="cuda",
                   help="where the model trains and serves (cuda unless "
                        "cpu)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.smoke:
        args.clients = max(args.clients, 16)
        args.requests = min(args.requests, 12)
        args.num_nodes = min(args.num_nodes, 400)
        args.train_steps = min(args.train_steps, 12)

    import shutil
    import tempfile

    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.checkpoint import Checkpointer
    from euler_tpu_torch.datasets import build_planted
    from euler_tpu_torch.device import resolve_device
    from euler_tpu_torch.graph import Graph, GraphService
    from euler_tpu_torch.models import SupervisedGraphSage
    from euler_tpu_torch.serving import (BusyError, DeadlineError,
                                         EmbedClient)

    dev = resolve_device(args.device)

    t_start = time.monotonic()
    failures: list = []

    def check(ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            failures.append(what)

    tmp = tempfile.mkdtemp(prefix="serve_drill_")
    data = os.path.join(tmp, "data")
    reg = os.path.join(tmp, "reg")
    ckpt_dir = os.path.join(tmp, "ckpt")
    os.makedirs(reg)
    k_comm, fdim = 4, 8
    build_planted(
        data, num_nodes=args.num_nodes, num_communities=k_comm,
        feature_dim=fdim, avg_degree=8, num_partitions=NUM_SHARDS,
        seed=23,
    )

    print(f"== serve drill: {args.clients} clients x {args.requests} "
          f"requests over a live {NUM_SHARDS}-shard cluster ==")

    # ---- train -> checkpoint (the artifact being served) ----
    local = Graph(directory=data)
    model = SupervisedGraphSage(
        label_idx=0, label_dim=k_comm, metapath=[[0], [0]],
        fanouts=[5, 5], dim=16, feature_idx=1, feature_dim=fdim,
        max_id=args.num_nodes - 1, sigmoid_loss=False,
    )
    train_lib.train(
        model, local, lambda s: local.sample_node(64, -1),
        num_steps=args.train_steps, learning_rate=0.01,
        checkpoint_dir=ckpt_dir, checkpoint_every=args.train_steps,
        log_every=10_000, seed=5, device=dev,
    )
    local.close()

    # ---- live 2-shard cluster + remote serving graph ----
    services = [
        GraphService(data, s, NUM_SHARDS, registry=reg)
        for s in range(NUM_SHARDS)
    ]
    server = frontend = remote = None
    try:
        remote = Graph(mode="remote", registry=reg, retries=4)

        # restore into a FRESH state structure: the drill must prove the
        # served params came off disk, not out of the training process
        from euler_tpu_torch.serve import EmbedServer
        from euler_tpu_torch.serving import EmbedFrontend

        state = model.init_state(
            remote, train_lib.get_optimizer("adam", 0.01), device=dev,
            seed=99,
        )
        state = Checkpointer(ckpt_dir).restore(state)
        server = EmbedServer(
            model, remote, state, max_batch=args.max_batch,
            max_wait_us=args.max_wait_us, queue_cap=args.queue_cap,
            slo_ms=args.slo_ms,
        ).start()
        frontend = EmbedFrontend(server, port=0,
                                 max_conns=args.clients + 4)
        # capture the fixed-bucket forward OUTSIDE the SLO window
        # (embed_direct skips the batcher, so capture time never lands
        # in a served request's tail)
        server.embed_direct(0)

        # ---- the storm: closed-loop clients with retry+backoff ----
        results: dict = {}

        def client(cid: int) -> None:
            rng = random.Random(1000 + cid)
            c = EmbedClient(frontend.address)
            done = busy_retries = 0
            try:
                while done < args.requests:
                    ids = [rng.randrange(args.num_nodes)
                           for _ in range(rng.randint(1, 4))]
                    try:
                        rows = c.embed(ids)
                    except BusyError:
                        busy_retries += 1
                        time.sleep(0.002 * min(busy_retries, 10))
                        continue
                    except DeadlineError:
                        continue
                    assert rows.shape == (len(ids), 16)
                    done += 1
                results[cid] = busy_retries
            finally:
                c.close()

        threads = [
            threading.Thread(target=client, args=(i,), daemon=True)
            for i in range(args.clients)
        ]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.monotonic() - t0

        # ---- verdict, against a LIVE scrape ----
        scrape = EmbedClient(frontend.address)
        stats = scrape.stats()
        slo = stats["slo"]
        ctr = stats["counters"]
        total = args.clients * args.requests
        print(f"  served {slo['count']} requests in {wall:.1f}s "
              f"({slo['count'] / max(wall, 1e-9):.0f} rps), "
              f"p50={slo['p50_ms']}ms p99={slo['p99_ms']}ms, "
              f"busy_rejects={ctr.get('serve_busy_rejects', 0)}, "
              f"batches={ctr.get('serve_batches', 0)} "
              f"(mean {stats['batch'].get('mean_unique_ids', 0)} "
              f"unique ids)")
        check(len(results) == args.clients,
              f"zero client deaths ({len(results)}/{args.clients} "
              "completed their quota)")
        check(slo["count"] >= total,
              f"all {total} requests served (slo count {slo['count']})")
        check(slo["p99_ms"] <= args.slo_ms,
              f"p99 {slo['p99_ms']}ms within SLO {args.slo_ms}ms")
        check(ctr.get("serve_busy_rejects", 0) > 0,
              "shedding provoked and visible on the live scrape "
              f"(serve_busy_rejects={ctr.get('serve_busy_rejects', 0)})")
        check(ctr.get("serve_batches", 1) < ctr.get("serve_requests", 0),
              "micro-batching coalesced (fewer dispatches than requests)")

        # bit-parity spot check: ids that just flowed through coalesced
        # mixed batches must equal the no-batching reference path
        spot = [1, args.num_nodes // 2, args.num_nodes - 1]
        served = scrape.embed(spot)
        direct = np.stack([server.embed_direct(i) for i in spot])
        check(served.dtype == direct.dtype
              and np.array_equal(served, direct),
              "served embeddings bit-identical to direct forward")
        scrape.close()
    finally:
        if frontend is not None:
            frontend.drain(grace_s=2.0)
        if server is not None:
            server.close()
        if frontend is not None:
            frontend.stop()
        if remote is not None:
            remote.close()
        for s in services:
            s.drain()
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"== serve drill {'FAIL' if failures else 'OK'} "
          f"({time.monotonic() - t_start:.1f}s) ==")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
