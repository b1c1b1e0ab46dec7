#!/usr/bin/env python3
"""Export a merged Chrome-trace/Perfetto JSON from a live euler_tpu_torch
cluster (and/or an existing run trace); counterpart of the JAX package's
``scripts/trace_dump.py``.

`run_loop --trace_file=` already writes the full merged trace for a
training run it owns. This is the standalone tool for everything else:

  * scrape a LIVE cluster's slow-span journals (server side of every
    shard) into a trace you can open in ui.perfetto.dev;
  * `--input run_trace.json` merges a trace written earlier by
    run_loop (phase slices + the client journal) with a fresh scrape —
    e.g. to re-pull shard journals after the training client exited;
  * `--smoke` spins a tiny in-process 2-shard cluster, drives traffic
    through an instrumented ``prefetch.pipeline`` loop whose batches go
    to ``--device``, exports, and asserts the result is valid
    Chrome-trace JSON whose client/server slow-span slices share wire-v3
    trace ids.

Each process lands on its own pid lane (train = 1, shard s = 100+s);
client-call -> server-handler arrows are flow events keyed by the
wire-v3 trace id, so a slow step is followable from the consumer stall
to the exact shard handler regardless of clock skew.

Usage:
    python -m euler_tpu_torch.scripts.trace_dump --registry R --out t.json
    python -m euler_tpu_torch.scripts.trace_dump --shards h1:9001,h2:9001 \\
        --out t.json
    python -m euler_tpu_torch.scripts.trace_dump --input run_trace.json \\
        --registry /shared/reg --out merged.json
    python -m euler_tpu_torch.scripts.trace_dump --smoke [--device cpu]

See OBSERVABILITY.md "Step phases" for the triage runbook.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def export(graph=None, base_events=None, include_local=False) -> dict:
    """Build the merged trace dict: optional pre-existing events +
    (optionally) this process's journal + every reachable shard's."""
    from euler_tpu_torch import trace as TR

    sources = []
    if include_local:
        sources = TR.gather_span_sources(None)
    if graph is not None:
        from euler_tpu_torch import telemetry as T

        for s in range(graph.num_shards):
            try:
                sources.append(
                    (T.scrape(graph, s), TR.PID_SHARD_BASE + s,
                     f"shard {s}")
                )
            except Exception as e:
                print(f"shard {s}: scrape failed ({e}); skipped",
                      file=sys.stderr)
    return TR.chrome_trace(None, sources, base_events)


def run_smoke(device=None) -> int:
    """Self-contained export check: tiny 2-shard cluster, a training-
    shaped loop through ``parallel.prefetch.pipeline`` (async fanouts
    submitted two steps ahead, each batch's features uploaded to
    ``device``) with a seeded handler stall so slow spans exist on both
    sides, then assert the merged trace is valid and correlated; any
    failed check raises (exit non-zero)."""
    import shutil
    import tempfile

    import torch

    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch import trace as TR
    from euler_tpu_torch.device import resolve_device
    from euler_tpu_torch.graph import Graph, GraphService, native
    from euler_tpu_torch.parallel import pipeline
    from euler_tpu_torch.scripts.powerlaw import build_powerlaw_fixture

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="euler_trace_smoke_")
    svcs = []
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        build_powerlaw_fixture(data, 120, 6, 8)
        svcs = [GraphService(data, s, 2) for s in range(2)]
        g = Graph(
            mode="remote", shards=[s.address for s in svcs],
            retries=2, timeout_ms=5000,
        )
        try:
            T.telemetry_reset()
            recorder = TR.TraceRecorder().start()
            # a seeded 5 ms handler stall guarantees both journals hold
            # the SAME requests (slow enough to beat the journal floor)
            native.fault_config("handler_stall:delay@5", 11)
            try:
                def start_batch(step):
                    roots = g.sample_node(8, -1)
                    return roots, g.sample_fanout_async(
                        roots, [[0, 1]], [3], -1)

                def finish_batch(step, pending):
                    roots, handle = pending
                    hops = (handle.take()[0] if handle is not None
                            else g.sample_fanout(roots, [[0, 1]], [3])[0])
                    ids = np.concatenate(hops)
                    return torch.as_tensor(
                        g.get_dense_feature(ids, [0], [8]), device=dev)

                total = 0.0
                for feats in pipeline(start_batch, finish_batch, 4,
                                      depth=2):
                    total += float(feats.sum())
            finally:
                native.fault_clear()
                recorder.stop()
            out = os.path.join(tmp, "trace.json")
            TR.write_trace(out, recorder, g)
            with open(out) as f:
                reread = json.load(f)
            events = TR.validate_chrome_trace(reread)
            phases = {e["name"] for e in events
                      if e.get("cat") == "phase"}
            assert {"input_stall", "sample"} <= phases, phases
            correlated = TR.correlated_trace_ids(reread)
            assert correlated, "no client/server trace-id pair in the " \
                "merged trace"
            pids = {e["pid"] for e in events}
            assert {TR.PID_TRAIN, TR.PID_SHARD_BASE,
                    TR.PID_SHARD_BASE + 1} <= pids, pids
            assert np.isfinite(total), total
            print(f"trace_dump smoke: OK ({len(events)} events, "
                  f"{len(correlated)} correlated trace ids, batches on "
                  f"{dev})")
            return 0
        finally:
            g.close()
    finally:
        for s in svcs:
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--registry", default="", help=(
        "registry dir or tcp://host:port the cluster registered with"))
    ap.add_argument("--shards", default="", help=(
        "explicit comma-separated host:port shard list"))
    ap.add_argument("--input", default="", help=(
        "existing Chrome-trace JSON (e.g. run_loop --trace_file output) "
        "to merge the scraped spans into"))
    ap.add_argument("--out", default="", help=(
        "output path (default: stdout)"))
    ap.add_argument("--timeout_ms", type=int, default=3000)
    ap.add_argument("--smoke", action="store_true", help=(
        "self-contained export check against a tiny in-process "
        "cluster"))
    ap.add_argument("--device", default="cuda", help=(
        "where --smoke's batches go (cuda unless cpu is asked for)"))
    args = ap.parse_args(argv)

    if args.smoke:
        return run_smoke(args.device)
    if not (args.registry or args.shards or args.input):
        ap.error("need --registry, --shards, or --input (or --smoke)")

    base_events = None
    if args.input:
        from euler_tpu_torch.trace import validate_chrome_trace

        with open(args.input) as f:
            base_events = validate_chrome_trace(json.load(f))

    g = None
    if args.registry or args.shards:
        from euler_tpu_torch.graph import Graph

        g = Graph(
            mode="remote",
            registry=args.registry or None,
            shards=args.shards.split(",") if args.shards else None,
            retries=2,
            timeout_ms=args.timeout_ms,
            rediscover_ms=0,
        )
    try:
        trace = export(g, base_events)
    finally:
        if g is not None:
            g.close()
    text = json.dumps(trace)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"{len(trace['traceEvents'])} events -> {args.out} "
              "(open in ui.perfetto.dev)", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
