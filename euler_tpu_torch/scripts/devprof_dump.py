#!/usr/bin/env python3
"""Device-plane report: compile economics, recompile ledger, memory
high-water, and the top-K kernels of a ``torch.profiler`` capture
(counterpart of the JAX package's ``scripts/devprof_dump.py``).

Three input modes, combinable (OBSERVABILITY.md "Device plane"):

  * ``--profile_dir DIR`` — read a ``torch.profiler`` capture (the
    training run's ``--profile_dir``, ``*.pt.trace.json``) and print the
    top-K device kernels by total self time, plus the lane inventory; a
    capture with no device lane (a CPU run) lists its host ops instead;
  * ``--registry`` / ``--shards`` — scrape a live cluster and print
    each shard's compile table (compiles, recompiles, compile wall,
    transfer volume, device-memory high-water) and serve SLO gauges;
  * ``--smoke`` — self-contained drill on ``--device``: a few
    supervised GraphSAGE steps at ppi's widths with the fanout drawn on
    the device (B1, ``sample_fanout2``, once a step), a watched step
    given a drifted batch shape, asserting exactly one journaled
    recompile with the offending diff, a profiler capture around it,
    the merged host+device export validated and, on the card, B1 in the
    kernel table as many times as its launch counter rose.

The port's compiles are its kernel builds and the serving bucket's
CUDA-graph captures (``devprof.py``), and a watched callable's first
call at each new signature.

Usage:
    python -m euler_tpu_torch.scripts.devprof_dump --profile_dir /tmp/prof
    python -m euler_tpu_torch.scripts.devprof_dump --registry /shared/reg
    python -m euler_tpu_torch.scripts.devprof_dump --smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

# the smoke's model: SupervisedGraphSage at ppi's widths (feature 50,
# 121 labels, dim 256, fanouts [10, 10], batch 512), drawn on the device
SMOKE_BATCH = 512
SMOKE_DRIFT_BATCH = 384
SMOKE_STEPS = 5  # in-bucket steps inside the capture, before the drift
SMOKE_TOPK = 50
# B1's symbol in a capture (csrc/sample_fanout2.cu)
B1_SYMBOL = "fanout2_kernel"


def _host_op_slices(profile_dir: str) -> list:
    """The host ops ("cpu_op" complete events) of the newest capture in
    ``profile_dir``, for a capture that has no device lane."""
    from euler_tpu_torch import trace as trace_mod

    path = trace_mod._latest_profiler_trace(profile_dir)
    if path is None:
        return []
    try:
        events, offset = trace_mod.load_profiler_trace(path)
    except Exception:
        return []
    offset = offset or 0.0
    return [{"name": e.get("name", "?"), "ph": "X", "pid": e.get("pid"),
             "ts": int(round(float(e["ts"]) + offset)),
             "dur": max(int(round(float(e.get("dur", 0)))), 0)}
            for e in events
            if e.get("ph") == "X" and "ts" in e
            and e.get("cat") == "cpu_op"]


def kernel_table(profile_dir: str, topk: int = 15) -> list:
    """Top-K device kernels by total self time from a capture; returns
    the aggregated (name, total_us, count) rows it printed. A capture
    with no device lane (the CPU's) gives its host ops the same way."""
    from euler_tpu_torch.trace import ingest_profiler_dir

    events = ingest_profiler_dir(profile_dir)
    slices = [e for e in events if e.get("ph") == "X"]
    kind = "device kernels"
    if not slices:
        slices = _host_op_slices(profile_dir)
        kind = "host ops, no device lane"
    if not slices:
        print(f"no device slices found under {profile_dir}")
        return []
    lanes = {e["pid"] for e in slices}
    agg: dict = defaultdict(lambda: [0, 0])
    for e in slices:
        agg[e["name"]][0] += e["dur"]
        agg[e["name"]][1] += 1
    rows = sorted(
        ((name, tot, cnt) for name, (tot, cnt) in agg.items()),
        key=lambda r: r[1], reverse=True,
    )[:topk]
    print(f"== {kind} ({len(slices)} slices, "
          f"{len(lanes)} lane(s)) ==")
    print(f"  {'kernel':40s} {'total_us':>10s} {'count':>7s} "
          f"{'avg_us':>9s}")
    for name, tot, cnt in rows:
        print(f"  {name[:40]:40s} {tot:10d} {cnt:7d} {tot / cnt:9.1f}")
    return rows


def compile_table(sources: list) -> None:
    """Per-source compile economics rows from telemetry dumps:
    [(label, dump_dict), ...] (a scrape, or this process's)."""
    from euler_tpu_torch import devprof

    print("== compile table ==")
    print(f"  {'source':10s} {'compiles':>8s} {'recomp':>6s} "
          f"{'serve_rc':>8s} {'compile_ms':>10s} {'p99_ms':>8s} "
          f"{'h2d_MB':>8s} {'d2h_MB':>8s} {'mem_peak_MB':>11s}")
    for label, data in sources:
        s = devprof.compile_summary(data)
        print(f"  {label:10s} {s['compiles']:8d} {s['recompiles']:6d} "
              f"{s['serve_recompiles']:8d} {s['compile_ms_total']:10.1f} "
              f"{s['compile_ms_p99']:8.1f} "
              f"{s['h2d_bytes'] / 1e6:8.1f} {s['d2h_bytes'] / 1e6:8.1f} "
              f"{s['device_mem_peak_bytes'] / 1e6:11.1f}")
        slo = data.get("serve_slo")
        if slo and slo.get("count"):
            print(f"  {label:10s} serve SLO: p50 "
                  f"{slo['p50_us'] / 1000.0:.1f}ms p99 "
                  f"{slo['p99_us'] / 1000.0:.1f}ms "
                  f"violations {slo['violations']}/{slo['count']}")


def ledger_table() -> None:
    """This process's journaled post-warmup recompiles."""
    from euler_tpu_torch import devprof

    led = devprof.recompile_ledger()
    if not led:
        return
    print(f"== recompile ledger ({len(led)}) ==")
    for e in led:
        print(f"  {e['fn']}: {'; '.join(e['diff'])} "
              f"(wall {e['wall_us'] / 1000.0:.1f}ms)")


def run_smoke(device=None) -> int:
    """Self-contained device-plane drill on ``device``; any failed check
    raises (exit non-zero)."""
    import tempfile

    import numpy as np
    import torch

    from euler_tpu_torch import devprof
    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch import trace as trace_mod
    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import PPI, build_synthetic
    from euler_tpu_torch.device import resolve_device
    from euler_tpu_torch.graph import MemoryGraph, sampling_kernels
    from euler_tpu_torch.models import SupervisedGraphSage

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    T.telemetry_reset()
    devprof.devprof_reset()
    devprof.install(device=dev)
    graph = MemoryGraph(**build_synthetic(**PPI))
    model = SupervisedGraphSage(
        label_idx=0, label_dim=PPI["label_dim"], metapath=[[0], [0]],
        fanouts=[10, 10], dim=256, feature_idx=1,
        feature_dim=PPI["feature_dim"], max_id=graph.max_node_id,
        device_features=True, device_sampling=True)
    state = model.init_state(graph, train.get_optimizer("adam", 0.01),
                             device=dev, seed=0)
    train_step = model.make_train_step()
    rng = np.random.default_rng(0)
    seeds = iter(range(1, 1 << 30))

    def batch(size):
        return model.device_sample_batch(
            rng.integers(0, graph.max_node_id + 1, size), next(seeds), dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    step = devprof.watch(lambda b: train_step(state, b)[0],
                         name="smoke_step")
    step(batch(SMOKE_BATCH))  # warmup: first compile, not a recompile
    sync()

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    prof_dir = tempfile.mkdtemp(prefix="euler_devprof_smoke_")
    before = sampling_kernels.launches["sample_fanout2"]
    losses = []
    t0 = trace_mod.now_us()
    with profile(activities=acts) as prof:
        with trace_mod.align_annotation():
            pass
        for _ in range(SMOKE_STEPS):  # in-bucket: no compile
            losses.append(step(batch(SMOKE_BATCH)))
        # injected shape drift: the classic silent recompile, detected
        # loudly
        losses.append(step(batch(SMOKE_DRIFT_BATCH)))
        sync()
    t1 = trace_mod.now_us()
    launched = sampling_kernels.launches["sample_fanout2"] - before
    prof.export_chrome_trace(os.path.join(prof_dir, "smoke.pt.trace.json"))

    devprof.sample_device_mem()
    s = devprof.compile_summary()
    assert s["recompiles"] == 1, s
    assert s["compiles"] >= 2, s  # warmup + drift at minimum
    led = devprof.recompile_ledger()
    assert len(led) == 1 and led[0]["fn"] == "smoke_step", led
    assert any("->" in d for d in led[0]["diff"]), led
    assert s["device_mem_bytes"] > 0 and s["device_buffers"] > 0, s
    assert all(np.isfinite(float(x)) for x in losses), losses

    # merged export: device lanes present, time-aligned, valid (the
    # CPU's capture has no device lane)
    events = trace_mod.ingest_profiler_dir(prof_dir)
    xs = [e for e in events if e.get("ph") == "X"]
    if on_card:
        assert xs, "no device slices ingested"
        assert all(e["pid"] >= trace_mod.PID_DEVICE_BASE for e in xs), \
            xs[:3]
        pad = 2_000_000  # capture bracketing slack, us
        aligned = [e for e in xs if t0 - pad <= e["ts"] <= t1 + pad]
        assert len(aligned) == len(xs), (len(aligned), len(xs))
    trace = trace_mod.chrome_trace(base_events=events)
    trace_mod.validate_chrome_trace(trace)

    compile_table([("local", T.telemetry_json())])
    ledger_table()
    rows = kernel_table(prof_dir, topk=SMOKE_TOPK)
    assert rows and all(len(r) == 3 and r[2] > 0 for r in rows), rows
    b1 = [r for r in rows if B1_SYMBOL in r[0]]
    if on_card:
        # B1 in the table once per launch of the window, as counted by
        # its wrapper
        assert launched == SMOKE_STEPS + 1, launched
        assert len(b1) == 1 and b1[0][2] == launched, (b1, launched)
        print(f"B1 ({B1_SYMBOL}): {b1[0][2]} kernel events, "
              f"{b1[0][1]} us in the capture; sample_fanout2 launches "
              f"+{launched} over the window")
    else:
        assert launched == 0, launched  # the CPU draws the plain version
    # this process's launches, as run_loop logs them at exit
    print("kernel launches " + json.dumps(
        {**sampling_kernels.launches, **sampling_kernels.sharded_launches}))
    print("devprof_dump smoke: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--profile_dir", default="", help=(
        "torch.profiler capture directory (the run's --profile_dir) "
        "for the top-K kernel table"))
    ap.add_argument("--topk", type=int, default=15,
                    help="kernel rows to print")
    ap.add_argument("--registry", default="", help=(
        "registry dir or tcp://host:port — scrape the live cluster's "
        "compile tables"))
    ap.add_argument("--shards", default="",
                    help="explicit comma-separated host:port shard list")
    ap.add_argument("--timeout_ms", type=int, default=3000)
    ap.add_argument("--smoke", action="store_true", help=(
        "self-contained recompile + merged-trace drill"))
    ap.add_argument("--device", default="cuda", help=(
        "where --smoke trains (cuda unless cpu is asked for)"))
    args = ap.parse_args(argv)

    if args.smoke:
        return run_smoke(args.device)
    if not args.profile_dir and not args.registry and not args.shards:
        ap.error("need --profile_dir, --registry/--shards, or --smoke")

    if args.registry or args.shards:
        from euler_tpu_torch import telemetry as T
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
            compile_table([
                (f"shard {s}", T.scrape(g, s))
                for s in range(g.num_shards)
            ])
        finally:
            g.close()
    if args.profile_dir:
        kernel_table(args.profile_dir, topk=args.topk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
