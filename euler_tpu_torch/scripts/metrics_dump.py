#!/usr/bin/env python3
"""Scrape a running euler_tpu_torch cluster's telemetry and pretty-print it
(counterpart of the JAX package's ``scripts/metrics_dump.py``).

Connects a remote client to a live cluster (registry dir, tcp://
registry, or an explicit shard list), scrapes every shard over the
STATS wire opcode (eg_telemetry), and prints per shard:

  * admission gauges — handler pool size, workers busy, queue depth,
    open connections, draining flag (the shard's survivability state an
    operator previously had to shell into the host to see);
  * per-op server handler latency: count + p50/p90/p99 µs from the
    log2-bucketed histograms;
  * non-zero counters (FAULTS.md glossary);
  * the shard's slowest spans with their trace ids.

With `--watch N` it re-scrapes every N seconds and prints per-interval
RATES (requests served /s, counter movement /s) next to the live
gauges — the at-a-glance view for watching a rolling restart or a load
drill without a Prometheus stack; `--raw` restores raw cumulative
counter values. A transiently unreachable shard (mid-restart,
crashed, draining) is skipped-and-noted, never aborts the watch; its
deltas resume from the last good scrape once it answers again.
Step-phase histograms (OBSERVABILITY.md "Step phases") print whenever
a scraped process has recorded any — shard
services normally haven't (phases live in the training client), but an
in-process cluster or a future co-located trainer shows them here.

Usage:
    python -m euler_tpu_torch.scripts.metrics_dump --registry /shared/reg
    python -m euler_tpu_torch.scripts.metrics_dump --shards h1:9001,h2:9001
    python -m euler_tpu_torch.scripts.metrics_dump --registry R --watch 5
    python -m euler_tpu_torch.scripts.metrics_dump --registry tcp://h:91 --json
    python -m euler_tpu_torch.scripts.metrics_dump --smoke   # self-contained
                                               # check (spins a tiny
                                               # 2-shard cluster)

See OBSERVABILITY.md for the runbook (watching a rolling restart
through this scrape included); the README lists the port's commands.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def dump_cluster(graph, as_json: bool = False) -> list:
    """Scrape every shard; print and return the per-shard dicts."""
    from euler_tpu_torch import telemetry as T

    shards = []
    for s in range(graph.num_shards):
        data = T.scrape(graph, s)
        shards.append(data)
        if as_json:
            continue
        g = data.get("gauges", {})
        print(f"== shard {data['shard']} ==")
        print(
            f"  workers {g.get('workers', '?')}"
            f" busy {g.get('workers_active', '?')}"
            f" queue {g.get('queue_depth', '?')}"
            f" conns {g.get('conns', '?')}"
            f" draining {g.get('draining', '?')}"
            f" epoch {g.get('epoch', 0)}"
        )
        rows = [
            (key.split(":", 1)[1], h)
            for key, h in sorted(data["hist"].items())
            if key.startswith("server_handler:") and h["count"] > 0
        ]
        if rows:
            print(f"  {'op':22s} {'count':>8s} {'p50_us':>10s} "
                  f"{'p90_us':>10s} {'p99_us':>10s}")
            for op, h in rows:
                pct = T.percentiles(h)
                print(f"  {op:22s} {h['count']:8d} {pct[50]:10.1f} "
                      f"{pct[90]:10.1f} {pct[99]:10.1f}")
        else:
            print("  no handler latency samples yet")
        ph_rows = [
            (key.split(":", 1)[1], h)
            for key, h in sorted(data["hist"].items())
            if key.startswith("phase:") and h["count"] > 0
        ]
        if ph_rows:
            print(f"  {'phase':22s} {'count':>8s} {'p50_us':>10s} "
                  f"{'p90_us':>10s} {'p99_us':>10s}")
            for ph, h in ph_rows:
                pct = T.percentiles(h)
                print(f"  {ph:22s} {h['count']:8d} {pct[50]:10.1f} "
                      f"{pct[90]:10.1f} {pct[99]:10.1f}")
        sv_rows = [
            (key.split(":", 1)[1], h)
            for key, h in sorted(data["hist"].items())
            if key.startswith("serve:") and h["count"] > 0
        ]
        if sv_rows:
            print(f"  {'serve':22s} {'count':>8s} {'p50_us':>10s} "
                  f"{'p90_us':>10s} {'p99_us':>10s}")
            for ph, h in sv_rows:
                pct = T.percentiles(h)
                print(f"  {ph:22s} {h['count']:8d} {pct[50]:10.1f} "
                      f"{pct[90]:10.1f} {pct[99]:10.1f}")
        sb = data["hist"].get("serve_batch", {})
        if sb.get("count"):
            print(f"  serve_batch: {sb['count']} dispatches, "
                  f"{sb['sum_us'] / sb['count']:.1f} unique ids/dispatch")
        nonzero = {k: v for k, v in data["counters"].items() if v}
        if nonzero:
            print(f"  counters: {nonzero}")
        # device plane (OBSERVABILITY.md "Device plane"): compile
        # economics + memory high-water + transfer volume, whenever the
        # scraped process has recorded any
        res = data.get("resource", {})
        c = data["counters"]
        if (c.get("device_compiles") or c.get("device_recompiles")
                or res.get("device_mem_peak_bytes")):
            ch = data["hist"].get("phase:compile") or {"count": 0,
                                                       "sum_us": 0}
            print(
                f"  device: {c.get('device_compiles', 0)} compiles "
                f"({ch['sum_us'] / 1000.0:.0f} ms), "
                f"{c.get('device_recompiles', 0)} recompiles, "
                f"{c.get('serve_recompiles', 0)} serve recompiles, "
                f"mem {res.get('device_mem_bytes', 0) / 1e6:.1f}MB "
                f"(peak {res.get('device_mem_peak_bytes', 0) / 1e6:.1f}MB"
                f", {res.get('device_buffers', 0)} buffers), "
                f"h2d {c.get('h2d_bytes', 0) / 1e6:.1f}MB "
                f"d2h {c.get('d2h_bytes', 0) / 1e6:.1f}MB"
            )
        for sp in data["slow_spans"][:5]:
            print(f"  slow: {sp['op']:20s} {sp['total_us']:>9d}us "
                  f"queue={sp['queue_us']} handler={sp['handler_us']} "
                  f"wire={sp['wire_us']} outcome={sp['outcome']} "
                  f"trace={int(sp['trace']):#x}")
    if as_json:
        print(json.dumps(shards))
    return shards


def _served_total(data: dict) -> int:
    return sum(
        h["count"] for key, h in data["hist"].items()
        if key.startswith("server_handler:")
    )


def watch_cluster(graph, every_s: float, iterations: int | None = None,
                  out=sys.stdout, raw: bool = False) -> None:
    """Re-scrape every `every_s` seconds, printing per-shard RATES
    (requests served /s and counter movement /s over the interval since
    the shard's last good scrape) next to the live admission gauges —
    a cumulative counter's absolute value says nothing at a glance; its
    rate is what an operator watches move. `raw=True` (--raw) prints
    the raw cumulative counter values instead. iterations=None runs
    until interrupted (the CLI); tests pass a bound."""
    from euler_tpu_torch import telemetry as T

    prev: dict = {}
    unreachable: set = set()
    n = 0
    while iterations is None or n < iterations:
        if n:
            time.sleep(every_s)
        stamp = time.strftime("%H:%M:%S")
        for s in range(graph.num_shards):
            try:
                data = T.scrape(graph, s)
            except Exception as e:
                # a transiently unreachable shard is ROUTINE during a
                # rolling restart (DEPLOY.md drill): skip-and-note, keep
                # watching the rest — the watch must outlive the blip.
                # prev[s] is kept, so rates resume from the last good
                # scrape when the shard comes back.
                unreachable.add(s)
                print(f"[{stamp}] shard {s}: unreachable — skipped "
                      f"({type(e).__name__}: {e})", file=out)
                continue
            if s in unreachable:
                unreachable.discard(s)
                print(f"[{stamp}] shard {s}: reachable again", file=out)
            now = time.monotonic()
            served = _served_total(data)
            ctr = {k: v for k, v in data["counters"].items() if v}
            last = prev.get(s, {})
            dt = now - last.get("t", now)
            d_served = served - last.get("served", 0)
            d_ctr = {
                k: v - last.get("ctr", {}).get(k, 0)
                for k, v in ctr.items()
            }
            d_ctr = {k: v for k, v in d_ctr.items() if v}
            # transfer volume reads as a bandwidth, not a raw delta
            h2d, d2h = d_ctr.pop("h2d_bytes", 0), d_ctr.pop("d2h_bytes", 0)
            g = data.get("gauges", {})
            line = (f"[{stamp}] shard {s}: served +{d_served}"
                    f"{_rate(d_served, dt)} "
                    f"busy {g.get('workers_active', '?')} "
                    f"queue {g.get('queue_depth', '?')} "
                    f"conns {g.get('conns', '?')} "
                    f"draining {g.get('draining', '?')} "
                    # current serving snapshot epoch (eg_epoch.h): during
                    # a rolling graph refresh (DEPLOY.md) the operator
                    # watches this tick up shard by shard
                    f"epoch {g.get('epoch', 0)}")
            res = data.get("resource", {})
            if res.get("device_mem_peak_bytes"):
                line += (f" dev_mem {res.get('device_mem_bytes', 0) / 1e6:.0f}"
                         f"/{res['device_mem_peak_bytes'] / 1e6:.0f}MB")
            if not raw and (h2d or d2h) and dt > 0:
                line += (f" h2d {h2d / dt / 1e6:.1f}MB/s "
                         f"d2h {d2h / dt / 1e6:.1f}MB/s")
            # input-stall rate: the sampler pipeline's acceptance metric as a
            # live column — a shared-mode training process exposes its
            # phase hists in the same scrape; mean stall per step over
            # THIS interval, so a pipeline losing the race shows up as
            # the number moving, not as a diluted lifetime mean
            ih = data.get("hist", {}).get("phase:input_stall")
            if not raw and ih and ih.get("count"):
                lst = last.get("stall", {"count": 0, "sum_us": 0})
                dc = ih["count"] - lst["count"]
                ds = ih["sum_us"] - lst["sum_us"]
                if dc > 0:
                    line += (f" input_stall {ds / dc / 1000:.2f}ms/step"
                             f"{_rate(dc, dt)}")
            if raw:
                if ctr:
                    line += f"  counters {ctr}"
            elif d_ctr:
                rates = {
                    k: round(v / dt, 1) if dt > 0 else float(v)
                    for k, v in d_ctr.items()
                }
                line += f"  Δcounters/s {rates}"
            print(line, file=out)
            prev[s] = {
                "served": served, "ctr": ctr, "t": now,
                "stall": {
                    "count": ih["count"] if ih else 0,
                    "sum_us": ih["sum_us"] if ih else 0,
                },
            }
        out.flush()
        n += 1


def _rate(delta: int, dt: float) -> str:
    """Render ' (N/s)' for a per-interval delta; empty on the first
    scrape of a shard (no interval to rate over yet)."""
    if dt <= 0:
        return ""
    return f" ({delta / dt:.1f}/s)"


def run_smoke() -> int:
    """Self-contained scrape check: tiny 2-shard in-process cluster,
    a little traffic, then assert the scrape agrees with the wire's
    ground truth; any failed check raises (exit non-zero)."""
    import shutil
    import tempfile

    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch.graph import Graph, GraphService
    from euler_tpu_torch.scripts.powerlaw import build_powerlaw_fixture

    tmp = tempfile.mkdtemp(prefix="euler_metrics_smoke_")
    svcs = []
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        build_powerlaw_fixture(data, 120, 6, 8)
        svcs = [GraphService(data, s, 2) for s in range(2)]
        g = Graph(
            mode="remote", shards=[s.address for s in svcs],
            retries=2, timeout_ms=2000,
        )
        try:
            T.telemetry_reset()
            steps = 4
            for _ in range(steps):
                roots = g.sample_node(16, -1)
                g.sample_fanout(roots, [[0, 1], [0, 1]], [3, 3])
                g.get_dense_feature(roots, [0], [8])
            shards = dump_cluster(g)
            assert len(shards) == 2, shards
            for data_s in shards:
                assert "gauges" in data_s and data_s["gauges"]["workers"] > 0
                served = sum(
                    h["count"] for key, h in data_s["hist"].items()
                    if key.startswith("server_handler:")
                )
                assert served > 0, data_s["hist"]
            # in-process shards: the scrape and the local dump read the
            # same globals — numbers must be identical where the scrape
            # itself doesn't add samples (the stats op records AFTER its
            # reply is built, so compare a family the scrape never touches)
            local = T.telemetry_json()["hist"]
            for data_s in shards[-1:]:
                key = "server_handler:sample_node"
                assert data_s["hist"][key]["b"] == local[key]["b"], key
            # client side saw every op too
            spans = T.slow_spans()
            assert spans and any(s["side"] == "client" for s in spans)
            # the --watch rate path against the same live cluster
            # (after the parity pins — watching adds scrape traffic):
            # a second interval must carry /s rates (the first scrape
            # of a shard has no interval to rate over), and --raw must
            # fall back to cumulative counter values
            import io

            # in-process shards share the client's phase globals, so a
            # recorded stall must surface as the input_stall column
            # (the live view of the sampler_depth pipeline's race)
            T.record_phase("input_stall", 1500)
            buf = io.StringIO()
            watch_cluster(g, 0.05, iterations=2, out=buf)
            watch_out = buf.getvalue()
            assert "served +" in watch_out, watch_out
            assert "/s)" in watch_out, watch_out
            assert " epoch 0" in watch_out, watch_out  # per-shard column
            assert "input_stall 1.50ms/step" in watch_out, watch_out
            buf_raw = io.StringIO()
            watch_cluster(g, 0.05, iterations=1, out=buf_raw, raw=True)
            raw_out = buf_raw.getvalue()
            assert "Δcounters/s" not in raw_out, raw_out
            print("metrics_dump smoke: OK")
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
    ap.add_argument("--timeout_ms", type=int, default=3000)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable: one JSON array of shard dumps")
    ap.add_argument("--watch", type=float, default=0.0, metavar="N", help=(
        "re-scrape every N seconds, printing per-shard RATES (requests "
        "served /s, counter movement /s over each interval) next to "
        "the live gauges; Ctrl-C stops"))
    ap.add_argument("--raw", action="store_true", help=(
        "with --watch: print raw cumulative counter values instead of "
        "per-interval rates"))
    ap.add_argument("--iterations", type=int, default=None,
                    help=argparse.SUPPRESS)  # bounds --watch (tests)
    ap.add_argument("--smoke", action="store_true", help=(
        "spin a tiny local 2-shard cluster and assert the scrape"))
    args = ap.parse_args(argv)

    if args.smoke:
        return run_smoke()
    if not args.registry and not args.shards:
        ap.error("need --registry or --shards (or --smoke)")

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
        if args.watch > 0:
            try:
                watch_cluster(g, args.watch, iterations=args.iterations,
                              raw=args.raw)
            except KeyboardInterrupt:
                pass
        else:
            dump_cluster(g, as_json=args.json)
    finally:
        g.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
