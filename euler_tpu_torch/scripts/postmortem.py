#!/usr/bin/env python3
"""Collect a dead cluster's postmortem dumps and merge them into one
incident timeline (counterpart of the JAX package's
``scripts/postmortem.py``).

When a shard dies (SIGSEGV, abort, OOM kill mid-handler), its blackbox
(graph/_native/eg_blackbox) writes ``postmortem.<pid>.json`` into the
shard's ``--postmortem_dir``: flight-recorder rings, the full counter
ledger, admission gauges, resource history, and a backtrace. This
script is the incident-response half (DEPLOY.md runbook: "shard died →
collect the postmortems BEFORE restarting"):

  * **collect** — parse every dump in a directory (shared-FS clusters
    drop all shards' dumps in one place; per-host dirs can be rsync'd
    together first) and print a per-dump summary: signal, shard,
    counters that moved, resource tail, the flight-recorder tail;
  * **merge** — fold the dumps into a client-side Chrome trace (the
    ``run_loop --trace_file`` export): each dump becomes a process
    lane of instant events on the shared CLOCK_MONOTONIC timeline,
    and every wire-v3 trace id seen on BOTH a client rpc slice and a
    dead shard's ring gets a flow arrow — the incident reads as ONE
    timeline from the training step to the exact request the shard
    died serving.

Usage:
    python -m euler_tpu_torch.scripts.postmortem --dir /shared/postmortems
    python -m euler_tpu_torch.scripts.postmortem --dir pm/ \\
        --trace run.trace.json --out incident.json  # open in Perfetto
    python -m euler_tpu_torch.scripts.postmortem --smoke  # self-contained
                                                           # drill

See OBSERVABILITY.md "Postmortems" for the file format and the
async-signal-safety constraints it honors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the checkout's root, the smoke's shard processes' PYTHONPATH
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# pid lane for postmortem shards in the merged trace: distinct from the
# live-scrape shard lanes (trace.py PID_SHARD_BASE = 100) so a trace
# that has BOTH (shard scraped before it died, dump after) stays legible
PID_POSTMORTEM_BASE = 200


def summarize(dump: dict, out=sys.stdout) -> None:
    """Human summary of one postmortem dump."""
    print(f"== {dump.get('path', '?')} ==", file=out)
    print(f"  {dump['signal_name']} (signal {dump['signal']})  "
          f"pid {dump['pid']}  shard {dump['shard']}", file=out)
    moved = {k: v for k, v in dump["counters"].items() if v}
    if moved:
        print(f"  counters: {moved}", file=out)
    if dump.get("gauges"):
        print(f"  admission: {dump['gauges']}", file=out)
    hist = dump.get("resource_history", [])
    if hist:
        r = hist[-1]
        print(f"  resource at death: rss {r['rss_bytes'] / 1e6:.1f}MB  "
              f"fds {r['open_fds']}  threads {r['threads']}  "
              f"cache {r['cache_bytes'] / 1e6:.1f}MB  "
              f"({len(hist)} samples)", file=out)
    for ring in dump.get("rings", []):
        evs = ring["events"]
        if not evs:
            continue
        print(f"  ring tid={ring['tid']} ({ring['head']} events, "
              f"last {min(len(evs), 5)}):", file=out)
        for e in evs[-5:]:
            print(f"    {e['t_us']:>14d}us {e['point']:12s} "
                  f"op={e['op']:<2d} shard={e['shard']:<3d} "
                  f"value={e['value']:<8d} trace={int(e['trace']):#x}",
                  file=out)
    if dump.get("backtrace_symbols"):
        print(f"  backtrace ({len(dump['backtrace_symbols'])} frames):",
              file=out)
        for line in dump["backtrace_symbols"][:6]:
            print(f"    {line}", file=out)


def _dump_trace_events(dump: dict, pid: int) -> list:
    """One dump's rings -> instant events on its own process lane.

    Ring events become cat="rpc" instants carrying the trace id and a
    side label, so trace.py's correlated_trace_ids() and the flow
    emitter below treat a dead shard's last-seen requests exactly like
    a live shard's journal spans."""
    events = []
    label = (f"postmortem shard {dump['shard']} "
             f"({dump['signal_name']}, pid {dump['pid']})")
    events.append({
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": label},
    })
    for tid, ring in enumerate(dump.get("rings", []), start=1):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"ring tid={ring['tid']}"},
        })
        for e in ring["events"]:
            ev = {
                "name": e["point"], "cat": "rpc", "ph": "i", "s": "t",
                "ts": e["t_us"], "pid": pid, "tid": tid,
                "args": {
                    "trace": f"{int(e['trace']):#x}",
                    "side": "server",
                    "outcome": e["outcome"], "shard": e["shard"],
                    "op": e["op"], "value": e["value"],
                    "source": label,
                },
            }
            events.append(ev)
    return events


def merge_trace(dumps: list, base_trace: dict | None = None) -> dict:
    """Merge postmortem dumps into a (possibly empty) client trace.

    Returns the merged Chrome-trace dict; every wire-v3 trace id seen
    on BOTH a client rpc slice (the --trace file) and a dead shard's
    ring gets an s/f flow arrow, so Perfetto draws the line from the
    training step to the request the shard died serving."""
    events = list((base_trace or {}).get("traceEvents", []))
    for i, dump in enumerate(dumps):
        shard = dump.get("shard", -1)
        pid = PID_POSTMORTEM_BASE + (shard if shard >= 0 else 50 + i)
        events.extend(_dump_trace_events(dump, pid))
    # flow arrows: client slice -> postmortem instant, keyed by trace id
    clients: dict = {}
    servers: dict = {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("cat") != "rpc" or "trace" not in args:
            continue
        if int(args["trace"], 16) == 0:
            continue
        if args.get("side") == "client":
            clients.setdefault(args["trace"], ev)
        elif ev["pid"] >= PID_POSTMORTEM_BASE:
            servers.setdefault(args["trace"], ev)
    for trace, cli in clients.items():
        srv = servers.get(trace)
        if srv is None:
            continue
        common = {"name": "fatal-rpc", "cat": "rpc-flow", "id": trace}
        events.append({**common, "ph": "s", "ts": cli["ts"],
                       "pid": cli["pid"], "tid": cli["tid"]})
        events.append({**common, "ph": "f", "bp": "e", "ts": srv["ts"],
                       "pid": srv["pid"], "tid": srv["tid"]})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def correlated_fatal_ids(merged: dict) -> set:
    """Trace ids linked client-side AND in a postmortem lane — the
    'incident reads as one timeline' pin the acceptance test asserts."""
    sides: dict = {}
    for ev in merged["traceEvents"]:
        args = ev.get("args") or {}
        if ev.get("cat") != "rpc" or "trace" not in args:
            continue
        if int(args["trace"], 16) == 0:
            continue
        if args.get("side") == "client":
            sides.setdefault(args["trace"], set()).add("client")
        elif ev["pid"] >= PID_POSTMORTEM_BASE:
            sides.setdefault(args["trace"], set()).add("postmortem")
    return {t for t, ss in sides.items()
            if {"client", "postmortem"} <= ss}


def run_smoke() -> int:
    """Self-contained incident drill: live 2-shard subprocess cluster
    (``python -m euler_tpu_torch.graph.service``), shard 1 restarted
    with a seeded crash failpoint, client traffic kills it, then collect
    + merge and assert the timeline correlates by trace id; any failed
    check raises (exit non-zero)."""
    import shutil
    import socket
    import subprocess
    import tempfile
    import time

    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch import trace as trace_mod
    from euler_tpu_torch.blackbox import postmortem_read
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.scripts.powerlaw import build_powerlaw_fixture

    tmp = tempfile.mkdtemp(prefix="euler_postmortem_smoke_")
    procs = []

    def launch(idx, fault=None, pmdir=None):
        env = dict(os.environ, PYTHONPATH=REPO)
        cmd = [sys.executable, "-m", "euler_tpu_torch.graph.service",
               "--data_dir", data, "--shard_idx", str(idx),
               "--shard_num", "2", "--registry", reg]
        if fault:
            cmd += ["--fault", fault, "--fault_seed", "7"]
        if pmdir:
            cmd += ["--postmortem_dir", pmdir]
        p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL, env=env)
        procs.append(p)
        return p

    def wait_up(idx, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for f in os.listdir(reg):
                # a shard writes its entry under a .tmp name, then renames
                if not f.startswith(f"{idx}#") or f.endswith(".tmp"):
                    continue
                host, port = f.split("#", 1)[1].rsplit("_", 1)
                try:
                    with socket.create_connection((host, int(port)), 1.0):
                        return
                except OSError:
                    continue
            time.sleep(0.1)
        raise TimeoutError(f"shard {idx} never came up")

    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        build_powerlaw_fixture(data, 120, 6, 8)
        reg = os.path.join(tmp, "reg")
        os.makedirs(reg)
        pmdir = os.path.join(tmp, "pm")
        os.makedirs(pmdir)

        launch(0)
        victim = launch(1)
        wait_up(0)
        wait_up(1)
        g = Graph(
            mode="remote", registry=reg, retries=1, timeout_ms=1500,
            backoff_ms=10, rediscover_ms=200,
        )
        try:
            T.telemetry_reset()
            roots = g.sample_node(16, -1)
            g.get_dense_feature(roots, [0], [8])

            # the incident: shard 1 comes back armed to die on its next
            # request, with the postmortem path armed
            victim.terminate()
            victim.wait(timeout=30)
            for f in list(os.listdir(reg)):
                if f.startswith("1#"):
                    os.unlink(os.path.join(reg, f))
            victim = launch(1, fault="crash:err@1#1", pmdir=pmdir)
            wait_up(1)
            time.sleep(0.5)  # let the client re-discover the new port

            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                g.sample_node(8, -1)
                g.get_dense_feature(roots, [0], [8])
                if any(f.startswith("postmortem.")
                       for f in os.listdir(pmdir)):
                    break
                time.sleep(0.2)
            dumps = postmortem_read(pmdir)
            assert dumps, "no postmortem written by the crashed shard"
            dump = dumps[-1]
            assert dump["signal_name"] == "SIGSEGV", dump["signal_name"]
            assert dump["counters"]["crashes"] == 1, dump["counters"]
            recvs = [e for ring in dump["rings"] for e in ring["events"]
                     if e["point"] == "server_recv"]
            assert recvs, "fatal call not in the flight-recorder tail"

            # client-side trace (run_loop --trace_file form), then merge
            trace_path = os.path.join(tmp, "client.trace.json")
            client_trace = trace_mod.write_trace(trace_path, None, g)
            merged = merge_trace(dumps, client_trace)
            out_path = os.path.join(tmp, "incident.json")
            with open(out_path, "w") as f:
                json.dump(merged, f)
            trace_mod.validate_chrome_trace(merged)
            linked = correlated_fatal_ids(merged)
            assert linked, (
                "no trace id correlated between the client journal and "
                "the dead shard's postmortem rings"
            )
            for d in dumps:
                summarize(d)
            print(f"postmortem smoke: OK ({len(dumps)} dump(s), "
                  f"{len(linked)} fatal call(s) correlated)")
            return 0
        finally:
            g.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--dir", default="", help=(
        "postmortem directory to collect (every postmortem.*.json; "
        "rsync per-host dirs together first on multi-host clusters)"))
    ap.add_argument("--trace", default="", help=(
        "client-side Chrome trace (run_loop --trace_file / "
        "trace_dump output) to merge the dumps into"))
    ap.add_argument("--out", default="", help=(
        "write the merged incident trace here (open in "
        "ui.perfetto.dev)"))
    ap.add_argument("--json", action="store_true",
                    help="machine-readable: one JSON array of dumps")
    ap.add_argument("--smoke", action="store_true", help=(
        "self-contained incident drill against a live 2-shard "
        "cluster"))
    args = ap.parse_args(argv)

    if args.smoke:
        return run_smoke()
    if not args.dir:
        ap.error("need --dir (or --smoke)")

    from euler_tpu_torch.blackbox import postmortem_read

    dumps = postmortem_read(args.dir)
    if not dumps:
        print(f"no postmortem.*.json dumps in {args.dir}",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(dumps))
    else:
        for d in dumps:
            summarize(d)
    base = None
    if args.trace:
        with open(args.trace) as f:
            base = json.load(f)
    if args.out or args.trace:
        merged = merge_trace(dumps, base)
        linked = correlated_fatal_ids(merged)
        out_path = args.out or "incident.json"
        with open(out_path, "w") as f:
            json.dump(merged, f)
        print(f"incident trace: {len(merged['traceEvents'])} events, "
              f"{len(linked)} fatal call(s) correlated client<->shard "
              f"-> {out_path} (open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
