"""Interactive graph console (counterpart of ``euler_tpu/console.py``).

A readline REPL over the port's engine client, with the JAX package's
command surface: connect, feature and neighbour reads, samples and walks,
snapshot epochs, an embedding server query, and the ``stats`` views of
the native observability (span timers and counters, latency histograms,
step phases, the slow-span journal, the flight recorder, the data-plane
heat) plus the device plane (``stats devprof``):

    con  "directory=/data/ppi"            connect (key=value config)
    con  "mode=remote;registry=/reg"      connect to a sharded service
    nf   dense  "1, 2, 3" "0:50, 1:2"     node features by type + slots
    nf   sparse "1, 2" "0"
    nf   binary "1" "0"
    ef   dense  "1:2:0, 2:3:1" "0"        edge features (src:dst:type ids)
    nb   "1, 2, 3" "0, 1"                 full weighted neighbors
    sn   <count> [node_type]              sample nodes
    se   <count> [edge_type]              sample edges
    walk "1, 2" "0" <len> [p] [q]         random walks
    epoch [load <path> [shard]]           snapshot epochs / apply a delta
    embed <host:port> <nids>              query a running embedding server
    stats [hist|phases|slow|blackbox|heat|devprof|reset]
    help [command] / quit

Each command prints what the JAX console prints on the same graph.

Usage:  python -m euler_tpu_torch.console [--config "directory=..."]
"""

from __future__ import annotations

import argparse
import shlex
import sys

import numpy as np

COMMANDS = {
    "help": ("Command help message", "help [command]", "help con"),
    "con": (
        "Connect to a graph (embedded or remote)",
        "con <config>",
        'con "directory=/data/ppi"  |  con "mode=remote;registry=/reg"',
    ),
    "nf": (
        "Get features for nodes (dense slots take fid:dim)",
        "nf <dense|sparse|binary> <nids> <fids>",
        'nf dense "1, 2, 3" "0:50, 1:2"  |  nf sparse "1, 2" "0"',
    ),
    "ef": (
        "Get features for edges (dense slots take fid:dim)",
        "ef <dense|sparse|binary> <src:dst:type,...> <fids>",
        'ef dense "1:2:0, 2:3:1" "0:4"',
    ),
    "nb": (
        "Get full weighted neighbors for nodes",
        "nb <nids> <etypes>",
        'nb "1, 2, 3" "0, 1"',
    ),
    "sn": ("Sample nodes by weight", "sn <count> [node_type=-1]", "sn 5 0"),
    "se": ("Sample edges by weight", "se <count> [edge_type=-1]", "se 5"),
    "walk": (
        "Random walks (node2vec p/q optional)",
        "walk <nids> <etypes> <walk_len> [p] [q]",
        'walk "1, 2" "0" 5 1.0 2.0',
    ),
    "stats": (
        "Show native stats: span timers + counters; 'hist' for latency "
        "histograms (p50/p90/p99 per op), 'phases' for the step-phase "
        "profiler (input_stall/sample/h2d/device + prefetch gauges), "
        "'slow' for the slow-span journal, 'blackbox' for the flight "
        "recorder + resource gauges, 'heat' for the data-plane access "
        "profiler (hot-vertex top-K, fan-out, cache classes), 'devprof' "
        "for the device plane (compiles, recompile ledger, transfers, "
        "device memory), 'reset' to zero everything",
        "stats [hist|phases|slow|blackbox|heat|devprof|reset]",
        "stats heat",
    ),
    "epoch": (
        "Show the snapshot epoch: local graphs print the merged-delta "
        "epoch; remote graphs print the client's last-observed epoch "
        "per shard plus the cache generation. 'epoch load <path> "
        "[shard]' applies a delta file (convert.py --delta-from) — "
        "local merges in-process, remote flips the given shard live",
        "epoch [load <path> [shard]]",
        "epoch  |  epoch load /data/part.delta.1 0",
    ),
    "embed": (
        "Query a running embedding server (euler_tpu_torch.serve)",
        "embed <host:port> <nids> [deadline_ms]",
        'embed 127.0.0.1:9200 "1, 2, 3"  |  embed 127.0.0.1:9200 "5" 50',
    ),
    "quit": ("Exit the console", "quit", "quit"),
}


def _ids(text: str) -> np.ndarray:
    return np.array(
        [int(x) for x in text.replace(",", " ").split()], dtype=np.int64
    )


def _edge_ids(text: str):
    src, dst, et = [], [], []
    for tok in text.replace(",", " ").split():
        s, d, t = tok.split(":")
        src.append(int(s))
        dst.append(int(d))
        et.append(int(t))
    return (
        np.array(src, dtype=np.int64),
        np.array(dst, dtype=np.int64),
        et,
    )


def _dense_slots(text: str):
    """Parse 'fid:dim' tokens (dim defaults to 1)."""
    fids, dims = [], []
    for tok in text.replace(",", " ").split():
        if ":" in tok:
            f, d = tok.split(":")
        else:
            f, d = tok, "1"
        fids.append(int(f))
        dims.append(int(d))
    return fids, dims


def _split_ragged(values, counts):
    rows, off = [], 0
    for c in counts:
        rows.append(values[off : off + int(c)])
        off += int(c)
    return rows


def _help(args: list) -> None:
    names = [args[0]] if args and args[0] in COMMANDS else sorted(COMMANDS)
    for name in names:
        desc, usage, example = COMMANDS[name]
        print(f"{name:6s} {desc}\n       usage:   {usage}"
              f"\n       example: {example}")


class Console:
    def __init__(self):
        self.graph = None

    def _need_graph(self) -> bool:
        if self.graph is None:
            print("not connected — run: con \"directory=...\"",
                  file=sys.stderr)
            return False
        return True

    def do_con(self, args: list) -> None:
        from euler_tpu_torch.graph import Graph

        if not args:
            return _help(["con"])
        # same loader as Graph(config=...): inline k=v;k=v or an .ini path
        self.graph = Graph(config=args[0])
        print(
            f"connected: {self.graph.num_nodes} nodes, "
            f"{self.graph.num_edges} edges, "
            f"{self.graph.num_shards} shard(s)"
        )

    def do_nf(self, args: list) -> None:
        if len(args) != 3:
            return _help(["nf"])
        if not self._need_graph():
            return
        kind, nids = args[0], _ids(args[1])
        if kind == "dense":
            fids, dims = _dense_slots(args[2])
            vals = self.graph.get_dense_feature(nids, fids, dims)
            for i, nid in enumerate(nids):
                print(f"node {nid}: {vals[i].tolist()}")
        elif kind == "sparse":
            fids = [int(x) for x in _ids(args[2])]
            slots = self.graph.get_sparse_feature(nids, fids)
            for f, (values, counts) in zip(fids, slots):
                for nid, row in zip(nids, _split_ragged(values, counts)):
                    print(f"node {nid} slot {f}: {row.tolist()}")
        elif kind == "binary":
            fids = [int(x) for x in _ids(args[2])]
            slots = self.graph.get_binary_feature(nids, fids)
            for f, rows in zip(fids, slots):
                for nid, row in zip(nids, rows):
                    print(f"node {nid} slot {f}: {row!r}")
        else:
            _help(["nf"])

    def do_ef(self, args: list) -> None:
        if len(args) != 3:
            return _help(["ef"])
        if not self._need_graph():
            return
        kind = args[0]
        src, dst, types = _edge_ids(args[1])
        eids = list(zip(src.tolist(), dst.tolist(), types))
        if kind == "dense":
            fids, dims = _dense_slots(args[2])
            vals = self.graph.get_edge_dense_feature(
                src, dst, types, fids, dims
            )
            for i, eid in enumerate(eids):
                print(f"edge {eid}: {vals[i].tolist()}")
        elif kind == "sparse":
            fids = [int(x) for x in _ids(args[2])]
            slots = self.graph.get_edge_sparse_feature(src, dst, types, fids)
            for f, (values, counts) in zip(fids, slots):
                for eid, row in zip(eids, _split_ragged(values, counts)):
                    print(f"edge {eid} slot {f}: {row.tolist()}")
        elif kind == "binary":
            fids = [int(x) for x in _ids(args[2])]
            slots = self.graph.get_edge_binary_feature(src, dst, types, fids)
            for f, rows in zip(fids, slots):
                for eid, row in zip(eids, rows):
                    print(f"edge {eid} slot {f}: {row!r}")
        else:
            _help(["ef"])

    def do_nb(self, args: list) -> None:
        if len(args) != 2:
            return _help(["nb"])
        if not self._need_graph():
            return
        nids = _ids(args[0])
        etypes = [int(x) for x in _ids(args[1])]
        nbr, w, t, counts = self.graph.get_full_neighbor(nids, etypes)
        off = 0
        for nid, c in zip(nids, counts):
            row = ", ".join(
                f"{int(nbr[j])}({w[j]:.3g},t{int(t[j])})"
                for j in range(off, off + int(c))
            )
            off += int(c)
            print(f"node {nid}: [{row}]")

    def do_sn(self, args: list) -> None:
        if not args:
            return _help(["sn"])
        if not self._need_graph():
            return
        t = int(args[1]) if len(args) > 1 else -1
        print(self.graph.sample_node(int(args[0]), t).tolist())

    def do_se(self, args: list) -> None:
        if not args:
            return _help(["se"])
        if not self._need_graph():
            return
        t = int(args[1]) if len(args) > 1 else -1
        src, dst, types = self.graph.sample_edge(int(args[0]), t)
        print([
            (int(s), int(d), int(et))
            for s, d, et in zip(src, dst, types)
        ])

    def do_walk(self, args: list) -> None:
        if len(args) < 3:
            return _help(["walk"])
        if not self._need_graph():
            return
        nids = _ids(args[0])
        etypes = [int(x) for x in _ids(args[1])]
        p = float(args[3]) if len(args) > 3 else 1.0
        q = float(args[4]) if len(args) > 4 else 1.0
        walks = self.graph.random_walk(nids, etypes, int(args[2]), p=p, q=q)
        for row in walks:
            print(" -> ".join(str(int(x)) for x in row))

    def do_epoch(self, args: list) -> None:
        if not self._need_graph():
            return
        g = self.graph
        if args and args[0] == "load":
            if len(args) < 2:
                return _help(["epoch"])
            shard = int(args[2]) if len(args) > 2 else None
            ep = g.load_delta(args[1], shard=shard)
            where = "local" if shard is None else f"shard {shard}"
            print(f"applied {args[1]} -> {where} epoch {ep}")
            return
        if args:
            return _help(["epoch"])
        if g.mode == "local":
            print(f"epoch {g.epoch()} (local; {g.epoch()} delta(s) merged)")
            return
        # remote: the client's passive view (v4 reply stamps + registry
        # heartbeats), which may trail a shard that flipped but hasn't
        # answered this client since
        for s in range(g.num_shards):
            print(f"shard {s}: epoch {g.shard_epoch(s)}")
        print(f"cache_gen {g.cache_gen} (feature/neighbor/sample caches "
              f"keyed on this; stale generations evict on next touch)")

    def do_embed(self, args: list) -> None:
        if len(args) < 2:
            return _help(["embed"])
        from euler_tpu_torch.serving import (BusyError, DeadlineError,
                                             EmbedClient)

        deadline = float(args[2]) if len(args) > 2 else None
        client = EmbedClient(args[0])
        try:
            rows = client.embed(_ids(args[1]), deadline_ms=deadline)
        except BusyError:
            print("BUSY (server shed the request — retry with backoff)")
            return
        except DeadlineError:
            print("DEADLINE (expired before dispatch)")
            return
        finally:
            client.close()
        for nid, row in zip(_ids(args[1]), rows):
            vals = " ".join(f"{v:.6f}" for v in row[:8])
            more = " ..." if rows.shape[1] > 8 else ""
            print(f"{int(nid)}: [{vals}{more}]  dim={rows.shape[1]}")

    def do_stats(self, args: list) -> None:
        from euler_tpu_torch.graph.native import (
            counters,
            reset_counters,
            stats,
            stats_reset,
        )

        if args and args[0] == "reset":
            from euler_tpu_torch import devprof
            from euler_tpu_torch.telemetry import telemetry_reset

            stats_reset()
            reset_counters()
            telemetry_reset()
            devprof.devprof_reset()
            print("stats reset")
            return
        if args and args[0] == "hist":
            # latency histograms (eg_telemetry): p50/p90/p99 per series
            from euler_tpu_torch.telemetry import percentiles, telemetry_json

            rows = [
                (key, h["count"], percentiles(h))
                for key, h in sorted(telemetry_json()["hist"].items())
                if h["count"] > 0
            ]
            if not rows:
                print("no latency samples recorded")
                return
            print(f"{'series':36s} {'count':>8s} {'p50_us':>10s} "
                  f"{'p90_us':>10s} {'p99_us':>10s}")
            for key, count, pct in rows:
                print(f"{key:36s} {count:8d} {pct[50]:10.1f} "
                      f"{pct[90]:10.1f} {pct[99]:10.1f}")
            return
        if args and args[0] == "phases":
            # step-phase profiler (OBSERVABILITY.md "Step phases"):
            # per-phase latency percentiles + the prefetch pipeline's
            # depth/busy means and produced/dropped/error counters
            from euler_tpu_torch.telemetry import (
                PHASES,
                percentiles,
                phase_hists,
                telemetry_json,
            )

            data = telemetry_json()
            hists = phase_hists(data)
            rows = [
                (name, hists[name])
                for name in PHASES
                if hists.get(name, {}).get("count", 0) > 0
            ]
            if not rows:
                print("no step phases recorded (run a training step "
                      "with telemetry on)")
                return
            print(f"{'phase':12s} {'count':>8s} {'mean_ms':>9s} "
                  f"{'p50_us':>10s} {'p90_us':>10s} {'p99_us':>10s}")
            for name, h in rows:
                pct = percentiles(h)
                mean_ms = h["sum_us"] / h["count"] / 1000.0
                print(f"{name:12s} {h['count']:8d} {mean_ms:9.2f} "
                      f"{pct[50]:10.1f} {pct[90]:10.1f} {pct[99]:10.1f}")
            for key, label in (("prefetch_depth", "queue depth"),
                               ("prefetch_busy", "workers busy")):
                h = data["hist"].get(key)
                if h and h["count"]:
                    print(f"prefetch {label}: mean "
                          f"{h['sum_us'] / h['count']:.2f} over "
                          f"{h['count']} dequeues")
            pf = {k: v for k, v in counters().items()
                  if k.startswith("prefetch_") and v}
            if pf:
                print(f"prefetch counters: {pf}")
            return
        if args and args[0] == "blackbox":
            # flight recorder + resource gauges (eg_blackbox,
            # OBSERVABILITY.md "Postmortems"): the live view of exactly
            # what a fatal-signal postmortem would freeze
            from euler_tpu_torch.blackbox import blackbox_json

            d = blackbox_json()
            r = d["resource"]
            state = "on" if d["enabled"] else "OFF"
            print(f"blackbox {state}  shard {d['shard']}  "
                  f"postmortem_dir {d['postmortem_dir'] or '(unarmed)'}  "
                  f"dropped {d['dropped']}")
            print(f"resource: rss {r['rss_bytes'] / 1e6:.1f}MB  "
                  f"fds {r['open_fds']}  threads {r['threads']}  "
                  f"cache {r['cache_bytes'] / 1e6:.1f}MB  "
                  f"history {r['history_depth']}/60 samples")
            if not d["rings"]:
                print("flight recorder empty (no instrumented calls yet)")
                return
            for ring in d["rings"]:
                evs = ring["events"]
                print(f"ring tid={ring['tid']} events={ring['head']} "
                      f"(showing last {min(len(evs), 8)}):")
                for e in evs[-8:]:
                    print(f"  {e['t_us']:>14d}us {e['point']:12s} "
                          f"op={e['op']:<2d} shard={e['shard']:<3d} "
                          f"value={e['value']:<8d} "
                          f"trace={int(e['trace']):#x}")
            return
        if args and args[0] == "heat":
            # data-plane access profiler (eg_heat, OBSERVABILITY.md
            # "Data-plane heat"): hot-vertex top-K per side, the
            # client ids ledger, and cache-efficacy classes
            from euler_tpu_torch.heat import heat_json, topk_share

            d = heat_json()
            state = "on" if d["enabled"] else "OFF"
            tot = d["sketch"]["total"]
            print(f"heat {state}  topk_capacity {d['topk_capacity']}  "
                  f"ids fed: client {tot['client']} server "
                  f"{tot['server']}")
            any_rows = False
            for side in ("client", "server"):
                top = d["topk"][side]
                if not top:
                    continue
                any_rows = True
                share = topk_share(d, side)
                print(f"{side} top-{len(top)} (share of stream "
                      f"{share:.1%}):")
                print(f"  {'rank':>4s} {'id':>12s} {'count':>10s} "
                      f"{'err':>8s}")
                for rank, e in enumerate(top[:10], 1):
                    print(f"  {rank:4d} {e['id']:12d} {e['count']:10d} "
                          f"{e['err']:8d}")
            if not any_rows:
                print("no ids fed yet (run remote queries with heat on)")
                return
            if d["fanout"]:
                print(f"{'op':22s} {'calls':>7s} {'requested':>10s} "
                      f"{'deduped':>8s} {'cache_hit':>9s} "
                      f"{'on_wire':>8s} {'shards':>7s}")
                for op, f in sorted(d["fanout"].items()):
                    print(f"{op:22s} {f['calls']:7d} "
                          f"{f['ids_requested']:10d} "
                          f"{f['ids_deduped']:8d} {f['cache_hits']:9d} "
                          f"{f['ids_on_wire']:8d} "
                          f"{f['shards_touched']:7d}")
            cc = d["cache_class"]
            if any(sum(v) for v in cc.values()):
                print("cache events by frequency class "
                      "(class c = estimate in [2^(c-1), 2^c)):")
                for event in ("hit", "miss", "evict"):
                    print(f"  {event:6s} {cc[event]}")
            return
        if args and args[0] == "devprof":
            # the device plane (devprof.py): compiles (kernel builds,
            # CUDA-graph captures) and their wall time, the recompile
            # ledger, transfer bytes and the device-memory gauges
            from euler_tpu_torch import devprof

            s = devprof.compile_summary()
            state = "on" if devprof.devprof_enabled() else "OFF"
            print(f"devprof {state}  compiles {s['compiles']}  recompiles "
                  f"{s['recompiles']}  serve_recompiles "
                  f"{s['serve_recompiles']}")
            print(f"compile: {s['compile_events']} event(s), total "
                  f"{s['compile_ms_total']:.1f} ms, p50 "
                  f"{s['compile_ms_p50']:.1f} ms, p99 "
                  f"{s['compile_ms_p99']:.1f} ms")
            print(f"transfers: h2d {s['h2d_bytes']} B  d2h "
                  f"{s['d2h_bytes']} B")
            print(f"device memory: in use {s['device_mem_bytes'] / 1e6:.1f}"
                  f"MB  peak {s['device_mem_peak_bytes'] / 1e6:.1f}MB  "
                  f"buffers {s['device_buffers']}")
            led = devprof.recompile_ledger()
            if not led:
                print("recompile ledger empty")
                return
            print(f"recompile ledger (last {min(len(led), 8)} of "
                  f"{len(led)}):")
            for e in led[-8:]:
                print(f"  {e['fn']} {e['wall_us']}us: "
                      f"{'; '.join(e['diff'])}")
            return
        if args and args[0] == "slow":
            from euler_tpu_torch.telemetry import slow_spans

            spans = slow_spans()
            if not spans:
                print("slow-span journal empty")
                return
            print(f"{'side':6s} {'op':20s} {'shard':>5s} {'total_us':>9s} "
                  f"{'queue':>7s} {'handler':>8s} {'wire':>7s} "
                  f"{'outcome':8s} trace")
            for s in spans:
                print(f"{s['side']:6s} {s['op']:20s} {s['shard']:5d} "
                      f"{s['total_us']:9d} {s['queue_us']:7d} "
                      f"{s['handler_us']:8d} {s['wire_us']:7d} "
                      f"{s['outcome']:8s} {s['trace']:#018x}")
            return
        snap = stats()
        if not snap:
            print("no ops recorded")
        else:
            print(f"{'op':16s} {'count':>10s} {'total_ms':>10s} "
                  f"{'avg_us':>10s} {'max_us':>10s}")
            for name, s in sorted(snap.items()):
                print(f"{name:16s} {s['count']:10d} {s['total_ms']:10.2f} "
                      f"{s['avg_us']:10.2f} {s['max_us']:10.2f}")
        # one ledger, both sides: client transport fight (retries,
        # failovers, ...) and — when this process serves a shard —
        # server survivability (busy_rejects, handler_timeouts,
        # deadline_rejects, draining), all via the eg_counters_* ABI
        fails = {k: v for k, v in counters().items() if v}
        if fails:
            print("counters:")
            for name, v in sorted(fails.items()):
                print(f"  {name:20s} {v:10d}")
        # the full subcommand roster, so the bare command advertises
        # every view (keep in step with COMMANDS)
        print("subcommands: stats hist | phases | slow | blackbox | "
              "heat | devprof | reset")

    def execute(self, line: str) -> bool:
        """Run one command line; returns False on quit."""
        try:
            parts = shlex.split(line)
        except ValueError as e:
            print(f"parse error: {e}", file=sys.stderr)
            return True
        if not parts:
            return True
        cmd, args = parts[0], parts[1:]
        if cmd in ("quit", "exit"):
            return False
        if cmd == "help":
            _help(args)
            return True
        handler = getattr(self, f"do_{cmd}", None)
        if handler is None:
            print(f"invalid command: {cmd}", file=sys.stderr)
            _help([])
            return True
        try:
            handler(args)
        except Exception as e:  # keep the REPL alive on bad input
            print(f"error: {e}", file=sys.stderr)
        return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="euler_tpu_torch.console")
    ap.add_argument("--config", default="",
                    help='connect on startup, e.g. "directory=/data/ppi"')
    args = ap.parse_args(argv)
    try:
        import readline  # noqa: F401  (history + line editing)
    except ImportError:
        pass
    console = Console()
    if args.config:
        try:
            console.do_con([args.config])
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
    while True:
        try:
            line = input("euler> ")
        except EOFError:
            break
        except KeyboardInterrupt:
            print()
            continue
        if not console.execute(line):
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
