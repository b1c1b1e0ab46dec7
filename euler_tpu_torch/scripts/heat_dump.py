#!/usr/bin/env python3
"""Live-cluster data-plane skew report from the eg_heat profiler
(counterpart of the JAX package's ``scripts/heat_dump.py``).

Scrapes every shard's heat dump (kHeat opcode: hot-vertex top-K table,
count-min totals, per-op/per-conn ids ledger) and prints the skew
measurements locality-aware sharding and hot-vertex caching are judged
against:

  * per shard: the top-K hot-vertex table with space-saving error
    bounds, the share of the shard's access stream the top-K absorbs,
    and a Zipf fit of the tail exponent (log count ~ -alpha log rank);
  * with --probe N: the client-side view after N training-shaped probe
    steps (sample_node -> 2-hop fanout -> dense features) — per-op
    ids_requested / ids_after_dedup / cache_hits / ids_on_wire ledger,
    mean shards touched per call, bytes per shard, and the MEASURED
    cross-shard edge-cut under the current hash sharding (fraction of
    sampled (parent, child) hops whose endpoints live on different
    shards — the number a locality-aware partitioner must beat);
  * the projected FREQUENCY-AWARE CACHE hit-rate ceiling at the
    configured capacity: if the cache pinned the C hottest ids, every
    access after an id's first would hit — computed from the tracked
    top-K and Zipf-extrapolated beyond it, next to the measured hit
    rate of the current FIFO cache.

Usage:
    python -m euler_tpu_torch.scripts.heat_dump --registry /shared/reg
    python -m euler_tpu_torch.scripts.heat_dump --shards h1:9001,h2:9001 \\
        --probe 8
    python -m euler_tpu_torch.scripts.heat_dump --registry tcp://h:9100 --json
    python -m euler_tpu_torch.scripts.heat_dump --smoke     # self-contained
                                                            # 2-shard drill
    python -m euler_tpu_torch.scripts.heat_dump --ab-smoke  # locality A/B

See OBSERVABILITY.md "Data-plane heat" for the triage runbook.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def probe_workload(graph, steps: int, batch: int = 64, fanouts=(5, 5),
                   feature_dim: int = 8):
    """Run the training-shaped workload (roots -> 2-hop fanout -> dense
    features over the frontier) and measure the sharding edge-cut
    directly from the sampled hops: the fraction of (parent, child)
    pairs whose ids route to different shards — through the client's
    ACTUAL routing (placement map when loaded, hash otherwise), so a
    locality-aware cluster is measured by the routing it uses."""
    def shard_of(ids):
        return graph.shard_of(np.asarray(ids))

    cross = 0
    total = 0
    f1, f2 = fanouts
    for _ in range(steps):
        roots = graph.sample_node(batch, -1)
        hop_ids, _, _ = graph.sample_fanout(
            roots, [[0], [0]] if graph.edge_type_num == 1
            else [[0, 1], [0, 1]], [f1, f2],
        )
        frontier = np.concatenate(hop_ids)
        graph.get_dense_feature(frontier, [0], [feature_dim])
        for parents, children, fan in (
            (hop_ids[0], hop_ids[1], f1),
            (hop_ids[1], hop_ids[2], f2),
        ):
            ps = np.repeat(shard_of(parents), fan)
            cs = shard_of(children)
            cross += int((ps != cs).sum())
            total += len(cs)
    return {"hops_sampled": total, "cross_shard_hops": cross,
            "placement_routed": bool(graph.has_placement),
            "edge_cut": round(cross / total, 4) if total else 0.0}


def build_report(graph, probe: dict | None, cache_mb: int,
                 row_bytes: int) -> dict:
    from euler_tpu_torch import heat as H
    from euler_tpu_torch.graph.native import counters

    report: dict = {"num_shards": graph.num_shards, "shards": []}
    combined_total = 0
    for s in range(graph.num_shards):
        d = H.heat_json(graph, s)
        top = d["topk"]["server"]
        total = d["sketch"]["total"]["server"]
        combined_total += total
        report["shards"].append({
            "shard": s,
            "ids_total": total,
            "topk": top,
            "topk_share": round(H.topk_share(d, "server"), 4),
            "zipf": H.zipf_fit(top),
            "conns": d["conns"],
        })

    # client-side view (this process): fan-out ledger + cache ceiling
    local = H.heat_json()
    client_top = local["topk"]["client"]
    client_total = local["sketch"]["total"]["client"]
    report["client"] = {
        "ids_total": client_total,
        "topk_share": round(H.topk_share(local, "client"), 4),
        "zipf": H.zipf_fit(client_top),
        "fanout": local["fanout"],
        "shard_bytes": local["shard_bytes"],
        "cache_class": local["cache_class"],
    }
    if probe is not None:
        report["edge_cut"] = probe

    # projected frequency-aware cache ceiling at the configured budget
    capacity_rows = (cache_mb << 20) // max(row_bytes, 1)
    ceiling = H.cache_hit_ceiling(client_top, client_total, capacity_rows)
    if ceiling:
        ceiling["cache_mb"] = cache_mb
        ceiling["row_bytes"] = row_bytes
        ctr = counters()
        probes = ctr["cache_hits"] + ctr["cache_misses"]
        if probes:
            ceiling["measured_hit_rate"] = round(
                ctr["cache_hits"] / probes, 4
            )
            # older key kept so recorded baselines keep parsing
            ceiling["measured_fifo_hit_rate"] = ceiling["measured_hit_rate"]
        report["cache_ceiling"] = ceiling

    # one flat gate-friendly block: the numbers a locality A/B script
    # compares (edge-cut, cache hit rate, ids on wire) without walking
    # the nested report
    ctr = counters()
    feat_probes = ctr["cache_hits"] + ctr["cache_misses"]
    nbr_probes = ctr["nbr_cache_hits"] + ctr["nbr_cache_misses"]
    on_wire = sum(f["ids_on_wire"] for f in local["fanout"].values())
    report["summary"] = {
        "placement_routed": bool(getattr(graph, "has_placement", False)),
        "edge_cut": probe["edge_cut"] if probe else None,
        "topk_share": report["client"]["topk_share"],
        "ids_on_wire": on_wire,
        "feature_cache_hit_rate": (
            round(ctr["cache_hits"] / feat_probes, 4) if feat_probes
            else None
        ),
        "nbr_cache_hit_rate": (
            round(ctr["nbr_cache_hits"] / nbr_probes, 4) if nbr_probes
            else None
        ),
        "cache_admit_rejects": ctr["cache_admit_rejects"],
        "projected_hit_ceiling": (
            report["cache_ceiling"]["projected_hit_rate"]
            if "cache_ceiling" in report else None
        ),
    }
    return report


def print_report(report: dict, top_n: int = 10) -> None:
    for sh in report["shards"]:
        z = sh["zipf"]
        zs = (f"zipf alpha {z['alpha']} (r2 {z['r2']})" if z
              else "zipf fit n/a")
        print(f"== shard {sh['shard']} == ids {sh['ids_total']}  "
              f"top-{len(sh['topk'])} share {sh['topk_share']:.1%}  {zs}")
        if sh["topk"]:
            print(f"  {'rank':>4s} {'id':>12s} {'count':>10s} {'err':>7s}")
            for rank, e in enumerate(sh["topk"][:top_n], 1):
                print(f"  {rank:4d} {e['id']:12d} {e['count']:10d} "
                      f"{e['err']:7d}")
        if sh["conns"]:
            print(f"  conns: {sh['conns']}")
    c = report["client"]
    print(f"== client == ids {c['ids_total']}  top-K share "
          f"{c['topk_share']:.1%}")
    for op, f in sorted(c["fanout"].items()):
        mean_shards = (f["shards_touched"] / f["calls"]) if f["calls"] else 0
        print(f"  {op:20s} calls {f['calls']:6d} requested "
              f"{f['ids_requested']:8d} deduped {f['ids_deduped']:8d} "
              f"cache_hits {f['cache_hits']:8d} on_wire "
              f"{f['ids_on_wire']:8d} shards/call {mean_shards:.2f}")
    if "edge_cut" in report:
        e = report["edge_cut"]
        routing = ("placement-routed" if e.get("placement_routed")
                   else "hash-sharding")
        print(f"{routing} edge-cut: {e['edge_cut']:.1%} of "
              f"{e['hops_sampled']} sampled hops crossed shards")
    if "cache_ceiling" in report:
        ce = report["cache_ceiling"]
        line = (f"frequency-aware cache ceiling @ {ce['cache_mb']} MB "
                f"({ce['capacity_rows']} rows): "
                f"{ce['projected_hit_rate']:.1%} projected hit rate")
        if "measured_fifo_hit_rate" in ce:
            line += f" (measured FIFO: {ce['measured_fifo_hit_rate']:.1%})"
        print(line)


def run_smoke() -> int:
    """Self-contained drill: tiny power-law 2-shard cluster, probe
    workload, then assert the report's invariants; any failed check
    raises (exit non-zero)."""
    import shutil
    import tempfile

    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch.graph import Graph, GraphService, native
    from euler_tpu_torch.scripts.powerlaw import build_powerlaw_fixture

    tmp = tempfile.mkdtemp(prefix="euler_heat_smoke_")
    svcs = []
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        build_powerlaw_fixture(data, 300, 10, 8)
        svcs = [GraphService(data, s, 2) for s in range(2)]
        g = Graph(
            mode="remote", shards=[s.address for s in svcs],
            retries=2, timeout_ms=2000,
        )
        try:
            T.telemetry_reset()
            native.reset_counters()
            probe = probe_workload(g, steps=4, batch=32, fanouts=(5, 5))
            report = build_report(g, probe, cache_mb=64, row_bytes=128)
            print_report(report)
            assert len(report["shards"]) == 2, report
            for sh in report["shards"]:
                assert sh["ids_total"] > 0, sh
                assert sh["topk"], sh
                assert 0.0 < sh["topk_share"] <= 1.0, sh
                assert sh["zipf"] and sh["zipf"]["alpha"] > 0, sh
            # the power-law fixture routes most mass to a few hubs —
            # the measured hash-sharding edge-cut must be substantial
            assert 0.0 < report["edge_cut"]["edge_cut"] <= 1.0, report
            # ids ledger identity as seen by the heat surface
            f = report["client"]["fanout"]["dense_feature"]
            assert f["ids_on_wire"] == (f["ids_requested"]
                                        - f["ids_deduped"]
                                        - f["cache_hits"]), f
            assert "cache_ceiling" in report, report
            ce = report["cache_ceiling"]
            assert 0.0 < ce["projected_hit_rate"] <= 1.0, ce
            print("heat_dump smoke: OK")
            return 0
        finally:
            g.close()
    finally:
        for s in svcs:
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def run_ab_smoke() -> int:
    """Locality A/B drill: partition the SAME
    power-law fixture twice — hash vs degree-aware placement — run the
    probe workload against a live 2-shard cluster of each, and assert
    the placement edge-cut comes out strictly below hash. The counters
    and heat tables are process-global, so each leg resets them. A
    failed check raises (exit non-zero)."""
    import shutil
    import tempfile

    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch.graph import Graph, GraphService, native
    from euler_tpu_torch.graph.convert import convert_dicts
    from euler_tpu_torch.scripts.powerlaw import (PL_META,
                                                  powerlaw_fixture_nodes)

    tmp = tempfile.mkdtemp(prefix="euler_locality_ab_")
    try:
        # one node set, two partitionings of it
        nodes = powerlaw_fixture_nodes(400, 10, 8, alpha=1.4)
        meta = PL_META
        results = {}
        for mode in ("hash", "degree"):
            data = os.path.join(tmp, mode)
            os.makedirs(data)
            convert_dicts(nodes, meta, data + "/part", num_partitions=4,
                          placement=mode)
            svcs = [GraphService(data, s, 2) for s in range(2)]
            try:
                g = Graph(
                    mode="remote", shards=[s.address for s in svcs],
                    retries=2, timeout_ms=3000,
                )
                try:
                    T.telemetry_reset()
                    native.reset_counters()
                    probe = probe_workload(g, steps=4, batch=32,
                                           fanouts=(5, 5))
                    report = build_report(g, probe, cache_mb=64,
                                          row_bytes=128)
                    results[mode] = report["summary"]
                finally:
                    g.close()
            finally:
                for s in svcs:
                    s.stop()

        h, d = results["hash"], results["degree"]
        print(f"hash    edge-cut {h['edge_cut']:.1%}  ids_on_wire "
              f"{h['ids_on_wire']}  placement_routed "
              f"{h['placement_routed']}")
        print(f"degree  edge-cut {d['edge_cut']:.1%}  ids_on_wire "
              f"{d['ids_on_wire']}  placement_routed "
              f"{d['placement_routed']}")
        assert not h["placement_routed"], h
        assert d["placement_routed"], d
        # the gate: locality-aware placement must STRICTLY beat hash on
        # the same graph, same workload shape
        assert d["edge_cut"] < h["edge_cut"], (
            f"placement edge-cut {d['edge_cut']} not below hash "
            f"{h['edge_cut']}"
        )
        print("locality A/B smoke: OK")
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--registry", default="", help=(
        "registry dir or tcp://host:port the cluster registered with"))
    ap.add_argument("--shards", default="", help=(
        "explicit comma-separated host:port shard list"))
    ap.add_argument("--timeout_ms", type=int, default=3000)
    ap.add_argument("--probe", type=int, default=0, metavar="N", help=(
        "run N training-shaped probe steps through this client first, "
        "so the client-side fan-out ledger and the measured edge-cut "
        "exist (0 = passive: server-side tables only)"))
    ap.add_argument("--cache_mb", type=int, default=64, help=(
        "cache budget for the frequency-aware ceiling projection "
        "(matches the feature_cache_mb default)"))
    ap.add_argument("--row_bytes", type=int, default=2504, help=(
        "bytes per cached feature row for the ceiling projection "
        "(default: reddit-shaped 602 floats + entry overhead)"))
    ap.add_argument("--json", action="store_true",
                    help="machine-readable: one JSON report")
    ap.add_argument("--smoke", action="store_true", help=(
        "spin a tiny local 2-shard cluster and assert the report"))
    ap.add_argument("--ab-smoke", action="store_true", help=(
        "locality A/B drill: partition one power-law fixture hash vs "
        "degree-aware, probe both live 2-shard clusters, assert the "
        "placement edge-cut strictly below hash"))
    args = ap.parse_args(argv)

    if args.smoke:
        return run_smoke()
    if args.ab_smoke:
        return run_ab_smoke()
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
        probe = probe_workload(g, args.probe) if args.probe > 0 else None
        report = build_report(g, probe, args.cache_mb, args.row_bytes)
        if args.json:
            print(json.dumps(report))
        else:
            print_report(report)
    finally:
        g.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
