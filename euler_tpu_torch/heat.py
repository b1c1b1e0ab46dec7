"""Data-plane heat surface over the native access profiler (counterpart
of ``euler_tpu/heat.py``).

The native layer (graph/_native/eg_heat.{h,cc}) tracks WHICH vertex ids
the cluster touches: a space-saving top-K hot-key table plus a count-min
sketch per side (client feeds post-coalesce per op, shard services feed
pre-execute per op + requesting conn), client fan-out attribution for
SampleNeighbor/GetDenseFeature (ids_requested / ids_after_dedup /
cache_hits / ids_on_wire / shards touched / bytes per shard), and
cache-efficacy classes (hits/misses/evictions bucketed by the key's
sketch-estimated frequency). This module is the Python half:

    heat.heat_json()            this process's full heat dump
    heat.heat_json(g, shard)    a live shard's dump (kHeat opcode)
    heat.heat_topk()            hot ids, hottest first
    heat.heat_topk(g, shard=1)  a live shard's hot ids
    heat.set_heat(False)        process-global kill-switch

plus `set_heat_topk()` (tracker capacity), `heat_reset()`,
`record_heat()` (feed an app-level id stream through the same
primitive), and `estimate()` (count-min point estimate). Config keys
`heat=` / `heat_topk=` reach the same switches through graph config
(remote mode) and service options. Everything also rides the existing
telemetry surfaces: the `heat` section of `telemetry_json()` / the
STATS scrape, `heat_spread:<op>` histograms in the shared `hist` map,
and the `eg_heat_*` Prometheus families of `metrics_text()`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from euler_tpu_torch.graph.native import lib
from euler_tpu_torch.telemetry import _json_abi

# Side selectors of the native layer (eg_heat.h HeatSide).
SIDES = ("client", "server")

# Wire-op names in native slot order (eg_telemetry.h kWireOpNames);
# record_heat() maps op names through this, pinned by tests.
OP_NAMES = (
    "other", "ping", "info", "sample_node", "sample_edge", "node_type",
    "sample_neighbor", "full_neighbor", "topk_neighbor", "dense_feature",
    "edge_dense_feature", "sparse_feature", "edge_sparse_feature",
    "binary_feature", "edge_binary_feature", "node_weight",
    "sample_neighbor_uniq", "stats", "history", "heat", "placement",
)


def heat_json(graph=None, shard: int | None = None) -> dict:
    """Full heat dump: top-K tables (ids as Python ints), sketch
    geometry + totals, per-(side, op) ids ledger, client fan-out
    attribution, per-shard wire bytes, per-conn server ledger, and
    cache-efficacy classes.

    No arguments: this process. With (graph, shard): one live shard's
    dump over the kHeat wire opcode (the graph's ordinary transport
    config applies)."""
    if graph is None:
        data = _json_abi(lambda buf, cap: lib().eg_heat_json(buf, cap))
    else:
        if getattr(graph, "mode", None) != "remote":
            raise ValueError("heat_json(graph=...) needs a mode='remote' "
                             "graph (a local graph IS this process)")
        if shard is None:
            raise ValueError("heat_json(graph=...) needs shard=")
        h = graph._h
        data = _json_abi(
            lambda buf, cap: lib().eg_remote_heat(h, shard, buf, cap)
        )
    for side in SIDES:
        for e in data["topk"][side]:
            e["id"] = int(e["id"])  # decimal string on the wire (u64-safe)
    return data


def heat_topk(graph=None, shard: int | None = None, side: str = "client",
              k: int | None = None) -> list:
    """Hot ids, hottest first: [{"id", "count", "err"}]. `count` upper-
    bounds the true feed count and `count - err` lower-bounds it
    (space-saving guarantee; err == 0 means exact). Local by default;
    (graph, shard) scrapes a live shard — use side="server" there (a
    shard process's client table is empty)."""
    data = heat_json(graph, shard)
    if side not in SIDES:
        raise ValueError(f"side must be one of {SIDES}")
    top = data["topk"][side]
    return top[:k] if k is not None else top


def heat_enabled() -> bool:
    return lib().eg_heat_enabled() == 1


def set_heat(on: bool) -> None:
    """Process-global heat kill-switch (`heat=` config key). The master
    telemetry switch gates it too: `telemetry=0` silences heat even
    when this flag is on."""
    lib().eg_heat_set_enabled(1 if on else 0)


def set_heat_topk(k: int) -> None:
    """Resize the hot-key tracker (`heat_topk=` config key; clamped to
    the fixed native pool). Resets the tables — space-saving guarantees
    only hold for a capacity kept over the whole stream."""
    lib().eg_heat_set_topk(int(k))


def heat_reset() -> None:
    """Zero sketches, top-K tables, ledgers and cache classes (the
    enabled flag and tracker capacity survive)."""
    lib().eg_heat_reset()


def record_heat(ids, op: str | int = "other", side: str = "client") -> None:
    """Feed a batch of ids through the same primitive the native hook
    points use — app-level access streams, and the exactness tests that
    pin the sketch against ground-truth counts."""
    arr = np.ascontiguousarray(np.asarray(ids).reshape(-1))
    if arr.dtype != np.uint64:
        arr = arr.astype(np.int64, copy=False).view(np.uint64)
    op_i = OP_NAMES.index(op) if isinstance(op, str) else int(op)
    lib().eg_heat_record(
        SIDES.index(side), op_i,
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(arr),
    )


def estimate(id: int, side: str = "client") -> int:
    """Count-min point estimate for one id: >= its true feed count
    always; overestimates bounded by (e/width) * stream-length per
    query with probability 1 - e^-depth (geometry in the dump's
    ``sketch`` section, pinned by tests)."""
    u64 = int(np.int64(id).view(np.uint64)) if id < 0 else int(id)
    return int(lib().eg_heat_estimate(SIDES.index(side), u64))


def zipf_fit(topk: list) -> dict:
    """Least-squares fit of log(count) ~ -alpha * log(rank) over a
    top-K table (hottest first): the tail exponent of the access skew.
    Returns {"alpha", "r2", "n"}; {} when under 3 points."""
    counts = [e["count"] for e in topk if e["count"] > 0]
    if len(counts) < 3:
        return {}
    x = np.log(np.arange(1, len(counts) + 1, dtype=np.float64))
    y = np.log(np.asarray(counts, dtype=np.float64))
    alpha, intercept = np.polyfit(x, y, 1)
    pred = alpha * x + intercept
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return {"alpha": round(float(-alpha), 4), "r2": round(r2, 4),
            "n": len(counts)}


def cache_hit_ceiling(topk: list, total: int, capacity_rows: int) -> dict:
    """Projected hit rate of a frequency-aware cache that pinned the
    `capacity_rows` hottest ids: sum of (count - 1) over the top-C ids
    divided by the total access stream (every access after an id's
    first is a hit). Counts beyond the tracked top-K are extrapolated
    from the Zipf fit; with capacity <= K the projection is exact up to
    the space-saving err bounds."""
    if total <= 0 or not topk:
        return {}
    counts = [e["count"] for e in topk]
    k = len(counts)
    cap = max(int(capacity_rows), 0)
    hits = sum(c - 1 for c in counts[:min(cap, k)])
    # guaranteed floor: space-saving only promises true >= count - err,
    # so a churned table (large errs) must not inflate the projection
    hits_lb = sum(
        max(e["count"] - e["err"] - 1, 0) for e in topk[:min(cap, k)]
    )
    extrapolated = 0
    if cap > k:
        fit = zipf_fit(topk)
        if fit:
            # extend the fitted power law over ranks k+1..cap
            c_k = counts[-1]
            alpha = fit["alpha"]
            for r in range(k + 1, cap + 1):
                c_r = c_k * (r / k) ** (-alpha)
                if c_r < 1.0:
                    break
                extrapolated += c_r - 1.0
    ceiling = min(1.0, (hits + extrapolated) / total)
    return {
        "capacity_rows": cap,
        "projected_hit_rate": round(ceiling, 4),
        "projected_hit_rate_lb": round(min(1.0, hits_lb / total), 4),
        "from_tracked_topk": round(min(1.0, hits / total), 4),
        "extrapolated": extrapolated > 0,
    }


def topk_share(data: dict, side: str = "client") -> float:
    """Share of the side's whole access stream absorbed by its tracked
    top-K ids — the one-number skew headline (1.0 = every access was a
    tracked hot id)."""
    total = data["sketch"]["total"][side]
    if not total:
        return 0.0
    return min(1.0, sum(e["count"] for e in data["topk"][side]) / total)


# epsilon of the count-min bound, derived from the dump's geometry
def cms_epsilon(data: dict) -> float:
    """e/width: with probability 1 - e^-depth an estimate exceeds the
    true count by at most epsilon * total-ids-fed."""
    return math.e / data["sketch"]["width"]
