"""Observability over the engine's native telemetry (counterpart of
``euler_tpu/telemetry.py``).

The engine (``graph/_native/eg_telemetry``, ``eg_phase``) keeps
log2-bucketed histograms (per RPC op on the client and the server, dial,
retry backoff, the step and serve phases), the counters and a slowest-N
span journal on each side; shards answer the STATS wire opcode with their
dump plus the admission gauges. This module reads them and renders them:

    telemetry.telemetry_json()        this process's dump
    telemetry.metrics_text()          Prometheus text, this process
    telemetry.metrics_text(graph=g)   every shard of a live cluster
    telemetry.slow_spans()            the local slow-span journal
    telemetry.scrape(g, shard)        one shard's dump
    telemetry.snapshot(step)          one compact metrics record
    telemetry.set_telemetry(False)    process-global kill-switch

It records the training loop's step phases and the prefetch pipeline's
gauges (``record_phase``, ``record_prefetch_gauges``: histograms
``phase:<name>``, ``prefetch_depth`` and ``prefetch_busy``), which
``append_metrics_line`` writes as JSONL (``run_loop --metrics_every``)
and a ``trace.TraceRecorder`` taps through ``set_trace_sink``, and the
serving layer's samples (``record_serve_phase``, ``record_serve_batch``,
keys ``serve:<phase>`` and ``serve_batch``)."""

from __future__ import annotations

import ctypes
import json
import time

from euler_tpu_torch.graph.native import lib

# Bucket layout, as eg_telemetry.h HistBucketOf: bucket 0 = [0, 1 us);
# bucket b (1..26) = [2^(b-1), 2^b) us; bucket 27 = [2^26, inf).
NUM_BUCKETS = 28

# Step-phase order, as eg_phase.h StepPhase (record_phase records by
# index). "compile" is the device plane's (devprof.py): kernel builds and
# CUDA-graph captures, not part of a step.
PHASES = ("input_stall", "sample", "h2d", "device", "host", "step",
          "compile")

# Serve-request phase order, as eg_phase.h ServePhase (the serving layer
# records by index through eg_serve_record).
SERVE_PHASES = ("queue_wait", "sample", "dispatch", "total")

def bucket_of(us: int) -> int:
    """Bucket index of a microsecond value (the native HistBucketOf)."""
    if us <= 0:
        return 0
    b = int(us).bit_length()
    return min(b, NUM_BUCKETS - 1)


def bucket_edges_us() -> list:
    """Upper bucket edges in us (27 finite edges, last bucket +Inf)."""
    return [1 << b for b in range(NUM_BUCKETS - 1)]


def percentiles(hist: dict, qs=(50, 90, 99)) -> dict:
    """Percentiles of one histogram dict ({"b": [...], "count": n,
    "sum_us": s}) by linear interpolation inside the containing log2
    bucket: {q: us float}; an empty histogram gives {}."""
    buckets = hist["b"]
    total = sum(buckets)
    if total == 0:
        return {}
    out = {}
    for q in qs:
        rank = q / 100.0 * total
        acc = 0.0
        for b, n in enumerate(buckets):
            if n == 0:
                continue
            if acc + n >= rank:
                lo = 0.0 if b == 0 else float(1 << (b - 1))
                # the open-ended last bucket gets a 2x-wide span
                hi = float(1 << b) if b < NUM_BUCKETS - 1 else lo * 2.0
                out[q] = lo + (hi - lo) * (rank - acc) / n
                break
            acc += n
    return out


def _json_abi(call) -> dict:
    """Run a (buf, cap) -> needed-length ABI call, growing the buffer
    until the dump fits, and parse the JSON."""
    cap = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = call(buf, cap)
        if n < 0:
            raise RuntimeError(lib().eg_last_error().decode())
        if n < cap:
            return json.loads(buf.value.decode())
        cap = n + 1


def telemetry_json() -> dict:
    """This process's telemetry dump: counters, span-timer stats, every
    histogram, the slow-span journal and the serve-SLO gauges."""
    return _json_abi(lambda buf, cap: lib().eg_telemetry_json(buf, cap))


def scrape(graph, shard: int) -> dict:
    """One live shard's dump over the STATS wire opcode: the shape of
    :func:`telemetry_json` plus a ``gauges`` section (handler pool,
    workers busy, queue depth, open connections, draining, epoch),
    fetched with the graph's own transport settings."""
    if getattr(graph, "mode", None) != "remote":
        raise ValueError("scrape() needs a mode='remote' graph (a local "
                         "graph is this process: use telemetry_json())")
    h = graph._h
    return _json_abi(
        lambda buf, cap: lib().eg_remote_scrape(h, shard, buf, cap))


def ping(graph, shard: int) -> bool:
    """One ping round trip to ``shard`` through the whole transport
    (retries, deadline, wire negotiation): True when it answered."""
    if getattr(graph, "mode", None) != "remote":
        raise ValueError("ping() needs a mode='remote' graph")
    return lib().eg_remote_ping(graph._h, shard) == 1


def record_span(total_us: int, op: int = 0, side: str = "client",
                outcome: int = 0, shard: int = -1, trace: int = 0,
                queue_us: int = 0, handler_us: int = 0,
                wire_us: int = 0) -> None:
    """Offer a span to the local journal (the primitive the native
    transport records through)."""
    lib().eg_telemetry_record_span(
        1 if side == "server" else 0, int(op), int(outcome), int(shard),
        int(trace), int(queue_us), int(handler_us), int(wire_us),
        int(total_us))


def slow_spans(graph=None, shard: int | None = None) -> list:
    """The slowest-N spans, slowest first: the local journal, or a live
    shard's when ``graph`` and ``shard`` name one. Trace ids come back
    as ints (0: not propagated)."""
    data = telemetry_json() if graph is None else scrape(graph, shard)
    spans = data["slow_spans"]
    for s in spans:
        s["trace"] = int(s["trace"])
    return spans


def set_slow_capacity(n: int) -> None:
    """Resize the slowest-N span journal (the ``slow_spans=`` key)."""
    lib().eg_telemetry_set_slow_capacity(int(n))


def telemetry_enabled() -> bool:
    return lib().eg_telemetry_enabled() == 1


def set_telemetry(on: bool) -> None:
    """Process-global kill-switch: False stops histogram recording
    (counters keep counting)."""
    lib().eg_telemetry_set_enabled(1 if on else 0)


def telemetry_reset() -> None:
    """Zero every histogram and the serve-SLO gauges (the enabled flag
    survives)."""
    lib().eg_telemetry_reset()


# the trace recorder's tap (trace.TraceRecorder): fn(phase, us, step) on
# every record_phase while a capture is active; None costs one read
_trace_sink = None


def set_trace_sink(fn) -> None:
    """Install (or clear, with None) the per-event phase sink, the trace
    recorder's tap into :func:`record_phase`."""
    global _trace_sink
    _trace_sink = fn


def record_phase(phase: str, us: float, step: int | None = None) -> None:
    """One step-phase sample in us (``PHASES``), into the
    ``phase:<phase>`` histogram (the kill-switch is honoured natively)
    and, while a trace capture is active, the recorder's buffer."""
    lib().eg_phase_record(PHASES.index(phase), max(int(us), 0))
    sink = _trace_sink
    if sink is not None:
        sink(phase, us, step)


def record_prefetch_gauges(queue_depth: int, workers_busy: int) -> None:
    """One prefetch sample at the consumer's dequeue: ready batches
    waiting and workers inside make_batch, the two value histograms that
    tell a starved queue (depth 0, workers busy) from slow or dead
    workers (depth 0, workers idle)."""
    L = lib()
    L.eg_phase_gauge(0, max(int(queue_depth), 0))
    L.eg_phase_gauge(1, max(int(workers_busy), 0))


def record_serve_phase(phase: str, us: float) -> None:
    """One serve-request phase sample in us (``SERVE_PHASES``), into the
    ``serve:<phase>`` histogram; the kill-switch is honoured natively."""
    lib().eg_serve_record(SERVE_PHASES.index(phase), max(int(us), 0))


def record_serve_batch(unique_ids: int) -> None:
    """One micro-batch dispatch of ``unique_ids`` ids, into the
    ``serve_batch`` value histogram: its count is dispatches, its sum
    ids, their ratio the coalescing factor."""
    lib().eg_serve_batch(max(int(unique_ids), 0))


def serve_hists(data: dict | None = None) -> dict:
    """{phase: histogram dict} of the serve-request phases, from a dump
    (default: this process's)."""
    data = data or telemetry_json()
    return {key.partition(":")[2]: h for key, h in data["hist"].items()
            if key.startswith("serve:")}


def phase_hists(data: dict | None = None) -> dict:
    """{phase: histogram dict} of the step phases, from a dump (default:
    this process's)."""
    data = data or telemetry_json()
    return {key.partition(":")[2]: h for key, h in data["hist"].items()
            if key.startswith("phase:")}


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

# kind -> (family, help, series-label for the per-kind key suffix;
# scalar kinds have no suffix and ignore the label)
_HIST_FAMILIES = {
    "client_call": ("eg_client_call_latency_us",
                    "Client whole-call latency per RPC op (retries "
                    "included), microseconds", "op"),
    "server_handler": ("eg_server_handler_latency_us",
                       "Server handler time per RPC op (decode + "
                       "execute + encode), microseconds", "op"),
    "server_queue": ("eg_server_queue_wait_us",
                     "Poller-ready to handler pickup wait, microseconds",
                     "op"),
    "dial": ("eg_dial_latency_us", "DialTcp latency, microseconds", "op"),
    "backoff": ("eg_retry_backoff_us",
                "Retry backoff sleeps, microseconds", "op"),
    "phase": ("eg_step_phase_us",
              "Training step-phase wall time (input_stall/sample/h2d/"
              "device/host/step, plus XLA compile), microseconds",
              "phase"),
    "prefetch_depth": ("eg_prefetch_queue_depth",
                       "Ready batches in the prefetch queue at consumer "
                       "dequeue (value histogram)", "op"),
    "prefetch_busy": ("eg_prefetch_workers_busy",
                      "Prefetch workers inside make_batch at consumer "
                      "dequeue (value histogram)", "op"),
    "heat_spread": ("eg_heat_shard_spread",
                    "Shards touched per client call (value histogram "
                    "per op — data-plane heat fan-out attribution)",
                    "op"),
    "serve": ("eg_serve_phase_us",
              "Serve-request phase wall time (queue_wait/sample/"
              "dispatch/total), microseconds", "phase"),
    "serve_batch": ("eg_serve_batch_ids",
                    "Unique ids per micro-batch device dispatch (value "
                    "histogram; count = dispatches, sum = ids)", "op"),
}

_GAUGE_FAMILIES = {
    "workers": ("eg_workers", "Fixed handler pool size"),
    "workers_active": ("eg_workers_active", "Workers currently serving"),
    "queue_depth": ("eg_queue_depth",
                    "Ready connections waiting for a worker"),
    "conns": ("eg_conns", "Admitted open connections"),
    "draining": ("eg_draining", "1 while the server drains"),
    "epoch": ("eg_epoch",
              "Current serving snapshot epoch (0 = base load; each "
              "applied delta flips it up by one)"),
}

# Process resource gauges (eg_blackbox.h: sampled live for every dump,
# background-sampled into the HISTORY ring, frozen into postmortems).
_RESOURCE_FAMILIES = {
    "rss_bytes": ("eg_rss_bytes",
                  "Resident set size of the process, bytes"),
    "open_fds": ("eg_open_fds", "Open file descriptors"),
    "threads": ("eg_threads", "Live OS threads"),
    "cache_bytes": ("eg_cache_bytes",
                    "Client feature-row cache resident bytes"),
    "nbr_cache_bytes": ("eg_nbr_cache_bytes",
                        "Client neighbor-list cache resident bytes"),
    "device_mem_bytes": ("eg_device_mem_bytes",
                         "Device (HBM) bytes in use — memory_stats() "
                         "where present, live-array census on CPU"),
    "device_mem_peak_bytes": ("eg_device_mem_peak_bytes",
                              "High-water mark of eg_device_mem_bytes "
                              "since start/reset"),
    "device_buffers": ("eg_device_buffers",
                       "Live device buffers at the last devprof sample"),
}


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return "{" + inner + "}"


def _render(sources: list) -> str:
    """Render [(telemetry dict, base labels), ...] as one Prometheus
    text exposition — families emitted once, series per source."""
    lines = []
    edges = bucket_edges_us()

    for kind, (fam, help_text, label) in _HIST_FAMILIES.items():
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} histogram")
        for data, base in sources:
            for key, h in sorted(data["hist"].items()):
                k, _, op = key.partition(":")
                if k != kind:
                    continue
                labels = dict(base)
                if op:
                    labels[label] = op
                cum = 0
                for b, n in enumerate(h["b"]):
                    cum += n
                    le = str(edges[b]) if b < len(edges) else "+Inf"
                    bl = dict(labels)
                    bl["le"] = le
                    lines.append(f"{fam}_bucket{_fmt_labels(bl)} {cum}")
                lines.append(
                    f"{fam}_sum{_fmt_labels(labels)} {h['sum_us']}"
                )
                lines.append(
                    f"{fam}_count{_fmt_labels(labels)} {h['count']}"
                )

    lines.append("# HELP eg_counter_total Transport/server event "
                 "counters (see FAULTS.md)")
    lines.append("# TYPE eg_counter_total counter")
    for data, base in sources:
        for name, v in sorted(data["counters"].items()):
            labels = dict(base)
            labels["name"] = name
            lines.append(f"eg_counter_total{_fmt_labels(labels)} {v}")

    lines.append("# HELP eg_stat_calls_total Span-timer call counts "
                 "per engine op")
    lines.append("# TYPE eg_stat_calls_total counter")
    for data, base in sources:
        for name, (count, total_ns, max_ns) in sorted(
            data["stats"].items()
        ):
            labels = dict(base)
            labels["op"] = name
            lines.append(
                f"eg_stat_calls_total{_fmt_labels(labels)} {count}"
            )

    for gkey, (fam, help_text) in _GAUGE_FAMILIES.items():
        emitted_header = False
        for data, base in sources:
            gauges = data.get("gauges")
            if gauges is None or gkey not in gauges:
                continue
            if not emitted_header:
                lines.append(f"# HELP {fam} {help_text}")
                lines.append(f"# TYPE {fam} gauge")
                emitted_header = True
            lines.append(f"{fam}{_fmt_labels(dict(base))} {gauges[gkey]}")

    for rkey, (fam, help_text) in _RESOURCE_FAMILIES.items():
        emitted_header = False
        for data, base in sources:
            resource = data.get("resource")
            if resource is None or rkey not in resource:
                continue
            if not emitted_header:
                lines.append(f"# HELP {fam} {help_text}")
                lines.append(f"# TYPE {fam} gauge")
                emitted_header = True
            lines.append(
                f"{fam}{_fmt_labels(dict(base))} {resource[rkey]}"
            )

    # live serve-SLO gauges (eg_devprof.h "serve_slo" section): the
    # windowed p50/p99 the SLOTracker pushes through the ABI, plus the
    # lifetime violation count — a scrape reads serving latency without
    # draining the server. Headers always (the section is always
    # emitted, zeros included).
    lines.append("# HELP eg_serve_slo_ms Serve request latency over the "
                 "SLO tracker window, milliseconds")
    lines.append("# TYPE eg_serve_slo_ms gauge")
    for data, base in sources:
        slo = data.get("serve_slo")
        if slo is None:
            continue
        for q in ("p50", "p99"):
            labels = dict(base)
            labels["quantile"] = q
            lines.append(
                f"eg_serve_slo_ms{_fmt_labels(labels)} "
                f"{slo[q + '_us'] / 1000.0:.3f}"
            )
    lines.append("# HELP eg_serve_slo_violations_total Lifetime serve "
                 "replies over the SLO target")
    lines.append("# TYPE eg_serve_slo_violations_total counter")
    for data, base in sources:
        slo = data.get("serve_slo")
        if slo is None:
            continue
        lines.append(
            f"eg_serve_slo_violations_total{_fmt_labels(dict(base))} "
            f"{slo['violations']}"
        )

    # data-plane heat (eg_heat.h "heat" section): per-(side, op) id
    # feeds, cache-efficacy classes, and the top-K concentration
    # headline — nonzero series only, headers always (dashboards before
    # traffic)
    lines.append("# HELP eg_heat_ids_total Vertex ids fed to the heat "
                 "profiler per side and op (client: post-coalesce; "
                 "server: pre-execute)")
    lines.append("# TYPE eg_heat_ids_total counter")
    for data, base in sources:
        heat = data.get("heat")
        if not heat:
            continue
        for key, v in sorted(heat["ids"].items()):
            side, _, op = key.partition(":")
            labels = dict(base)
            labels["side"] = side
            labels["op"] = op
            lines.append(f"eg_heat_ids_total{_fmt_labels(labels)} {v}")
    lines.append("# HELP eg_heat_cache_class_total Feature-cache events "
                 "bucketed by the key's sketch-estimated frequency class "
                 "(class c covers estimates in [2^(c-1), 2^c))")
    lines.append("# TYPE eg_heat_cache_class_total counter")
    for data, base in sources:
        heat = data.get("heat")
        if not heat:
            continue
        for event, classes in sorted(heat["cache_class"].items()):
            for cls, v in enumerate(classes):
                if not v:
                    continue
                labels = dict(base)
                labels["event"] = event
                labels["class"] = str(cls)
                lines.append(
                    f"eg_heat_cache_class_total{_fmt_labels(labels)} {v}"
                )
    lines.append("# HELP eg_heat_topk_share Share of the side's access "
                 "stream absorbed by its tracked top-K hot ids")
    lines.append("# TYPE eg_heat_topk_share gauge")
    for data, base in sources:
        heat = data.get("heat")
        if not heat:
            continue
        for side in ("client", "server"):
            total = heat["sketch"]["total"].get(side, 0)
            if not total:
                continue
            share = min(
                1.0,
                sum(e["count"] for e in heat["topk"][side]) / total,
            )
            labels = dict(base)
            labels["side"] = side
            lines.append(
                f"eg_heat_topk_share{_fmt_labels(labels)} {share:.6f}"
            )

    return "\n".join(lines) + "\n"


def metrics_text(graph=None, shard: int | None = None) -> str:
    """Prometheus text exposition: of this process with no arguments;
    with a remote ``graph``, of every shard of the live cluster over the
    STATS opcode, one series set a shard (label ``shard="N"``), or of
    ``shard`` alone. Every family's header is emitted even at zero
    count, so dashboards can be built before traffic exists."""
    if graph is None:
        return _render([(telemetry_json(), {})])
    shards = [shard] if shard is not None else range(graph.num_shards)
    return _render([(scrape(graph, s), {"shard": str(s)}) for s in shards])


# ---------------------------------------------------------------------------
# JSONL lines (run_loop --metrics_every)
# ---------------------------------------------------------------------------


def _pct_row(h: dict) -> dict:
    pct = percentiles(h, (50, 99))
    return {"count": h["count"], "p50_us": round(pct.get(50, 0.0), 1),
            "p99_us": round(pct.get(99, 0.0), 1)}


def snapshot(step: int | None = None) -> dict:
    """One compact metrics record of this process: the nonzero counters,
    each client op's count and p50/p99 us, each step phase's count and
    p50/p99 us, the mean consumer stall a step (``input_stall_ms``) and
    the prefetch pipeline's mean queue depth and busy workers."""
    data = telemetry_json()
    ops = {}
    for key, h in data["hist"].items():
        kind, _, op = key.partition(":")
        if kind == "client_call" and h["count"]:
            ops[op] = _pct_row(h)
    hists = phase_hists(data)
    phases = {name: _pct_row(h) for name, h in hists.items() if h["count"]}
    out = {
        "step": step,
        "unix_ms": int(time.time() * 1000),
        "counters": {k: v for k, v in data["counters"].items() if v},
        "ops": ops,
        "phases": phases,
    }
    stall = hists.get("input_stall")
    if stall and stall["count"]:
        out["input_stall_ms"] = round(
            stall["sum_us"] / stall["count"] / 1000.0, 3)
    for key, name in (("prefetch_depth", "mean_queue_depth"),
                      ("prefetch_busy", "mean_workers_busy")):
        h = data["hist"].get(key)
        if h and h["count"]:
            out.setdefault("prefetch", {})[name] = round(
                h["sum_us"] / h["count"], 2)
    return out


def append_metrics_line(path: str, step: int | None = None) -> None:
    """Append one :func:`snapshot` line to a JSONL file."""
    with open(path, "a") as f:
        f.write(json.dumps(snapshot(step)) + "\n")
