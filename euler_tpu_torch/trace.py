"""One Chrome-trace / Perfetto export of a training run (counterpart of
``euler_tpu/trace.py``).

The histograms (telemetry.py) say how much time each phase takes; the
trace says when: one merged timeline where a slow step can be followed
from the consumer's ``input_stall`` slice to the prefetch worker's
``sample`` slice, to the shard handler that caused it (linked by the
wire's trace ids), and down to the card's kernels.

It merges into one ``traceEvents`` JSON:

  * the step-phase events: :class:`TraceRecorder` taps
    ``telemetry.record_phase`` while active, so the training loop and
    the prefetch workers need no other plumbing;
  * this process's slow-span journal (the client side of every RPC) and
    each live shard's (over the STATS scrape, the server side);
  * with a ``torch.profiler`` capture (``run_loop --profile_dir``), its
    device events, the card's kernels, copies and memsets
    (:func:`ingest_profiler_dir`), on lanes of their own.

Timeline: CLOCK_MONOTONIC microseconds, ``time.monotonic_ns() // 1000``
here and ``std::chrono::steady_clock`` in the native spans, so phase
events and the spans of shard processes on one host line up. The
profiler's events sit on Kineto's own epoch; the ``eg_align:<us>``
marker that ``train.train`` stamps right after the profiler starts
(:func:`align_annotation`) carries the monotonic time of that instant,
from which the ingest solves the offset. ``run_loop --trace_file``
writes the merged trace when training ends; open it in
ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import threading
import time
from collections import deque

from euler_tpu_torch import telemetry as _telemetry

# Synthetic pids: one "process" lane per source in the merged view.
PID_TRAIN = 1
PID_SHARD_BASE = 100  # shard s renders as pid 100+s
PID_DEVICE_BASE = 200  # torch.profiler device lanes render from pid 200

# The alignment marker train.train stamps into a torch.profiler capture.
# Kineto's timestamps sit on an epoch of their own, not CLOCK_MONOTONIC;
# the monotonic us in the marker's name lets ingest_profiler_dir solve
# for the offset exactly instead of guessing from wall clocks.
ALIGN_PREFIX = "eg_align:"


def now_us() -> int:
    """CLOCK_MONOTONIC us, the exporter's one clock (the native spans'
    steady_clock ``end_us`` stamps)."""
    return time.monotonic_ns() // 1000


class TraceRecorder:
    """Bounded in-memory buffer of step-phase events.

    ``start()`` registers the recorder as the telemetry phase sink;
    every ``record_phase(phase, us, step)`` anywhere in the process
    (train loop, prefetch consumer, prefetch workers) then lands here
    with its thread identity, until ``stop()``. The buffer is a ring:
    beyond ``capacity`` events the oldest fall off (``dropped`` counts
    them), so a week-long run cannot run the trainer out of memory."""

    def __init__(self, capacity: int = 200_000):
        self._events: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self.dropped = 0
        self.started_us: int | None = None

    def start(self) -> "TraceRecorder":
        self.started_us = now_us()
        _telemetry.set_trace_sink(self._on_phase)
        return self

    def stop(self) -> None:
        if _telemetry._trace_sink is self._on_phase:
            _telemetry.set_trace_sink(None)

    def _on_phase(self, phase: str, us: float, step: int | None) -> None:
        end = now_us()
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(
                (phase, end - max(int(us), 0), int(us), step,
                 threading.current_thread().name)
            )

    def events(self) -> list:
        with self._lock:
            return list(self._events)


def _phase_trace_events(phase_events: list) -> list:
    """Recorder tuples -> complete ("X") slice events on the train pid,
    one tid lane per recording thread."""
    out = []
    tids: dict = {}
    for phase, ts, dur, step, thread_name in phase_events:
        tid = tids.setdefault(thread_name, len(tids) + 1)
        ev = {
            "name": phase, "cat": "phase", "ph": "X",
            "ts": ts, "dur": dur, "pid": PID_TRAIN, "tid": tid,
        }
        if step is not None:
            ev["args"] = {"step": step}
        out.append(ev)
    for thread_name, tid in tids.items():
        out.append({
            "name": "thread_name", "ph": "M", "pid": PID_TRAIN,
            "tid": tid, "args": {"name": thread_name},
        })
    return out


def _span_trace_events(data: dict, pid: int, label: str) -> list:
    """One telemetry dump's slow-span journal -> slice events (client
    spans on tid 90, server spans on tid 91) carrying the wire-v3 trace
    id, outcome, and the queue/handler/wire decomposition."""
    out = []
    for s in data.get("slow_spans", []):
        end = int(s.get("end_us", 0))
        dur = int(s["total_us"])
        server = s["side"] == "server"
        out.append({
            "name": s["op"], "cat": "rpc", "ph": "X",
            "ts": end - dur, "dur": dur,
            "pid": pid, "tid": 91 if server else 90,
            "args": {
                "trace": f"{int(s['trace']):#x}",
                "side": s["side"], "outcome": s["outcome"],
                "shard": s["shard"], "queue_us": s["queue_us"],
                "handler_us": s["handler_us"], "wire_us": s["wire_us"],
                "source": label,
            },
        })
    out.append({
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": label},
    })
    for tid, name in ((90, "rpc client calls"), (91, "rpc handlers")):
        out.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
    return out


def _flow_events(span_events: list) -> list:
    """Client-call -> server-handler flow arrows: for every wire-v3
    trace id seen on BOTH a client and a server span, emit an
    "s"/"f" pair so Perfetto links them across process lanes (and
    across clock skew, when shards live on other hosts)."""
    by_trace: dict = {}
    for ev in span_events:
        args = ev.get("args")
        if not args or "trace" not in args:
            continue
        if int(args["trace"], 16) == 0:
            continue  # id not propagated (v1/v2 peer / telemetry off)
        side = args["side"]
        by_trace.setdefault(args["trace"], {})[side] = ev
    out = []
    for trace, sides in by_trace.items():
        if "client" not in sides or "server" not in sides:
            continue
        cli, srv = sides["client"], sides["server"]
        common = {"name": "rpc", "cat": "rpc-flow", "id": trace}
        out.append({**common, "ph": "s", "ts": cli["ts"],
                    "pid": cli["pid"], "tid": cli["tid"]})
        out.append({**common, "ph": "f", "bp": "e",
                    "ts": srv["ts"] + srv["dur"],
                    "pid": srv["pid"], "tid": srv["tid"]})
    return out


def align_annotation(monotonic_us: int | None = None):
    """A ``torch.profiler.record_function`` context whose name carries
    CLOCK_MONOTONIC us, so the ingest can map the profiler's epoch onto
    the exporter's timeline. Enter it, with an empty body, right after
    the profiler starts."""
    import torch

    us = monotonic_us if monotonic_us is not None else now_us()
    return torch.profiler.record_function(f"{ALIGN_PREFIX}{us}")


def _latest_profiler_trace(profile_dir: str) -> str | None:
    """Newest ``<worker>.<ts>.pt.trace.json[.gz]`` that
    ``torch.profiler.tensorboard_trace_handler`` wrote into
    ``profile_dir``."""
    paths = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    paths += glob.glob(os.path.join(profile_dir, "*.pt.trace.json.gz"))
    return max(paths, key=os.path.getmtime) if paths else None


# Kineto's device-side event categories: the card's kernels, copies and
# memsets (host lanes carry cpu_op, user_annotation, cuda_runtime, ...)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_profiler_trace(path: str) -> tuple:
    """``(events, offset)`` of one profiler trace file: its traceEvents
    and the us to add to a Kineto ``ts`` to put it on the monotonic
    timeline, solved from the host-side ``eg_align:`` marker (None when
    no marker was stamped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents") or []
    for ev in events:
        if ev.get("cat") == "user_annotation" and "ts" in ev:
            m = re.match(ALIGN_PREFIX + r"(\d+)$", str(ev.get("name", "")))
            if m:
                return events, int(m.group(1)) - float(ev["ts"])
    return events, None


def ingest_profiler_dir(profile_dir: str, max_events: int = 50_000) -> list:
    """A ``torch.profiler`` capture directory -> device-lane trace events
    on the exporter's CLOCK_MONOTONIC timeline.

    Reads the newest capture, keeps its complete ("X") events of the
    device categories (``DEVICE_CATS``), shifts them by the offset the
    ``eg_align:`` marker gives (raw profiler time when there is none)
    and remaps each GPU lane's pid (the device index) into the
    PID_DEVICE_BASE block, so the kernels render as a process of their
    own beside the host phases. Returns [] when the directory holds no
    capture or an unreadable one: exporting a trace never fails a
    training teardown."""
    path = _latest_profiler_trace(profile_dir)
    if path is None:
        return []
    try:
        events, offset = load_profiler_trace(path)
    except Exception:
        return []
    offset = offset or 0.0
    pid_names: dict = {}
    tid_names: dict = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        name = (ev.get("args") or {}).get("name", "")
        if ev.get("name") == "process_name":
            pid_names[ev.get("pid")] = name
        elif ev.get("name") == "thread_name":
            tid_names[(ev.get("pid"), ev.get("tid"))] = name
    lanes: dict = {}  # source pid -> synthetic device pid
    used_tids: set = set()
    out = []
    for ev in events:
        if (ev.get("ph") != "X" or "ts" not in ev
                or str(ev.get("cat", "")).lower() not in DEVICE_CATS):
            continue
        pid, tid = ev.get("pid"), ev.get("tid")
        new_pid = lanes.setdefault(pid, PID_DEVICE_BASE + len(lanes))
        used_tids.add((pid, tid))
        out.append({
            "name": ev.get("name", "?"), "cat": "device", "ph": "X",
            "ts": int(round(float(ev["ts"]) + offset)),
            "dur": max(int(round(float(ev.get("dur", 0)))), 0),
            "pid": new_pid, "tid": tid,
            "args": {"kind": str(ev.get("cat"))},
        })
    if len(out) > max_events:
        # keep the longest slices: a long capture can hold millions of
        # short events that would swamp the export
        out.sort(key=lambda e: e["dur"], reverse=True)
        del out[max_events:]
        out.sort(key=lambda e: e["ts"])
    for pid, new_pid in lanes.items():
        out.append({
            "name": "process_name", "ph": "M", "pid": new_pid,
            "args": {"name": f"device: {pid_names.get(pid) or pid}"},
        })
    for pid, tid in used_tids:
        name = tid_names.get((pid, tid))
        if name:
            out.append({
                "name": "thread_name", "ph": "M", "pid": lanes[pid],
                "tid": tid, "args": {"name": name},
            })
    return out


def chrome_trace(phase_events: list | None = None,
                 span_sources: list | None = None,
                 base_events: list | None = None) -> dict:
    """Build the merged trace dict.

    phase_events: TraceRecorder tuples (or None);
    span_sources: [(telemetry dump dict, pid, label), ...];
    base_events: pre-built traceEvents to merge under (an existing
    trace file's, to merge into)."""
    events = list(base_events or [])
    if phase_events:
        events.extend(_phase_trace_events(phase_events))
        events.append({
            "name": "process_name", "ph": "M", "pid": PID_TRAIN,
            "args": {"name": "train (step phases)"},
        })
    span_events: list = []
    for data, pid, label in span_sources or []:
        span_events.extend(_span_trace_events(data, pid, label))
    events.extend(span_events)
    events.extend(_flow_events(
        [e for e in events if e.get("cat") == "rpc"]
    ))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def gather_span_sources(graph=None) -> list:
    """This process's journal plus, for a live remote graph, every
    reachable shard's, as ``chrome_trace`` span_sources. A shard that
    fails to scrape is skipped (trace export must never fail a training
    teardown), noted under its label."""
    sources = [(_telemetry.telemetry_json(), PID_TRAIN,
                "train (client journal)")]
    if graph is not None and getattr(graph, "mode", None) == "remote":
        for s in range(graph.num_shards):
            try:
                sources.append((_telemetry.scrape(graph, s),
                                PID_SHARD_BASE + s, f"shard {s}"))
            except Exception:
                pass  # unreachable shard: trace ships without its side
    return sources


def write_trace(path: str, recorder: TraceRecorder | None = None,
                graph=None, base_events: list | None = None,
                profile_dir: str | None = None) -> dict:
    """Export the merged trace to ``path`` and return it. When a
    ``torch.profiler`` capture directory is given its device lanes merge
    in, time-aligned with the host phase events."""
    base = list(base_events or [])
    if profile_dir:
        base.extend(ingest_profiler_dir(profile_dir))
    trace = chrome_trace(
        recorder.events() if recorder is not None else None,
        gather_span_sources(graph),
        base,
    )
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def validate_chrome_trace(trace: dict) -> list:
    """Structural validity check (tests and chip_smoke.py): returns
    the trace's events after asserting the Chrome-trace invariants the
    viewers rely on. Raises ValueError on the first violation."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("not a Chrome trace: no traceEvents key")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents is not a list")
    for ev in events:
        for k in ("name", "ph", "pid"):
            if k not in ev:
                raise ValueError(f"event missing {k!r}: {ev}")
        if ev["ph"] == "X":
            if "ts" not in ev or "dur" not in ev:
                raise ValueError(f"X event missing ts/dur: {ev}")
            if ev["dur"] < 0 or not isinstance(ev["ts"], int):
                raise ValueError(f"bad X timing: {ev}")
        if ev["ph"] in ("s", "f") and "id" not in ev:
            raise ValueError(f"flow event missing id: {ev}")
    return events


def correlated_trace_ids(trace: dict) -> set:
    """Trace ids carried by both a client and a server rpc slice: the
    cross-process correlation."""
    sides: dict = {}
    for ev in trace["traceEvents"]:
        args = ev.get("args") or {}
        if ev.get("cat") == "rpc" and "trace" in args:
            sides.setdefault(args["trace"], set()).add(args["side"])
    return {t for t, ss in sides.items()
            if {"client", "server"} <= ss and int(t, 16) != 0}
