"""The flight recorder and its postmortems (counterpart of
``euler_tpu/blackbox.py``), over the port's engine
(``graph/_native/eg_blackbox``).

The engine keeps an always-on lock-free flight recorder (one ring of
fixed-slot events a thread, fed from the transport, admission,
dispatcher and step-phase hook points), samples the process's resource
gauges (RSS, open fds, live threads, client cache bytes, and the device
memory ``devprof.sample_device_mem`` pushes) into a 60-entry history
ring, and, once :func:`install` has armed it, writes an
async-signal-safe postmortem on SIGSEGV, SIGBUS, SIGABRT or SIGFPE:

    blackbox.install(dir)           arm the fatal-signal dump
    blackbox.blackbox_json()        live rings and resource history
    blackbox.history(g, s)          a live shard's resource ring
    blackbox.postmortem_read(path)  parse dump file(s) back to dicts
    blackbox.set_blackbox(False)    process-global kill-switch

:func:`write_postmortem` is the manual dump ``run_loop`` writes on an
unhandled exception, and :func:`record` an app-level event.

A postmortem's first line is one JSON document (signal, counters,
admission gauges, resource history, the rings, backtrace addresses); the
lines after it are ``backtrace_symbols_fd`` frames (symbolization cannot
run inside a signal handler), which :func:`postmortem_read` returns
under ``backtrace_symbols``.
"""

from __future__ import annotations

import json
import os

from euler_tpu_torch.graph.native import lib
from euler_tpu_torch.telemetry import _json_abi

# Flight-recorder hook points, as eg_blackbox.h BlackboxPoint.
POINTS = ("client_call", "server_recv", "server_reply", "dispatch",
          "phase", "app")


def install(postmortem_dir: str | None = None, shard: int = -1,
            sample_ms: int = 0) -> None:
    """Arm the postmortem path: install the fatal-signal handlers,
    start the resource sampler, and (when ``postmortem_dir`` is given)
    point the dump at ``<dir>/postmortem.<pid>.json``. Re-invocable —
    later calls update the directory/shard label. Raises RuntimeError
    when the directory is not writable (a typo'd dir must fail at init,
    not stay silent until the one crash that needed it)."""
    if postmortem_dir:
        try:
            os.makedirs(postmortem_dir, exist_ok=True)
        except OSError:
            pass  # the native writability probe reports it uniformly
    rc = lib().eg_blackbox_init(
        (postmortem_dir or "").encode(), int(shard), int(sample_ms)
    )
    if rc != 0:
        raise RuntimeError(lib().eg_last_error().decode())


def blackbox_enabled() -> bool:
    return lib().eg_blackbox_enabled() == 1


def set_blackbox(on: bool) -> None:
    """Process-global flight-recorder kill-switch (`blackbox=` config
    key): False stops ring recording everywhere AND suppresses the
    fatal-signal dump (the handler still re-raises, so the process
    dies with the same status either way)."""
    lib().eg_blackbox_set_enabled(1 if on else 0)


def blackbox_reset() -> None:
    """Zero the flight-recorder rings + drop ledger (the enabled flag,
    installed handlers and resource history survive)."""
    lib().eg_blackbox_reset()


def record(point: str = "app", op: int = 0, shard: int = -1,
           trace: int = 0, value: int = 0, outcome: int = 0) -> None:
    """One app-level flight-recorder event (same rings the native
    transport hooks write). Raises ValueError on an unknown point."""
    lib().eg_blackbox_record(
        POINTS.index(point), int(op), int(shard), int(trace), int(value),
        int(outcome),
    )


def blackbox_json() -> dict:
    """Live dump of this process's flight-recorder rings (oldest-first
    per ring) and resource gauges — what a postmortem would freeze,
    readable while everything is still fine."""
    return _json_abi(lambda buf, cap: lib().eg_blackbox_json(buf, cap))


def history(graph=None, shard: int | None = None) -> dict:
    """Resource-gauge history: this process's by default, a live
    shard's over the kHistory wire opcode when (graph, shard) name one.
    Returns {"shard": n, "resource": {latest}, "history": [samples]} —
    the live twin of a postmortem's frozen ``resource_history``."""
    if graph is None:
        return _json_abi(
            lambda buf, cap: lib().eg_blackbox_history(buf, cap)
        )
    if getattr(graph, "mode", None) != "remote":
        raise ValueError("history(graph=...) needs a mode='remote' graph "
                         "(a local graph IS this process)")
    h = graph._h
    return _json_abi(
        lambda buf, cap: lib().eg_remote_history(h, shard or 0, buf, cap)
    )


def write_postmortem(path: str) -> str:
    """Write a postmortem dump NOW (same format as the fatal-signal
    dump, signal 0 = "exception") — the manual path behind run_loop's
    crash-dump-on-unhandled-exception. Returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib().eg_blackbox_dump(path.encode())
    if rc != 0:
        raise RuntimeError(lib().eg_last_error().decode())
    return path


def postmortem_read(path: str) -> dict | list:
    """Parse postmortem dump(s).

    ``path`` may be one dump file (returns its dict) or a directory
    (returns every ``postmortem.*.json`` in it, oldest first). The
    backtrace_symbols_fd frames after the JSON line come back under
    ``backtrace_symbols``; ``trace`` fields in ring events are decimal
    strings (u64-exact), left as strings for the caller to int()."""
    if os.path.isdir(path):
        dumps = []
        for name in sorted(
            (f for f in os.listdir(path)
             if f.startswith("postmortem.") and f.endswith(".json")),
            key=lambda f: os.path.getmtime(os.path.join(path, f)),
        ):
            dumps.append(postmortem_read(os.path.join(path, name)))
        return dumps
    with open(path) as f:
        first = f.readline()
        rest = f.read()
    doc = json.loads(first)
    doc["path"] = path
    doc["backtrace_symbols"] = [
        line for line in rest.splitlines() if line.strip()
    ]
    return doc
