"""Graph-service shard launcher (counterpart of
``euler_tpu/graph/service.py``).

The engine's native service (``_native/eg_service.cc``) runs its own
poller and a bounded handler pool (``eg_admission.h``), so
``GraphService(...)`` returns as soon as the shard has loaded its
partitions and bound its port. Discovery is a flat-file registry
directory (shared filesystem) or a TCP registry (``registry=
"tcp://host:port"`` of a ``graph.registry`` server; the shard heartbeats
to keep its entry alive).

``workers=`` bounds the handler pool (default twice the cores),
``pending=`` the admitted work beyond it (connections past both get a
BUSY reply that clients fail over on), and ``drain()`` is the graceful
half of a rolling restart: deregister, finish in-flight requests, close.
The standalone process wires SIGTERM to that drain:

    python -m euler_tpu_torch.graph.service --data_dir d --shard_idx 0 \\
        --shard_num 2 --registry /shared/reg

A ``data_dir`` behind an fsspec URL (``gs://``, ``memory://``) is
staged for this shard first (``graph/remote_fs.py``).

The shard speaks the JAX package's wire protocol (the engine is one
copy), so either package's client reads either package's shards.
"""

from __future__ import annotations

import os

from euler_tpu_torch.graph import remote_fs
from euler_tpu_torch.graph.native import lib


class GraphService:
    """One graph shard served over TCP; stops on ``stop()`` or GC. Port
    0 binds a free port, read back into ``port``."""

    def __init__(
        self,
        data_dir: str,
        shard_idx: int = 0,
        shard_num: int = 1,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: str | None = None,
        workers: int | None = None,
        pending: int | None = None,
        options: str | None = None,
        postmortem_dir: str | None = None,
        blackbox: bool | None = None,
    ):
        self._lib = lib()
        self._h = None
        data_dir = str(data_dir)
        if remote_fs.is_remote_path(data_dir):
            # a shard on a remote directory stages its own partitions
            # (into $EULER_TPU_CACHE) before the native loader reads them
            data_dir = remote_fs.stage_directory(
                data_dir, shard_idx=shard_idx, shard_num=shard_num)
        else:
            data_dir = remote_fs.strip_local_scheme(data_dir)
        # the common admission knobs get keywords; the long tail
        # (max_conns, io_timeout_ms, idle_timeout_ms, linger_ms, drain_ms,
        # wire_version, telemetry, slow_spans, heat, heat_topk) rides in
        # options=; blackbox= and postmortem_dir= arm this process's
        # flight recorder and its fatal-signal dump
        opts = []
        if workers is not None:
            opts.append(f"workers={int(workers)}")
        if pending is not None:
            opts.append(f"pending={int(pending)}")
        if blackbox is not None:
            opts.append(f"blackbox={1 if blackbox else 0}")
        if postmortem_dir is not None:
            # the native probe fails loudly on an unwritable directory;
            # create it so a fresh path just works
            os.makedirs(postmortem_dir, exist_ok=True)
            opts.append(f"postmortem_dir={postmortem_dir}")
        if options:
            opts.append(options)
        self._h = self._lib.eg_service_start(
            data_dir.encode(), shard_idx, shard_num, host.encode(), port,
            (registry or "").encode(), ";".join(opts).encode())
        if not self._h:
            raise RuntimeError("graph service start failed: "
                               + self._lib.eg_last_error().decode())
        self.host = host
        self.port = self._lib.eg_service_port(self._h)
        self.shard_idx = shard_idx
        self.shard_num = shard_num

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def epoch(self) -> int:
        """The serving snapshot's epoch (0 until the first delta)."""
        if not self._h:
            return 0
        return int(self._lib.eg_service_epoch(self._h))

    def load_delta(self, path: str) -> int:
        """Merge one ``<prefix>.delta.<n>`` file into a fresh snapshot and
        flip the serving epoch; requests in flight keep reading the old
        snapshot until they finish. Returns the new epoch; raises on
        failure, the old snapshot still serving."""
        ep = self._lib.eg_service_load_delta(self._h, path.encode())
        if ep < 0:
            raise RuntimeError(self._lib.eg_last_error().decode())
        return int(ep)

    def drain(self, grace_ms: int = 0) -> None:
        """Deregister, stop accepting, let in-flight requests finish
        (within ``grace_ms``; 0 is the service's ``drain_ms`` option,
        5 s by default) and close every connection. ``stop()`` still
        frees the handle."""
        if self._h:
            self._lib.eg_service_drain(self._h, int(grace_ms))

    def stop(self) -> None:
        if getattr(self, "_h", None):
            self._lib.eg_service_stop(self._h)
            self._h = None

    close = stop

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def main(argv=None) -> None:
    import argparse
    import signal
    import sys
    import time

    from euler_tpu_torch.graph import native

    ap = argparse.ArgumentParser(description="Run one graph-service shard.")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--shard_idx", type=int, default=0)
    ap.add_argument("--shard_num", type=int, default=1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--registry", default=None)
    ap.add_argument("--workers", type=int, default=None, help=(
        "handler pool size (default: twice the cores); connections beyond "
        "workers+pending get a BUSY reply the client fails over on"))
    ap.add_argument("--pending", type=int, default=None, help=(
        "admitted work beyond the handler pool before new connections "
        "are answered BUSY (default 64)"))
    ap.add_argument("--options", default=None, help=(
        "extra k=v;k=v admission options (max_conns, io_timeout_ms, "
        "idle_timeout_ms, linger_ms, drain_ms, wire_version, telemetry, "
        "slow_spans, heat, heat_topk; eg_admission.h)"))
    ap.add_argument("--load_delta", action="append", default=[], help=(
        "delta file(s) to merge right after the base load, one epoch flip "
        "each, in the order given; the shard serves after the last"))
    ap.add_argument("--fault", default="", help=(
        "deterministic failpoint spec injected in this shard process"))
    ap.add_argument("--fault_seed", type=int, default=0)
    ap.add_argument("--postmortem_dir", default=None, help=(
        "arm the fatal-signal postmortem path: on SIGSEGV/SIGBUS/SIGABRT/"
        "SIGFPE this shard writes <dir>/postmortem.<pid>.json"))
    ap.add_argument("--blackbox", type=int, default=None, help=(
        "the flight recorder's kill-switch: 0 stops its recording and "
        "suppresses the postmortem dump (default: on)"))
    args = ap.parse_args(argv)
    if args.fault:
        native.fault_config(args.fault, args.fault_seed)
    t0 = time.perf_counter()
    svc = GraphService(args.data_dir, args.shard_idx, args.shard_num,
                       args.host, args.port, args.registry,
                       workers=args.workers, pending=args.pending,
                       options=args.options,
                       postmortem_dir=args.postmortem_dir,
                       blackbox=None if args.blackbox is None
                       else bool(args.blackbox))
    load_s = time.perf_counter() - t0
    for path in args.load_delta:
        print(f"shard {svc.shard_idx} applied {path} -> epoch "
              f"{svc.load_delta(path)}", flush=True)
    print(f"graph shard {svc.shard_idx}/{svc.shard_num} serving on "
          f"{svc.address} (loaded in {load_s:.3f} s)", flush=True)
    stop = []
    # SIGTERM (and ^C) run the rolling-restart drain: deregister, stop
    # accepting, finish in-flight requests, close
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)
    svc.drain()
    served = {k: v for k, v in native.counters().items() if v}
    if served:
        print(f"shard {svc.shard_idx} drained; counters: {served}",
              file=sys.stderr, flush=True)
    svc.stop()


if __name__ == "__main__":
    main()
