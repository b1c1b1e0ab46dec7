"""TCP shard registry (counterpart of ``euler_tpu/graph/registry.py``):
discovery across hosts without a shared filesystem.

A small native TCP server (``_native/eg_registry.cc``) holds soft TTL
state: shards register and heartbeat, entries of dead shards expire on
their own, clients list the live ones. Run it beside the trainer,

    registry = RegistryServer(port=9100)                  # in-process
    python -m euler_tpu_torch.graph.registry --port 9100  # or alone

and point shards and clients at ``tcp://<host>:9100`` through the same
``registry=`` that otherwise names a shared directory (``GraphService``,
``Graph(mode="remote")``, ``run_loop --registry``).
"""

from __future__ import annotations

import ctypes

from euler_tpu_torch.graph.native import lib


class RegistryServer:
    """The registry service; stops on ``stop()`` or GC. ``ttl_ms`` is an
    entry's life without a heartbeat (shards re-register about every 3
    s, so 10 s tolerates two lost heartbeats). Port 0 binds a free port,
    read back into ``port``."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 ttl_ms: int = 10000):
        self._lib = lib()
        self._h = self._lib.eg_registry_start(host.encode(), port, ttl_ms)
        if not self._h:
            raise RuntimeError("registry start failed: "
                               + self._lib.eg_last_error().decode())
        self.host = host
        self.port = self._lib.eg_registry_port(self._h)

    @property
    def address(self) -> str:
        host = "127.0.0.1" if self.host in ("", "0.0.0.0") else self.host
        return f"tcp://{host}:{self.port}"

    def stop(self) -> None:
        if getattr(self, "_h", None):
            self._lib.eg_registry_stop(self._h)
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


def parse_tcp_url(url: str) -> tuple[str, int] | None:
    """``tcp://host:port`` -> ``(host, port)``; None when not a tcp URL."""
    if not url.startswith("tcp://"):
        return None
    host, sep, port_s = url[len("tcp://"):].rpartition(":")
    if not sep or not host or not port_s.isdigit():
        raise ValueError(f"bad tcp registry url: {url}")
    return host, int(port_s)


def query(url: str, timeout_ms: int = 2000) -> dict[int, list[str]]:
    """List a registry's live entries: ``{shard: ["host:port", ...]}``.
    Raises ``ConnectionError`` when the registry does not answer."""
    parsed = parse_tcp_url(url)
    if parsed is None:
        raise ValueError(f"not a tcp:// registry url: {url}")
    host, port = parsed
    buf = ctypes.create_string_buffer(1 << 20)
    n = lib().eg_registry_query(host.encode(), port, timeout_ms, buf,
                                len(buf))
    if n < 0:
        raise ConnectionError(f"registry unreachable: {url}")
    out: dict[int, list[str]] = {}
    # skip any line that is not "<int> host:port"
    for line in buf.raw[:n].decode(errors="replace").splitlines():
        shard_s, _, addr = line.partition(" ")
        if addr and shard_s.isascii() and shard_s.isdigit():
            out.setdefault(int(shard_s), []).append(addr)
    return out


def main(argv=None) -> None:
    import argparse
    import signal
    import time

    ap = argparse.ArgumentParser(description="Run the TCP shard registry.")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--ttl_ms", type=int, default=10000)
    args = ap.parse_args(argv)
    reg = RegistryServer(args.host, args.port, args.ttl_ms)
    print(f"shard registry serving on {reg.address}", flush=True)
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)
    reg.stop()


if __name__ == "__main__":
    main()
