"""TCP request frontend for the embedding server and its Python client
(counterpart of ``euler_tpu/serving/frontend.py``, on the same wire: a
client of either package talks to a frontend of either).

Protocol: one JSON object per line, both directions.

    {"op": "embed", "ids": [..], "deadline_ms": 50}   ->
        {"ok": true, "shape": [n, d], "dtype": "float32",
         "data": "<base64 raw little-endian float32>"}
        {"ok": false, "error": "busy"}       (admission shed — retry)
        {"ok": false, "error": "deadline"}   (expired before dispatch)
    {"op": "stats"}  -> {"ok": true, "slo": {...}, "serve_phases": {...},
                         "counters": {serve_*...}, "batch": {...}}
    {"op": "ping"}   -> {"ok": true, "draining": false}

Embeddings travel as base64 of the raw float32 buffer so the wire is
bit-exact — the parity criterion (served == direct forward) holds
through a network hop, not just in-process. The ``stats`` op is the
live scrape of shedding and latency without touching the server
process.

Drain: stop accepting, finish in-flight connections, then the owner
closes the batcher (which itself drains its queue), so a restart loses
no accepted request.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
from typing import Optional

import numpy as np

from euler_tpu_torch.graph import native
from euler_tpu_torch.serving.microbatch import BusyError, DeadlineError


class EmbedFrontend:
    """Line-JSON TCP frontend over one EmbedServer."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 max_conns: int = 64, default_deadline_ms: int = 0):
        self._server = server
        self.max_conns = int(max_conns)
        self.default_deadline_ms = int(default_deadline_ms)
        self._draining = False
        self._conns: set = set()
        self._threads: list = []
        self._lock = threading.Lock()
        self._listener = socket.create_server(
            (host, int(port)), backlog=128, reuse_port=False
        )
        # accept() wakes on this timeout to check the drain flag —
        # closing a listener does NOT reliably wake a thread blocked in
        # accept(), and its freed port/fd can be reused by a later
        # frontend, which the stale thread would then steal from
        self._listener.settimeout(0.25)
        self.address = "%s:%d" % self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="eg-serve-accept", daemon=True
        )
        self._accept_thread.start()

    # ---- lifecycle ----

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, grace_s: float = 5.0) -> None:
        """Stop accepting, let in-flight connections finish (up to
        ``grace_s``). The owner then closes the EmbedServer, whose
        batcher drains its queue — no accepted request is dropped."""
        self._draining = True
        # join BEFORE closing: the accept loop exits on its own flag
        # check (<= its accept timeout), and only then is the port
        # released — never while a thread could still accept on it
        self._accept_thread.join(timeout=max(grace_s, 0.5))
        try:
            self._listener.close()
        except OSError:
            pass
        deadline = grace_s
        for t in list(self._threads):
            t.join(timeout=max(deadline, 0.1))

    def stop(self) -> None:
        """Drain with zero grace, then force-close anything left."""
        self.drain(grace_s=0.5)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in list(self._threads):
            t.join(timeout=2.0)

    # ---- accept / serve ----

    def _accept_loop(self) -> None:
        while not self._draining:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue  # periodic drain-flag check
            except OSError:
                return  # listener closed (stop)
            with self._lock:
                over = len(self._conns) >= self.max_conns
                if not over:
                    self._conns.add(conn)
            if over or self._draining:
                # one BUSY reply, then close: the connection cap is the
                # frontend's admission tier (the queue cap is the
                # batcher's) — both shed onto the same counter
                native.counter_add("serve_busy_rejects", 1)
                try:
                    conn.sendall(
                        b'{"ok": false, "error": "busy"}\n'
                    )
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            t = threading.Thread(
                target=self._handle, args=(conn,),
                name="eg-serve-conn", daemon=True,
            )
            with self._lock:
                self._threads.append(t)
            t.start()

    def _handle(self, conn) -> None:
        try:
            f = conn.makefile("rwb")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    reply = self._reply(json.loads(line))
                except ValueError as e:
                    reply = {"ok": False, "error": f"bad request: {e}"}
                f.write(json.dumps(reply).encode() + b"\n")
                f.flush()
        except OSError:
            pass  # client went away mid-exchange
        finally:
            with self._lock:
                self._conns.discard(conn)
                self._threads = [
                    t for t in self._threads
                    if t is not threading.current_thread()
                ]
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True, "draining": self._draining}
        if op == "stats":
            return {"ok": True, **self._server.stats()}
        if op == "embed":
            ids = msg.get("ids")
            if not ids:
                return {"ok": False, "error": "embed needs ids"}
            deadline_ms = msg.get(
                "deadline_ms", self.default_deadline_ms
            ) or None
            try:
                rows = self._server.embed(ids, deadline_ms=deadline_ms)
            except BusyError:
                return {"ok": False, "error": "busy"}
            except DeadlineError:
                return {"ok": False, "error": "deadline"}
            except Exception as e:
                return {"ok": False, "error": f"internal: {e}"}
            rows = np.ascontiguousarray(rows, dtype=np.float32)
            return {
                "ok": True,
                "shape": list(rows.shape),
                "dtype": "float32",
                "data": base64.b64encode(rows.tobytes()).decode(),
            }
        return {"ok": False, "error": f"unknown op {op!r}"}


class EmbedClient:
    """Blocking line-JSON client for one EmbedFrontend address."""

    def __init__(self, address: str, timeout_s: float = 30.0):
        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection(
            (host, int(port)), timeout=timeout_s
        )
        self._file = self._sock.makefile("rwb")
        self._lock = threading.Lock()

    def _call(self, msg: dict) -> dict:
        with self._lock:
            self._file.write(json.dumps(msg).encode() + b"\n")
            self._file.flush()
            line = self._file.readline()
        if not line:
            raise ConnectionError("embed server closed the connection")
        reply = json.loads(line)
        if not reply.get("ok"):
            # admission sheds map to typed errors on EVERY op — a ping
            # against a full frontend must say BUSY, not hand back a
            # dict the caller has to grep
            err = reply.get("error", "")
            if err == "busy":
                raise BusyError("server busy")
            if err == "deadline":
                raise DeadlineError("server-side deadline expired")
        return reply

    def embed(self, ids, deadline_ms: Optional[float] = None) -> np.ndarray:
        """Embeddings for ids, [len(ids), dim] float32 — bit-exact to
        the server's device output. Raises BusyError on shed (retry
        with backoff) and DeadlineError on expiry."""
        msg: dict = {"op": "embed", "ids": [int(i) for i in ids]}
        if deadline_ms is not None:
            msg["deadline_ms"] = deadline_ms
        reply = self._call(msg)
        if not reply.get("ok"):
            raise RuntimeError(f"embed failed: {reply.get('error', '')}")
        raw = base64.b64decode(reply["data"])
        return np.frombuffer(raw, dtype=np.float32).reshape(
            reply["shape"]
        )

    def stats(self) -> dict:
        return self._call({"op": "stats"})

    def ping(self) -> dict:
        return self._call({"op": "ping"})

    def close(self) -> None:
        try:
            self._file.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
