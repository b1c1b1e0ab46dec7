"""Request-level micro-batching for embedding inference (counterpart of
``euler_tpu/serving/microbatch.py``).

Concurrent embed queries coalesce into one padded-bucket device
dispatch: the dispatcher thread collects queued requests until either
``max_batch`` unique ids are pending or the oldest request has waited
``max_wait_us``, dedupes ids across requests (two clients asking for
the same hub node cost one sample and one device row), runs the
server's ``embed_unique`` callback once, and scatters rows back per
request.

Admission is bounded: at most ``queue_cap`` requests may be queued;
beyond that :meth:`submit` raises :class:`BusyError` immediately
(counter ``serve_busy_rejects``) instead of building unbounded queue
latency. A request carrying a deadline that expires
before its batch dispatches is answered :class:`DeadlineError`
(``serve_deadline_rejects``) and never reaches the device.

Phase telemetry (queue_wait / total here; sample / dispatch inside the
server's callback) rides the native ``serve:<phase>`` histograms —
kill-switch honored natively, so ``telemetry=0`` leaves this hot path
histogram-free.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from euler_tpu_torch import telemetry as T
from euler_tpu_torch.graph import native


class BusyError(RuntimeError):
    """Admission refused: the serve queue is at capacity (shed, retry)."""


class DeadlineError(RuntimeError):
    """The request's deadline expired before its batch dispatched."""


class _Request:
    __slots__ = ("ids", "deadline", "t_submit", "done", "rows", "error")

    def __init__(self, ids: np.ndarray, deadline: Optional[float]):
        self.ids = ids
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.t_submit = time.monotonic()
        self.done = threading.Event()
        self.rows: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Coalesce concurrent embed requests into bounded device batches.

    ``embed_unique(uids)`` is the server's batch callback: unique int64
    ids in, one float row per id out (same order). ``on_done(total_us,
    error)`` is an optional completion hook (the SLO tracker's feed).
    """

    def __init__(
        self,
        embed_unique: Callable[[np.ndarray], np.ndarray],
        max_batch: int = 64,
        max_wait_us: int = 2000,
        queue_cap: int = 128,
        on_done: Optional[Callable[[float, Optional[Exception]], None]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        self._embed_unique = embed_unique
        self.max_batch = int(max_batch)
        self._max_wait_s = max(int(max_wait_us), 0) / 1e6
        self.queue_cap = int(queue_cap)
        self._on_done = on_done
        self._queue: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----

    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._thread is not None:
                return self
            self._closed = False
            self._thread = threading.Thread(
                target=self._run, name="eg-serve-batcher", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        """Drain: stop admitting, dispatch everything queued, stop."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()

    # ---- request path ----

    def submit(self, ids, deadline_ms: Optional[float] = None) -> np.ndarray:
        """Embed ``ids``; blocks until the coalesced batch completes.

        Raises :class:`BusyError` when the queue is full and
        :class:`DeadlineError` when ``deadline_ms`` elapses before the
        batch dispatches."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.size == 0:
            raise ValueError("submit() needs at least one id")
        native.counter_add("serve_requests", 1)
        deadline = (
            time.monotonic() + deadline_ms / 1e3
            if deadline_ms is not None and deadline_ms > 0 else None
        )
        req = _Request(ids, deadline)
        with self._cond:
            if self._closed or self._thread is None:
                raise RuntimeError("serving stopped (batcher not running)")
            if len(self._queue) >= self.queue_cap:
                native.counter_add("serve_busy_rejects", 1)
                raise BusyError(
                    f"serve queue at capacity ({self.queue_cap} requests "
                    "pending) — shed, retry with backoff"
                )
            self._queue.append(req)
            self._cond.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.rows

    # ---- dispatcher ----

    def _pending_unique_locked(self) -> int:
        seen: set = set()
        for r in self._queue:
            seen.update(r.ids.tolist())
        return len(seen)

    def _pop_batch_locked(self) -> list:
        """FIFO-pop requests whose combined unique ids fit max_batch.
        A single oversize request still pops alone — the server's
        callback chunks it across dispatches."""
        batch: list = []
        uniq: set = set()
        while self._queue:
            r = self._queue[0]
            new = [i for i in r.ids.tolist() if i not in uniq]
            if batch and len(uniq) + len(new) > self.max_batch:
                break
            uniq.update(new)
            batch.append(self._queue.popleft())
        return batch

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._queue and not self._closed:
                        self._cond.wait()
                    if not self._queue:
                        return  # closed and drained
                    # coalescing window: flush on max_batch unique ids,
                    # the oldest request's max_wait expiring, or close
                    window_end = self._queue[0].t_submit + self._max_wait_s
                    while (
                        not self._closed
                        and self._queue
                        and self._pending_unique_locked() < self.max_batch
                    ):
                        remaining = window_end - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                    batch = self._pop_batch_locked()
                if batch:
                    self._dispatch(batch)
        except BaseException as e:  # never die silently mid-serve
            with self._cond:
                leftovers = list(self._queue)
                self._queue.clear()
            for r in leftovers:
                r.error = RuntimeError(f"serve dispatcher died: {e!r}")
                r.done.set()
            raise

    def _dispatch(self, batch: list) -> None:
        now = time.monotonic()
        live: list = []
        for r in batch:
            T.record_serve_phase("queue_wait", (now - r.t_submit) * 1e6)
            if r.deadline is not None and now >= r.deadline:
                native.counter_add("serve_deadline_rejects", 1)
                r.error = DeadlineError(
                    f"deadline expired {(now - r.deadline) * 1e3:.1f}ms "
                    "before dispatch"
                )
                self._finish(r)
            else:
                live.append(r)
        if not live:
            return
        index: dict = {}
        for r in live:
            for i in r.ids.tolist():
                if i not in index:
                    index[i] = len(index)
        uids = np.fromiter(index.keys(), dtype=np.int64, count=len(index))
        native.counter_add("serve_batches", 1)
        T.record_serve_batch(len(uids))
        try:
            rows = self._embed_unique(uids)
        except Exception as e:
            for r in live:
                r.error = e
                self._finish(r)
            return
        for r in live:
            r.rows = rows[[index[i] for i in r.ids.tolist()]]
            self._finish(r)

    def _finish(self, r: _Request) -> None:
        total_us = (time.monotonic() - r.t_submit) * 1e6
        T.record_serve_phase("total", total_us)
        if self._on_done is not None:
            self._on_done(total_us, r.error)
        r.done.set()
