"""Host input pipelines (counterpart of ``euler_tpu/parallel/prefetch.py``).

``prefetch``: the sampler runs in background threads (the engine releases
the GIL) and builds batch k+1..k+depth as numpy arrays while the training
thread drives step k on the card. ``pipeline``: one sampler thread keeps
``depth`` steps of a split sampler submitted to the remote client's own
dispatcher (``Graph.sample_fanout_async``) and finishes them in order.
Only the training thread touches CUDA: it uploads each batch after
taking it from here.

``timings``, when given a dict, collects two lists a run: ``"sample"``,
each batch's build seconds in its worker, and ``"input_stall"``, the
seconds the consumer waited for each step's batch (the JAX package
records the same two phases in its native telemetry, which is not
ported).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Iterator


def prefetch(
    make_batch: Callable[[int], dict],
    num_steps: int,
    depth: int = 2,
    num_threads: int = 2,
    start: int = 0,
    worker_init: Callable[[int], None] | None = None,
    timings: dict | None = None,
) -> Iterator[dict]:
    """Yield num_steps batches for steps start..start+num_steps, produced
    ahead of time by worker threads, in step order.

    make_batch(step) must be thread-safe (the engine is: the store is
    immutable and its RNG is thread-local). worker_init(worker_idx) runs
    once at the start of each worker thread, e.g. to seed its sampler
    RNG. An exception in a worker is raised to the consumer at the step
    it belongs to."""
    stall = sample = None
    if timings is not None:
        stall = timings.setdefault("input_stall", [])
        sample = timings.setdefault("sample", [])

    def timed(step):
        t0 = time.perf_counter()
        batch = make_batch(step + start)
        if sample is not None:
            sample.append(time.perf_counter() - t0)
        return batch

    if num_threads <= 1 or depth <= 0:
        # synchronous: the consumer is the producer, so every sample is
        # a full stall
        if worker_init is not None:
            worker_init(0)
        for step in range(num_steps):
            t0 = time.perf_counter()
            batch = timed(step)
            if stall is not None:
                stall.append(time.perf_counter() - t0)
            yield batch
        return

    out: "queue.Queue" = queue.Queue()
    cv = threading.Condition()
    next_step = [0]  # next step a worker may claim
    consumed = [0]  # steps the consumer has taken
    stop = threading.Event()

    def worker(widx: int):
        try:
            if worker_init is not None:
                worker_init(widx)
        except Exception as e:  # surface init errors instead of hanging
            with cv:
                step = next_step[0]
                next_step[0] = step + 1
            out.put((step, e))
            return
        while not stop.is_set():
            with cv:
                # backpressure: never more than `depth` steps ahead of the
                # consumer, reorder buffer included
                while (
                    not stop.is_set()
                    and next_step[0] < num_steps
                    and next_step[0] - consumed[0] >= depth + 1
                ):
                    cv.wait(timeout=0.1)
                step = next_step[0]
                if stop.is_set() or step >= num_steps:
                    return
                next_step[0] = step + 1
            try:
                batch = timed(step)
            except Exception as e:
                out.put((step, e))
                return
            out.put((step, batch))

    threads = [
        threading.Thread(target=worker, args=(w,), daemon=True)
        for w in range(num_threads)
    ]
    for t in threads:
        t.start()
    # batches may complete out of order with more than one worker; the
    # reorder buffer is bounded by depth+1 through the backpressure
    pending: dict[int, object] = {}
    try:
        for want in range(num_steps):
            t_wait = time.perf_counter()
            while want not in pending:
                step, item = out.get()
                pending[step] = item
            if stall is not None:
                stall.append(time.perf_counter() - t_wait)
            item = pending.pop(want)
            if isinstance(item, Exception):
                raise item
            yield item
            with cv:
                consumed[0] = want + 1
                cv.notify_all()
    finally:
        stop.set()
        with cv:
            cv.notify_all()
        for t in threads:
            t.join(timeout=1.0)


def pipeline(
    start_fn: Callable[[int], object],
    finish_fn: Callable[[int, object], dict],
    num_steps: int,
    depth: int = 2,
    start: int = 0,
    worker_init: Callable[[int], None] | None = None,
    timings: dict | None = None,
) -> Iterator[dict]:
    """Yield num_steps batches for steps start..start+num_steps over a
    split sampler (``train.train``'s ``sampler_depth``), kept ``depth``
    submits ahead of the consumer.

    ``start_fn(step)`` submits the step's sampling without blocking (a
    remote graph: one async op whose hop chain runs on the client's
    dispatcher pool, no Python thread held) and returns a pending token;
    ``finish_fn(step, pending)`` blocks on it and builds the batch. One
    sampler thread keeps up to ``depth`` steps submitted and finishes
    them strictly in order into a bounded queue. ``timings`` collects
    what ``prefetch`` does: ``"sample"`` is the sampler thread's wait in
    ``finish_fn`` a step (near 0 when the ring hides the wire). An
    exception in either function is raised to the consumer at its step;
    tokens still in the ring are dropped (their handles recycle their
    native slots when collected)."""
    stall = sample = None
    if timings is not None:
        stall = timings.setdefault("input_stall", [])
        sample = timings.setdefault("sample", [])
    depth = max(1, int(depth))
    # bounded: at most depth submitted and depth+1 finished batches exist
    out: "queue.Queue" = queue.Queue(maxsize=depth + 1)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def sampler():
        inflight: deque = deque()
        step = 0
        try:
            if worker_init is not None:
                worker_init(0)
            while not stop.is_set() and (inflight or step < num_steps):
                while step < num_steps and len(inflight) < depth:
                    inflight.append((step, start_fn(step + start)))
                    step += 1
                cur, pending = inflight.popleft()
                t0 = time.perf_counter()
                batch = finish_fn(cur + start, pending)
                if sample is not None:
                    sample.append(time.perf_counter() - t0)
                if not put(batch):
                    return
        except Exception as e:
            put(e)

    t = threading.Thread(target=sampler, daemon=True)
    t.start()
    try:
        for _ in range(num_steps):
            t_wait = time.perf_counter()
            item = out.get()  # the sampler thread produces in order
            if stall is not None:
                stall.append(time.perf_counter() - t_wait)
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=1.0)
