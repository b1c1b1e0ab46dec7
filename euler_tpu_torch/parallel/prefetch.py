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
seconds the consumer waited for each step's batch.

With ``profile`` on (the default while telemetry is enabled) both
pipelines also record into the engine's telemetry, as the JAX package's
do: the ``input_stall`` phase at the consumer, the ``sample`` phase in
the producer (left to the caller with ``record_sample=False``, when it
times finer phases inside its own functions, as ``train.train`` does),
the queue-depth and workers-busy gauges at each dequeue, and the
``prefetch_produced``, ``prefetch_dropped`` (batches an abandoned
iterator never handed out) and ``prefetch_worker_errors`` counters.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Iterator


def _profiler():
    """(record_phase, record_gauges, counter_add) while telemetry is
    enabled, else None; None too when the engine library cannot load, so
    the pipelines stay usable without it (telemetry only: nothing else
    here depends on the library)."""
    try:
        from euler_tpu_torch.graph.native import counter_add
        from euler_tpu_torch.telemetry import (
            record_phase,
            record_prefetch_gauges,
            telemetry_enabled,
        )

        if not telemetry_enabled():
            return None
        return record_phase, record_prefetch_gauges, counter_add
    except Exception:
        return None


def _error_span(us: float) -> None:
    """A failed produce as an error span in the slow-span journal, so a
    worker's death shows in a scrape while the consumer is mid-step."""
    try:
        from euler_tpu_torch.telemetry import record_span

        record_span(int(us), outcome=1)
    except Exception:
        pass


def _count_dropped(prof, pending, out) -> None:
    """Count the batches produced but never handed out (an early close or
    an error teardown) into ``prefetch_dropped``."""
    dropped = sum(1 for v in pending if not isinstance(v, Exception))
    while True:
        try:
            item = out.get_nowait()[1]
        except queue.Empty:
            break
        if not isinstance(item, Exception):
            dropped += 1
    if dropped:
        prof[2]("prefetch_dropped", dropped)


def prefetch(
    make_batch: Callable[[int], dict],
    num_steps: int,
    depth: int = 2,
    num_threads: int = 2,
    start: int = 0,
    worker_init: Callable[[int], None] | None = None,
    timings: dict | None = None,
    profile: bool | None = None,
    record_sample: bool = True,
) -> Iterator[dict]:
    """Yield num_steps batches for steps start..start+num_steps, produced
    ahead of time by worker threads, in step order.

    make_batch(step) must be thread-safe (the engine is: the store is
    immutable and its RNG is thread-local). worker_init(worker_idx) runs
    once at the start of each worker thread, e.g. to seed its sampler
    RNG. An exception in a worker is raised to the consumer at the step
    it belongs to. ``profile=None`` records into the telemetry while it
    is enabled, False never."""
    prof = _profiler() if profile in (None, True) else None
    stall = sample = None
    if timings is not None:
        stall = timings.setdefault("input_stall", [])
        sample = timings.setdefault("sample", [])

    def timed(step):
        t0 = time.perf_counter()
        batch = make_batch(step + start)
        dt = time.perf_counter() - t0
        if sample is not None:
            sample.append(dt)
        if prof is not None:
            if record_sample:
                prof[0]("sample", dt * 1e6, step=step + start)
            prof[2]("prefetch_produced")
        return batch

    if num_threads <= 1 or depth <= 0:
        # synchronous: the consumer is the producer, so every sample is
        # a full stall
        if worker_init is not None:
            worker_init(0)
        for step in range(num_steps):
            t0 = time.perf_counter()
            batch = timed(step)
            dt = time.perf_counter() - t0
            if stall is not None:
                stall.append(dt)
            if prof is not None:
                prof[0]("input_stall", dt * 1e6, step=step + start)
                prof[1](0, 0)
            yield batch
        return

    out: "queue.Queue" = queue.Queue()
    cv = threading.Condition()
    next_step = [0]  # next step a worker may claim
    consumed = [0]  # steps the consumer has taken
    busy = [0]  # workers inside make_batch
    stop = threading.Event()

    def worker(widx: int):
        try:
            if worker_init is not None:
                worker_init(widx)
        except Exception as e:  # surface init errors instead of hanging
            if prof is not None:
                prof[2]("prefetch_worker_errors")
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
                busy[0] += 1
            t0 = time.perf_counter()
            try:
                batch = timed(step)
            except Exception as e:
                if prof is not None:
                    prof[2]("prefetch_worker_errors")
                    _error_span((time.perf_counter() - t0) * 1e6)
                with cv:
                    busy[0] -= 1
                out.put((step, e))
                return
            with cv:
                busy[0] -= 1
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
            dt = time.perf_counter() - t_wait
            if stall is not None:
                stall.append(dt)
            if prof is not None:
                prof[0]("input_stall", dt * 1e6, step=want + start)
                # ready batches beyond the one about to be consumed
                prof[1](out.qsize() + len(pending) - 1, busy[0])
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
        if prof is not None:
            _count_dropped(prof, pending.values(), out)


def pipeline(
    start_fn: Callable[[int], object],
    finish_fn: Callable[[int, object], dict],
    num_steps: int,
    depth: int = 2,
    start: int = 0,
    worker_init: Callable[[int], None] | None = None,
    timings: dict | None = None,
    profile: bool | None = None,
    record_sample: bool = True,
) -> Iterator[dict]:
    """Yield num_steps batches for steps start..start+num_steps over a
    split sampler (``train.train``'s ``sampler_depth``), kept ``depth``
    submits ahead of the consumer.

    ``start_fn(step)`` submits the step's sampling without blocking (a
    remote graph: one async op whose hop chain runs on the client's
    dispatcher pool, no Python thread held) and returns a pending token;
    ``finish_fn(step, pending)`` blocks on it and builds the batch. One
    sampler thread keeps up to ``depth`` steps submitted and finishes
    them strictly in order into a bounded queue. ``timings`` and
    ``profile`` record what ``prefetch``'s do: ``"sample"`` is the
    sampler thread's wait in ``finish_fn`` a step (near 0 when the ring
    hides the wire), and the busy gauge the steps in flight. An
    exception in either function is raised to the consumer at its step;
    tokens still in the ring are dropped (their handles recycle their
    native slots when collected)."""
    prof = _profiler() if profile in (None, True) else None
    stall = sample = None
    if timings is not None:
        stall = timings.setdefault("input_stall", [])
        sample = timings.setdefault("sample", [])
    depth = max(1, int(depth))
    # bounded: at most depth submitted and depth+1 finished batches exist
    out: "queue.Queue" = queue.Queue(maxsize=depth + 1)
    stop = threading.Event()
    busy = [0]  # steps submitted but not yet finished

    def put(step, item) -> bool:
        while not stop.is_set():
            try:
                out.put((step, item), timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def sampler():
        inflight: deque = deque()
        step = cur = 0
        try:
            if worker_init is not None:
                worker_init(0)
            while not stop.is_set() and (inflight or step < num_steps):
                while step < num_steps and len(inflight) < depth:
                    inflight.append((step, start_fn(step + start)))
                    step += 1
                    busy[0] = len(inflight)
                cur, pending = inflight.popleft()
                t0 = time.perf_counter()
                batch = finish_fn(cur + start, pending)
                dt = time.perf_counter() - t0
                busy[0] = len(inflight)
                if sample is not None:
                    sample.append(dt)
                if prof is not None:
                    if record_sample:
                        prof[0]("sample", dt * 1e6, step=cur + start)
                    prof[2]("prefetch_produced")
                if not put(cur, batch):
                    return
        except Exception as e:
            if prof is not None:
                prof[2]("prefetch_worker_errors")
                _error_span(0)
            put(cur, e)

    t = threading.Thread(target=sampler, daemon=True)
    t.start()
    try:
        for want in range(num_steps):
            t_wait = time.perf_counter()
            item = out.get()[1]  # the sampler thread produces in order
            dt = time.perf_counter() - t_wait
            if stall is not None:
                stall.append(dt)
            if prof is not None:
                prof[0]("input_stall", dt * 1e6, step=want + start)
                prof[1](out.qsize(), busy[0])
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=1.0)
        if prof is not None:
            _count_dropped(prof, (), out)
