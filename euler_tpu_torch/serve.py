"""Online embedding inference over a trained checkpoint (counterpart of
``euler_tpu/serve.py``), on one CUDA device:

    request -> MicroBatcher (coalesce, shed, deadline)
            -> per-unique-id neighborhood sampling on the host (engine)
            -> one fixed-bucket forward on the card -> rows per request

Determinism is a serving feature: each id's neighborhood is sampled once,
with an engine seed derived from the id (``_id_seed``), and cached
(``--serve_sample_cache``), so an id's embedding is bit-stable across
requests and across co-batched traffic, and equal to
:meth:`EmbedServer.embed_direct`. Over a remote graph the shards draw
with their own RNGs, which the id's seed does not reach: the cache alone
keeps a row stable. Its entries are keyed by the graph's ``cache_gen``,
which a shard's delta moves, so a block drawn before a graph refresh is
evicted (``epoch_stale_hits_evicted``) and drawn again from the new
snapshot.

A block is bit-stable only while each engine draw runs on the calling
thread: ``eg_seed`` seeds that thread's RNG, and the engine's neighbor
draw fans out over OpenMP threads, each with an RNG of its own, when
``n * count > 2048`` (ids times picks of one hop, ``SampleNeighbor`` in
``graph/_native/eg_engine.cc``). One id draws ``prod(fanouts[:h + 1])``
picks at hop h, so its block is stable while ``prod(fanouts) <=
OMP_DRAW_BOUND``: ppi's [10, 10] draws 10 then 100. The feature gather
fans out past ``n * row_dim > 8192`` floats (100 x 50 = 5,000 at ppi's
last hop), but it draws nothing, so its threads change no bit.

Every forward fills one fixed bucket, laid out by the model's
``serving_layout`` (``models/base.py``): leaf by leaf for the fanout,
walk, shallow and sparse models (``max_batch`` blocks, padding repeats
the first), with offsets into hop arrays of fixed caps for SupervisedGCN,
whose blocks differ in size (a dispatch past a cap splits into more
forwards, in request order). One forward of one shape serves all
traffic, and a row's bits depend neither on its co-batched neighbours
nor on how many there are (the GCN family's segment sums are
deterministic, ``nn/sparse_aggregators.py``). On the card that forward
is a CUDA graph: the first dispatch captures the module's ``embed`` over
static device buffers of the bucket's shapes, after a warm-up on a side
stream; each forward then (1) writes the layout into pinned staging,
(2) copies the rows it filled into the static inputs without blocking,
(3) replays the graph and (4) copies out the first n rows. On the CPU
(``device="cpu"``, as the tests run) the same bucket's forward runs
eagerly. One lock guards
staging, replay and read-back, which ``embed_direct`` from any thread and
the batcher's dispatch thread share. The dispatch is watched by
``devprof.watch`` (name ``embed_step``): each capture is a compile
(``device_compiles`` and the ``phase:compile`` histogram), and a
dispatch whose shapes or dtypes differ from the captured bucket's is a
recompile: it is journaled with the leaves that drifted and bumps
``device_recompiles`` and ``serve_recompiles``, then captures again, or
under ``strict_bucket`` raises ``devprof.RecompileError`` and keeps the
bucket it has. A capture or replay that fails raises: the server never
falls back to an eager forward on the card.

Usage (inference sampling, ``--all_edge_type`` metapaths, as evaluate
and save_embedding use):

    python -m euler_tpu_torch.serve --data_dir ... --model_dir ckpt \\
        --model graphsage_supervised --serve_port 9200 [--serve_slo_ms 50]

or train, then serve, in one process: ``python -m euler_tpu_torch ...
--serve_after 1`` (with the training sampling config).
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from euler_tpu_torch import devprof
from euler_tpu_torch import telemetry as T
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import native
from euler_tpu_torch.models import base
from euler_tpu_torch.serving import EmbedFrontend, MicroBatcher, SLOTracker

log = logging.getLogger("euler_tpu_torch.serve")

_MIX = 0x9E3779B97F4A7C15  # splitmix64 increment
_MASK = (1 << 64) - 1

# picks of one engine draw past which it fans out over OpenMP threads
# (eg_engine.cc SampleNeighbor: n * count > 2048)
OMP_DRAW_BOUND = 2048

# forwards on a side stream before the capture (lazy init, cuBLAS
# handles and workspaces, the allocator's first blocks)
_WARMUP = 3


def _id_seed(seed: int, nid: int) -> int:
    """Deterministic nonzero 64-bit engine seed for one (server seed, id)."""
    h = (nid * _MIX + seed * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) & _MASK
    h ^= h >> 31
    return (h * _MIX) & _MASK or 1


# a dispatch's shapes or dtypes differ from the captured bucket's under
# strict_bucket: the fixed-bucket forward must be captured exactly once
RecompileError = devprof.RecompileError


class _LeafSpec:
    """One padded leaf's shape and dtype: what the watched dispatch's
    signature reads of it."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype_str: str):
        self.shape = shape
        self.dtype = np.dtype(dtype_str)


class _Dispatch:
    """One forward's signature, blocks and row count: a single constant
    leaf of the watched call's signature."""

    __slots__ = ("sig", "blocks", "n")

    def __init__(self, sig: tuple, blocks: list, n: int):
        self.sig, self.blocks, self.n = sig, blocks, n


def _torch_dtype(dtype_str: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype_str))).dtype


def _staged(staging: list, used: list) -> list:
    """The rows of each staged leaf that go up: its first ``used``."""
    return [buf[:u] for buf, u in zip(staging, used)]


class _EagerBucket:
    """The bucket's forward on the CPU, run eagerly each dispatch over
    the staging arrays (its input tensors share their memory)."""

    def __init__(self, layout, signature, blocks, embed_fn, state, device):
        self.signature = signature
        self._layout = layout
        self._embed_fn = embed_fn
        self._state = state
        self._staging = [np.zeros(shape, np.dtype(dt))
                         for _, shape, dt in signature]
        self._inputs = base.batch_with_leaves(
            blocks[0], [torch.from_numpy(x) for x in self._staging])

    def run(self, blocks: list, n: int) -> np.ndarray:
        used = self._layout.write(blocks, self._staging)
        devprof.count_h2d(_staged(self._staging, used))
        return self._embed_fn(self._state, self._inputs)[:n].numpy().copy()


class _GraphBucket:
    """The bucket's forward on the card as one CUDA graph over static
    input buffers, with pinned staging on either side of it. Both start
    zeroed: rows a layout leaves unfilled hold valid ids and finite
    values."""

    def __init__(self, layout, signature, blocks, embed_fn, state, device):
        self.signature = signature
        self._layout = layout
        self._device = device
        shapes = [(shape, _torch_dtype(dt)) for _, shape, dt in signature]
        self._pinned = [torch.zeros(s, dtype=d, pin_memory=True)
                        for s, d in shapes]
        self._staging = [p.numpy() for p in self._pinned]
        self._static = [torch.zeros(s, dtype=d, device=device)
                        for s, d in shapes]
        inputs = base.batch_with_leaves(blocks[0], self._static)
        with torch.cuda.device(device):
            # the warm-up and the capture read this dispatch's inputs
            self._stage(blocks)
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(_WARMUP):
                    embed_fn(state, inputs)
            stream.wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph,
                                  capture_error_mode="thread_local"):
                self._output = embed_fn(state, inputs)
        self._out = torch.empty(self._output.shape, dtype=self._output.dtype,
                                pin_memory=True)

    def _stage(self, blocks: list) -> None:
        """Steps 1 and 2: the layout writes the bucket straight into
        pinned staging, then the rows it filled go into the static inputs
        without blocking."""
        used = self._layout.write(blocks, self._staging)
        devprof.count_h2d(_staged(self._staging, used))
        for src, dst, u in zip(self._pinned, self._static, used):
            if u:
                dst[:u].copy_(src[:u], non_blocking=True)

    def run(self, blocks: list, n: int) -> np.ndarray:
        with torch.cuda.device(self._device):
            self._stage(blocks)
            self._graph.replay()
            self._out[:n].copy_(self._output[:n], non_blocking=True)
            torch.cuda.current_stream(self._device).synchronize()
        return self._out[:n].numpy().copy()


class EmbedServer:
    """Micro-batched embedding inference over one model, graph and state.

    ``state`` is a restored (or freshly initialised) training state, as
    ``Checkpointer.restore`` returns it; the forward runs where its
    module's parameters live: a CUDA graph on the card, eagerly on the
    CPU."""

    def __init__(self, model, graph, state, *, max_batch: int = 64,
                 max_wait_us: int = 2000, queue_cap: int = 128,
                 slo_ms: float = 100.0, seed: int = 42,
                 sample_cache: int = 65536,
                 strict_bucket: bool = False):
        if getattr(model, "device_sampling", False):
            raise ValueError(
                "EmbedServer samples neighborhoods on the host per "
                "unique id (the determinism anchor); build the serving "
                "model with device_sampling=False"
            )
        self.model = model
        self.graph = graph
        self.max_batch = int(max_batch)
        self.seed = int(seed)
        self.sample_cache = max(int(sample_cache), 1)
        self.strict_bucket = bool(strict_bucket)
        self._state = state
        self.device = next(state["module"].parameters()).device
        self._embed_fn = model.make_embed_step()
        self._layout = model.serving_layout(self.max_batch)
        self._bucket_cls = (_GraphBucket if self.device.type == "cuda"
                            else _EagerBucket)
        self._bucket = None
        self._forward_lock = threading.Lock()
        self._captures = self._replays = self._recaptures = 0
        self._refused = 0  # changed buckets refused under strict_bucket

        def dispatch(specs, job):
            return self._dispatch(job)

        # a capture (or a refused one) is a compile of the watched call
        dispatch._cache_size = lambda: self._captures + self._refused
        self._watched = devprof.watch(
            dispatch, name="embed_step", strict=self.strict_bucket,
            on_recompile=lambda e: native.counter_add("serve_recompiles"))
        self._cache: OrderedDict = OrderedDict()
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self.slo = SLOTracker(slo_ms)
        self.batcher = MicroBatcher(
            self._embed_unique,
            max_batch=max_batch,
            max_wait_us=max_wait_us,
            queue_cap=queue_cap,
            on_done=self._on_done,
        )

    # ---- lifecycle ----

    def start(self) -> "EmbedServer":
        self.batcher.start()
        return self

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self) -> "EmbedServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- request path ----

    def embed(self, ids, deadline_ms: Optional[float] = None) -> np.ndarray:
        """Embeddings of ``ids`` through the micro-batcher: [n, dim]
        float32, one row per requested id (duplicates allowed). Raises
        ``serving.BusyError`` or ``serving.DeadlineError`` when shed or
        expired."""
        return np.asarray(
            self.batcher.submit(ids, deadline_ms=deadline_ms),
            dtype=np.float32,
        )

    def embed_direct(self, nid: int) -> np.ndarray:
        """One id, no micro-batching: the bit-parity anchor the batched
        path is held to."""
        return np.asarray(
            self._forward([self._block(int(nid))])[0], dtype=np.float32
        )

    def stats(self) -> dict:
        """Live serving stats (the frontend's ``stats`` op): the SLO
        verdict, serve-phase percentiles, serve counters, the coalescing
        ledger, ``devprof`` (``devprof.compile_summary()`` with the
        bucket's device, captures, replays and re-captures) and the
        sample cache's entries and host bytes."""
        data = T.telemetry_json()
        phases = {}
        for name, h in T.serve_hists(data).items():
            if not h["count"]:
                continue
            pct = T.percentiles(h, (50, 99))
            phases[name] = {
                "count": h["count"],
                "p50_us": round(pct.get(50, 0.0), 1),
                "p99_us": round(pct.get(99, 0.0), 1),
            }
        ctr = native.counters()
        batch_h = data["hist"].get("serve_batch", {})
        batch = {}
        if batch_h.get("count"):
            batch = {
                "dispatches": batch_h["count"],
                "mean_unique_ids": round(
                    batch_h["sum_us"] / batch_h["count"], 2
                ),
            }
        with self._cache_lock:
            cache = {"entries": len(self._cache), "bytes": self._cache_bytes}
        return {
            "slo": self.slo.report(),
            "serve_phases": phases,
            "counters": {k: v for k, v in ctr.items()
                         if k.startswith("serve_")},
            "batch": batch,
            "devprof": {
                **devprof.compile_summary(data),
                "device": str(self.device),
                "captures": self._captures,
                "replays": self._replays,
                "recaptures": self._recaptures,
            },
            "cache": cache,
        }

    # ---- internals ----

    def _on_done(self, total_us: float, error) -> None:
        if error is None:
            self.slo.record(total_us)

    def _block(self, nid: int) -> dict:
        """One id's sampled host inputs, drawn once under the id's engine
        seed and then cached (hot ids sample zero times). Entries are
        keyed by the graph's cache generation (``cache_gen``; a local
        graph's never changes), so a block drawn before a graph refresh
        is drawn again."""
        gen = getattr(self.graph, "cache_gen", 0)
        with self._cache_lock:
            ent = self._cache.get(nid)
            if ent is not None:
                if ent[0] == gen:
                    self._cache.move_to_end(nid)
                    return ent[1]
                del self._cache[nid]
                self._cache_bytes -= ent[2]
                native.counter_add("epoch_stale_hits_evicted", 1)
        native.lib().eg_seed(_id_seed(self.seed, nid))
        blk = self.model.sample_serve_block(self.graph, nid)
        nbytes = sum(x.nbytes for _, x in base.batch_leaves(blk))
        with self._cache_lock:
            old = self._cache.pop(nid, None)
            if old is not None:  # another thread drew it meanwhile
                self._cache_bytes -= old[2]
            self._cache[nid] = (gen, blk, nbytes)
            self._cache_bytes += nbytes
            while len(self._cache) > self.sample_cache:
                self._cache_bytes -= self._cache.popitem(last=False)[1][2]
        return blk

    def _forward(self, blocks: list) -> np.ndarray:
        """One fixed-bucket forward over per-id blocks (one of the
        layout's ``split``), so one captured forward serves every
        dispatch (see the module docstring)."""
        sig = self._layout.signature(blocks)
        specs = tuple(_LeafSpec(shape, dt) for _, shape, dt in sig)
        with self._forward_lock:
            rows = self._watched(specs, _Dispatch(sig, blocks, len(blocks)))
        if rows is None:  # refused, and devprof off did not raise it
            raise RecompileError(
                f"serve bucket changed after capture: {sig} under "
                "strict_bucket")
        devprof.count_d2h(rows)
        return rows

    def _dispatch(self, job: _Dispatch):
        """The watched call: fix the bucket at the dispatch's signature
        if it has none or another (a capture; refused under
        strict_bucket, which returns None), then run it."""
        if self._bucket is None or self._bucket.signature != job.sig:
            if self._bucket is not None and self.strict_bucket:
                self._refused += 1
                return None
            self._capture(job.sig, job.blocks)
        rows = self._bucket.run(job.blocks, job.n)
        self._replays += 1
        return rows

    def _capture(self, sig: tuple, blocks: list) -> None:
        """Fix the bucket at ``sig``: on the card, capture its graph (a
        compile for the device plane)."""
        if self._bucket is not None:
            self._recaptures += 1
            self._bucket = None  # its graph and buffers go first
        t0 = time.monotonic()
        self._bucket = self._bucket_cls(self._layout, sig, blocks,
                                        self._embed_fn, self._state,
                                        self.device)
        if self.device.type == "cuda":
            devprof.record_compile((time.monotonic() - t0) * 1e6)
        self._captures += 1

    def _embed_unique(self, uids: np.ndarray) -> np.ndarray:
        """The batcher's callback: sample each unique id (cached), then
        run the layout's forwards (max_batch blocks at most, fewer where
        a bucket's caps fill first) in request order. Each forward is
        one ``serve:dispatch`` sample, and ``serve_batches`` (bumped once
        a micro-batch by the batcher) counts each forward past the
        first too."""
        t0 = time.monotonic()
        blocks = [self._block(int(i)) for i in uids]
        T.record_serve_phase("sample", (time.monotonic() - t0) * 1e6)
        groups = self._layout.split(blocks)
        if len(groups) > 1:
            native.counter_add("serve_batches", len(groups) - 1)
        outs = []
        for group in groups:
            t1 = time.monotonic()
            outs.append(self._forward(group))
            T.record_serve_phase("dispatch", (time.monotonic() - t1) * 1e6)
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)


def restore_serving_state(model, graph, args, device=None):
    """Initialise the state and restore the checkpoint in
    ``--model_dir``, which must hold one: serving fresh random parameters
    is a bug, so this raises ``Checkpointer.restore``'s ``ValueError``
    when the directory has none. A checkpoint written under
    ``--model_parallel k`` holds tables padded to a multiple of k: the
    state is padded alike (``parallel.mesh.pad_tables_for_mesh``), as the
    JAX package's serving pads it, and served from this one rank."""
    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.checkpoint import Checkpointer
    from euler_tpu_torch.parallel.mesh import pad_tables_for_mesh

    opt = train_lib.get_optimizer(args.optimizer, args.learning_rate)
    state = model.init_state(graph, opt, device=device, seed=args.seed)
    state = pad_tables_for_mesh(state, getattr(args, "model_parallel", 1))
    ckpt = Checkpointer(args.model_dir)
    try:
        state = ckpt.restore(state)
    finally:
        ckpt.close()
    return state


def build_server(model, graph, args, device=None) -> EmbedServer:
    """EmbedServer from the run_loop flag surface and a restored
    checkpoint, on ``device`` (the card unless ``"cpu"`` is asked for)."""
    state = restore_serving_state(model, graph, args, device)
    return EmbedServer(
        model, graph, state,
        max_batch=args.serve_max_batch,
        max_wait_us=args.serve_max_wait_us,
        queue_cap=args.serve_queue_cap,
        slo_ms=args.serve_slo_ms,
        seed=args.seed,
        sample_cache=args.serve_sample_cache,
        strict_bucket=bool(args.serve_strict_bucket),
    )


def run_serve(model, graph, args, device=None, block: bool = True):
    """Start the embedding server and its frontend (``run_loop
    --serve_after`` and the serve CLI both land here).

    ``block=True`` serves until SIGTERM or SIGINT and drains on the way
    out (stop accepting, finish in-flight requests, drain the batch
    queue); it installs signal handlers, so it must run on the main
    thread. ``block=False`` returns the live ``(server, frontend)``; the
    caller then owns ``frontend.stop()`` and ``server.close()``. The
    caller also owns the graph and the services ``run_loop.build_graph``
    started for it (the serve CLI and ``run_loop`` stop them after the
    graph closes)."""
    server = build_server(model, graph, args, device).start()
    frontend = EmbedFrontend(
        server,
        host=args.serve_host,
        port=args.serve_port,
        max_conns=args.serve_max_conns,
        default_deadline_ms=args.serve_deadline_ms,
    )
    log.info(
        "serving embeddings on %s (max_batch=%d max_wait_us=%d "
        "queue_cap=%d slo_ms=%g device=%s)", frontend.address,
        args.serve_max_batch, args.serve_max_wait_us,
        args.serve_queue_cap, args.serve_slo_ms, server.device,
    )
    if not block:
        return server, frontend
    stop = threading.Event()

    def _stop(signum, _frame):
        log.info("signal %d: draining embedding server", signum)
        stop.set()

    prev = {
        s: signal.signal(s, _stop)
        for s in (signal.SIGTERM, signal.SIGINT)
    }
    try:
        while not stop.wait(0.5):
            pass
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        frontend.drain()
        server.close()  # drains the queued batches
        frontend.stop()
        log.info("serve SLO at exit: %s", server.slo.report())
    return server, frontend


def main(argv=None, device=None) -> int:
    """``python -m euler_tpu_torch.serve``: serve a trained checkpoint on
    ``device`` (the card unless ``"cpu"`` is asked for; with no card it
    raises).

    The run_loop flag surface (graph, model and checkpoint flags mean the
    same, ``--graph_mode remote`` and ``shared`` included: the services
    a shared run starts are drained and stopped on the way out) plus the
    serve flags; the model is built with the inference
    sampling config (``--all_edge_type`` metapaths, as evaluate and
    save_embedding), so ``--mode`` is ignored. ``--num_devices`` and
    ``--model_parallel`` are the training mesh's: they must divide, and a
    checkpoint saved under ``--model_parallel k`` is read with its padded
    tables and served from this one process."""
    from euler_tpu_torch import run_loop
    from euler_tpu_torch.parallel.mesh import Mesh

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    args = run_loop.define_flags().parse_args(argv)
    args.mode = "evaluate"  # inference sampling config (all_edge_type)
    run_loop.check_flags(args)
    # raises when the mesh's counts do not divide
    Mesh(args.num_devices or args.model_parallel, args.model_parallel)
    dev = resolve_device(device)
    # the planes before the first capture, so the device plane sees it
    run_loop.setup_planes(args, dev)
    graph, services = run_loop.build_graph(args)
    try:
        model = run_loop.build_model(args, graph)
        run_serve(model, graph, args, dev, block=True)
    finally:
        graph.close()
        ledger = {k: v for k, v in native.counters().items() if v}
        if ledger:
            log.info("serve counters at exit: %s", ledger)
        # a shared-mode shard (and its tcp:// registry) started here
        run_loop.stop_services(services)
    return 0


if __name__ == "__main__":
    sys.exit(main())
