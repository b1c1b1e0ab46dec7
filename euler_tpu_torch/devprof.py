"""The device plane: compile attribution, device-memory gauges and
transfer counters (counterpart of ``euler_tpu/devprof.py``).

The port has no XLA compile. What it compiles is (1) its CUDA kernels,
built from ``csrc/`` at first use (``_build.load_library``), and (2) the
serving bucket's CUDA graph, captured at its first dispatch and again
whenever the bucket's shapes change (``serve._GraphBucket``). Each of
the two calls :func:`record_compile`, which bumps ``device_compiles``
and records the wall time in the ``phase:compile`` histogram. There is
no ``jax.monitoring`` listener: those two hooks take its place. A
library that came from an earlier build compiles nothing, as a
persistent-cache hit compiles nothing in JAX.

    devprof.setup(device=dev)         once per process (run_loop, serve)
    fn = devprof.watch(fn, "name")    recompile attribution
    devprof.recompile_ledger()        journaled recompiles, newest last
    devprof.sample_device_mem()       one device-memory gauge refresh
    devprof.count_h2d(batch)          transfer-byte bracketing
    devprof.set_devprof(False)        process-global kill-switch

Counts go to ``device_compiles``, ``device_recompiles`` and
``serve_recompiles`` (``_native/eg_stats.h``), compile wall time to the
``phase:compile`` histogram, and the memory gauges to the blackbox
resource section (``eg_devprof_set_mem``), from where ``metrics_text()``,
the STATS scrape and postmortems read them. On the card the gauges are
the CUDA caching allocator's: ``torch.cuda.memory_allocated`` is the
bytes in use, ``max_memory_allocated`` raises the high-water mark, and
the live blocks (``active.all.current``) are the buffers; on the CPU a
census of live tensors stands in, as ``jax.live_arrays()`` does there.
Attribution (which function recompiled, which argument drifted) comes
from :class:`Watched`'s per-function signature registry, as in the JAX
package.
"""

from __future__ import annotations

import gc
import logging
import threading
import time

import numpy as np
import torch

from euler_tpu_torch import telemetry
from euler_tpu_torch.graph import native
from euler_tpu_torch.graph.native import lib

log = logging.getLogger("euler_tpu_torch.devprof")

_LEDGER_CAP = 256

_enabled = True
_lock = threading.Lock()
_ledger: list = []
_device = None  # the entry point's device, whose memory the gauges read
_last_mem: dict = {}
_sampler_stop = None
_sampler_thread = None


class RecompileError(RuntimeError):
    """A watched function compiled again after warmup under strict=True
    (the serving bucket's ``strict_bucket`` contract: the fixed-bucket
    forward is captured exactly once)."""


def devprof_enabled() -> bool:
    return _enabled


def set_devprof(on: bool) -> None:
    """Process-global device-plane kill-switch (``--devprof 0``): False
    stops compile counting and journaling, memory sampling and transfer
    counting; the hooks and wrappers stay in place and write nothing."""
    global _enabled
    _enabled = bool(on)


def record_compile(wall_us: float) -> None:
    """One compile (a kernel build or a CUDA-graph capture) of
    ``wall_us``: ``device_compiles`` and the ``phase:compile``
    histogram."""
    if not _enabled:
        return
    native.counter_add("device_compiles")
    telemetry.record_phase("compile", wall_us)


def install(sample_ms: int = 0, device=None) -> None:
    """Arm the device plane (idempotent): remember the device whose
    memory the gauges read and, with ``sample_ms > 0``, start the
    background memory sampler. The compile hooks need no arming."""
    global _device
    if device is not None:
        _device = torch.device(device)
    if sample_ms > 0:
        start_sampler(sample_ms)


def setup(enabled: bool = True, device=None, sample_ms: int = 0) -> bool:
    """CLI start-up shared by ``python -m euler_tpu_torch`` and
    ``python -m euler_tpu_torch.serve`` (their ``--devprof`` flag lands
    here): disarm the plane when ``enabled`` is False, else install it
    for ``device``. The memory sampler runs on the card only: on the CPU
    its census walks the heap. Returns devprof_enabled()."""
    if not enabled:
        set_devprof(False)
        return False
    set_devprof(True)
    dev = torch.device(device) if device is not None else None
    install(sample_ms=sample_ms if dev is not None and dev.type == "cuda"
            else 0, device=dev)
    return True


# ---------------------------------------------------------------------------
# compile attribution: per-function shape-signature registry
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """The leaves of nested dicts (sorted keys), lists and tuples, in
    ``jax.tree_util.tree_leaves`` order (None is an empty subtree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _dtype_name(dtype) -> str:
    # torch.float32 -> "float32", as numpy and jax name it
    return str(dtype).removeprefix("torch.")


def _leaf_sig(x) -> tuple:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), _dtype_name(dtype))
    return (type(x).__name__,)


def _signature(args: tuple, kwargs: dict) -> tuple:
    return tuple(_leaf_sig(leaf) for leaf in _leaves((args, kwargs)))


def sig_diff(old, new) -> list:
    """Per-leaf diff between two signatures: what drifted."""
    if old is None:
        return ["first compile"]
    out = []
    n = max(len(old), len(new))
    for i in range(n):
        a = old[i] if i < len(old) else None
        b = new[i] if i < len(new) else None
        if a != b:
            out.append(f"leaf{i}: {_fmt_sig(a)} -> {_fmt_sig(b)}")
    return out or [f"leaf count {len(old)} -> {len(new)}"]


def _fmt_sig(s) -> str:
    if s is None:
        return "absent"
    if len(s) == 2:
        return f"{s[0]} {s[1]}"
    return str(s[0])


def _journal(entry: dict) -> None:
    with _lock:
        _ledger.append(entry)
        del _ledger[:-_LEDGER_CAP]
    # the same event in the slow-span journal (op 0 "other", client side),
    # beside the RPC spans it held up
    telemetry.record_span(int(entry["wall_us"]), op=0, side="client")
    log.warning("devprof: recompile of %s after warmup: %s",
                entry["fn"], "; ".join(entry["diff"]))


def recompile_ledger() -> list:
    """Journaled post-warmup recompiles, oldest first (the last 256):
    [{"t_us", "fn", "diff", "sig", "prev", "wall_us"}]."""
    with _lock:
        return list(_ledger)


def devprof_reset() -> None:
    """Clear the recompile ledger (the native gauges and counters reset
    with telemetry_reset() and reset_counters())."""
    with _lock:
        del _ledger[:]


class Watched:
    """A callable with a shape-signature registry: it detects each
    compile a call made and journals a compile after warmup as a
    recompile, with the argument shapes and dtypes that drifted.

    A callable that reports its own compiles (a ``_cache_size()`` that
    grows by one a compile, as the serving bucket's captures do) has
    them counted by the hook that made them; for any other callable a
    signature not seen before is a compile, and the wrapper counts it
    (its call's wall time in ``phase:compile``), as the JAX package's
    fallback does. ``on_recompile(entry)`` is the serving hook;
    ``strict=True`` raises :class:`RecompileError` after the call has
    run."""

    def __init__(self, fn, name: str | None = None, strict: bool = False,
                 counter: str = "device_recompiles", on_recompile=None):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self.strict = strict
        self._counter = counter
        self._on_recompile = on_recompile
        self._sigs: dict = {}
        self._last_sig = None
        self.warm = False
        self.compiles = 0
        self.recompiles = 0

    def _cache_size(self):
        cs = getattr(self._fn, "_cache_size", None)
        return None if cs is None else cs()

    def mark_warm(self) -> None:
        """Declare warmup done: the next compile is a recompile even if
        no tracked call compiled yet."""
        self.warm = True

    def __call__(self, *args, **kwargs):
        if not _enabled:
            return self._fn(*args, **kwargs)
        before = self._cache_size()
        t0 = time.monotonic()
        out = self._fn(*args, **kwargs)
        wall_us = int((time.monotonic() - t0) * 1e6)
        after = self._cache_size()
        owns_count = after is None
        if not owns_count:
            if after == before:
                # steady state: nothing compiled, no signature built
                return out
            compiled = True
            sig = _signature(args, kwargs)
        else:
            sig = _signature(args, kwargs)
            compiled = sig not in self._sigs
        self._sigs[sig] = self._sigs.get(sig, 0) + 1
        if not compiled:
            self._last_sig = sig
            return out
        self.compiles += 1
        if owns_count:
            record_compile(wall_us)
        if self.warm:
            self.recompiles += 1
            entry = {
                "t_us": int(time.monotonic() * 1e6),
                "fn": self.name,
                "diff": sig_diff(self._last_sig, sig),
                "sig": sig,
                "prev": self._last_sig,
                "wall_us": wall_us,
            }
            native.counter_add(self._counter)
            _journal(entry)
            self._last_sig = sig
            if self._on_recompile is not None:
                self._on_recompile(entry)
            if self.strict:
                raise RecompileError(
                    f"{self.name} recompiled after warmup: "
                    f"{'; '.join(entry['diff'])}")
            return out
        self.warm = True
        self._last_sig = sig
        return out


def watch(fn, name: str | None = None, strict: bool = False,
          counter: str = "device_recompiles", on_recompile=None) -> Watched:
    """Wrap a callable with recompile attribution (:class:`Watched`):
    same arguments and results, free when the kill-switch is off."""
    return Watched(fn, name=name, strict=strict, counter=counter,
                   on_recompile=on_recompile)


# ---------------------------------------------------------------------------
# device memory and transfers
# ---------------------------------------------------------------------------


def _census() -> tuple:
    """(bytes, tensors) of the live CPU tensors: the CPU's stand-in for
    an allocator gauge."""
    total = count = 0
    for obj in gc.get_objects():
        # the type, not isinstance: some objects warn when asked theirs
        if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
            count += 1
            total += obj.numel() * obj.element_size()
    return total, count


def sample_device_mem(device=None) -> tuple:
    """One device-memory sample pushed into the native gauges (and from
    there into the blackbox resource ring, postmortems and
    metrics_text): ``(bytes_in_use, live_buffers)`` of ``device`` (the
    installed one by default, else the current CUDA device when a card
    is present, else the CPU). On the card: ``memory_allocated`` and the
    allocator's live blocks, after ``max_memory_allocated`` has raised
    the high-water mark; ``last_device_mem()`` keeps the sample with
    ``memory_reserved``. On the CPU: a census of live tensors."""
    if not _enabled:
        return (0, 0)
    dev = device if device is not None else _device
    if dev is None:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(dev)
    L = lib()
    if dev.type == "cuda":
        allocated = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.memory_reserved(dev)
        buffers = int(torch.cuda.memory_stats(dev).get("active.all.current",
                                                       0))
        # the native peak is the high-water of the samples: the
        # allocator's own peak first, then the current value
        L.eg_devprof_set_mem(peak, buffers)
    else:
        allocated, buffers = _census()
        peak = reserved = allocated
    L.eg_devprof_set_mem(allocated, buffers)
    with _lock:
        _last_mem.update(device=str(dev), allocated=allocated,
                         reserved=reserved, peak=peak, buffers=buffers)
    return (allocated, buffers)


def last_device_mem() -> dict:
    """The last :func:`sample_device_mem`: device, allocated, reserved,
    peak (``max_memory_allocated``) and buffers."""
    with _lock:
        return dict(_last_mem)


def start_sampler(period_ms: int = 1000) -> None:
    """Background device-memory sampler (a daemon thread; idempotent):
    refreshes the gauges every ``period_ms``, so the blackbox resource
    ring and a scrape see a trajectory, not only the last manual
    sample."""
    global _sampler_stop, _sampler_thread
    with _lock:
        if _sampler_thread is not None and _sampler_thread.is_alive():
            return
        stop = threading.Event()

        def loop():
            while not stop.wait(max(period_ms, 50) / 1000.0):
                try:
                    sample_device_mem()
                except Exception:  # telemetry only: keep sampling
                    pass

        t = threading.Thread(target=loop, name="eg-devprof-sampler",
                             daemon=True)
        t.start()
        _sampler_stop, _sampler_thread = stop, t


def stop_sampler() -> None:
    global _sampler_stop, _sampler_thread
    with _lock:
        if _sampler_stop is not None:
            _sampler_stop.set()
        _sampler_stop = _sampler_thread = None


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensors and numpy arrays (other leaves
    count 0)."""
    total = 0
    for leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


def count_h2d(tree) -> int:
    """Add a tree's bytes about to cross host to device to ``h2d_bytes``
    (the training loop's upload, a serving dispatch). Returns the bytes
    counted (0 when the kill-switch is off)."""
    if not _enabled:
        return 0
    n = tree_bytes(tree)
    if n:
        native.counter_add("h2d_bytes", n)
    return n


def count_d2h(tree) -> int:
    """Add a device-to-host read (fetched losses and metrics, served
    rows) to ``d2h_bytes``."""
    if not _enabled:
        return 0
    n = tree_bytes(tree)
    if n:
        native.counter_add("d2h_bytes", n)
    return n


# ---------------------------------------------------------------------------
# summaries (run_loop's first-step line, serving stats)
# ---------------------------------------------------------------------------


def compile_summary(data: dict | None = None) -> dict:
    """Compile economics from a telemetry dump (default: this process):
    counts, compile wall time (total, p50, p99), transfer bytes and the
    memory gauges."""
    data = data or telemetry.telemetry_json()
    h = data["hist"].get("phase:compile") or {"b": [0], "count": 0,
                                              "sum_us": 0}
    pct = telemetry.percentiles(h, (50, 99)) if h["count"] else {}
    res = data.get("resource", {})
    return {
        "compiles": data["counters"].get("device_compiles", 0),
        "recompiles": data["counters"].get("device_recompiles", 0),
        "serve_recompiles": data["counters"].get("serve_recompiles", 0),
        "compile_events": h["count"],
        "compile_ms_total": round(h["sum_us"] / 1000.0, 1),
        "compile_ms_p50": round(pct.get(50, 0.0) / 1000.0, 1),
        "compile_ms_p99": round(pct.get(99, 0.0) / 1000.0, 1),
        "h2d_bytes": data["counters"].get("h2d_bytes", 0),
        "d2h_bytes": data["counters"].get("d2h_bytes", 0),
        "device_mem_bytes": res.get("device_mem_bytes", 0),
        "device_mem_peak_bytes": res.get("device_mem_peak_bytes", 0),
        "device_buffers": res.get("device_buffers", 0),
    }
