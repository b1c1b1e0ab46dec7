"""ctypes binding of the port's copy of the C++ graph engine
(counterpart of ``euler_tpu/graph/native.py``).

The engine's sources live in ``graph/_native/`` (a copy of the JAX
package's, unchanged). At first use they are built out of tree with
``make`` into a scratch directory, and the library is renamed into

    build/euler_tpu_torch/native/libeuler_graph_torch_<hash>.so

beside the package (a checkout's root, or the directory an install put
the package in; a directory that cannot be written raises, naming it),
named by a hash of the sources, the Makefile and
the host's CPU model (the Makefile builds with ``-march=native``), so a
changed source or another machine builds anew. A file lock serialises
concurrent builders (test workers, several processes of one run): the
first builds, the others wait and load its library. It builds with the
``g++`` on ``PATH`` whatever ``$CXX`` names (a ``$CXX`` toolchain may
lack OpenMP's runtime, which the engine links). A missing ``make`` or
``g++``, or a failed build, raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

from euler_tpu_torch._build import make_build_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "graph", "_native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "euler_tpu_torch",
                         "native")
_TARGET = "libeuler_graph_torch.so"

_lib = None
build_seconds = 0.0  # 0.0 when the library came from an earlier build


def _sources() -> list[str]:
    return sorted(
        os.path.join(NATIVE_DIR, f) for f in os.listdir(NATIVE_DIR)
        if f.endswith((".cc", ".h")) or f == "Makefile"
    )


def _cpu_model() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"model name"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> str:
    h = hashlib.sha256(_cpu_model())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(
        BUILD_DIR, f"libeuler_graph_torch_{h.hexdigest()[:16]}.so")


def build_native() -> str:
    """Path of the engine library, built first when this source hash has
    no build yet."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    missing = [t for t in ("make", "g++") if shutil.which(t) is None]
    if missing:
        raise RuntimeError(
            f"{' and '.join(missing)} not found on PATH: the graph engine "
            "of euler_tpu_torch is built from graph/_native at first use")
    make_build_dir(BUILD_DIR, "the graph engine")
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            jobs = min(os.cpu_count() or 1, 8)
            r = subprocess.run(
                ["make", "-s", f"-j{jobs}", f"OUT={tmp}",
                 f"CXX={shutil.which('g++')}"],
                cwd=NATIVE_DIR, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"graph engine build failed (make exit {r.returncode})"
                    f":\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
            os.replace(os.path.join(tmp, _TARGET), out)
        build_seconds = time.perf_counter() - t0
    return out


def _sig(fn, restype, argtypes) -> None:
    fn.restype = restype
    fn.argtypes = argtypes


def lib() -> ctypes.CDLL:
    """The engine library (built if needed), loaded once a process."""
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(build_native())
    c = ctypes
    p = c.c_void_p
    u64p = c.POINTER(c.c_uint64)
    i32p = c.POINTER(c.c_int32)
    f32p = c.POINTER(c.c_float)
    _sig(L.eg_last_error, c.c_char_p, [])
    _sig(L.eg_create, p, [])
    _sig(L.eg_destroy, None, [p])
    _sig(L.eg_load, c.c_int, [p, c.c_char_p, c.c_int, c.c_int])
    _sig(L.eg_load_files, c.c_int, [p, c.POINTER(c.c_char_p), c.c_int])
    _sig(L.eg_load_buffers, c.c_int,
         [p, c.POINTER(c.c_void_p), u64p, c.POINTER(c.c_char_p), c.c_int])
    _sig(L.eg_load_deltas, c.c_int, [p, c.c_char_p])
    _sig(L.eg_graph_epoch, c.c_uint64, [p])
    _sig(L.eg_seed, None, [c.c_uint64])
    _sig(L.eg_stat_count, c.c_int, [])
    _sig(L.eg_stat_name, c.c_char_p, [c.c_int])
    _sig(L.eg_stats_snapshot, None, [u64p, u64p, u64p])
    _sig(L.eg_stats_reset, None, [])
    _sig(L.eg_num_nodes, c.c_int64, [p])
    _sig(L.eg_num_edges, c.c_int64, [p])
    _sig(L.eg_node_type_num, c.c_int32, [p])
    _sig(L.eg_edge_type_num, c.c_int32, [p])
    _sig(L.eg_feature_num, c.c_int32, [p, c.c_int])
    _sig(L.eg_type_weight_sums, None, [p, c.c_int, f32p])
    _sig(L.eg_sample_node, None, [p, c.c_int, c.c_int32, u64p])
    _sig(L.eg_sample_edge, None, [p, c.c_int, c.c_int32, u64p, u64p, i32p])
    _sig(L.eg_sample_node_with_src, None, [p, u64p, c.c_int, c.c_int, u64p])
    _sig(L.eg_get_node_type, None, [p, u64p, c.c_int, i32p])
    _sig(L.eg_get_node_weight, c.c_int, [p, u64p, c.c_int, f32p])
    _sig(
        L.eg_sample_neighbor,
        None,
        [p, u64p, c.c_int, i32p, c.c_int, c.c_int, c.c_uint64, u64p, f32p,
         i32p],
    )
    _sig(
        L.eg_sample_fanout,
        None,
        [
            p, u64p, c.c_int, i32p, i32p, i32p, c.c_int, c.c_uint64,
            c.POINTER(u64p), c.POINTER(f32p), c.POINTER(i32p),
        ],
    )
    _sig(L.eg_get_full_neighbor, p, [p, u64p, c.c_int, i32p, c.c_int, c.c_int])
    _sig(
        L.eg_get_top_k_neighbor,
        None,
        [p, u64p, c.c_int, i32p, c.c_int, c.c_int, c.c_uint64, u64p, f32p,
         i32p],
    )
    _sig(
        L.eg_random_walk,
        None,
        [p, u64p, c.c_int, i32p, i32p, c.c_int, c.c_float, c.c_float,
         c.c_uint64, u64p],
    )
    _sig(
        L.eg_get_dense_feature,
        None,
        [p, u64p, c.c_int, i32p, i32p, c.c_int, f32p],
    )
    _sig(
        L.eg_get_edge_dense_feature,
        None,
        [p, u64p, u64p, i32p, c.c_int, i32p, i32p, c.c_int, f32p],
    )
    _sig(L.eg_get_sparse_feature, p, [p, u64p, c.c_int, i32p, c.c_int])
    _sig(
        L.eg_get_edge_sparse_feature,
        p,
        [p, u64p, u64p, i32p, c.c_int, i32p, c.c_int],
    )
    _sig(L.eg_get_binary_feature, p, [p, u64p, c.c_int, i32p, c.c_int])
    _sig(
        L.eg_get_edge_binary_feature,
        p,
        [p, u64p, u64p, i32p, c.c_int, i32p, c.c_int],
    )
    _sig(L.eg_result_size, c.c_int64, [p, c.c_int, c.c_int])
    _sig(L.eg_result_copy, None, [p, c.c_int, c.c_int, p])
    _sig(L.eg_result_free, None, [p])
    # the counters and telemetry that serving records through
    _sig(L.eg_counter_count, c.c_int, [])
    _sig(L.eg_counter_name, c.c_char_p, [c.c_int])
    _sig(L.eg_counters_snapshot, None, [u64p])
    _sig(L.eg_counters_reset, None, [])
    _sig(L.eg_counter_add, None, [c.c_int, c.c_uint64])
    _sig(L.eg_serve_record, None, [c.c_int, c.c_uint64])
    _sig(L.eg_serve_batch, None, [c.c_uint64])
    _sig(L.eg_serve_slo_set, None,
         [c.c_uint64, c.c_uint64, c.c_uint64, c.c_uint64])
    _sig(L.eg_telemetry_enabled, c.c_int, [])
    _sig(L.eg_telemetry_set_enabled, None, [c.c_int])
    _sig(L.eg_telemetry_reset, None, [])
    _sig(L.eg_telemetry_json, c.c_int, [c.c_char_p, c.c_int])
    _sig(L.eg_telemetry_set_slow_capacity, None, [c.c_int])
    _sig(
        L.eg_telemetry_record_span,
        None,
        [c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_uint64,
         c.c_uint64, c.c_uint64, c.c_uint64],
    )
    # training's observability: step phases and prefetch gauges, the
    # device-memory gauges, the flight recorder and its postmortems
    _sig(L.eg_phase_record, None, [c.c_int, c.c_uint64])
    _sig(L.eg_phase_gauge, None, [c.c_int, c.c_uint64])
    _sig(L.eg_devprof_set_mem, None, [c.c_int64, c.c_int64])
    _sig(L.eg_blackbox_enabled, c.c_int, [])
    _sig(L.eg_blackbox_set_enabled, None, [c.c_int])
    _sig(L.eg_blackbox_init, c.c_int, [c.c_char_p, c.c_int, c.c_int])
    _sig(
        L.eg_blackbox_record,
        None,
        [c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_uint64, c.c_int],
    )
    _sig(L.eg_blackbox_json, c.c_int, [c.c_char_p, c.c_int])
    _sig(L.eg_blackbox_history, c.c_int, [c.c_char_p, c.c_int])
    _sig(L.eg_blackbox_dump, c.c_int, [c.c_char_p])
    _sig(L.eg_blackbox_reset, None, [])
    # the remote client, shard service, registry, heat profiler and
    # failpoints (remote and shared graphs)
    _sig(L.eg_remote_ping, c.c_int, [p, c.c_int])
    _sig(L.eg_remote_scrape, c.c_int, [p, c.c_int, c.c_char_p, c.c_int])
    _sig(L.eg_remote_history, c.c_int, [p, c.c_int, c.c_char_p, c.c_int])
    _sig(L.eg_heat_enabled, c.c_int, [])
    _sig(L.eg_heat_set_enabled, None, [c.c_int])
    _sig(L.eg_heat_set_topk, None, [c.c_int])
    _sig(L.eg_heat_record, None, [c.c_int, c.c_int, u64p, c.c_int64])
    _sig(L.eg_heat_estimate, c.c_uint64, [c.c_int, c.c_uint64])
    _sig(L.eg_heat_json, c.c_int, [c.c_char_p, c.c_int])
    _sig(L.eg_heat_reset, None, [])
    _sig(L.eg_remote_heat, c.c_int, [p, c.c_int, c.c_char_p, c.c_int])
    _sig(L.eg_fault_config, c.c_int, [c.c_char_p, c.c_uint64])
    _sig(L.eg_fault_clear, None, [])
    _sig(L.eg_fault_count, c.c_int, [])
    _sig(L.eg_fault_name, c.c_char_p, [c.c_int])
    _sig(L.eg_fault_injected, None, [u64p])
    _sig(L.eg_remote_create, p, [c.c_char_p])
    _sig(L.eg_remote_shards, c.c_int, [p])
    _sig(L.eg_remote_partitions, c.c_int, [p])
    _sig(L.eg_remote_replica_count, c.c_int, [p, c.c_int])
    _sig(L.eg_remote_has_placement, c.c_int, [p])
    _sig(L.eg_remote_route, None, [p, u64p, c.c_int, i32p])
    _sig(L.eg_remote_strict_error, c.c_int, [p, c.c_char_p, c.c_int])
    _sig(L.eg_remote_epoch, c.c_uint64, [p, c.c_int])
    _sig(L.eg_remote_cache_gen, c.c_uint64, [p])
    _sig(L.eg_remote_load_delta, c.c_int64, [p, c.c_int, c.c_char_p])
    _sig(
        L.eg_remote_sample_async,
        c.c_int,
        [
            p, u64p, c.c_int, i32p, i32p, i32p, c.c_int, c.c_uint64,
            c.POINTER(u64p), c.POINTER(f32p), c.POINTER(i32p),
        ],
    )
    _sig(L.eg_remote_async_poll, c.c_int, [p, c.c_int])
    _sig(L.eg_remote_async_take, c.c_int, [p, c.c_int])
    _sig(
        L.eg_service_start,
        p,
        [c.c_char_p, c.c_int, c.c_int, c.c_char_p, c.c_int, c.c_char_p,
         c.c_char_p],
    )
    _sig(L.eg_service_port, c.c_int, [p])
    _sig(L.eg_service_drain, None, [p, c.c_int])
    _sig(L.eg_service_load_delta, c.c_int64, [p, c.c_char_p])
    _sig(L.eg_service_epoch, c.c_uint64, [p])
    _sig(L.eg_service_stop, None, [p])
    _sig(L.eg_registry_start, p, [c.c_char_p, c.c_int, c.c_int])
    _sig(L.eg_registry_port, c.c_int, [p])
    _sig(L.eg_registry_stop, None, [p])
    _sig(
        L.eg_registry_query,
        c.c_int,
        [c.c_char_p, c.c_int, c.c_int, c.c_char_p, c.c_int],
    )
    _lib = L
    return L


def counters() -> dict:
    """Snapshot of the engine's process-global counters, every name
    present (zero included): the transport's failure and efficiency
    ledger and the serving counters (``serve_requests``,
    ``serve_busy_rejects``, ``serve_deadline_rejects``,
    ``serve_batches``, ``serve_recompiles``, ``h2d_bytes``,
    ``d2h_bytes``; ``_native/eg_stats.h``)."""
    L = lib()
    n = L.eg_counter_count()
    arr = (ctypes.c_uint64 * n)()
    L.eg_counters_snapshot(arr)
    return {L.eg_counter_name(i).decode(): int(arr[i]) for i in range(n)}


def reset_counters() -> None:
    """Zero the engine's counters (process-global)."""
    lib().eg_counters_reset()


_counter_ids: dict = {}


def counter_add(name: str, n: int = 1) -> None:
    """Add ``n`` to one counter by name, so Python threads account into
    the ledger the engine keeps. Raises ``KeyError`` on an unknown
    name."""
    global _counter_ids
    if not _counter_ids:
        # built whole, then published: a thread arriving meanwhile never
        # sees a partial table (each ctypes call releases the GIL)
        L = lib()
        _counter_ids = {L.eg_counter_name(i).decode(): i
                        for i in range(L.eg_counter_count())}
    lib().eg_counter_add(_counter_ids[name], n)


def stats() -> dict:
    """Snapshot of the engine's span timers (process-global: engine
    calls, remote client round trips and served shard requests all
    record here, ``_native/eg_stats.h``): ``{op: {count, total_ms,
    avg_us, max_us}}`` for the ops with a count."""
    L = lib()
    n = L.eg_stat_count()
    counts, total, mx = (np.zeros(n, dtype=np.uint64) for _ in range(3))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    L.eg_stats_snapshot(counts.ctypes.data_as(u64p),
                        total.ctypes.data_as(u64p), mx.ctypes.data_as(u64p))
    return {
        L.eg_stat_name(i).decode(): {
            "count": int(counts[i]),
            "total_ms": float(total[i]) / 1e6,
            "avg_us": float(total[i]) / float(counts[i]) / 1e3,
            "max_us": float(mx[i]) / 1e3,
        }
        for i in range(n) if counts[i]
    }


def stats_reset() -> None:
    """Zero the engine's span timers."""
    lib().eg_stats_reset()


def fault_config(spec: str, seed: int = 0) -> None:
    """Install a process-global deterministic failpoint spec (the JAX
    package's FAULTS.md grammar), e.g. ``recv_frame:err@0.5,dial:delay@
    200``. The same ``seed`` fires the same pattern of faults at each
    point. A malformed spec raises ``ValueError`` and installs nothing;
    an empty spec clears."""
    if lib().eg_fault_config(spec.encode(), seed) != 0:
        raise ValueError(lib().eg_last_error().decode())


def fault_clear() -> None:
    """Remove every installed failpoint."""
    lib().eg_fault_clear()


def fault_injected() -> dict:
    """``{failpoint: fires since its last config}``, every failpoint
    present."""
    L = lib()
    n = L.eg_fault_count()
    arr = (ctypes.c_uint64 * n)()
    L.eg_fault_injected(arr)
    return {L.eg_fault_name(i).decode(): int(arr[i]) for i in range(n)}
