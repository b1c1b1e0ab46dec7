"""The graph engine client, local mode (counterpart of
``euler_tpu/graph/graph.py``): a Python facade over the port's copy of
the C++ engine (``graph/native.py``) that loads ``.dat`` partitions and
returns fixed-shape numpy arrays for the host sampling path.

All ids are int64 on the Python side; the engine works in uint64 and the
bit patterns pass through unchanged (default ids such as -1 wrap). The
engine releases the GIL inside each call, so prefetch threads sample
while the training thread drives the card.

Remote and shared modes, streaming ingest, snapshot deltas and the
remote client's cache and placement options need the shard service, the
registry and the remote filesystem layer, which are not ported yet
(ROADMAP A0b): asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from euler_tpu_torch.graph.native import lib

# Feature-kind selectors of the C ABI (eg_capi.cc eg_feature_num).
NODE_U64, NODE_F32, NODE_BIN, EDGE_U64, EDGE_F32, EDGE_BIN = range(6)

_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)

# The JAX client's keywords of the remote client, streaming ingest and
# snapshot deltas, all of which need modules not ported yet.
_A0B_OPTIONS = (
    "registry", "shards", "retries", "timeout_ms", "quarantine_ms",
    "rediscover_ms", "backoff_ms", "deadline_ms", "fault", "fault_seed",
    "feature_cache_mb", "neighbor_cache_mb", "cache_policy", "placement",
    "strict", "coalesce", "chunk_ids", "dispatch_workers", "wire_version",
    "telemetry", "slow_spans", "heat", "heat_topk", "blackbox", "devprof",
    "postmortem_dir", "cache_dir", "stream", "delta", "config", "init",
)


def _ids(a) -> np.ndarray:
    """Accept any integer array-like; reinterpret int64 as uint64 bits."""
    arr = np.ascontiguousarray(np.asarray(a).reshape(-1))
    if arr.dtype == np.uint64:
        return arr
    return arr.astype(np.int64, copy=False).view(np.uint64)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32).reshape(-1))


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def _default_u64(default_node: int) -> int:
    return int(np.int64(default_node).view(np.uint64))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to euler_tpu_torch yet (ROADMAP A0b: remote "
        "and shared modes, service.py, registry.py, remote_fs.py, streams "
        "and deltas); the port's Graph embeds the engine (mode='local')")


class Graph:
    """Embedded engine over ``.dat`` partitions: ``directory=`` (every
    ``*.dat`` there whose partition index ``p`` has ``p % shard_num ==
    shard_idx``) or an explicit ``files=`` list."""

    def __init__(
        self,
        directory: str | None = None,
        files: list[str] | None = None,
        shard_idx: int = 0,
        shard_num: int = 1,
        mode: str = "local",
        **options,
    ):
        self._lib = lib()
        self._handle = None
        if mode != "local":
            raise _not_ported(f"mode={mode!r}")
        unknown = sorted(set(options) - set(_A0B_OPTIONS))
        if unknown:
            raise TypeError(f"Graph got unknown keywords {unknown}")
        asked = sorted(k for k, v in options.items()
                       if v is not None and v is not False)
        if asked:
            raise _not_ported(", ".join(f"{k}=" for k in asked))
        if directory is not None and files:
            raise ValueError(
                "pass directory= OR files=, not both (the embedded engine "
                "loads exactly one of them)")
        self.mode = "local"
        h = self._lib.eg_create()
        if directory is not None:
            rc = self._lib.eg_load(h, str(directory).encode(),
                                   int(shard_idx), int(shard_num))
        elif files:
            arr = (ctypes.c_char_p * len(files))(
                *[str(f).encode() for f in files])
            rc = self._lib.eg_load_files(h, arr, len(files))
        else:
            self._lib.eg_destroy(h)
            raise ValueError("pass directory= or files=")
        if rc != 0:
            err = self._lib.eg_last_error().decode()
            self._lib.eg_destroy(h)
            raise RuntimeError(f"graph load failed: {err}")
        self._handle = h

    @property
    def _h(self):
        if self._handle is None:
            raise RuntimeError("graph is closed")
        return self._handle

    def load_delta(self, path: str, shard: int | None = None) -> int:
        raise _not_ported("Graph.load_delta")

    def epoch(self) -> int:
        return int(self._lib.eg_graph_epoch(self._h))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.eg_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ---- introspection ----
    @property
    def num_nodes(self) -> int:
        return self._lib.eg_num_nodes(self._h)

    @property
    def num_edges(self) -> int:
        return self._lib.eg_num_edges(self._h)

    @property
    def node_type_num(self) -> int:
        return self._lib.eg_node_type_num(self._h)

    @property
    def edge_type_num(self) -> int:
        return self._lib.eg_edge_type_num(self._h)

    def feature_num(self, kind: int) -> int:
        return self._lib.eg_feature_num(self._h, kind)

    def type_weight_sums(self, edges: bool = False) -> np.ndarray:
        n = self.edge_type_num if edges else self.node_type_num
        out = np.zeros(n, dtype=np.float32)
        if n:
            self._lib.eg_type_weight_sums(
                self._h, 1 if edges else 0, _ptr(out, _F32P))
        return out

    # ---- global sampling ----
    def sample_node(self, count: int, node_type: int = -1) -> np.ndarray:
        out = np.empty(count, dtype=np.uint64)
        self._lib.eg_sample_node(self._h, count, node_type, _ptr(out, _U64P))
        return out.view(np.int64)

    def sample_edge(self, count: int, edge_type: int = -1):
        src = np.empty(count, dtype=np.uint64)
        dst = np.empty(count, dtype=np.uint64)
        t = np.empty(count, dtype=np.int32)
        self._lib.eg_sample_edge(
            self._h, count, edge_type, _ptr(src, _U64P), _ptr(dst, _U64P),
            _ptr(t, _I32P))
        return src.view(np.int64), dst.view(np.int64), t

    def sample_node_with_src(self, src_ids, count: int) -> np.ndarray:
        """[n, count] negatives drawn from each src's node-type sampler."""
        ids = _ids(src_ids)
        out = np.empty((len(ids), count), dtype=np.uint64)
        self._lib.eg_sample_node_with_src(
            self._h, _ptr(ids, _U64P), len(ids), count, _ptr(out, _U64P))
        return out.view(np.int64)

    def node_types(self, ids) -> np.ndarray:
        """Per-node types, -1 for unknown ids."""
        ids = _ids(ids)
        out = np.empty(len(ids), dtype=np.int32)
        self._lib.eg_get_node_type(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(out, _I32P))
        return out

    def node_weights(self, ids) -> np.ndarray:
        """Per-node sampling weights, 0 for unknown ids."""
        ids = _ids(ids)
        out = np.empty(len(ids), dtype=np.float32)
        if self._lib.eg_get_node_weight(
                self._h, _ptr(ids, _U64P), len(ids), _ptr(out, _F32P)) != 0:
            raise RuntimeError(self._lib.eg_last_error().decode())
        return out

    # ---- neighbor ops ----
    def sample_neighbor(self, ids, edge_types, count: int,
                        default_node: int = -1):
        """(nbr_ids [n, count] i64, weights [n, count] f32, types [n,
        count] i32)."""
        ids = _ids(ids)
        et = _i32(edge_types)
        n = len(ids)
        out_i = np.empty((n, count), dtype=np.uint64)
        out_w = np.empty((n, count), dtype=np.float32)
        out_t = np.empty((n, count), dtype=np.int32)
        self._lib.eg_sample_neighbor(
            self._h, _ptr(ids, _U64P), n, _ptr(et, _I32P), len(et), count,
            _default_u64(default_node), _ptr(out_i, _U64P),
            _ptr(out_w, _F32P), _ptr(out_t, _I32P))
        return out_i.view(np.int64), out_w, out_t

    def sample_fanout(self, ids, edge_types, counts, default_node: int = -1):
        """Fused multi-hop sampling, one native call for all hops.

        ``edge_types``: one edge-type list a hop; ``counts``: the fanouts.
        Returns (ids_per_hop, weights_per_hop, types_per_hop); hop h's
        arrays are flat with n * prod(counts[:h+1]) rows, and
        ids_per_hop[0] is the (flattened) input."""
        ids = _ids(ids)
        nhops = len(counts)
        et_lists = [_i32(e) for e in edge_types]
        et_flat = (np.concatenate(et_lists) if et_lists
                   else np.zeros(0, np.int32))
        et_counts = _i32([len(e) for e in et_lists])
        counts_arr = _i32(counts)
        out_i, out_w, out_t = [], [], []
        m = len(ids)
        for h in range(nhops):
            m *= int(counts[h])
            out_i.append(np.empty(m, dtype=np.uint64))
            out_w.append(np.empty(m, dtype=np.float32))
            out_t.append(np.empty(m, dtype=np.int32))
        ids_ptrs = (_U64P * nhops)(*[_ptr(a, _U64P) for a in out_i])
        w_ptrs = (_F32P * nhops)(*[_ptr(a, _F32P) for a in out_w])
        t_ptrs = (_I32P * nhops)(*[_ptr(a, _I32P) for a in out_t])
        self._lib.eg_sample_fanout(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(et_flat, _I32P),
            _ptr(et_counts, _I32P), _ptr(counts_arr, _I32P), nhops,
            _default_u64(default_node), ids_ptrs, w_ptrs, t_ptrs)
        return ([ids.view(np.int64)] + [a.view(np.int64) for a in out_i],
                out_w, out_t)

    def get_full_neighbor(self, ids, edge_types, sorted: bool = False):
        """Ragged full adjacency ``(nbr_ids i64, weights f32, types i32,
        row_counts i32)``."""
        ids = _ids(ids)
        et = _i32(edge_types)
        r = self._lib.eg_get_full_neighbor(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(et, _I32P), len(et),
            1 if sorted else 0)
        try:
            nbr = self._fetch(r, 0, 0, np.uint64)
            w = self._fetch(r, 1, 0, np.float32)
            t = self._fetch(r, 2, 0, np.int32)
            counts = self._fetch(r, 2, 1, np.int32)
        finally:
            self._lib.eg_result_free(r)
        return nbr.view(np.int64), w, t, counts

    def get_top_k_neighbor(self, ids, edge_types, k: int, default_node=-1):
        ids = _ids(ids)
        et = _i32(edge_types)
        n = len(ids)
        out_i = np.empty((n, k), dtype=np.uint64)
        out_w = np.empty((n, k), dtype=np.float32)
        out_t = np.empty((n, k), dtype=np.int32)
        self._lib.eg_get_top_k_neighbor(
            self._h, _ptr(ids, _U64P), n, _ptr(et, _I32P), len(et), k,
            _default_u64(default_node), _ptr(out_i, _U64P),
            _ptr(out_w, _F32P), _ptr(out_t, _I32P))
        return out_i.view(np.int64), out_w, out_t

    # ---- walks ----
    def random_walk(self, ids, edge_types, walk_len: int = None,
                    p: float = 1.0, q: float = 1.0,
                    default_node: int = -1) -> np.ndarray:
        """[n, walk_len+1] int64 walks; column 0 is the start node.

        ``edge_types`` is a flat list (the same types every step;
        ``walk_len`` required) or one list a step, a metapath such as
        [[0], [1], [0]] (``walk_len`` inferred)."""
        ids = _ids(ids)
        if len(edge_types) > 0 and isinstance(
                edge_types[0], (list, tuple, np.ndarray)):
            steps = [_i32(e) for e in edge_types]
            if walk_len is None:
                walk_len = len(steps)
            elif walk_len != len(steps):
                raise ValueError("walk_len != len(edge_types metapath)")
        else:
            if walk_len is None:
                raise ValueError("walk_len required with flat edge_types")
            steps = [_i32(edge_types)] * walk_len
        et_flat = np.concatenate(steps) if steps else np.zeros(0, np.int32)
        et_counts = _i32([len(s) for s in steps])
        out = np.empty((len(ids), walk_len + 1), dtype=np.uint64)
        self._lib.eg_random_walk(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(et_flat, _I32P),
            _ptr(et_counts, _I32P), walk_len, p, q,
            _default_u64(default_node), _ptr(out, _U64P))
        return out.view(np.int64)

    # ---- features ----
    def get_dense_feature(self, ids, fids, dims) -> np.ndarray:
        """[n, sum(dims)] float32, zero-padded per slot."""
        ids = _ids(ids)
        fids = _i32(fids)
        dims = _i32(dims)
        out = np.empty((len(ids), int(dims.sum())), dtype=np.float32)
        self._lib.eg_get_dense_feature(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(fids, _I32P),
            _ptr(dims, _I32P), len(fids), _ptr(out, _F32P))
        return out

    def get_edge_dense_feature(self, src, dst, types, fids,
                               dims) -> np.ndarray:
        src, dst = _ids(src), _ids(dst)
        types, fids, dims = _i32(types), _i32(fids), _i32(dims)
        out = np.empty((len(src), int(dims.sum())), dtype=np.float32)
        self._lib.eg_get_edge_dense_feature(
            self._h, _ptr(src, _U64P), _ptr(dst, _U64P), _ptr(types, _I32P),
            len(src), _ptr(fids, _I32P), _ptr(dims, _I32P), len(fids),
            _ptr(out, _F32P))
        return out

    def get_sparse_feature(self, ids, fids):
        """Per slot: (values i64 concatenated, row_counts i32 [n])."""
        ids = _ids(ids)
        fids = _i32(fids)
        r = self._lib.eg_get_sparse_feature(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(fids, _I32P),
            len(fids))
        return self._drain_sparse(r, len(fids))

    def get_edge_sparse_feature(self, src, dst, types, fids):
        src, dst = _ids(src), _ids(dst)
        types, fids = _i32(types), _i32(fids)
        r = self._lib.eg_get_edge_sparse_feature(
            self._h, _ptr(src, _U64P), _ptr(dst, _U64P), _ptr(types, _I32P),
            len(src), _ptr(fids, _I32P), len(fids))
        return self._drain_sparse(r, len(fids))

    def get_binary_feature(self, ids, fids):
        """Per slot: a list of bytes, one a row."""
        ids = _ids(ids)
        fids = _i32(fids)
        r = self._lib.eg_get_binary_feature(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(fids, _I32P),
            len(fids))
        return self._drain_binary(r, len(fids))

    def get_edge_binary_feature(self, src, dst, types, fids):
        src, dst = _ids(src), _ids(dst)
        types, fids = _i32(types), _i32(fids)
        r = self._lib.eg_get_edge_binary_feature(
            self._h, _ptr(src, _U64P), _ptr(dst, _U64P), _ptr(types, _I32P),
            len(src), _ptr(fids, _I32P), len(fids))
        return self._drain_binary(r, len(fids))

    # ---- result plumbing ----
    def _fetch(self, r, kind: int, slot: int, dtype) -> np.ndarray:
        n = self._lib.eg_result_size(r, kind, slot)
        out = np.empty(max(n, 0), dtype=dtype)
        if n > 0:
            self._lib.eg_result_copy(
                r, kind, slot, out.ctypes.data_as(ctypes.c_void_p))
        return out

    def _drain_sparse(self, r, nslots: int):
        try:
            return [(self._fetch(r, 0, k, np.uint64).view(np.int64),
                     self._fetch(r, 2, k, np.int32)) for k in range(nslots)]
        finally:
            self._lib.eg_result_free(r)

    def _drain_binary(self, r, nslots: int):
        try:
            out = []
            for k in range(nslots):
                n = int(self._lib.eg_result_size(r, 3, k))
                buf = ctypes.create_string_buffer(max(n, 1))
                if n > 0:
                    self._lib.eg_result_copy(r, 3, k, buf)
                data = buf.raw[:n]
                off = np.cumsum([0, *self._fetch(r, 2, k, np.int32)])
                out.append([data[a:b] for a, b in zip(off[:-1], off[1:])])
            return out
        finally:
            self._lib.eg_result_free(r)
