"""The graph engine client (counterpart of ``euler_tpu/graph/graph.py``):
a Python facade over the port's copy of the C++ engine
(``graph/native.py``) that returns fixed-shape numpy arrays for the host
sampling path, either over an embedded engine (``mode="local"``, loading
``.dat`` partitions) or over a sharded graph service (``mode="remote"``,
the engine's remote client: discovery from a ``registry`` or an explicit
``shards`` list, routing, scatter and gather, caches, failover and
deadlines, all in native code, ``_native/eg_remote.cc``).

All ids are int64 on the Python side; the engine works in uint64 and the
bit patterns pass through unchanged (default ids such as -1 wrap). The
engine releases the GIL inside each call, so prefetch threads sample
while the training thread drives the card.

Staged data (``graph/remote_fs.py``): a ``directory=`` or ``files=``
behind an fsspec URL (``gs://``, ``s3://``, ``memory://``) is staged
into ``cache_dir=`` before a local load, or with ``stream=True`` fetched
into memory and parsed from there (``eg_load_buffers``), with no local
copy; ``file://`` URLs are plain paths. ``blackbox=``,
``devprof=`` and ``postmortem_dir=`` arm the process's flight recorder,
device plane and postmortem path (``euler_tpu_torch.blackbox``,
``devprof``), as the JAX package's graph does.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from euler_tpu_torch.graph import remote_fs
from euler_tpu_torch.graph.native import lib
from euler_tpu_torch.graph.remote_fs import is_remote_path, strip_local_scheme

# Feature-kind selectors of the C ABI (eg_capi.cc eg_feature_num).
NODE_U64, NODE_F32, NODE_BIN, EDGE_U64, EDGE_F32, EDGE_BIN = range(6)

_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)

_KNOWN = (
    "directory", "files", "shard_idx", "shard_num", "mode", "registry",
    "shards", "retries", "timeout_ms", "quarantine_ms", "rediscover_ms",
    "backoff_ms", "deadline_ms", "fault", "fault_seed", "feature_cache_mb",
    "neighbor_cache_mb", "cache_policy", "placement", "strict", "coalesce",
    "chunk_ids", "dispatch_workers", "wire_version", "telemetry",
    "slow_spans", "heat", "heat_topk", "blackbox", "devprof",
    "postmortem_dir", "cache_dir", "stream", "delta", "init",
)

# the remote client's keys: a local graph has no wire, so they raise there
_REMOTE_ONLY = (
    "feature_cache_mb", "strict", "neighbor_cache_mb", "cache_policy",
    "placement", "coalesce", "chunk_ids", "dispatch_workers",
    "wire_version", "telemetry", "slow_spans", "heat", "heat_topk",
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


def str2bool(v) -> bool:
    """The one truthy-string rule for bools that arrive as text (config
    strings here, CLI flags in run_loop)."""
    return str(v).lower() in ("1", "true", "yes", "y")


def parse_config(source: str) -> dict:
    """Parse a client config: a ``.ini``-style file of ``key = value``
    lines ('#'/';' comments, ``[sections]`` ignored) or an inline
    ``k=v;k=v`` string. Values that look numeric come back as ints."""
    # a path wins over the inline form when both could apply
    if os.path.exists(source) or "=" not in source:
        with open(source) as f:
            lines = f.read().splitlines()
    else:
        lines = source.split(";")
    out: dict = {}
    for line in lines:
        line = line.strip()
        if not line or line[0] in "#;[":
            continue
        if "=" not in line:
            raise ValueError(f"bad config line (want key=value): {line!r}")
        k, v = (x.strip() for x in line.split("=", 1))
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v
    return out


class Graph:
    """Graph client: embedded engine (``mode="local"``: ``directory=``,
    every ``*.dat`` there whose partition index ``p`` has ``p % shard_num
    == shard_idx``, or an explicit ``files=`` list) or the sharded remote
    client (``mode="remote"``: ``registry=``, a flat-file directory that
    ``GraphService`` writes or ``tcp://host:port`` of a
    ``graph.registry`` server, or ``shards=``, addresses or replica lists
    of addresses; ids route to shard ``(id % P) % S`` or through the
    cluster's placement map).

    ``config=`` takes a ``key = value`` file or a ``k=v;k=v`` string,
    explicit keywords winning; ``init="lazy"`` connects at first use.
    The remote client's keywords (caches, placement, strict, deadlines,
    failpoints, telemetry and heat switches) raise on a local graph, as
    the JAX client's do."""

    def __init__(
        self,
        directory: str | None = None,
        files: list[str] | None = None,
        shard_idx: int | None = None,
        shard_num: int | None = None,
        mode: str | None = None,
        registry: str | None = None,
        shards: list[str] | list[list[str]] | None = None,
        retries: int | None = None,
        timeout_ms: int | None = None,
        quarantine_ms: int | None = None,
        rediscover_ms: int | None = None,
        backoff_ms: int | None = None,
        deadline_ms: int | None = None,
        fault: str | None = None,
        fault_seed: int | None = None,
        feature_cache_mb: int | None = None,
        neighbor_cache_mb: int | None = None,
        cache_policy: str | None = None,
        placement: bool | None = None,
        strict: bool | None = None,
        coalesce: bool | None = None,
        chunk_ids: int | None = None,
        dispatch_workers: int | None = None,
        wire_version: int | None = None,
        telemetry: bool | None = None,
        slow_spans: int | None = None,
        heat: bool | None = None,
        heat_topk: int | None = None,
        blackbox: bool | None = None,
        devprof: bool | None = None,
        postmortem_dir: str | None = None,
        cache_dir: str | None = None,
        stream: bool | None = None,
        delta: str | list[str] | None = None,
        config: str | None = None,
        init: str | None = None,
    ):
        self._lib = lib()
        self._handle = None
        self._closed = False
        self._connect_lock = threading.Lock()
        cfg = parse_config(config) if config else {}
        unknown = set(cfg) - set(_KNOWN)
        if unknown:
            raise ValueError(f"unknown config keys {sorted(unknown)}; "
                             f"valid: {sorted(_KNOWN)}")
        given = dict(locals())

        def pick(name, default=None):
            v = given[name]
            return v if v is not None else cfg.get(name, default)

        def flag(name):
            v = pick(name)
            return str2bool(v) if isinstance(v, str) else v

        directory, files = pick("directory"), pick("files")
        if isinstance(files, str):
            files = [x.strip() for x in files.split(",")]
        shards = pick("shards")
        if isinstance(shards, str):
            shards = [x.strip() for x in shards.split(",")]
        mode = str(pick("mode", "local")).lower()
        delta = pick("delta")
        if isinstance(delta, str):
            delta = [x.strip() for x in delta.replace(";", ",").split(",")
                     if x.strip()]
        init = str(pick("init", "eager")).lower()
        p = dict(
            directory=directory, files=files,
            shard_idx=int(pick("shard_idx", 0)),
            shard_num=int(pick("shard_num", 1)),
            registry=pick("registry"), shards=shards,
            retries=int(pick("retries", 3)),
            timeout_ms=int(pick("timeout_ms", 5000)),
            quarantine_ms=int(pick("quarantine_ms", 3000)),
            fault=pick("fault"), fault_seed=pick("fault_seed"),
            delta=delta, placement=flag("placement"),
            strict=flag("strict"), coalesce=flag("coalesce"),
            telemetry=flag("telemetry"), heat=flag("heat"),
            cache_dir=pick("cache_dir"), stream=bool(flag("stream")),
        )
        for k in ("rediscover_ms", "backoff_ms", "deadline_ms",
                  "feature_cache_mb", "neighbor_cache_mb", "cache_policy",
                  "chunk_ids", "dispatch_workers", "wire_version",
                  "slow_spans", "heat_topk"):
            p[k] = pick(k)
        # the flight recorder and the device plane: process-global, armed
        # below in both modes (a trainer's postmortem is worth a shard's)
        planes = {k: flag(k) for k in ("blackbox", "devprof")}
        postmortem_dir = pick("postmortem_dir")
        if mode not in ("local", "remote"):
            raise ValueError("mode must be 'local' or 'remote'")
        if directory is not None and files:
            raise ValueError(
                "pass directory= OR files=, not both (the embedded engine "
                "loads exactly one of them)")
        if p["fault_seed"] is not None and p["fault"] is None:
            raise ValueError("fault_seed= without fault= would seed "
                             "nothing: pass the failpoint spec too")
        if p["fault"] is not None and mode != "remote":
            raise ValueError(
                "fault= applies to mode='remote' graphs (failpoints sit in "
                "the transport; for service-side injection use "
                "euler_tpu_torch.graph.native.fault_config in the shard "
                "process)")
        if mode != "remote":
            for key in _REMOTE_ONLY:
                if p[key] is not None:
                    raise ValueError(
                        f"{key}= applies to mode='remote' graphs (it "
                        "configures the remote client's request path; the "
                        "embedded engine reads local memory)")
        if delta and mode != "local":
            raise ValueError(
                "delta= applies to mode='local' graphs (remote shards "
                "merge their own delta files: use load_delta(path, "
                "shard=...) or `python -m euler_tpu_torch.graph.service "
                "--load_delta`)")
        if p["stream"] and mode != "local":
            # never dropped without a word: a remote client reads no graph
            # data itself; its shards stage their own
            raise ValueError(
                "stream=True applies to mode='local' graphs (remote-mode "
                "clients read from shard services, which stage their own "
                "data)")
        if init not in ("eager", "lazy"):
            raise ValueError("init must be 'eager' or 'lazy'")
        # kill-switches first, then the postmortem path, before the engine
        # loads, so a crash while loading leaves a dump
        if planes["blackbox"] is not None:
            from euler_tpu_torch import blackbox as blackbox_mod

            blackbox_mod.set_blackbox(bool(planes["blackbox"]))
        if planes["devprof"] is not None:
            from euler_tpu_torch import devprof as devprof_mod

            devprof_mod.set_devprof(bool(planes["devprof"]))
            if planes["devprof"]:
                devprof_mod.install()
        if postmortem_dir is not None:
            from euler_tpu_torch import blackbox as blackbox_mod

            blackbox_mod.install(postmortem_dir)
        self._params = p
        self.mode = mode
        self._strict = bool(p["strict"])
        # the local delta chain applied so far (load_delta re-sends it all)
        self._applied_deltas: list[str] = list(delta) if delta else []
        if init == "eager":
            self._connect()

    @property
    def _h(self):
        """The native handle; a lazy graph connects at first use, once,
        whichever threads ask together."""
        if self._handle is None:
            with self._connect_lock:
                if self._handle is None:
                    self._connect()
        return self._handle

    def _remote_config(self) -> str:
        """The remote client's ``k=v;k=v`` configuration string."""
        p = self._params
        if p["registry"]:
            conf = f"registry={p['registry']}"
        elif p["shards"]:
            # each entry an address, or a list of replica addresses
            conf = "shards=" + ",".join(
                s if isinstance(s, str) else "|".join(s) for s in p["shards"])
        else:
            raise ValueError("remote mode needs registry= or shards=")
        conf += (f";retries={p['retries']};timeout_ms={p['timeout_ms']}"
                 f";quarantine_ms={p['quarantine_ms']}")
        for k in ("rediscover_ms", "backoff_ms", "deadline_ms",
                  "feature_cache_mb", "neighbor_cache_mb"):
            if p[k] is not None:
                conf += f";{k}={int(p[k])}"
        if p["cache_policy"] is not None:
            conf += f";cache_policy={p['cache_policy']}"
        for k in ("placement", "strict", "coalesce"):
            if p[k] is not None:
                conf += f";{k}={1 if p[k] else 0}"
        for k in ("chunk_ids", "dispatch_workers", "wire_version"):
            if p[k] is not None:
                conf += f";{k}={int(p[k])}"
        if p["telemetry"] is not None:
            conf += f";telemetry={1 if p['telemetry'] else 0}"
        if p["slow_spans"] is not None:
            conf += f";slow_spans={int(p['slow_spans'])}"
        if p["heat"] is not None:
            conf += f";heat={1 if p['heat'] else 0}"
        if p["heat_topk"] is not None:
            conf += f";heat_topk={int(p['heat_topk'])}"
        if p["fault"] is not None:
            # ';' separates keys, so failpoints are joined by ','
            conf += f";fault={p['fault']}"
            if p["fault_seed"] is not None:
                conf += f";fault_seed={int(p['fault_seed'])}"
        return conf

    def _connect(self) -> None:
        if self._closed:
            # close() is final: a lingering reference (a prefetch thread)
            # must not load the store or dial the cluster again
            raise RuntimeError("graph is closed")
        p = self._params
        registry = p["registry"]
        if (registry is not None and not registry.startswith("tcp://")
                and is_remote_path(registry)):
            raise NotImplementedError(
                f"registry on a remote filesystem is not supported "
                f"({registry}); use a local path, tcp://host:port of a "
                "euler_tpu_torch.graph.registry server, or shards=")
        if self.mode == "remote":
            h = self._lib.eg_remote_create(self._remote_config().encode())
            if not h:
                raise RuntimeError("remote graph init failed: "
                                   + self._lib.eg_last_error().decode())
            self._handle = h
            return
        directory, buffers = p["directory"], None
        files = [str(f) for f in p["files"]] if p["files"] else None
        if directory is not None:
            directory = str(directory)
            if is_remote_path(directory):
                # this shard's partitions only; the engine's own filter
                # on the staged names is then a no-op
                if p["stream"]:
                    buffers = remote_fs.read_directory(
                        directory, p["shard_idx"], p["shard_num"])
                else:
                    directory = remote_fs.stage_directory(
                        directory, cache_dir=p["cache_dir"],
                        shard_idx=p["shard_idx"], shard_num=p["shard_num"])
            else:
                directory = strip_local_scheme(directory)
        elif files:
            # stream= is never dropped: a disk-poor host asked for no copy
            if p["stream"]:
                buffers = remote_fs.read_files(files)
            else:
                files = remote_fs.stage_files(files,
                                              cache_dir=p["cache_dir"])
        h = self._lib.eg_create()
        if buffers is not None:
            n = len(buffers)
            names = (ctypes.c_char_p * n)(*[nm.encode() for nm, _ in buffers])
            bufs = (ctypes.c_void_p * n)()
            lens = (ctypes.c_uint64 * n)()
            for i, (_, blob) in enumerate(buffers):
                bufs[i] = ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p)
                lens[i] = len(blob)
            # ``buffers`` holds the bytes through the call; the engine
            # copies them while parsing
            rc = self._lib.eg_load_buffers(h, bufs, lens, names, n)
        elif directory is not None:
            rc = self._lib.eg_load(h, directory.encode(),
                                   p["shard_idx"], p["shard_num"])
        elif files:
            arr = (ctypes.c_char_p * len(files))(
                *[f.encode() for f in files])
            rc = self._lib.eg_load_files(h, arr, len(files))
        else:
            self._lib.eg_destroy(h)
            raise ValueError("pass directory= or files=")
        if rc != 0:
            err = self._lib.eg_last_error().decode()
            self._lib.eg_destroy(h)
            raise RuntimeError(f"graph load failed: {err}")
        if p["delta"]:
            # a graph silently missing its updates is worse than none
            if self._lib.eg_load_deltas(
                    h, ";".join(p["delta"]).encode()) != 0:
                err = self._lib.eg_last_error().decode()
                self._lib.eg_destroy(h)
                raise RuntimeError(f"delta load failed: {err}")
        self._handle = h

    # ---- the cluster (remote mode) ----
    @property
    def num_shards(self) -> int:
        return (self._lib.eg_remote_shards(self._h)
                if self.mode == "remote" else 1)

    @property
    def num_partitions(self) -> int:
        return (self._lib.eg_remote_partitions(self._h)
                if self.mode == "remote" else 1)

    def num_replicas(self, shard: int) -> int:
        """The replicas one shard's connection pool holds now (remote
        mode; rediscovery changes it mid-run)."""
        if self.mode != "remote":
            return 1
        return self._lib.eg_remote_replica_count(self._h, shard)

    @property
    def has_placement(self) -> bool:
        """True when this remote client routes ids through a placement
        map fetched at init, False when it hash-routes."""
        if self.mode != "remote":
            return False
        return self._lib.eg_remote_has_placement(self._h) == 1

    def shard_of(self, ids) -> np.ndarray:
        """The serving shard of each id through the client's routing
        (placement map when loaded, hash otherwise)."""
        if self.mode != "remote":
            raise ValueError(
                "shard_of() applies to mode='remote' graphs (a local graph "
                "has no shards to route to)")
        arr = _ids(ids)
        out = np.empty(len(arr), dtype=np.int32)
        self._lib.eg_remote_route(self._h, _ptr(arr, _U64P), len(arr),
                                  _ptr(out, _I32P))
        return out

    # ---- snapshot epochs ----
    def epoch(self) -> int:
        """The snapshot epoch: local, the embedded snapshot's (0 the base
        load, N after N deltas); remote, the highest any shard has
        announced so far (it can lag a fresh flip by one call)."""
        return int(self._lib.eg_graph_epoch(self._h))

    def shard_epoch(self, shard: int) -> int:
        """The last epoch one shard announced (remote mode)."""
        if self.mode != "remote":
            raise ValueError(
                "shard_epoch() applies to mode='remote' graphs (a local "
                "graph has exactly one epoch: use epoch())")
        return int(self._lib.eg_remote_epoch(self._h, shard))

    @property
    def cache_gen(self) -> int:
        """The client's cache generation (remote mode; 0 for local),
        bumped once a raise of any shard's epoch is seen. Python caches
        (``serve.EmbedServer``) key their entries by it, as the native
        feature and neighbor caches do."""
        if self.mode != "remote":
            return 0
        return int(self._lib.eg_remote_cache_gen(self._h))

    def load_delta(self, path: str, shard: int | None = None) -> int:
        """Apply one delta file and flip to a fresh snapshot; returns the
        new epoch. Local graphs merge ``path`` themselves (no
        ``shard=``); remote graphs ask one shard (``shard=`` required)
        to merge a file on its own filesystem. Raises on failure, the
        serving snapshot untouched."""
        if self.mode == "remote":
            if shard is None:
                raise ValueError(
                    "remote load_delta needs shard= (each shard merges its "
                    "own delta file; roll through shards in turn)")
            ep = self._lib.eg_remote_load_delta(self._h, int(shard),
                                                path.encode())
            if ep < 0:
                raise RuntimeError(self._lib.eg_last_error().decode())
            return int(ep)
        if shard is not None:
            raise ValueError(
                "shard= applies to mode='remote' graphs (a local graph "
                "merges the delta into its own embedded engine)")
        # the merge rebuilds base + the whole chain, so every flip re-sends
        # each delta applied so far
        chain = self._applied_deltas + [path]
        if self._lib.eg_load_deltas(self._h, ";".join(chain).encode()) != 0:
            raise RuntimeError(self._lib.eg_last_error().decode())
        self._applied_deltas = chain
        return self.epoch()

    def _check_strict(self):
        """Raise the pending strict-mode failure, if any: with
        ``strict=True`` a shard call that exhausted every retry raises
        instead of leaving its rows at their defaults (the fixed-shape
        ABI returns void, so the failure crosses it through this poll)."""
        if not self._strict:
            return
        buf = ctypes.create_string_buffer(512)
        if self._lib.eg_remote_strict_error(self._handle, buf, 512) > 0:
            raise RuntimeError(buf.value.decode())

    def close(self) -> None:
        # _handle, not _h: closing a lazy graph must not connect it
        self._closed = True
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
        self._check_strict()
        return out.view(np.int64)

    def sample_edge(self, count: int, edge_type: int = -1):
        src = np.empty(count, dtype=np.uint64)
        dst = np.empty(count, dtype=np.uint64)
        t = np.empty(count, dtype=np.int32)
        self._lib.eg_sample_edge(
            self._h, count, edge_type, _ptr(src, _U64P), _ptr(dst, _U64P),
            _ptr(t, _I32P))
        self._check_strict()
        return src.view(np.int64), dst.view(np.int64), t

    def sample_node_with_src(self, src_ids, count: int) -> np.ndarray:
        """[n, count] negatives drawn from each src's node-type sampler."""
        ids = _ids(src_ids)
        out = np.empty((len(ids), count), dtype=np.uint64)
        self._lib.eg_sample_node_with_src(
            self._h, _ptr(ids, _U64P), len(ids), count, _ptr(out, _U64P))
        self._check_strict()
        return out.view(np.int64)

    def node_types(self, ids) -> np.ndarray:
        """Per-node types, -1 for unknown ids."""
        ids = _ids(ids)
        out = np.empty(len(ids), dtype=np.int32)
        self._lib.eg_get_node_type(
            self._h, _ptr(ids, _U64P), len(ids), _ptr(out, _I32P))
        self._check_strict()
        return out

    def node_weights(self, ids) -> np.ndarray:
        """Per-node sampling weights, 0 for unknown ids. A remote graph
        asks each shard, and raises when one cannot answer: a weight read
        as 0 would bias the device samplers built from it."""
        ids = _ids(ids)
        out = np.empty(len(ids), dtype=np.float32)
        if self._lib.eg_get_node_weight(
                self._h, _ptr(ids, _U64P), len(ids), _ptr(out, _F32P)) != 0:
            # the pending strict record names the shard: raise it first,
            # so it cannot fire on a later, unrelated call
            self._check_strict()
            raise RuntimeError(self._lib.eg_last_error().decode())
        self._check_strict()
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
        self._check_strict()
        return out_i.view(np.int64), out_w, out_t

    def sample_fanout(self, ids, edge_types, counts, default_node: int = -1):
        """Fused multi-hop sampling, one native call for all hops.

        ``edge_types``: one edge-type list a hop; ``counts``: the fanouts.
        Returns (ids_per_hop, weights_per_hop, types_per_hop); hop h's
        arrays are flat with n * prod(counts[:h+1]) rows, and
        ids_per_hop[0] is the (flattened) input."""
        req, out, ptrs = _fanout_buffers(ids, edge_types, counts)
        self._lib.eg_sample_fanout(self._h, *_fanout_args(
            req, ptrs, default_node))
        self._check_strict()
        return _fanout_result(req[0], out)

    def sample_fanout_async(self, ids, edge_types, counts,
                            default_node: int = -1):
        """Submit one whole multi-hop sample as an in-flight async op
        (remote graphs): the hop chain runs on the client's dispatcher
        pool, and this returns at once with an :class:`AsyncFanout`
        whose ``take()`` gives what ``sample_fanout`` returns. The handle
        owns every buffer the op writes into.

        Returns None on a local graph or when the native pool of async
        ops is full: the caller samples with ``sample_fanout`` then."""
        if self.mode != "remote":
            return None
        req, out, ptrs = _fanout_buffers(ids, edge_types, counts)
        slot = self._lib.eg_remote_sample_async(self._h, *_fanout_args(
            req, ptrs, default_node))
        if slot < 0:
            return None
        return AsyncFanout(self, slot, (req, ptrs), out)

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
        self._check_strict()
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
        self._check_strict()
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
        self._check_strict()
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
        self._check_strict()
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
        self._check_strict()
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
            out = [(self._fetch(r, 0, k, np.uint64).view(np.int64),
                    self._fetch(r, 2, k, np.int32)) for k in range(nslots)]
        finally:
            self._lib.eg_result_free(r)
        self._check_strict()
        return out

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
        finally:
            self._lib.eg_result_free(r)
        self._check_strict()
        return out


def _fanout_buffers(ids, edge_types, counts):
    """The request arrays (ids, flat edge types, types a hop, counts),
    the per-hop output arrays and their pointer tables of one
    ``eg_sample_fanout``-shaped call."""
    ids = _ids(ids)
    et_lists = [_i32(e) for e in edge_types]
    et_flat = (np.concatenate(et_lists) if et_lists
               else np.zeros(0, np.int32))
    req = (ids, et_flat, _i32([len(e) for e in et_lists]), _i32(counts))
    out_i, out_w, out_t = [], [], []
    m = len(ids)
    for c in counts:
        m *= int(c)
        out_i.append(np.empty(m, dtype=np.uint64))
        out_w.append(np.empty(m, dtype=np.float32))
        out_t.append(np.empty(m, dtype=np.int32))
    nhops = len(counts)
    ptrs = ((_U64P * nhops)(*[_ptr(a, _U64P) for a in out_i]),
            (_F32P * nhops)(*[_ptr(a, _F32P) for a in out_w]),
            (_I32P * nhops)(*[_ptr(a, _I32P) for a in out_t]))
    return req, (out_i, out_w, out_t), ptrs


def _fanout_args(req, ptrs, default_node: int) -> tuple:
    ids, et_flat, et_counts, counts = req
    return (_ptr(ids, _U64P), len(ids), _ptr(et_flat, _I32P),
            _ptr(et_counts, _I32P), _ptr(counts, _I32P), len(counts),
            _default_u64(default_node), *ptrs)


def _fanout_result(ids, out) -> tuple:
    out_i, out_w, out_t = out
    return ([ids.view(np.int64)] + [a.view(np.int64) for a in out_i],
            out_w, out_t)


class AsyncFanout:
    """The handle of one in-flight async multi-hop sample
    (:meth:`Graph.sample_fanout_async`). It owns the buffers the native
    op writes into, so it must stay referenced until :meth:`take`; one
    take a handle, which recycles the native slot."""

    def __init__(self, graph, slot, req, out):
        self._graph = graph
        self._slot = slot
        self._req, self._ptrs = req  # pinned until the take
        self._out = out
        self._taken = False

    def poll(self) -> bool:
        """True when the op has completed (``take`` will not block)."""
        if self._taken:
            return True
        return self._graph._lib.eg_remote_async_poll(
            self._graph._h, self._slot) == 1

    def take(self):
        """Block until the op completes, recycle its slot and return
        ``sample_fanout``'s tuple. Raises under ``strict=`` when a shard
        failed inside the op."""
        if self._taken:
            raise RuntimeError("AsyncFanout.take() called twice")
        rc = self._graph._lib.eg_remote_async_take(self._graph._h,
                                                   self._slot)
        self._taken = True
        if rc != 0:
            raise RuntimeError(
                f"eg_remote_async_take failed for slot {self._slot}")
        self._graph._check_strict()
        return _fanout_result(self._req[0], self._out)

    def __del__(self):
        # an abandoned handle must not leak its slot while the op may
        # still write into these buffers: wait for it
        try:
            if not self._taken:
                self._graph._lib.eg_remote_async_take(self._graph._h,
                                                      self._slot)
                self._taken = True
        except Exception:
            pass
