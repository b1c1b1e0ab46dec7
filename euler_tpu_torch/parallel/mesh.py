"""Multi-device training over ``torch.distributed`` (counterpart of
``euler_tpu/parallel/mesh.py``).

One rank runs in each process and drives one device. The ranks form a
``(data, model)`` grid, as the JAX package's mesh lays its devices out:
rank ``r`` sits at data row ``r // model_parallel`` and model column
``r % model_parallel``.

- The data axis shards the batch: each data row trains on its
  contiguous slice of the global batch, and the gradients are
  all-reduced, so every rank takes the step of the global batch.
- The model axis row-shards the per-node tables (``_TABLE_KEYS``): the
  feature, label and sparse tables in ``consts`` and the Scalable
  models' ``stores``/``grad_stores``, each padded to a multiple of the
  model axis (``pad_tables_for_mesh``). A rank keeps its rows in a
  ``RowShard``, whose ``index_select`` gathers the rows it owns, zeros
  for the rest, and sums over the model group: one real row plus zeros,
  so the gather is exact. Adjacency, roots and negative samplers
  replicate unpadded.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast``:
gloo and NCCL both run these three on CUDA tensors. ``init_distributed``
joins the processes over TCP on a gloo default group (every rank's
device is compared there) and picks the backend of the mesh's groups:
NCCL when every rank has a card of its own, gloo when ranks share a card
(NCCL refuses two ranks on one device) or run on the CPU.

The JAX package's backend helpers have no counterpart:
``honor_jax_platforms_env``, ``probe_backend_once``,
``probe_backend_or_die`` and ``force_cpu_devices`` steer JAX's platform
choice, which PyTorch makes per tensor; ``enable_compile_cache`` is
ROADMAP A11.
"""

from __future__ import annotations

import datetime
import logging
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("euler_tpu_torch")

# Top-level train-state keys holding [num_nodes, ...] tables that
# row-shard over the 'model' axis.
_TABLE_KEYS = ("consts", "stores", "grad_stores")
# under consts, only the per-node lookup tables shard
_CONST_TABLES = ("features", "labels", "sparse")

# the process's distributed setup: the backend of the mesh groups and
# this rank's device (init_distributed)
_SETUP: dict = {}


def _is_table(path, x) -> bool:
    """True for leaves under a ``_TABLE_KEYS`` top-level state key: the
    per-node tables that row-shard (and row-pad) over the model axis.
    ``path`` is the leaf's keys from the state's top (dict keys and list
    indices). Under ``consts`` only the lookup tables (features, labels,
    sparse rows) shard; the device-sampling structures (``adj``,
    ``roots``, ``negs`` and anything else) replicate: their cumulative
    weights must stay contiguous and unpadded."""
    if not path or path[0] not in _TABLE_KEYS or np.ndim(x) < 1:
        return False
    if path[0] == "consts" and len(path) > 1:
        return path[1] in _CONST_TABLES
    return True


def _map_tables(state: dict, fn) -> dict:
    """``state`` with each table leaf ``x`` at ``path`` replaced by
    ``fn(path, x)``; the containers above the tables are copied, every
    other entry is kept as it is."""

    def walk(path, x):
        if isinstance(x, dict):
            return {k: walk(path + (k,), v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(path + (i,), v) for i, v in enumerate(x))
        if isinstance(x, (torch.Tensor, np.ndarray, RowShard)) and (
                _is_table(path, x)):
            return fn(path, x)
        return x

    return {k: walk((k,), v) if k in _TABLE_KEYS else v
            for k, v in state.items()}


def table_leaves(state: dict) -> list:
    """``(path, leaf)`` of every table of ``state``, in its order."""
    out = []
    _map_tables(state, lambda path, x: out.append((path, x)) or x)
    return out


class Mesh:
    """A ``(data, model)`` grid of ``num_devices`` ranks, ``model_parallel``
    wide: rank ``r`` is at ``divmod(r, model_parallel)``. Without a
    process group (``make_mesh`` before ``init_distributed``, or
    ``Mesh(...)`` itself) it is the grid's arithmetic alone and its
    collectives are the identity; ``connect`` makes the groups."""

    def __init__(self, num_devices: int, model_parallel: int = 1,
                 rank: int = 0, device=None):
        if num_devices < 1 or model_parallel < 1 or (
                num_devices % model_parallel):
            raise ValueError(f"{num_devices} devices not divisible by "
                             f"model_parallel={model_parallel}")
        if not 0 <= rank < num_devices:
            raise ValueError(f"rank {rank} outside {num_devices} devices")
        self.size = int(num_devices)
        self.shape = {"data": self.size // model_parallel,
                      "model": int(model_parallel)}
        self.rank = int(rank)
        self.device = None if device is None else torch.device(device)
        self.backend = None
        self._groups: dict = {}

    # ---- the grid ----
    def coords(self, rank=None) -> tuple:
        """``(data row, model column)`` of ``rank`` (default: this one)."""
        return divmod(self.rank if rank is None else rank,
                      self.shape["model"])

    @property
    def data_rank(self) -> int:
        return self.coords()[0]

    @property
    def model_rank(self) -> int:
        return self.coords()[1]

    def peers(self, axis: str, rank=None) -> list:
        """The ranks of ``rank``'s group along ``axis`` (``"data"``: the
        same model column, ``"model"``: the same data row, ``"world"``:
        all), in rank order, which is the axis's order."""
        d, m = self.coords(rank)
        mp = self.shape["model"]
        if axis == "data":
            return [i * mp + m for i in range(self.shape["data"])]
        if axis == "model":
            return [d * mp + j for j in range(mp)]
        if axis == "world":
            return list(range(self.size))
        raise ValueError(f"no axis {axis!r}")

    def batch_slice(self, n: int, rank=None) -> slice:
        """The rows of a global batch of ``n`` that ``rank``'s data row
        holds: a contiguous ``n / data`` of them. Raises when ``n`` does
        not divide."""
        data = self.shape["data"]
        if n % data:
            raise ValueError(
                f"batch of {n} not divisible by the data axis ({data})")
        per = n // data
        d = self.coords(rank)[0]
        return slice(d * per, (d + 1) * per)

    def padded_rows(self, rows: int) -> int:
        """``rows`` rounded up to a multiple of the model axis."""
        return rows + (-rows) % self.shape["model"]

    def row_range(self, rows: int, rank=None) -> tuple:
        """``(lo, hi)``: the rows of a table of ``rows`` rows (before
        padding) that ``rank``'s model column holds."""
        per = self.padded_rows(rows) // self.shape["model"]
        m = self.coords(rank)[1]
        return m * per, (m + 1) * per

    # ---- the groups ----
    @property
    def connected(self) -> bool:
        return bool(self._groups)

    def connect(self, backend: str) -> "Mesh":
        """Make the data, model and world groups of ``backend`` (and, for
        a NCCL mesh, gloo groups along the model axis for host objects).
        Every rank of the default group calls it, in the same order, as
        ``torch.distributed.new_group`` requires."""
        mp, data = self.shape["model"], self.shape["data"]
        self.backend = backend
        groups = {}
        for axis, heads in (("model", range(0, self.size, mp)),
                            ("data", range(mp))):
            for head in heads:
                ranks = self.peers(axis, head)
                g = dist.new_group(ranks, backend=backend)
                if self.rank in ranks:
                    groups[axis] = g
        groups["world"] = dist.new_group(list(range(self.size)),
                                         backend=backend)
        if backend == "gloo":
            groups["host"] = groups["model"]
        else:
            for head in range(0, self.size, mp):
                ranks = self.peers("model", head)
                g = dist.new_group(ranks, backend="gloo")
                if self.rank in ranks:
                    groups["host"] = g
        self._groups = groups
        log.info("mesh: rank %d of %d at (data %d of %d, model %d of %d) on "
                 "%s over %s", self.rank, self.size, self.data_rank, data,
                 self.model_rank, mp, self.device, backend)
        return self

    def _group(self, axis: str):
        return self._groups.get(axis)

    # ---- collectives (the identity without groups) ----
    def all_reduce(self, t: torch.Tensor, axis: str = "data"):
        """Sum ``t`` over ``axis``'s group in place; returns ``t``."""
        g = self._group(axis)
        if g is not None:
            dist.all_reduce(t, group=g)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "data"):
        """The ``t`` of every rank of ``axis``'s group (all of one shape),
        concatenated along dim 0 in the axis's order."""
        g = self._group(axis)
        if g is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in self.peers(axis)]
        dist.all_gather(parts, t, group=g)
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor):
        """``t`` of rank 0, in place."""
        g = self._group("world")
        if g is not None:
            dist.broadcast(t, 0, group=g)
        return t

    def broadcast_object(self, obj):
        """A picklable host object of the first rank of this rank's model
        group (over gloo: the model axis's host group)."""
        g = self._group("host")
        if g is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, self.peers("model")[0], group=g)
        return box[0]

    def barrier(self) -> None:
        g = self._group("world")
        if g is not None:
            if self.backend == "nccl":
                dist.barrier(group=g, device_ids=[self.device.index])
            else:
                dist.barrier(group=g)

    # ---- the train step's reductions ----
    def loss_scale(self, batch_loss: str) -> float:
        """The factor that turns the sum over the world of the ranks' losses
        (or gradients) into the global batch's: a mean loss averages
        over the data rows, a summed one adds them; the model columns of
        a row hold the same value and are averaged."""
        rows = self.shape["data"] if batch_loss == "mean" else 1
        return 1.0 / (rows * self.shape["model"])

    def reduce_grads(self, grads, scale: float) -> None:
        """All-reduce ``grads`` (tensors, in place) over the world in one
        flat bucket a dtype, times ``scale``: every rank then holds the
        same gradient, that of the global batch."""
        grads = list(grads)
        if not self.connected or not grads:
            return
        by_dtype: dict = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            self.all_reduce(flat, "world")
            flat.mul_(scale)
            off = 0
            for g in group:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def reduce_loss(self, loss: torch.Tensor, scale: float):
        """The global batch's loss from this rank's."""
        if not self.connected:
            return loss
        return self.all_reduce(loss.detach().clone(), "world") * scale

    def reduce_metric(self, name: str, metric: torch.Tensor):
        """The global batch's metric: f1 and auc counts add over the data
        rows, any other metric (mrr, a mean) averages."""
        if not self.connected:
            return metric
        out = self.all_reduce(metric.detach().clone().to(torch.float32),
                              "world") / self.shape["model"]
        if name not in ("f1", "auc"):
            out = out / self.shape["data"]
        return out.to(metric.dtype)


class RowShard:
    """Rows ``[lo, hi)`` of a ``[rows, ...]`` table (``rows`` padded to the
    model axis) that this rank holds, standing in for the whole table in
    the calls the models make on theirs:

    - ``index_select(0, ids)``: each rank gathers the rows it owns and
      zeros for the rest, then the model group sums: exact, one real row
      plus zeros. Every rank of the group must pass the same ``ids``.
    - ``index_fill_``, ``index_add_`` and ``write_rows_last_wins`` apply
      to the owned rows of ``ids`` only, in ``ids``' order.
    - ``full()`` gathers the whole padded table over the model group.
    """

    def __init__(self, local: torch.Tensor, lo: int, rows: int, mesh: Mesh):
        self.local, self.lo, self.rows, self.mesh = local, int(lo), int(
            rows), mesh

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.rows, *self.local.shape[1:]))

    @property
    def device(self):
        return self.local.device

    @property
    def ndim(self) -> int:
        return self.local.ndim

    def _owned(self, ids):
        rel = ids.reshape(-1).long() - self.lo
        own = (rel >= 0) & (rel < self.local.shape[0])
        return rel, own

    def index_select(self, dim: int, ids):
        if dim != 0:
            raise ValueError("a RowShard gathers rows (dim 0)")
        rel, own = self._owned(ids)
        rows = self.local.index_select(
            0, rel.clamp(0, self.local.shape[0] - 1))
        mask = own.reshape(-1, *([1] * (rows.ndim - 1)))
        rows = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))
        return self.mesh.all_reduce(rows, "model")

    def index_fill_(self, dim: int, ids, value):
        rel, own = self._owned(ids)
        self.local.index_fill_(dim, rel[own], value)
        return self

    def index_add_(self, dim: int, ids, src):
        rel, own = self._owned(ids)
        self.local.index_add_(dim, rel[own], src[own])
        return self

    def write_rows_last_wins(self, ids, rows, write) -> None:
        """``write(local, owned ids, their rows)``, the owned rows of
        ``ids`` in order (so the last occurrence of an id stays last)."""
        rel, own = self._owned(ids)
        write(self.local, rel[own], rows[own])

    def full(self) -> torch.Tensor:
        """The whole padded table, gathered over the model group."""
        return self.mesh.all_gather(self.local, "model")

    def load_full(self, table: torch.Tensor) -> None:
        """Copy this rank's rows out of a whole padded table."""
        if tuple(table.shape) != tuple(self.shape):
            raise ValueError(
                f"a table of shape {tuple(table.shape)} for a shard of "
                f"{tuple(self.shape)} (saved under another --model_parallel?)")
        self.local.copy_(table[self.lo:self.lo + self.local.shape[0]])


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago: for a
    coordinator or registry address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(num_devices=None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The ``(data, model)`` mesh over ``num_devices`` ranks.

    Under a process group (``init_distributed``) it is that group's: its
    ranks, this process's rank and device, and the groups of the backend
    ``init_distributed`` chose; ``num_devices`` (default: the world)
    must then be the world size, since one rank drives one device.
    Without one it is the grid alone, of ``num_devices`` (default: the
    cards this process sees, else 1), at rank 0.
    ``model_parallel`` = 1 is pure data parallelism; k > 1 dedicates a
    k-wide model axis to row-sharded tables. A count that does not divide
    raises ``ValueError``."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n = world if num_devices is None else int(num_devices)
        if n != world:
            raise ValueError(f"a mesh of {n} devices over {world} ranks: "
                             "each rank drives one device")
        mesh = Mesh(n, model_parallel, dist.get_rank(),
                    device or _SETUP.get("device"))
        return mesh.connect(_SETUP.get("backend", "gloo"))
    if num_devices is None:
        num_devices = (torch.cuda.device_count()
                       if torch.cuda.is_available() else 1) or 1
    return Mesh(int(num_devices), model_parallel, 0, device)


def _local_device(device, rank: int) -> torch.device:
    """The device of local rank ``rank``: ``device`` when it names one
    (``"cpu"``, or a numbered card), else card ``rank % cards``."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    from euler_tpu_torch.device import resolve_device

    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _device_identity(dev: torch.device) -> tuple:
    """What tells two ranks' devices apart across processes and hosts:
    the host and, for a card, its UUID (or index)."""
    if dev.type != "cuda":
        return (socket.gethostname(), dev.type, None)
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    return (socket.gethostname(), "cuda",
            str(uuid) if uuid is not None else dev.index)


def init_distributed(coordinator_addr: str, num_processes: int,
                     process_id: int, device=None,
                     timeout_s: float = 300.0) -> tuple:
    """Join ``num_processes`` processes as ranks of one group
    (counterpart of ``jax.distributed.initialize``): process
    ``process_id`` connects to ``coordinator_addr`` (``host:port``,
    where process 0 listens) and drives ``device`` (default: card
    ``process_id % cards``). The default group is gloo; the devices of
    all ranks are compared over it and the mesh groups' backend chosen:
    NCCL when every rank has a card of its own, else gloo (ranks sharing
    a card, or on the CPU). The choice is logged. Returns ``(backend,
    device)``; ``make_mesh`` then builds the mesh over the group."""
    dev = _local_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = coordinator_addr
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(
        "gloo", init_method=addr, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    idents = [None] * int(num_processes)
    dist.all_gather_object(idents, _device_identity(dev))
    own_card = (all(i[1] == "cuda" for i in idents)
                and len(set(idents)) == len(idents))
    backend = "nccl" if own_card and dist.is_nccl_available() else "gloo"
    _SETUP.update(backend=backend, device=dev)
    log.info("distributed: rank %d of %d on %s; mesh backend %s (%s)",
             process_id, num_processes, dev, backend,
             "a card per rank" if backend == "nccl" else
             "ranks share a card" if all(i[1] == "cuda" for i in idents)
             else "CPU ranks")
    return backend, dev


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    _SETUP.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def launch(fn, nprocs: int, args: tuple = (), timeout_s: float = 3600.0):
    """Run ``fn(local_rank, *args)`` in ``nprocs`` spawned processes (CUDA
    cannot be forked after it starts) and wait at most ``timeout_s``: a
    rank that raises or exits nonzero ends the others and raises here, a
    wait past the limit kills them all and raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{nprocs} ranks still running after {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5.0)


def pad_tables_for_mesh(state: dict, mesh) -> dict:
    """``state`` with its table rows (dim 0) padded with zeros up to a
    multiple of the model axis, so they shard evenly: 18 rows become 20
    at ``model_parallel`` 4. The extra rows are never indexed (valid ids
    stay below the original row count). A checkpoint resumes only under
    the same ``model_parallel``, since the stores' shapes include the
    padding. ``mesh`` is a ``Mesh`` or the model axis's width."""
    k = mesh if isinstance(mesh, int) else mesh.shape["model"]
    if k <= 1:
        return state

    def pad(path, x):
        extra = (-x.shape[0]) % k
        if not extra:
            return x
        if isinstance(x, np.ndarray):
            return np.pad(x, [(0, extra)] + [(0, 0)] * (x.ndim - 1))
        return torch.cat([x, x.new_zeros((extra, *x.shape[1:]))])

    return _map_tables(state, pad)


def shard_state(state: dict, mesh: Mesh) -> dict:
    """``state`` for this rank of ``mesh``: tables padded and cut to this
    rank's rows as ``RowShard``s when the mesh has a model axis, and the
    module's parameters and buffers broadcast from rank 0 (the
    counterpart of ``put_global``: every rank starts from the same
    state). The module and optimizers are the given ones."""
    if mesh.shape["model"] > 1:
        state = pad_tables_for_mesh(state, mesh)

        def cut(path, x):
            lo, hi = mesh.row_range(x.shape[0])
            return RowShard(x[lo:hi].clone(), lo, x.shape[0], mesh)

        state = _map_tables(state, cut)
    module = state.get("module")
    if module is not None and mesh.connected:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                mesh.broadcast(t.data)
    return state


def full_tables(state: dict) -> dict:
    """``state`` with each ``RowShard`` replaced by its whole padded table
    (a collective over the model group: every rank calls it)."""
    return _map_tables(state, lambda path, x: x.full()
                       if isinstance(x, RowShard) else x)


def shard_batch(batch, mesh: Mesh, n: int):
    """This rank's part of a global host batch of ``n`` roots: each array
    leaf (numpy or tensor) whose leading dim holds a whole number of rows
    a root (hop h of a fanout holds ``n * prod(fanouts[:h])``, root-major)
    cut to the data row's contiguous share; other leaves and scalars are
    replicated as they are."""
    s = mesh.batch_slice(n)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)) and np.ndim(x) >= 1 \
                and len(x) % n == 0:
            per = len(x) // n
            return x[s.start * per:s.stop * per]
        return x

    return walk(batch)


def _dryrun_rank(rank: int, n: int, model_parallel: int, addr: str,
                 steps: int, data_dir: str, out: str) -> None:
    """One rank of ``dryrun_multichip``."""
    import json

    from euler_tpu_torch import train
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.graph import device as device_graph
    from euler_tpu_torch.models import ScalableSage, SupervisedGraphSage

    torch.set_num_threads(1)
    init_distributed(addr, n, rank, "cpu")
    try:
        mesh = make_mesh(n, model_parallel)
        graph = Graph(directory=data_dir)
        # one global batch of 16 roots, each data row training on its
        # slice every step: a fit the loss must show
        fixed = np.random.default_rng(100).integers(0, 200, 16)
        mine = fixed[mesh.batch_slice(16)]

        def roots(step):
            return mine

        kw = dict(label_idx=0, label_dim=4, feature_idx=1, feature_dim=8,
                  max_id=199, metapath=[[0], [0]], fanouts=[3, 2], dim=16,
                  device_features=True)
        res = {}
        for name, model in (
                ("host", SupervisedGraphSage(**kw)),
                ("device_sampling", SupervisedGraphSage(
                    **kw, device_sampling=True)),
                ("scalable", ScalableSage(
                    label_idx=0, label_dim=4, feature_idx=1, feature_dim=8,
                    max_id=199, edge_type=[0], fanout=3, num_layers=2,
                    dim=16, device_features=True))):
            device_graph.set_kernel_mesh(
                mesh if model.device_sampling else None)
            try:
                _, hist = train.train(
                    model, graph, roots, steps if name == "host" else 2,
                    mesh=mesh, learning_rate=0.01, log_every=1,
                    prefetch_threads=1, device="cpu", seed=1)
            finally:
                device_graph.set_kernel_mesh(None)
            res[name] = [h["loss"] for h in hist]
        graph.close()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        shutdown_distributed()


def dryrun_multichip(n_devices: int = 4, model_parallel=None,
                     steps: int = 10, timeout_s: float = 300.0) -> dict:
    """The full train step over ``n_devices`` gloo ranks on the CPU
    (counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``):
    on a 200-node synthetic graph written as ``.dat`` files, host-sampled
    SupervisedGraphSage with its feature
    and label tables on the device trains ``steps`` steps with the batch
    (one batch of 16 roots, each data row on its slice) sharded over the
    data axis and the tables over the model axis
    (``model_parallel``, by default 2 when ``n_devices`` is even and at
    least 4, as the JAX dryrun picks it), then device sampling (the draws
    per rank) and ScalableSage (row-sharded stores) take two steps each.
    Raises unless every loss is finite and the first model's loss falls
    (the mean of its last three steps below that of its first three);
    returns the losses by path."""
    import json
    import os
    import tempfile

    from euler_tpu_torch.datasets import write_synthetic

    if model_parallel is None:
        model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    Mesh(n_devices, model_parallel)  # raises when it does not divide
    addr = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as d:
        data_dir = write_synthetic(os.path.join(d, "graph"), 200, 5, 8, 4,
                                   num_partitions=2, seed=3)
        out = os.path.join(d, "losses.json")
        launch(_dryrun_rank, n_devices,
               (n_devices, model_parallel, addr, steps, data_dir, out),
               timeout_s)
        with open(out) as f:
            res = json.load(f)
    losses = res["host"]
    if not all(np.isfinite(v) for vals in res.values() for v in vals):
        raise AssertionError(f"non-finite loss in the dryrun: {res}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"loss did not fall over {steps} sharded "
                             f"steps: {losses}")
    log.info("dryrun_multichip ok: %d ranks (data %d x model %d), loss "
             "%.4f -> %.4f over %d steps; device sampling %s; scalable %s",
             n_devices, n_devices // model_parallel, model_parallel,
             losses[0], losses[-1], steps, res["device_sampling"],
             res["scalable"])
    return res
