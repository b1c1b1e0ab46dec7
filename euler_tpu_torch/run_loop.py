"""Training / evaluation / embedding-export CLI driver (counterpart of
``euler_tpu/run_loop.py``), on one CUDA device.

The flag surface is the JAX package's. ``--graph_mode local`` (the
default) loads ``.dat`` partitions into an embedded engine
(``Graph(directory=--data_dir)``); ``--graph_mode remote`` connects the
engine's remote client to running shards (``--registry``, a flat-file
directory or ``tcp://host:port``, or ``--shards``); ``--graph_mode
shared`` serves this process's shard of ``--data_dir`` itself
(``graph.service.GraphService``, one process so far), waits for it on
``--registry`` (hosting the registry when it is ``tcp://``) and connects
to it as a remote graph. ``--mode train`` draws ``--batch_size`` roots a
step on the host and trains through ``train.train`` (host sampling
through the engine and prefetch, or over a remote graph through the
``--sampler_depth`` ring of async fanouts; with ``--device_sampling``
the fanouts drawn on the card), checkpointing into ``--model_dir``; ``--mode evaluate`` and ``--mode save_embedding``
restore the latest checkpoint and write ``eval.json`` or
``embedding.npy`` and ``id.txt`` there. ``--serve_after 1`` trains,
then serves the checkpoint (``serve.run_serve``, with the training
sampling config) until SIGTERM or SIGINT; the ``--serve_*`` flags
configure it and are refused without it (``check_serve_flags``).

The observability planes are the JAX package's. ``--telemetry`` (on by
default; 0 is the kill-switch) records the step phases
(``train.train``'s ``phase_profile``, fenced on each step's loss) and
the native histograms; ``--metrics_every N`` appends a
``telemetry.snapshot`` line to ``--metrics_file`` (default
``<model_dir>/metrics.jsonl``) every N steps; ``--trace_file`` writes the
merged Chrome trace when training ends (step phases, the slow-span
journals, and with ``--profile_dir`` the ``torch.profiler`` capture of
steps 10-20 with the card's kernels); ``--devprof`` counts compiles
(kernel builds, CUDA-graph captures), uploads and downloads and samples
the card's memory each second; ``--blackbox 0`` stops the flight
recorder; ``--postmortem_dir`` arms the fatal-signal postmortem, and an
unhandled exception writes ``postmortem.<pid>.exception.json`` there.

Several devices train as one mesh of ranks (``parallel.mesh``), one
rank a process and a device: ``--num_devices N`` starts N local ranks
(spawned, card ``rank % cards`` each; unset, every card the process
sees), ``--coordinator_addr host:port --num_processes N --process_id i``
joins N processes over TCP (process 0 listens there), and
``--model_parallel k`` row-shards the tables over a k-wide model axis.
``--batch_size`` stays the global batch, each data row sampling its
share; with ``--device_sampling`` the draws go per rank
(``graph.device.set_kernel_mesh``). ``--graph_mode shared`` across
processes serves shard ``--process_id`` of ``--num_processes`` in each,
and process 0 hosts a ``tcp://`` registry. Rank 0 logs and writes the
checkpoints, ``eval.json`` and the export. ``--serve_after`` over a
mesh serves once every rank is done (``serve_after_mesh``): under
``--num_devices`` the launching process, which holds no rank, waits for
its ranks to exit 0, then restores the mesh's padded checkpoint and
serves it on its device; under ``--coordinator_addr`` process 0 serves
after leaving the group and the others exit. Either serves the rows
``python -m euler_tpu_torch.serve --model_parallel k`` serves from the
same checkpoint.

A ``--data_dir`` behind an fsspec URL (``gs://``, ``memory://``) is
staged into the local cache before the engine loads it, or with
``--stream 1`` (local graphs only) fetched into memory and parsed from
there (``graph/remote_fs.py``). ``--optimizer`` is the JAX package's:
``sgd``, ``momentum``, ``adagrad`` (optax's) or ``adam``.
``--compile_cache`` names the JAX package's XLA program cache; the
port's counterpart is the cache of built kernels under
``build/euler_tpu_torch/`` (unset or 1: reused across launches; 0: this
launch's kernels built anew, ``_build.set_compile_cache``).

Usage:  python -m euler_tpu_torch --data_dir ... --model graphsage_supervised
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

import numpy as np
import torch

from euler_tpu_torch import blackbox, models
from euler_tpu_torch import train as train_lib
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.nn import metrics
from euler_tpu_torch.nn.layers import Dense
from euler_tpu_torch.serving import add_serve_flags, serve_flag_overrides

log = logging.getLogger("euler_tpu_torch")



def _str2bool(v) -> bool:
    """The JAX package's one truthy-string rule."""
    return str(v).lower() in ("1", "true", "yes", "y")


def _int_list(v) -> list[int]:
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(x) for x in str(v).split(",") if x != ""]


def define_flags(parser: Optional[argparse.ArgumentParser] = None):
    """The JAX package's flag surface (``euler_tpu/run_loop.py``
    ``define_flags``, serving flags included)."""
    p = parser or argparse.ArgumentParser(prog="euler_tpu_torch")
    p.add_argument("--mode", default="train",
                   choices=["train", "evaluate", "save_embedding"])
    # graph
    p.add_argument("--data_dir", default="")
    p.add_argument("--stream", type=_str2bool, default=False)
    p.add_argument("--graph_mode", default="local",
                   choices=["local", "remote", "shared"])
    p.add_argument("--registry", default="")
    p.add_argument("--rediscover_ms", type=int, default=None)
    p.add_argument("--backoff_ms", type=int, default=None)
    p.add_argument("--deadline_ms", type=int, default=None)
    p.add_argument("--feature_cache_mb", type=int, default=None)
    p.add_argument("--neighbor_cache_mb", type=int, default=None)
    p.add_argument("--cache_policy", default=None, choices=("freq", "fifo"))
    p.add_argument("--placement", type=_str2bool, default=None)
    p.add_argument("--strict", type=_str2bool, default=False)
    p.add_argument("--fault", default="")
    p.add_argument("--fault_seed", type=int, default=0)
    p.add_argument("--service_host", default="")
    p.add_argument("--service_workers", type=int, default=None)
    p.add_argument("--service_pending", type=int, default=None)
    p.add_argument("--shards", default="")
    p.add_argument("--train_node_type", type=int, default=0)
    p.add_argument("--all_node_type", type=int, default=-1)
    p.add_argument("--train_edge_type", default="0")
    p.add_argument("--all_edge_type", default="0,1,2")
    p.add_argument("--max_id", type=int, default=-1)
    p.add_argument("--feature_idx", type=int, default=-1)
    p.add_argument("--feature_dim", type=int, default=0)
    p.add_argument("--label_idx", type=int, default=-1)
    p.add_argument("--label_dim", type=int, default=0)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--id_file", default="")
    # model
    p.add_argument("--model", default="graphsage_supervised")
    p.add_argument("--sigmoid_loss", type=_str2bool, default=True)
    p.add_argument("--xent_loss", type=_str2bool, default=True)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--num_negs", type=int, default=5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--walk_len", type=int, default=5)
    p.add_argument("--walk_p", type=float, default=1.0)
    p.add_argument("--walk_q", type=float, default=1.0)
    p.add_argument("--walk_trials", type=int, default=0)
    p.add_argument("--left_win_size", type=int, default=5)
    p.add_argument("--right_win_size", type=int, default=5)
    p.add_argument("--fanouts", default="10,10")
    p.add_argument("--aggregator", default="mean",
                   choices=["gcn", "mean", "meanpool", "maxpool",
                            "attention"])
    p.add_argument("--concat", type=_str2bool, default=True)
    p.add_argument("--device_features", type=_str2bool, default=False,
                   help="keep the feature/label tables on the card")
    p.add_argument("--device_sampling", type=_str2bool, default=False,
                   help="keep the adjacency on the card and draw fanouts "
                        "and walks there (implies --device_features); the "
                        "host ships only root ids a step")
    p.add_argument("--feature_dtype", default="")
    p.add_argument("--use_residual", type=_str2bool, default=False)
    p.add_argument("--store_learning_rate", type=float, default=0.001)
    p.add_argument("--store_init_maxval", type=float, default=0.05)
    p.add_argument("--head_num", type=int, default=1)
    p.add_argument("--embedding_file", default="")
    # training
    p.add_argument("--model_dir", default="ckpt")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--optimizer", default="adam",
                   choices=sorted(train_lib.OPTIMIZERS))
    p.add_argument("--learning_rate", type=float, default=0.01)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--log_steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--max_degree", type=int, default=None)
    p.add_argument("--alias_sampling", type=_str2bool, default=False)
    p.add_argument("--metrics_every", type=int, default=0)
    p.add_argument("--metrics_file", default="")
    p.add_argument("--telemetry", type=_str2bool, default=True)
    p.add_argument("--postmortem_dir", default="")
    p.add_argument("--blackbox", type=_str2bool, default=True)
    p.add_argument("--trace_file", default="")
    p.add_argument("--prefetch_depth", type=int, default=2)
    p.add_argument("--prefetch_threads", type=int, default=2)
    p.add_argument("--sampler_depth", type=int, default=2,
                   help="remote graphs only (the async sampler pipeline); "
                        "a local graph samples through --prefetch_threads")
    p.add_argument("--profile_dir", default="")
    p.add_argument("--devprof", type=_str2bool, default=True)
    p.add_argument("--compile_cache", type=_str2bool, default=None)
    # serving
    p.add_argument("--serve_after", type=_str2bool, default=False,
                   help="after --mode train, serve the checkpoint until "
                        "SIGTERM (serve.run_serve)")
    add_serve_flags(p)
    # multi-process
    p.add_argument("--coordinator_addr", default="")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    return p


def check_flags(args) -> None:
    """Refuse graph flags that would silently do nothing: ``--stream``
    off a local graph (remote clients read no graph data; the shards
    stage their own), with the JAX CLI's message."""
    if args.stream and args.graph_mode != "local":
        raise ValueError(
            "--stream is only supported with --graph_mode=local "
            "(shared/remote services stage their shard to the local "
            "cache; see DEPLOY.md 'Remote data')")


def check_serve_flags(args) -> None:
    """Refuse serve-only flags on a run that will never serve (they would
    silently do nothing), and ``--serve_after`` outside ``--mode
    train``."""
    if args.serve_after and args.mode != "train":
        raise ValueError(
            "--serve_after means train-then-serve and needs "
            f"--mode=train (got --mode={args.mode}); to serve an "
            "existing checkpoint use `python -m euler_tpu_torch.serve`"
        )
    overrides = serve_flag_overrides(args)
    if overrides and not args.serve_after:
        raise ValueError(
            f"serve-only flags {', '.join(overrides)} do nothing in "
            f"--mode={args.mode} without --serve_after; add "
            "--serve_after=1 (train, then serve the checkpoint) or use "
            "`python -m euler_tpu_torch.serve` against a saved --model_dir"
        )


def _remote_graph(args, registry, shards=None):
    from euler_tpu_torch.graph import Graph

    return Graph(
        mode="remote", registry=registry, shards=shards,
        rediscover_ms=args.rediscover_ms, backoff_ms=args.backoff_ms,
        deadline_ms=args.deadline_ms,
        feature_cache_mb=args.feature_cache_mb,
        neighbor_cache_mb=args.neighbor_cache_mb,
        cache_policy=args.cache_policy, placement=args.placement,
        strict=args.strict or None, fault=args.fault or None,
        fault_seed=args.fault_seed if args.fault else None)


def _wait_for_shards(args, tcp_registry: bool) -> None:
    """Wait until ``--num_processes`` shards are live on ``--registry``:
    listed by a TCP registry (its entries expire without heartbeats), or
    in a flat-file registry with an address that accepts a connection
    (entries a killed run left behind are skipped). Raises after 120 s."""
    import socket
    import time

    from euler_tpu_torch.graph import registry as registry_mod

    dead: dict = {}  # entry -> when its dead verdict expires

    def alive(entry: str) -> bool:
        # an entry is "<shard>#<host>_<port>" (eg_service.cc); a dead
        # verdict is kept 5 s, so a shard not yet listening is re-probed
        if dead.get(entry, 0.0) > time.time():
            return False
        try:
            host, port = entry.split("#", 1)[1].rsplit("_", 1)
            with socket.create_connection((host, int(port)), 1.0):
                dead.pop(entry, None)
                return True
        except (OSError, ValueError):
            dead[entry] = time.time() + 5.0
            return False

    def live_shards() -> set:
        if tcp_registry:
            try:
                return set(registry_mod.query(args.registry))
            except ConnectionError:
                return set()
        return {f.split("#", 1)[0] for f in os.listdir(args.registry)
                if "#" in f and not f.endswith(".tmp") and alive(f)}

    deadline = time.time() + 120.0
    while True:
        live = live_shards()
        if len(live) >= args.num_processes:
            return
        if time.time() > deadline:
            hint = ("" if tcp_registry else "; stale entries from a killed "
                    "run are ignored: clear the registry directory")
            raise TimeoutError(
                f"only live shards {sorted(live)} in {args.registry} after "
                f"120 s (need {args.num_processes}{hint})")
        time.sleep(0.1)


def _wait_for_registry(registry: str, timeout_s: float = 120.0) -> None:
    """Wait until the ``tcp://`` registry answers; raises after
    ``timeout_s``."""
    import time

    from euler_tpu_torch.graph import registry as registry_mod

    deadline = time.time() + timeout_s
    while True:
        try:
            registry_mod.query(registry)
            return
        except ConnectionError:
            if time.time() > deadline:
                raise TimeoutError(
                    f"registry {registry} unreachable after {timeout_s:.0f} "
                    "s (does process 0 run there?)")
            time.sleep(0.2)


def build_graph(args):
    """The graph of ``--graph_mode`` and the services this process
    started for it, ``(graph, services)``: a local engine over
    ``--data_dir``, the remote client over ``--registry`` or
    ``--shards``, or (shared) this process's shard served by a
    ``GraphService`` (and the ``tcp://`` registry hosted here), then the
    remote client over it. The caller drains and stops the services
    after closing the graph. The JAX CLI's refusals hold: the remote
    client's flags raise on a local graph."""
    from euler_tpu_torch.graph import Graph, GraphService

    check_flags(args)
    services = []
    if args.fault and args.graph_mode == "local":
        raise ValueError(
            "--fault needs --graph_mode=remote or shared (failpoints sit "
            "in the transport)")
    if args.graph_mode == "local" and (
            args.feature_cache_mb is not None or args.strict
            or args.neighbor_cache_mb is not None
            or args.cache_policy is not None or args.placement is not None):
        raise ValueError(
            "--feature_cache_mb/--neighbor_cache_mb/--cache_policy/"
            "--placement/--strict need --graph_mode=remote or shared (they "
            "configure the remote client's request path; a local graph "
            "reads its own memory)")
    if args.graph_mode == "local":
        return Graph(directory=args.data_dir, stream=args.stream), services
    if args.graph_mode == "remote":
        return _remote_graph(
            args, args.registry or None,
            args.shards.split(",") if args.shards else None), services
    # shared: serve this process's shard, then connect to the cluster
    if not args.registry:
        raise ValueError("--graph_mode=shared needs --registry")
    from euler_tpu_torch.graph import registry as registry_mod

    tcp_registry = args.registry.startswith("tcp://")
    try:
        if tcp_registry:
            # process 0 hosts the registry at the URL's port (port 0
            # binds a free one, for a one-process run); every other
            # process waits for it to answer before registering its shard
            host, port = registry_mod.parse_tcp_url(args.registry)
            if args.process_id == 0:
                services.append(registry_mod.RegistryServer(port=port))
                if port == 0:
                    args.registry = f"tcp://{host}:{services[-1].port}"
            elif port == 0:
                raise ValueError(
                    "--graph_mode=shared over several processes needs the "
                    "registry's port in --registry (process 0 hosts it)")
            else:
                _wait_for_registry(args.registry)
        services.append(GraphService(
            args.data_dir, shard_idx=args.process_id,
            shard_num=args.num_processes,
            host=args.service_host or _advertised_host(args.registry),
            registry=args.registry, workers=args.service_workers,
            pending=args.service_pending))
        _wait_for_shards(args, tcp_registry)
        return _remote_graph(args, args.registry), services
    except BaseException:
        stop_services(services)
        raise


def _advertised_host(registry: str) -> str:
    """The address a shared-mode shard advertises when ``--service_host``
    is empty: the interface that routes to a ``tcp://`` registry on
    another host (other hosts must dial it), else loopback."""
    import socket

    from euler_tpu_torch.graph import registry as registry_mod

    parsed = registry_mod.parse_tcp_url(registry)
    if parsed is None or parsed[0] in ("127.0.0.1", "localhost"):
        return "127.0.0.1"
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.connect((parsed[0], 9))  # routing only: a UDP connect sends nothing
        return probe.getsockname()[0]


def stop_services(services) -> None:
    """Drain each shard service (in-flight requests finish), then stop
    it; a registry server just stops."""
    for s in services:
        if hasattr(s, "drain"):
            s.drain()
        s.stop()


class _SavedEmbeddingModule(torch.nn.Module):
    """A trainable Dense over the batch's frozen ``"emb"`` rows, and the
    supervised decoder."""

    def __init__(self, emb_dim: int, num_classes: int, sigmoid_loss: bool,
                 generator=None):
        super().__init__()
        self.sigmoid_loss = sigmoid_loss
        self.predict = Dense(emb_dim, num_classes)
        self.predict.reset_parameters(generator)

    def embed(self, batch, consts=None):
        return batch["emb"]

    def forward(self, batch, consts=None):
        logits = self.predict(batch["emb"].detach())
        loss, predictions = models.base.supervised_decoder(
            logits, batch["labels"], self.sigmoid_loss)
        return models.ModelOutput(
            embedding=batch["emb"], loss=loss, metric_name="f1",
            metric=metrics.f1_counts(batch["labels"], predictions))


class SavedEmbedding(models.Model):
    """A frozen saved embedding (``embedding.npy`` of ``--mode
    save_embedding``) and a trainable classifier over it (the JAX
    package's ``SavedEmbedding``). Host batches: each id's row (an id
    past the table reads its last row) and its labels from ``graph``; no
    table lives on the device."""

    metric_name = "f1"
    device_features = False
    device_sampling = False

    def __init__(self, embedding: np.ndarray, label_idx, label_dim,
                 num_classes=None, sigmoid_loss=True):
        self.embedding = embedding.astype(np.float32)
        self.label_idx = label_idx
        self.label_dim = label_dim
        self.num_classes = num_classes or label_dim
        self.sigmoid_loss = sigmoid_loss

    def make_module(self, generator=None) -> _SavedEmbeddingModule:
        return _SavedEmbeddingModule(self.embedding.shape[1],
                                     self.num_classes, self.sigmoid_loss,
                                     generator)

    def sample(self, graph, inputs) -> dict:
        ids = np.asarray(inputs, dtype=np.int64).reshape(-1)
        safe = np.clip(ids, 0, len(self.embedding) - 1)
        return {"emb": self.embedding[safe],
                "labels": graph.get_dense_feature(
                    ids, [self.label_idx], [self.label_dim])}


def build_model(args, graph):
    """Model dispatch by the reference's model names, each sampled on the
    host unless ``--device_sampling``."""
    fanouts = _int_list(args.fanouts)
    train_edge = _int_list(args.train_edge_type)
    all_edge = _int_list(args.all_edge_type)
    metapath = [list(train_edge if args.mode == "train" else all_edge)] * max(
        len(fanouts), 1)
    name = args.model
    device_features = args.device_features or args.device_sampling
    dtype = args.feature_dtype or None
    common_sup = dict(
        label_idx=args.label_idx, label_dim=args.label_dim,
        num_classes=args.num_classes, sigmoid_loss=args.sigmoid_loss,
        feature_idx=args.feature_idx, feature_dim=args.feature_dim,
    )
    if name == "line":
        return models.LINE(
            node_type=args.all_node_type, edge_type=all_edge,
            max_id=args.max_id, dim=args.dim, xent_loss=args.xent_loss,
            num_negs=args.num_negs, order=args.order,
            device_sampling=args.device_sampling)
    if name in ("randomwalk", "deepwalk", "node2vec"):
        return models.Node2Vec(
            node_type=args.all_node_type, edge_type=all_edge,
            max_id=args.max_id, dim=args.dim, xent_loss=args.xent_loss,
            num_negs=args.num_negs, walk_len=args.walk_len,
            walk_p=args.walk_p, walk_q=args.walk_q,
            left_win_size=args.left_win_size,
            right_win_size=args.right_win_size,
            device_sampling=args.device_sampling,
            walk_trials=args.walk_trials)
    if name in ("gcn", "gcn_supervised"):
        cap = max(fanouts) if fanouts else 10
        return models.SupervisedGCN(
            metapath=metapath, dim=args.dim,
            max_nodes_per_hop=[args.batch_size * (cap ** h)
                               for h in range(1, len(metapath) + 1)],
            max_edges_per_hop=[args.batch_size * (cap ** (h + 1))
                               for h in range(len(metapath))],
            aggregator=args.aggregator, max_id=args.max_id,
            use_residual=args.use_residual, device_features=device_features,
            feature_dtype=dtype, device_sampling=args.device_sampling,
            **common_sup)
    if name == "scalable_gcn":
        return models.ScalableGCN(
            edge_type=metapath[0], num_layers=len(fanouts), dim=args.dim,
            max_id=args.max_id, max_neighbors=fanouts[0],
            aggregator=args.aggregator, use_residual=args.use_residual,
            store_learning_rate=args.store_learning_rate,
            store_init_maxval=args.store_init_maxval,
            device_features=device_features, feature_dtype=dtype,
            device_sampling=args.device_sampling,
            train_node_type=args.train_node_type, **common_sup)
    if name == "graphsage":
        return models.GraphSage(
            node_type=args.train_node_type, edge_type=train_edge,
            max_id=args.max_id, xent_loss=args.xent_loss,
            num_negs=args.num_negs, metapath=metapath, fanouts=fanouts,
            dim=args.dim, aggregator=args.aggregator, concat=args.concat,
            feature_idx=args.feature_idx, feature_dim=args.feature_dim,
            device_features=device_features, feature_dtype=dtype,
            device_sampling=args.device_sampling)
    if name == "graphsage_supervised":
        return models.SupervisedGraphSage(
            metapath=metapath, fanouts=fanouts, dim=args.dim,
            aggregator=args.aggregator, concat=args.concat,
            max_id=args.max_id, device_features=device_features,
            feature_dtype=dtype, device_sampling=args.device_sampling,
            train_node_type=args.train_node_type, **common_sup)
    if name == "scalable_sage":
        return models.ScalableSage(
            edge_type=metapath[0], fanout=fanouts[0],
            num_layers=len(fanouts), dim=args.dim,
            aggregator=args.aggregator, concat=args.concat,
            max_id=args.max_id,
            store_learning_rate=args.store_learning_rate,
            store_init_maxval=args.store_init_maxval,
            device_features=device_features, feature_dtype=dtype,
            device_sampling=args.device_sampling,
            train_node_type=args.train_node_type, **common_sup)
    if name == "gat":
        return models.GAT(
            max_id=args.max_id, head_num=args.head_num, hidden_dim=args.dim,
            nb_num=5, device_features=device_features, feature_dtype=dtype,
            device_sampling=args.device_sampling,
            train_node_type=args.train_node_type, **common_sup)
    if name == "lshne":
        return models.LsHNE(
            node_type=-1,
            # one view, two 3-step homogeneous metapaths
            path_patterns=[[[[0], [0], [0]], [[0], [0], [0]]]],
            max_id=args.max_id, dim=128,
            sparse_feature_dims=[args.max_id + 2],
            feature_ids=[args.feature_idx if args.feature_idx >= 0 else 0],
            device_sampling=args.device_sampling)
    if name == "saved_embedding":
        emb = np.load(args.embedding_file
                      or os.path.join(args.model_dir, "embedding.npy"))
        return SavedEmbedding(emb, args.label_idx, args.label_dim,
                              args.num_classes, args.sigmoid_loss)
    raise ValueError(f"unsupported model {name!r}")


def _num_steps(args) -> int:
    per_epoch = max((args.max_id + 1) // args.batch_size, 1)
    return per_epoch * args.num_epochs


def run_train(model, graph, args, device=None, mesh=None):
    batch = args.batch_size * getattr(model, "batch_size_ratio", 1)
    if mesh is not None:
        # --batch_size stays the global batch; each data row samples its
        # contiguous share
        mesh.batch_slice(batch)  # raises when it does not divide
        batch //= mesh.shape["data"]

    def source_fn(step):
        return np.asarray(graph.sample_node(batch, args.train_node_type))

    step_hook = None
    if args.metrics_every > 0:
        from euler_tpu_torch.telemetry import append_metrics_line

        metrics_path = args.metrics_file or os.path.join(
            args.model_dir or ".", "metrics.jsonl")
        os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)

        def step_hook(step, _path=metrics_path):
            if step % args.metrics_every == 0:
                append_metrics_line(_path, step)

    recorder = None
    if args.trace_file:
        from euler_tpu_torch.trace import TraceRecorder

        recorder = TraceRecorder().start()
    try:
        return train_lib.train(
            model, graph, source_fn, num_steps=_num_steps(args),
            optimizer=args.optimizer, learning_rate=args.learning_rate,
            log_every=args.log_steps, seed=args.seed,
            prefetch_depth=args.prefetch_depth,
            prefetch_threads=args.prefetch_threads,
            sampler_depth=args.sampler_depth,
            checkpoint_dir=args.model_dir or None,
            profile_dir=args.profile_dir or None, step_hook=step_hook,
            device=device, mesh=mesh)
    finally:
        if recorder is not None:
            # written on an interrupted run too: the trace of a run that
            # died mid-step is the one worth reading
            recorder.stop()
            from euler_tpu_torch.trace import write_trace

            os.makedirs(os.path.dirname(args.trace_file) or ".",
                        exist_ok=True)
            # the --profile_dir capture's device lanes merge in, aligned
            # by the marker train() stamped into it
            trace = write_trace(args.trace_file, recorder, graph,
                                profile_dir=args.profile_dir or None)
            log.info("trace: %d events -> %s (open in ui.perfetto.dev)",
                     len(trace["traceEvents"]), args.trace_file)


def _restore_state(model, graph, args, device=None, mesh=None):
    from euler_tpu_torch.checkpoint import Checkpointer

    state = model.init_state(
        graph, train_lib.get_optimizer(args.optimizer, args.learning_rate),
        device=device, seed=args.seed, mesh=mesh)
    ckpt = Checkpointer(args.model_dir, mesh=mesh)
    if ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    else:
        log.warning("no checkpoint in %s; using fresh params",
                    args.model_dir)
    ckpt.close()
    # the exports draw on the engine's RNG of this thread: seeded, they
    # are reproducible
    engine = getattr(graph, "_lib", None)
    if engine is not None:
        engine.eg_seed(args.seed)
    return state


def run_evaluate(model, graph, args, device=None, mesh=None):
    state = _restore_state(model, graph, args, device, mesh)
    if args.id_file:
        ids = np.concatenate([
            np.loadtxt(f, dtype=np.int64).reshape(-1)
            for f in args.id_file.split(",")
        ])
    else:
        ids = np.arange(args.max_id + 1, dtype=np.int64)
    batch = args.batch_size
    # wrap-pad to whole batches (np.resize cycles ids)
    pad = (-len(ids)) % batch
    padded = np.resize(ids, len(ids) + pad) if pad else ids
    result = train_lib.evaluate(
        model, graph, (padded[i:i + batch]
                       for i in range(0, len(padded), batch)),
        state, device=device, seed=args.seed, log_fn=log.info, mesh=mesh)
    if args.model_dir and (mesh is None or mesh.rank == 0):
        os.makedirs(args.model_dir, exist_ok=True)
        with open(os.path.join(args.model_dir, "eval.json"), "w") as f:
            json.dump({**result, "id_file": args.id_file,
                       "model": args.model}, f)
    return result


def run_save_embedding(model, graph, args, device=None, mesh=None):
    state = _restore_state(model, graph, args, device, mesh)
    emb = train_lib.save_embedding(model, args.max_id, state,
                                   batch_size=args.batch_size,
                                   device=device, graph=graph, mesh=mesh)
    if mesh is not None:
        import hashlib

        # every rank holds the whole matrix; rank 0 writes it
        log.info("rank %d export sha256 %s", mesh.rank,
                 hashlib.sha256(np.ascontiguousarray(emb)).hexdigest())
        if mesh.rank != 0:
            return None
    os.makedirs(args.model_dir, exist_ok=True)
    out = os.path.join(args.model_dir, "embedding.npy")
    np.save(out, emb)
    ids_out = os.path.join(args.model_dir, "id.txt")
    np.savetxt(ids_out, np.arange(args.max_id + 1, dtype=np.int64), fmt="%d")
    log.info("saved %s %s and %s", out, emb.shape, ids_out)
    return out


def setup_planes(args, device) -> None:
    """Arm the observability planes from the flags, before any graph or
    service exists (so discovery records too, and a crash while loading
    leaves a postmortem), and choose where the kernels build
    (``--compile_cache``): the telemetry and flight-recorder switches,
    the device plane for ``device`` with its memory sampled each second,
    and with ``--postmortem_dir`` the fatal-signal dump (labelled with
    ``--process_id``)."""
    from euler_tpu_torch import _build, devprof
    from euler_tpu_torch.telemetry import set_telemetry

    _build.set_compile_cache(args.compile_cache)
    set_telemetry(bool(args.telemetry))
    blackbox.set_blackbox(bool(args.blackbox))
    devprof.setup(enabled=args.devprof, device=device, sample_ms=1000)
    if args.postmortem_dir:
        blackbox.install(args.postmortem_dir, shard=args.process_id)


def _spawned_rank(rank: int, argv, device, addr: str, n: int) -> None:
    """Local rank ``rank`` of ``n`` that ``main`` spawned for
    ``--num_devices``: one process of a coordinator run. It never serves:
    with ``--serve_after`` the launching process does, once every rank
    has exited."""
    args = define_flags().parse_args(argv)
    args.coordinator_addr, args.num_processes, args.process_id = addr, n, rank
    _configure_logging(rank)
    _run_rank(args, device, serve=False)


def _configure_logging(rank=None) -> None:
    tag = "" if rank is None else f" rank{rank}"
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s %(name)s{tag} %(message)s")


def _run_rank(args, device, serve: bool = True) -> int:
    """One rank of a mesh: join the group, build the mesh, run the mode,
    leave. With ``--serve_after`` (and ``serve``) process 0 then serves
    the mesh's checkpoint (``serve_after_mesh``) and the others exit."""
    from euler_tpu_torch.parallel import mesh as mesh_mod

    backend, dev = mesh_mod.init_distributed(
        args.coordinator_addr, args.num_processes, args.process_id, device)
    try:
        mesh = mesh_mod.make_mesh(args.num_devices or args.num_processes,
                                  args.model_parallel, device=dev)
        _run(args, dev, mesh)
    finally:
        mesh_mod.shutdown_distributed()
    if serve and args.serve_after and args.process_id == 0:
        return serve_after_mesh(args, dev)
    return 0


def _num_local_ranks(args, device) -> int:
    """``--num_devices``, or every card the process sees when unset (one
    on the CPU)."""
    if args.num_devices is not None:
        return args.num_devices
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return max(torch.cuda.device_count(), 1)
    return 1


def serve_after_mesh(args, device=None, block: bool = True):
    """``--serve_after`` over a mesh, once every rank is done: restore the
    mesh's checkpoint (tables padded for ``--model_parallel``, as
    ``serve.restore_serving_state`` reads them) into this one process on
    ``device`` and serve it through ``serve.run_serve``, with the training
    sampling config, until SIGTERM or SIGINT, then drain (the JAX
    package's ``run_loop`` trains over its mesh, then serves from the
    same launch). The
    graph is built anew here (``build_graph``): the ranks' graphs and
    services went with them. The model samples on the host per id
    (``serve.EmbedServer``'s determinism anchor), over device tables when
    training kept them there: a device-sampled run is served as
    ``python -m euler_tpu_torch.serve ... --device_sampling 0
    --device_features 1`` serves its checkpoint.

    ``block=False`` returns ``(server, frontend, graph, services)`` at
    once; the caller then stops the frontend, closes the server and the
    graph, and stops the services (``stop_services``)."""
    from euler_tpu_torch import serve

    dev = resolve_device(device)
    graph, services = build_graph(args)
    served = argparse.Namespace(**vars(args))
    served.device_features = bool(args.device_features
                                  or args.device_sampling)
    served.device_sampling = False
    try:
        model = build_model(served, graph)
        server, frontend = serve.run_serve(model, graph, args, dev,
                                           block=block)
    except BaseException:
        graph.close()
        stop_services(services)
        raise
    if not block:
        return server, frontend, graph, services
    graph.close()
    stop_services(services)
    return 0


def main(argv=None, device=None) -> int:
    """Run one mode on ``device``: the card unless the caller asks for
    the CPU (``device="cpu"``, as the tests do); with no card it raises.
    Over several devices or processes, each rank runs it on its own
    (``--num_devices``, ``--coordinator_addr``), and ``--serve_after``
    serves once they are done (``serve_after_mesh``)."""
    _configure_logging()
    args = define_flags().parse_args(argv)
    check_flags(args)
    check_serve_flags(args)
    n = _num_local_ranks(args, device)
    if (args.serve_after and args.coordinator_addr
            and args.graph_mode == "shared" and args.num_processes > 1):
        raise ValueError(
            "--serve_after with --coordinator_addr serves from process 0 "
            "after the others exit, and over --graph_mode=shared their "
            "shards stop with them: serve a local or remote graph")
    if args.coordinator_addr:
        return _run_rank(args, device)
    if n > 1:
        from euler_tpu_torch.parallel import mesh as mesh_mod

        mesh_mod.Mesh(n, args.model_parallel)  # raises when it does not divide
        argv = list(sys.argv[1:] if argv is None else argv)
        if args.graph_mode == "shared" and args.registry.startswith(
                "tcp://") and args.registry.endswith(":0"):
            # the ranks' shards meet at one registry: give it a port
            argv += ["--registry",
                     f"{args.registry[:-2]}:{mesh_mod.free_port()}"]
        mesh_mod.launch(_spawned_rank, n,
                        (argv, device, f"127.0.0.1:{mesh_mod.free_port()}",
                         n))
        if args.serve_after:
            # every rank exited 0 (launch raises otherwise): this
            # process, which held none, serves the mesh's checkpoint
            dev = resolve_device(device)
            setup_planes(args, dev)
            return serve_after_mesh(args, dev)
        return 0
    if args.model_parallel != 1:
        from euler_tpu_torch.parallel import mesh as mesh_mod

        mesh_mod.Mesh(n, args.model_parallel)  # raises: 1 device
    return _run(args, resolve_device(device), None)


def _run(args, dev, mesh) -> int:
    """Run ``--mode`` on ``dev``, as one rank of ``mesh`` when given."""
    from euler_tpu_torch.graph import device as device_graph

    setup_planes(args, dev)

    def exception_postmortem():
        # the Python twin of the fatal-signal dump, in its format (signal
        # 0, "exception"); the exception itself still propagates
        if not args.postmortem_dir:
            return
        path = os.path.join(args.postmortem_dir,
                            f"postmortem.{os.getpid()}.exception.json")
        try:
            blackbox.write_postmortem(path)
            log.error("unhandled exception; postmortem: %s", path)
        except Exception:
            log.exception("postmortem dump failed")

    try:
        graph, services = build_graph(args)
    except Exception:
        exception_postmortem()
        raise
    try:
        # device sampling over several ranks draws per rank; set or
        # cleared every run, so a stale mesh never routes a later run
        device_graph.set_kernel_mesh(
            mesh if mesh is not None and mesh.size > 1
            and args.device_sampling else None)
        model = build_model(args, graph)
        if args.max_degree is not None or args.alias_sampling:
            model.set_sampling_options(max_degree=args.max_degree,
                                       alias=args.alias_sampling)
        if args.mode == "train":
            run_train(model, graph, args, dev, mesh)
            if args.serve_after and mesh is None:
                # the freshest checkpoint goes live in this process, with
                # the training sampling config; blocks until SIGTERM or
                # SIGINT, then drains
                from euler_tpu_torch import serve

                serve.run_serve(model, graph, args, dev)
        elif args.mode == "evaluate":
            run_evaluate(model, graph, args, dev, mesh)
        else:
            run_save_embedding(model, graph, args, dev, mesh)
    except Exception:
        exception_postmortem()
        raise
    finally:
        device_graph.set_kernel_mesh(None)
        graph.close()
        # this process's kernel launches, sharded routes included, so a
        # caller can read which path the run took
        from euler_tpu_torch.graph import sampling_kernels

        log.info("kernel launches %s", json.dumps(
            {**sampling_kernels.launches,
             **sampling_kernels.sharded_launches}))
        # the transport's and (shared mode) the shard's survivability
        # ledger, then the services: in-flight shard requests finish
        from euler_tpu_torch.graph.native import counters

        ledger = {k: v for k, v in counters().items() if v}
        if ledger:
            log.info("transport/server counters: %s", ledger)
        stop_services(services)
    return 0


if __name__ == "__main__":
    sys.exit(main())
