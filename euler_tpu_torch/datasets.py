"""Synthetic benchmark graphs at the reference's scales.

The port's copies of ``euler_tpu.datasets.build_synthetic`` and
``build_powerlaw``: the same numpy RNG calls in the same order, so one
seed gives the same graph in both packages. They return the arrays that
``graph.MemoryGraph`` takes; ``build_ppi`` and ``build_reddit`` write the
same graphs as ``.dat`` partitions and ``meta.json`` for the engine
client (``graph.Graph``), byte for byte the JAX package's files.

Layout convention (matches the examples' training flags): dense feature
slot 0 = labels (multi-/one-hot), slot 1 = input features.
"""

from __future__ import annotations

import json
import os

import numpy as np

PPI = dict(num_nodes=56944, avg_degree=15, feature_dim=50, label_dim=121,
           multilabel=True)
REDDIT = dict(num_nodes=232965, avg_degree=50, feature_dim=602, label_dim=41,
              multilabel=False)
# real Reddit's published scale: 232,965 nodes, ~114.6M directed edges
# (mean degree ~492), as a power law
REDDIT_HEAVYTAIL = dict(
    num_nodes=232965, num_edges=114_600_000, feature_dim=602,
    label_dim=41, alpha=1.8, multilabel=False,
)


def _cache_begin(out_dir: str, params: str,
                 protect_unmarked: bool = False) -> bool:
    """The builders' done-marker protocol. True: a finished build with
    the same params is there (the caller returns at once). False: stale,
    partial or absent; stale outputs are cleared, the in-progress marker
    is written (an interrupted build is detected and redone next time),
    and the caller generates, then calls ``_cache_finish``.
    ``protect_unmarked``: ``.dat`` partitions with no marker at all are a
    real converted dataset, kept rather than overwritten."""
    os.makedirs(out_dir, exist_ok=True)
    marker = os.path.join(out_dir, "done")
    wip = os.path.join(out_dir, "synthetic-in-progress")
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == params:
                return True
    elif (
        protect_unmarked
        and not os.path.exists(wip)
        and any(n.endswith(".dat") for n in os.listdir(out_dir))
    ):
        return True
    with open(wip, "w") as f:
        f.write(params)
    for name in os.listdir(out_dir):
        if name.endswith(".dat") or name in ("done", "meta.json"):
            os.unlink(os.path.join(out_dir, name))
    return False


def _cache_finish(out_dir: str, params: str) -> None:
    with open(os.path.join(out_dir, "done"), "w") as f:
        f.write(params)
    os.unlink(os.path.join(out_dir, "synthetic-in-progress"))


def write_dat(arrays: dict, out_dir: str, num_partitions: int = 1) -> None:
    """Write ``MemoryGraph`` arrays as ``meta.json`` and ``part_<p>.dat``
    partitions (node id % ``num_partitions``), through ``graph.convert``'s
    block packer: each node's neighbors in the order the arrays hold
    them, its dense slots as float features and its sparse slots
    (``sparse_features``, CSR ``(indptr, values)``) as uint64 features."""
    from euler_tpu_torch.graph.convert import convert_dicts

    indptr = np.asarray(arrays["indptr"], np.int64)
    indices = np.asarray(arrays["indices"], np.int64)
    weights = np.asarray(arrays["weights"], np.float32)
    node_weights = np.asarray(arrays["node_weights"], np.float32)
    node_types = np.asarray(arrays["node_types"], np.int32)
    dense = list(arrays.get("dense_features", ()))
    sparse = [(np.asarray(ptr, np.int64), np.asarray(values, np.int64))
              for ptr, values in arrays.get("sparse_features", ())]
    n_et = int(arrays.get("edge_type_num", 1))
    meta = {
        "node_type_num": int(node_types.max(initial=0)) + 1,
        "edge_type_num": n_et,
        "node_uint64_feature_num": len(sparse),
        "node_float_feature_num": len(dense),
        "node_binary_feature_num": 0,
        "edge_uint64_feature_num": 0,
        "edge_float_feature_num": 0,
        "edge_binary_feature_num": 0,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)

    def nodes():
        for nid in range(len(node_weights)):
            neighbor = {}
            for t in range(n_et):
                a, b = indptr[nid * n_et + t], indptr[nid * n_et + t + 1]
                neighbor[str(t)] = dict(zip(
                    map(str, indices[a:b].tolist()), weights[a:b].tolist()))
            yield {
                "node_id": nid,
                "node_type": int(node_types[nid]),
                "node_weight": float(node_weights[nid]),
                "neighbor": neighbor,
                "uint64_feature": {
                    str(k): values[ptr[nid]:ptr[nid + 1]].tolist()
                    for k, (ptr, values) in enumerate(sparse)},
                "float_feature": {
                    str(k): table[nid].tolist()
                    for k, table in enumerate(dense)},
                "binary_feature": {},
                "edge": [],
            }

    convert_dicts(nodes(), meta, os.path.join(out_dir, "part"),
                  num_partitions)


def write_synthetic(
    out_dir: str,
    num_nodes: int,
    avg_degree: int,
    feature_dim: int,
    label_dim: int,
    multilabel: bool = True,
    num_partitions: int = 4,
    max_degree: int = 60,
    seed: int = 7,
) -> str:
    """``build_synthetic``'s graph written as ``.dat`` partitions and
    ``meta.json`` (cached: a ``done`` marker records the parameters and
    skips the work only when they match), the same files as the JAX
    package's ``build_synthetic(out_dir, ...)``. Returns out_dir."""
    params = json.dumps(
        dict(num_nodes=num_nodes, avg_degree=avg_degree,
             feature_dim=feature_dim, label_dim=label_dim,
             multilabel=multilabel, num_partitions=num_partitions,
             max_degree=max_degree, seed=seed),
        sort_keys=True,
    )
    if _cache_begin(out_dir, params, protect_unmarked=True):
        return out_dir
    write_dat(build_synthetic(num_nodes, avg_degree, feature_dim, label_dim,
                              multilabel, max_degree, seed),
              out_dir, num_partitions)
    _cache_finish(out_dir, params)
    return out_dir


def build_ppi(out_dir: str, **overrides) -> str:
    return write_synthetic(out_dir, **{**PPI, **overrides})


def build_reddit(out_dir: str, **overrides) -> str:
    return write_synthetic(out_dir, **{**REDDIT, **overrides})


def build_synthetic(
    num_nodes: int,
    avg_degree: int,
    feature_dim: int,
    label_dim: int,
    multilabel: bool = True,
    max_degree: int = 60,
    seed: int = 7,
) -> dict:
    """Graph arrays for ``graph.MemoryGraph(**arrays)``: one node type, one edge
    type, node weight 1.0, neighbors deduplicated in first-seen order with
    weight 1.0 (the JAX builder's ``{str(d): 1.0}`` dict), labels in dense
    slot 0 and ``standard_normal().round(3)`` features in slot 1."""
    rng = np.random.default_rng(seed)
    degrees = rng.poisson(avg_degree, num_nodes).clip(1, max_degree)
    nbr_rows = []
    labels = np.zeros((num_nodes, label_dim), np.float32)
    features = np.zeros((num_nodes, feature_dim), np.float32)
    for nid in range(num_nodes):
        nbrs = dict.fromkeys(
            rng.integers(0, num_nodes, degrees[nid]).tolist()
        )
        _draw_labels(rng, labels[nid], multilabel)
        features[nid] = rng.standard_normal(feature_dim).round(3)
        nbr_rows.append(np.fromiter(nbrs, np.int64, len(nbrs)))
    return _graph_arrays(nbr_rows, labels, features)


def powerlaw_degrees(
    num_nodes: int, num_edges: int, alpha: float, rng,
    d_min: int = 1, d_cap: int | None = None,
):
    """[num_nodes] int64 out-degrees from a discrete power law
    P(d) ~ d^-alpha (inverse-transform Pareto, d >= d_min, capped at
    ``d_cap`` or num_nodes/4), then scaled so the total lands within
    ~1% of ``num_edges``."""
    if alpha <= 1.0:
        raise ValueError(
            f"powerlaw_degrees needs alpha > 1 (got {alpha}): the "
            "inverse-transform exponent -1/(alpha-1) is undefined at 1 "
            "and flips sign below it (degenerating to all-d_min rows)"
        )
    if d_cap is None:
        d_cap = max(d_min + 1, num_nodes // 4)
    u = rng.random(num_nodes)
    d = d_min * (1.0 - u) ** (-1.0 / (alpha - 1.0))
    d = np.minimum(d, d_cap)
    # multiplicative rescale to the target edge count; iterate because
    # the cap bites harder as the scale grows
    for _ in range(16):
        total = d.sum()
        if abs(total - num_edges) <= 0.01 * num_edges:
            break
        d = np.minimum(np.maximum(d * (num_edges / total), d_min), d_cap)
    return np.maximum(d.round(), d_min).astype(np.int64)


def build_powerlaw(
    num_nodes: int,
    num_edges: int,
    feature_dim: int,
    label_dim: int,
    alpha: float = 1.8,
    multilabel: bool = False,
    seed: int = 17,
) -> dict:
    """Graph arrays of a heavy-tailed graph at a real edge budget, as
    ``build_synthetic``'s: power-law out-degrees (``powerlaw_degrees``)
    with targets drawn preferentially (p ~ degree), weights 1.0.

    Neighbors are unique per source. Rows below ``hub_degree`` draw,
    drop duplicates and redraw the shortfall (at most 8 rounds, then an
    overshoot is dropped uniformly by ``rng.choice``); hub rows take an
    exact weighted sample without replacement (the Gumbel top-k race).
    The RNG calls are the JAX builder's, in its order (its ``"hash"``
    placement), so one seed gives the same graph in both packages; rows
    come out sorted by id, as the engine returns them."""
    rng = np.random.default_rng(seed)
    degrees = powerlaw_degrees(num_nodes, num_edges, alpha, rng)
    # preferential targets: p ~ degree, drawn by inverse-CDF per node
    cum = np.cumsum(degrees.astype(np.float64))
    cum /= cum[-1]
    # past this degree redraw rounds stall on the taken heavy targets
    hub_degree = max(2048, num_nodes // 64)
    log_w = np.log(degrees.astype(np.float64))
    nbr_rows = []
    labels = np.zeros((num_nodes, label_dim), np.float32)
    features = np.zeros((num_nodes, feature_dim), np.float32)
    for nid in range(num_nodes):
        d = int(degrees[nid])
        if d >= hub_degree:
            # Gumbel keys on the log-weights, keep the d largest; uniforms
            # clipped away from 0 so log(0) never warns
            u = np.maximum(rng.random(num_nodes), np.finfo(np.float64).tiny)
            g = log_w - np.log(-np.log(u))
            nbrs = np.argpartition(g, num_nodes - d)[num_nodes - d:]
        else:
            nbrs = np.unique(np.searchsorted(cum, rng.random(d)))
            for _ in range(8):
                short = d - nbrs.size
                if short <= 0:
                    break
                extra = np.searchsorted(
                    cum, rng.random(short + short // 4 + 4)
                )
                nbrs = np.union1d(nbrs, extra)
            if nbrs.size > d:
                nbrs = rng.choice(nbrs, size=d, replace=False)
        _draw_labels(rng, labels[nid], multilabel)
        features[nid] = rng.standard_normal(feature_dim).round(3)
        nbr_rows.append(np.sort(nbrs))
    return _graph_arrays(nbr_rows, labels, features)


def _draw_labels(rng, row: np.ndarray, multilabel: bool) -> None:
    """One node's labels into ``row``, with the JAX builders' RNG call:
    a 0/1 draw per label, or one label index set to 1."""
    if multilabel:
        row[:] = rng.integers(0, 2, len(row))
    else:
        row[rng.integers(0, len(row))] = 1.0


def _graph_arrays(nbr_rows, labels, features) -> dict:
    """``graph.MemoryGraph`` arguments: one node type, one edge type, weights
    1.0, labels in dense slot 0 and features in slot 1."""
    num_nodes = len(nbr_rows)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum([len(r) for r in nbr_rows], out=indptr[1:])
    indices = (np.concatenate(nbr_rows) if num_nodes
               else np.zeros(0, np.int64))
    return {
        "indptr": indptr,
        "indices": indices,
        "weights": np.ones(len(indices), np.float32),
        "node_weights": np.ones(num_nodes, np.float32),
        "node_types": np.zeros(num_nodes, np.int32),
        "dense_features": [labels, features],
    }
