"""Synthetic benchmark graphs at the reference's scales, and the
preparation of real datasets already on disk (counterpart of
``euler_tpu/datasets.py``).

The port's copies of ``euler_tpu.datasets.build_synthetic``,
``build_powerlaw`` and ``build_planted``: the same numpy RNG calls in the
same order, so one seed gives the same graph in both packages. The first
two return the arrays that ``graph.MemoryGraph`` takes; ``build_ppi``,
``build_reddit`` and ``build_planted`` write the graphs as ``.dat``
partitions and ``meta.json`` for the engine client (``graph.Graph``),
byte for byte the JAX package's files. ``prepare_ppi`` (the GraphSAGE
release's files) and ``prepare_reddit`` (DGL's npz files) convert real
datasets the same way, and so does the CLI:

    python -m euler_tpu_torch.datasets ppi|reddit --out DIR
    python -m euler_tpu_torch.datasets prepare_ppi --prefix P --out DIR
    python -m euler_tpu_torch.datasets prepare_reddit --src DIR --out DIR

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


def planted_arrays(info: dict) -> dict:
    """``graph.MemoryGraph`` arrays of a ``build_planted`` graph from its
    ``info``: neighbors deduplicated in first-seen order (the JAX
    builder's dict), one-hot community labels in dense slot 0 and the
    features in slot 1."""
    communities = info["communities"]
    labels = np.zeros((len(communities), len(info["centroids"])),
                      np.float32)
    labels[np.arange(len(communities)), communities] = 1.0
    rows = [np.fromiter(dict.fromkeys(n.tolist()), np.int64)
            for n in info["neighbors"]]
    return _graph_arrays(rows, labels, info["features"])


def build_planted(
    out_dir: str,
    num_nodes: int = 2000,
    num_communities: int = 4,
    feature_dim: int = 16,
    avg_degree: int = 10,
    intra_p: float = 0.9,
    noise: float = 1.0,
    num_partitions: int = 2,
    max_degree: int = 30,
    seed: int = 11,
    alpha: float | None = None,
):
    """A planted-community graph, the convergence gate of supervised
    GNNs. Each node belongs to one of ``num_communities`` hidden
    communities: its label (dense slot 0, one-hot) is the community, its
    features (slot 1) the community's unit centroid plus ``noise`` *
    N(0, 1), and a share ``intra_p`` of its edges stays inside the
    community. Averaging a node's mostly-intra neighbours denoises its
    features, which is what a neighbourhood-aggregating GNN should learn;
    ``nearest_centroid_accuracy`` gives both separability bounds.
    Degrees are Poisson(avg_degree) in [1, max_degree], or with ``alpha``
    the power law of ``powerlaw_degrees`` capped at max_degree.

    Returns ``(out_dir, info)``: the graph written as ``.dat`` partitions
    and ``meta.json`` (cached by a ``done`` marker, as ``build_ppi``), and
    the generation arrays ``communities`` [N], ``features`` [N, F],
    ``centroids`` [K, F] and ``neighbors`` (an id array a node), drawn
    from the seed either way (``planted_arrays`` turns them into a
    ``MemoryGraph``'s)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((num_communities, feature_dim))
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    communities = rng.integers(0, num_communities, num_nodes)
    features = (centroids[communities]
                + noise * rng.standard_normal((num_nodes, feature_dim))
                ).astype(np.float32)
    by_comm = [np.flatnonzero(communities == c)
               for c in range(num_communities)]
    if alpha is None:
        degrees = rng.poisson(avg_degree, num_nodes).clip(1, max_degree)
    else:
        degrees = powerlaw_degrees(num_nodes, num_nodes * avg_degree, alpha,
                                   rng, d_cap=max_degree)
    neighbors = []
    for nid in range(num_nodes):
        d = degrees[nid]
        intra = rng.random(d) < intra_p
        own = by_comm[communities[nid]]
        neighbors.append(np.where(intra, own[rng.integers(0, len(own), d)],
                                  rng.integers(0, num_nodes, d)))
    info = dict(communities=communities, features=features,
                centroids=centroids, neighbors=neighbors)
    params = json.dumps(
        dict(kind="planted", num_nodes=num_nodes,
             num_communities=num_communities, feature_dim=feature_dim,
             avg_degree=avg_degree, intra_p=intra_p, noise=noise,
             num_partitions=num_partitions, max_degree=max_degree,
             seed=seed, alpha=alpha),
        sort_keys=True,
    )
    if _cache_begin(out_dir, params):
        return out_dir, info
    write_dat(planted_arrays(info), out_dir, num_partitions)
    _cache_finish(out_dir, params)
    return out_dir, info


def nearest_centroid_accuracy(info: dict, use_neighbors: bool) -> float:
    """The share of nodes whose feature vector (with ``use_neighbors``,
    averaged with its neighbours') is nearest its own community's
    centroid: the separability bound a convergence gate holds to."""
    feats = info["features"]
    if use_neighbors:
        agg = np.stack([(feats[nid] + feats[nbrs].sum(0)) / (1 + len(nbrs))
                        for nid, nbrs in enumerate(info["neighbors"])])
    else:
        agg = feats
    pred = np.argmax(agg @ info["centroids"].T, axis=1)
    return float(np.mean(pred == info["communities"]))


# ---------------------------------------------------------------------------
# Real datasets already on disk (the transform halves of the reference's
# examples/ppi_data.py and reddit_data.py, without the download): each
# writes meta.json, part_<p>.dat partitions and {train,val,test}.id files
# of graph node ids.
# ---------------------------------------------------------------------------

_REAL_META = {
    "node_type_num": 3,
    "edge_type_num": 1,
    "node_uint64_feature_num": 0,
    "node_float_feature_num": 2,  # 0 labels, 1 features
    "node_binary_feature_num": 0,
    "edge_uint64_feature_num": 0,
    "edge_float_feature_num": 0,
    "edge_binary_feature_num": 0,
}


def _write_graph(out_dir, meta, nodes_iter, id_lists, num_partitions):
    from euler_tpu_torch.graph.convert import convert_dicts

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    convert_dicts(nodes_iter, meta, os.path.join(out_dir, "part"),
                  num_partitions)
    # graph node ids, which evaluate and save_embedding query (the
    # reference writes the source's id_map values instead)
    for name, ids in zip(["train.id", "val.id", "test.id"], id_lists):
        with open(os.path.join(out_dir, name), "w") as f:
            f.writelines("%d\n" % i for i in ids)
    return out_dir


def _real_node(i, ntype, nbrs, etype_of, num_etypes, labels, feats) -> dict:
    """One node record of a prepared dataset: weight 1, its neighbours
    grouped by each of ``num_etypes`` edge types, labels in float slot 0,
    features in slot 1 and an edge record a neighbour."""
    return {
        "node_id": i,
        "node_type": ntype,
        "node_weight": 1,
        "neighbor": {
            str(t): {str(n): 1 for n in nbrs if etype_of(n) == t}
            for t in range(num_etypes)
        },
        "uint64_feature": {},
        "float_feature": {"0": labels, "1": feats},
        "binary_feature": {},
        "edge": [
            {"src_id": i, "dst_id": n, "edge_type": etype_of(n),
             "weight": 1, "uint64_feature": {}, "float_feature": {},
             "binary_feature": {}}
            for n in nbrs
        ],
    }


def prepare_ppi(prefix: str, out_dir: str, num_partitions: int = 1,
                normalize: bool = True) -> str:
    """GraphSAGE-format PPI on disk -> ``.dat`` partitions.

    Reads ``{prefix}-G.json`` (node-link, links index the nodes array),
    ``{prefix}-feats.npy``, ``{prefix}-id_map.json`` and
    ``{prefix}-class_map.json``. As the reference's
    examples/ppi_data.py: nodes without val/test annotations are
    dropped; node types are train 0, val 1, test 2; an edge touching a
    val or test node has type 1 ("train_removed"), others 0; features
    are standardized by the train split's statistics; float slot 0 is
    the multilabel class vector, slot 1 the features."""
    with open(prefix + "-G.json") as f:
        g = json.load(f)
    feats = np.load(prefix + "-feats.npy").astype(np.float64)
    with open(prefix + "-id_map.json") as f:
        id_map = {int(k): int(v) for k, v in json.load(f).items()}
    with open(prefix + "-class_map.json") as f:
        class_map = {int(k): v for k, v in json.load(f).items()}

    node_ids = [n["id"] for n in g["nodes"]]
    attrs = {n["id"]: n for n in g["nodes"]}
    adj: dict[int, set] = {i: set() for i in node_ids}
    for link in g["links"]:
        s, t = node_ids[link["source"]], node_ids[link["target"]]
        adj[s].add(t)
        adj[t].add(s)
    kept = [i for i in node_ids if "val" in attrs[i] and "test" in attrs[i]]
    kept_set = set(kept)

    def ntype(i):
        return 1 if attrs[i]["val"] else (2 if attrs[i]["test"] else 0)

    if normalize:
        train_rows = np.array([id_map[i] for i in kept if ntype(i) == 0],
                              dtype=np.int64)
        mean = feats[train_rows].mean(axis=0)
        std = feats[train_rows].std(axis=0)
        std[std == 0] = 1.0
        feats = (feats - mean) / std

    def nodes_iter():
        for i in kept:
            labels = class_map[i]
            labels = ([float(x) for x in labels] if isinstance(labels, list)
                      else [float(labels)])
            yield _real_node(
                i, ntype(i), [n for n in adj[i] if n in kept_set],
                lambda n, i=i: 1 if (ntype(i) or ntype(n)) else 0, 2,
                labels, feats[id_map[i]].tolist())

    ids = [[i for i in kept if ntype(i) == t] for t in range(3)]
    return _write_graph(out_dir, dict(_REAL_META, edge_type_num=2),
                        nodes_iter(), ids, num_partitions)


def prepare_reddit(data_dir: str, out_dir: str,
                   num_partitions: int = 1) -> str:
    """DGL's reddit npz files on disk -> ``.dat`` partitions.

    Reads ``{data_dir}/reddit_self_loop_graph.npz`` (a scipy CSR
    adjacency) and ``{data_dir}/reddit_data.npz`` (feature, node_ids,
    label, node_types). As the reference's examples/reddit_data.py: node
    type = node_types - 1 (train 0, val 1, test 2), every edge type 0,
    float slot 0 the one-hot label, slot 1 the features."""
    import scipy.sparse as sp

    graph = sp.load_npz(
        os.path.join(data_dir, "reddit_self_loop_graph.npz")).tocsr()
    data = np.load(os.path.join(data_dir, "reddit_data.npz"))
    feats = data["feature"]
    labels = data["label"].astype(np.int64)
    node_types = data["node_types"].astype(np.int64)
    num_nodes = graph.shape[0]
    num_classes = int(labels.max()) + 1

    def nodes_iter():
        indptr, indices = graph.indptr, graph.indices
        for i in range(num_nodes):
            onehot = [0.0] * num_classes
            onehot[int(labels[i])] = 1.0
            yield _real_node(
                i, int(node_types[i]) - 1,
                [int(n) for n in indices[indptr[i]:indptr[i + 1]]],
                lambda n: 0, 1, onehot, feats[i].tolist())

    ids = [[i for i in range(num_nodes) if node_types[i] - 1 == t]
           for t in range(3)]
    return _write_graph(out_dir, dict(_REAL_META), nodes_iter(), ids,
                        num_partitions)


def main(argv=None) -> None:
    """CLI: the synthetic builders and the real-data preparers.

    python -m euler_tpu_torch.datasets ppi|reddit --out DIR
    python -m euler_tpu_torch.datasets prepare_ppi --prefix P --out DIR
    python -m euler_tpu_torch.datasets prepare_reddit --src DIR --out DIR
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("cmd", choices=[
        "ppi", "reddit", "prepare_ppi", "prepare_reddit"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--prefix", help="GraphSAGE file prefix (prepare_ppi)")
    ap.add_argument("--src", help="DGL npz directory (prepare_reddit)")
    ap.add_argument("--partitions", type=int, default=1)
    args = ap.parse_args(argv)
    if args.cmd == "ppi":
        print(build_ppi(args.out, num_partitions=args.partitions))
    elif args.cmd == "reddit":
        print(build_reddit(args.out, num_partitions=args.partitions))
    elif args.cmd == "prepare_ppi":
        if not args.prefix:
            ap.error("prepare_ppi needs --prefix")
        print(prepare_ppi(args.prefix, args.out, args.partitions))
    else:
        if not args.src:
            ap.error("prepare_reddit needs --src")
        print(prepare_reddit(args.src, args.out, args.partitions))


if __name__ == "__main__":
    main()
