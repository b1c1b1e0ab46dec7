"""Synthetic benchmark graphs at the reference's scales, built in memory.

The port's copies of ``euler_tpu.datasets.build_synthetic`` and
``build_powerlaw``: the same numpy RNG calls in the same order, so one
seed gives the same graph in both packages. Where the JAX package writes
``.dat`` partitions for its C++ engine, these return the arrays that
``graph.Graph`` takes.

Layout convention (matches the examples' training flags): dense feature
slot 0 = labels (multi-/one-hot), slot 1 = input features.
"""

from __future__ import annotations

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


def build_synthetic(
    num_nodes: int,
    avg_degree: int,
    feature_dim: int,
    label_dim: int,
    multilabel: bool = True,
    max_degree: int = 60,
    seed: int = 7,
) -> dict:
    """Graph arrays for ``graph.Graph(**arrays)``: one node type, one edge
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
    """``graph.Graph`` arguments: one node type, one edge type, weights
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
