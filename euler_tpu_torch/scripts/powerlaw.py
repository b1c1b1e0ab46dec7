"""The hub-heavy synthetic graph the tools' smokes run on (the JAX
package's ``scripts/remote_bench.py`` fixture, node for node): zipf-ranked
destination draws, so the first few ids soak up most edge mass, as the
Reddit heavy tail does at a small size."""

from __future__ import annotations

import os

import numpy as np

NUM_PARTITIONS = 4

PL_META = {
    "node_type_num": 2,
    "edge_type_num": 2,
    "node_uint64_feature_num": 1,
    "node_float_feature_num": 1,
    "node_binary_feature_num": 0,
    "edge_uint64_feature_num": 0,
    "edge_float_feature_num": 0,
    "edge_binary_feature_num": 0,
}


def powerlaw_fixture_nodes(num_nodes: int, avg_degree: int,
                           feature_dim: int, alpha: float = 1.1,
                           seed: int = 7) -> list:
    """Node dicts of the hub-heavy graph: zipf(alpha)-ranked destination
    draws. Split from the ``.dat`` writer so the locality A/B
    (``heat_dump --ab-smoke``) can partition one node set two ways."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    nodes = []
    for nid in range(num_nodes):
        deg = max(1, int(rng.poisson(avg_degree)))
        dsts = rng.choice(num_nodes, size=deg, p=probs)
        groups: dict = {}
        for d in dsts:
            d = int(d)
            t = d % 2
            groups.setdefault(t, {})
            groups[t][d] = groups[t].get(d, 0.0) + 1.0
        nodes.append(
            {
                "node_id": nid,
                "node_type": nid % 2,
                "node_weight": 1.0,
                "neighbor": {
                    str(t): {str(d): w for d, w in g.items()}
                    for t, g in groups.items()
                },
                "uint64_feature": {"0": [nid]},
                "float_feature": {
                    "0": (np.arange(feature_dim) * 0.01 + nid * 0.001)
                    .astype(float).tolist()
                },
                "binary_feature": {},
                "edge": [
                    {
                        "src_id": nid, "dst_id": d, "edge_type": t,
                        "weight": w, "uint64_feature": {},
                        "float_feature": {}, "binary_feature": {},
                    }
                    for t, g in groups.items()
                    for d, w in g.items()
                ],
            }
        )
    return nodes


def build_powerlaw_fixture(directory: str, num_nodes: int, avg_degree: int,
                           feature_dim: int, alpha: float = 1.1,
                           seed: int = 7, placement: str = "hash") -> None:
    """Partition the hub-heavy graph into NUM_PARTITIONS ``.dat`` files
    (``placement="degree"`` adds the converter's placement file)."""
    from euler_tpu_torch.graph.convert import convert_dicts

    convert_dicts(
        powerlaw_fixture_nodes(num_nodes, avg_degree, feature_dim, alpha,
                               seed),
        PL_META, os.path.join(directory, "part"),
        num_partitions=NUM_PARTITIONS, placement=placement,
    )
