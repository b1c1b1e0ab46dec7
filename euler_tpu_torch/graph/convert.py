"""JSON graph → binary .dat partition converter.

Produces the same length-prefixed block format as the reference tooling
(format spec derived from the reference's euler/tools/json2dat.py:40-175 and
the Java partitioned converter tools/graph_data_parser/GraphDataParser.java:85),
so fixtures and datasets interoperate in both directions. Partitioning follows
the reference convention by default: node_id % num_partitions ->
``<prefix>_<p>.dat``. ``placement='degree'`` swaps in a greedy
degree-descending placer that co-locates hub vertices with their sampled
neighborhoods under a balance cap and emits a compact
``<prefix>.placement`` artifact (id -> partition; format in
eg_placement.h) that shards serve to clients over the kPlacement wire op
— the locality-aware half of ROADMAP item 5 (PERF.md "Locality").

Input: one JSON object per line::

    {"node_id": 1, "node_type": 0, "node_weight": 1.0,
     "neighbor": {"0": {"2": 1.0}},          # edge_type -> {dst: weight}
     "uint64_feature": {"0": [1, 2]},        # slot -> values
     "float_feature": {"0": [0.5]},
     "binary_feature": {"0": "ab"},
     "edge": [{"src_id": 1, "dst_id": 2, "edge_type": 0, "weight": 1.0,
               "uint64_feature": {}, "float_feature": {},
               "binary_feature": {}}]}

plus a meta.json declaring type/slot counts (node_type_num, edge_type_num,
node_uint64_feature_num, node_float_feature_num, node_binary_feature_num and
the three edge_* equivalents).
"""

from __future__ import annotations

import json
import struct
from typing import IO

# Balance slack of the degree-aware partitioner: no partition may hold
# more than ceil(slack * N / P) nodes, so locality can never collapse
# every hub neighborhood into one shard (the load-balance half of the
# GNNSampler/FastSample trade-off).
PLACEMENT_SLACK = 1.2


def _pack_features(record: dict, slot_nums: dict[str, int]) -> bytes:
    """Pack the u64/f32/binary feature sections shared by node and edge
    records: for each kind, ``i32 slot_num, i32 sizes[slot_num], values``."""
    out = []
    for kind, fmt_char in (("uint64", "Q"), ("float", "f"), ("binary", "s")):
        nslots = slot_nums[kind]
        slots = record.get(kind + "_feature", {}) or {}
        sizes = []
        values = []
        for i in range(nslots):
            v = slots.get(str(i), [] if kind != "binary" else "")
            if kind == "binary":
                b = v.encode() if isinstance(v, str) else bytes(v)
                sizes.append(len(b))
                values.append(b)
            else:
                sizes.append(len(v))
                values.extend(v)
        out.append(struct.pack("<i%di" % nslots, nslots, *sizes))
        if kind == "binary":
            out.append(b"".join(values))
        else:
            out.append(struct.pack("<%d%s" % (len(values), fmt_char), *values))
    return b"".join(out)


def _pack_edge(edge: dict, meta: dict) -> bytes:
    slot_nums = {
        "uint64": int(meta["edge_uint64_feature_num"]),
        "float": int(meta["edge_float_feature_num"]),
        "binary": int(meta["edge_binary_feature_num"]),
    }
    head = struct.pack(
        "<QQif",
        int(edge["src_id"]),
        int(edge["dst_id"]),
        int(edge["edge_type"]),
        float(edge["weight"]),
    )
    return head + _pack_features(edge, slot_nums)


def pack_block(node: dict, meta: dict) -> bytes:
    """Serialize one node line into a framed block."""
    edge_type_num = int(meta["edge_type_num"])
    neighbor = node.get("neighbor", {}) or {}
    group_sizes = []
    group_weights = []
    nbr_ids = []
    nbr_ws = []
    for t in range(edge_type_num):
        group = neighbor.get(str(t), {}) or {}
        group_sizes.append(len(group))
        group_weights.append(float(sum(group.values())))
        for dst, w in group.items():
            nbr_ids.append(int(dst))
            nbr_ws.append(float(w))

    slot_nums = {
        "uint64": int(meta["node_uint64_feature_num"]),
        "float": int(meta["node_float_feature_num"]),
        "binary": int(meta["node_binary_feature_num"]),
    }
    node_rec = b"".join(
        [
            struct.pack(
                "<Qifi",
                int(node["node_id"]),
                int(node["node_type"]),
                float(node["node_weight"]),
                edge_type_num,
            ),
            struct.pack("<%di" % edge_type_num, *group_sizes),
            struct.pack("<%df" % edge_type_num, *group_weights),
            struct.pack("<%dQ" % len(nbr_ids), *nbr_ids),
            struct.pack("<%df" % len(nbr_ws), *nbr_ws),
            _pack_features(node, slot_nums),
        ]
    )

    edges = [_pack_edge(e, meta) for e in node.get("edge", [])]
    edge_sizes = [len(e) for e in edges]
    # block_bytes counts everything after itself: the node_info_bytes field,
    # the node record, the edge_num field, the edge size list, and the edges.
    block_bytes = 4 + len(node_rec) + 4 + 4 * len(edges) + sum(edge_sizes)
    return b"".join(
        [
            struct.pack("<ii", block_bytes, len(node_rec)),
            node_rec,
            struct.pack("<i%di" % len(edges), len(edges), *edge_sizes),
            b"".join(edges),
        ]
    )


def degree_placement(
    nodes: list[dict],
    num_partitions: int,
    slack: float = PLACEMENT_SLACK,
) -> dict[int, int]:
    """Greedy degree-descending placement: node_id -> partition.

    Hubs (highest total degree: out-edges plus the in-edges the reverse
    adjacency reveals) are placed first and spread across partitions by
    load; every later node lands in the partition where the most of its
    already-placed neighborhood edge mass lives, under the balance cap
    ceil(slack * N / P). On power-law graphs this co-locates each
    low-degree node with the hub(s) it points at, which is where nearly
    all of its sampled hops go — the edge-cut win hash sharding cannot
    see (GNNSampler arXiv:2108.11571, FastSample arXiv:2311.17847).
    """
    # adjacency as (neighbor, weight) in BOTH directions: a node's
    # sampled hops follow its out-edges, but a hub's affinity must also
    # count the many nodes pointing AT it
    adj: dict[int, list[tuple[int, float]]] = {}
    degree: dict[int, float] = {}
    for node in nodes:
        u = int(node["node_id"])
        adj.setdefault(u, [])
        degree.setdefault(u, 0.0)
        for group in (node.get("neighbor", {}) or {}).values():
            for dst, w in (group or {}).items():
                v, w = int(dst), float(w)
                adj[u].append((v, w))
                adj.setdefault(v, []).append((u, w))
                degree[u] = degree.get(u, 0.0) + w
                degree[v] = degree.get(v, 0.0) + w
    order = sorted(
        (int(n["node_id"]) for n in nodes),
        key=lambda u: (-degree.get(u, 0.0), u),
    )
    n_nodes = len(nodes)
    cap = max(1, -(-int(n_nodes * slack) // num_partitions))
    load = [0] * num_partitions
    placed: dict[int, int] = {}
    for u in order:
        score = [0.0] * num_partitions
        for v, w in adj.get(u, ()):
            p = placed.get(v)
            if p is not None:
                score[p] += w
        best, best_key = -1, None
        for p in range(num_partitions):
            if load[p] >= cap:
                continue
            key = (score[p], -load[p])  # affinity first, then balance
            if best_key is None or key > best_key:
                best, best_key = p, key
        if best < 0:  # every partition at cap (slack rounding): spill
            best = min(range(num_partitions), key=lambda p: load[p])
        placed[u] = best
        load[best] += 1
    return placed


def write_placement(
    path: str, placed: dict[int, int], num_partitions: int
) -> None:
    """Serialize a placement map into the compact artifact the shards
    serve (kPlacement) and clients route by — format pinned by the
    native parser (eg_placement.h): ``EGP1 | i32 P | i64 count |
    u64 ids[count] | i32 parts[count]``, little-endian."""
    import numpy as np

    ids = np.fromiter(placed.keys(), dtype=np.int64,
                      count=len(placed)).view(np.uint64)
    parts = np.fromiter(placed.values(), dtype=np.int32, count=len(placed))
    order = np.argsort(ids)
    with open(path, "wb") as f:
        f.write(b"EGP1")
        f.write(struct.pack("<iq", num_partitions, len(placed)))
        f.write(ids[order].tobytes())
        f.write(parts[order].tobytes())


def _check_partitions(num_partitions: int) -> None:
    if num_partitions < 1:
        raise ValueError(
            f"num_partitions must be >= 1, got {num_partitions} (0 or "
            "negative would write no .dat files at all)"
        )


def _check_placement(placement: str) -> None:
    if placement not in ("hash", "degree"):
        raise ValueError(
            f"placement must be 'hash' (node_id % P, the default) or "
            f"'degree' (greedy hub co-location + placement artifact), "
            f"got {placement!r}"
        )


def _write_partitions(
    nodes: list[dict],
    meta: dict,
    output_prefix: str,
    num_partitions: int,
    placement: str,
) -> list[str]:
    """Shared writer: route every node block to its partition (hash or
    placement map), rejecting duplicate node_ids LOUDLY — a duplicate
    would silently overwrite the row in whichever partition wins, and
    under placement routing could even land the two copies on different
    shards."""
    placed = (
        degree_placement(nodes, num_partitions)
        if placement == "degree"
        else None
    )
    paths = ["%s_%d.dat" % (output_prefix, p) for p in range(num_partitions)]
    outs: list[IO[bytes]] = [open(p, "wb") for p in paths]
    seen: set[int] = set()
    try:
        for node in nodes:
            nid = int(node["node_id"])
            if nid in seen:
                raise ValueError(
                    f"duplicate node_id {nid} in input — each node must "
                    "appear exactly once (a duplicate would overwrite "
                    "the earlier row in whichever partition wins)"
                )
            seen.add(nid)
            p = placed[nid] if placed is not None else nid % num_partitions
            outs[p].write(pack_block(node, meta))
    finally:
        for o in outs:
            o.close()
    if placed is not None:
        write_placement(
            output_prefix + ".placement", placed, num_partitions
        )
    return paths


def convert(
    meta_path: str,
    input_path: str,
    output_prefix: str,
    num_partitions: int = 1,
    placement: str = "hash",
) -> list[str]:
    """Convert a JSON-lines graph into ``num_partitions`` .dat files.

    ``placement='degree'`` replaces hash partitioning with the greedy
    degree-descending placement (hub neighborhoods co-located under a
    balance cap) and writes the ``<prefix>.placement`` artifact next to
    the partitions; shards serve it and clients route by it
    (eg_placement.h). The whole graph is held in memory for the
    placement pass — for hash partitioning too, since duplicate-id
    validation needs the full id set anyway and fixture-scale inputs
    dominate this path.

    Returns the list of written partition paths.
    """
    _check_partitions(num_partitions)
    _check_placement(placement)
    with open(meta_path) as f:
        meta = json.load(f)
    nodes = []
    with open(input_path) as f:
        for line in f:
            line = line.strip()
            if line:
                nodes.append(json.loads(line))
    return _write_partitions(
        nodes, meta, output_prefix, num_partitions, placement
    )


def convert_dicts(
    nodes: list[dict],
    meta: dict,
    output_prefix: str,
    num_partitions: int = 1,
    placement: str = "hash",
) -> list[str]:
    """Like :func:`convert` but from in-memory dicts (used by tests and the
    synthetic benchmark generator)."""
    _check_partitions(num_partitions)
    _check_placement(placement)
    return _write_partitions(
        nodes, meta, output_prefix, num_partitions, placement
    )


# ---- snapshot-epoch delta files (eg_epoch.h) ----
# `<prefix>.delta.<n>` carries one graph refresh: removed node ids,
# removed edge keys, and a standard .dat block stream of added/replaced
# records (full replacement — GraphStore::Build's first-occurrence-wins
# dedup makes the newest delta authoritative when stagings merge
# newest-first). Layout, all little-endian, array = i64 count + raw
# elements (WireWriter::Arr), string = i64 length + bytes:
#   "EGD1" [u32 version=1] [u64 seq]
#   [arr u64 removed_nodes]
#   [arr u64 rme_src] [arr u64 rme_dst] [arr i32 rme_type]
#   [str dat_blob]


def pack_delta(
    seq: int,
    removed_nodes: list[int],
    removed_edges: list[tuple[int, int, int]],
    dat_blob: bytes,
) -> bytes:
    """Serialize one delta payload (format above). ``removed_edges`` are
    (src, dst, edge_type) keys; ``dat_blob`` a .dat block stream of the
    added/replaced node records."""

    def arr(fmt: str, vals) -> bytes:
        vals = list(vals)
        return struct.pack("<q", len(vals)) + struct.pack(
            "<%d%s" % (len(vals), fmt), *vals
        )

    u64 = lambda v: int(v) & 0xFFFFFFFFFFFFFFFF  # noqa: E731
    return b"".join(
        [
            b"EGD1",
            struct.pack("<IQ", 1, int(seq)),
            arr("Q", (u64(v) for v in removed_nodes)),
            arr("Q", (u64(e[0]) for e in removed_edges)),
            arr("Q", (u64(e[1]) for e in removed_edges)),
            arr("i", (int(e[2]) for e in removed_edges)),
            struct.pack("<q", len(dat_blob)),
            dat_blob,
        ]
    )


def _index_nodes(nodes: list[dict], label: str) -> dict[int, dict]:
    """Index nodes by id, rejecting duplicates LOUDLY — a duplicate in a
    delta input is a contradictory edit (two different replacement rows
    for one node; whichever won would be arbitrary)."""
    out: dict[int, dict] = {}
    for node in nodes:
        nid = int(node["node_id"])
        if nid in out:
            raise ValueError(
                f"duplicate node_id {nid} in {label} input — a delta "
                "must carry exactly one replacement record per node"
            )
        out[nid] = node
    return out


def _edge_keys(node: dict, label: str) -> set[tuple[int, int, int]]:
    """The (src, dst, type) edge-record keys of one node, rejecting
    duplicates — two records for one key is a contradictory edit (their
    weights/features could differ and one would silently win)."""
    keys: set[tuple[int, int, int]] = set()
    for e in node.get("edge", []) or []:
        k = (int(e["src_id"]), int(e["dst_id"]), int(e["edge_type"]))
        if k in keys:
            raise ValueError(
                f"duplicate edge record {k} in {label} input — a delta "
                "must carry exactly one record per (src, dst, type)"
            )
        keys.add(k)
    return keys


def make_delta(
    old_nodes: list[dict], new_nodes: list[dict], meta: dict
) -> tuple[list[int], list[tuple[int, int, int]], bytes]:
    """Diff two JSON-lines snapshots into one delta payload:
    (removed_nodes, removed_edges, dat_blob).

    Changed nodes are detected by canonical block bytes (pack_block), so
    a reordered-but-identical JSON line emits nothing. Edge-record
    removals are emitted only for edges entirely gone from a surviving
    node — a modified edge rides the node's replacement record instead
    (removing AND re-adding one key is the contradiction the native
    Validate rejects). Removed nodes drop their own edge records
    native-side (endpoint removal), so no keys are emitted for them."""
    old = _index_nodes(old_nodes, "old")
    new = _index_nodes(new_nodes, "new")
    removed_nodes = sorted(set(old) - set(new))
    removed_edges: list[tuple[int, int, int]] = []
    blocks: list[bytes] = []
    for nid in sorted(new):
        nb = pack_block(new[nid], meta)
        if nid not in old:
            blocks.append(nb)
            continue
        ob = pack_block(old[nid], meta)
        gone = sorted(
            _edge_keys(old[nid], "old") - _edge_keys(new[nid], "new")
        )
        removed_edges.extend(gone)
        if ob != nb:
            blocks.append(nb)
    return removed_nodes, removed_edges, b"".join(blocks)


def convert_delta(
    meta_path: str,
    old_input_path: str,
    new_input_path: str,
    output_prefix: str,
    seq: int = 1,
) -> str:
    """Diff two JSON-lines graphs into ``<output_prefix>.delta.<seq>``
    (the refresh payload shards merge and flip to; eg_epoch.h). Raises
    on duplicate/contradictory edits. Returns the written path."""

    def read_lines(path: str) -> list[dict]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    with open(meta_path) as f:
        meta = json.load(f)
    removed_nodes, removed_edges, blob = make_delta(
        read_lines(old_input_path), read_lines(new_input_path), meta
    )
    path = "%s.delta.%d" % (output_prefix, int(seq))
    with open(path, "wb") as f:
        f.write(pack_delta(seq, removed_nodes, removed_edges, blob))
    return path


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("meta", help="meta.json path")
    ap.add_argument("input", help="JSON-lines graph path")
    ap.add_argument("output_prefix", help="output prefix; writes <prefix>_<p>.dat")
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--placement", choices=("hash", "degree"),
                    default="hash", help=(
                        "partitioning rule: 'hash' = node_id %% P "
                        "(reference convention); 'degree' = greedy hub "
                        "co-location + a <prefix>.placement artifact "
                        "shards serve to clients (locality-aware "
                        "routing, ROADMAP item 5)"))
    ap.add_argument("--delta-from", default=None, metavar="OLD_INPUT", help=(
        "emit a snapshot-epoch delta instead of partitions: diff "
        "OLD_INPUT (the currently-served JSON-lines graph) against "
        "INPUT (the refreshed one) into <output_prefix>.delta.<seq> — "
        "the payload `service --load_delta` / Graph.load_delta merge "
        "and flip to (eg_epoch.h). Duplicate or contradictory edits "
        "are rejected loudly"))
    ap.add_argument("--delta-seq", type=int, default=1, help=(
        "sequence number of the emitted delta (deltas apply in seq "
        "order; name and header both carry it)"))
    args = ap.parse_args()
    if args.delta_from is not None:
        print(convert_delta(args.meta, args.delta_from, args.input,
                            args.output_prefix, seq=args.delta_seq))
        return
    for p in convert(args.meta, args.input, args.output_prefix,
                     args.partitions, placement=args.placement):
        print(p)


if __name__ == "__main__":
    main()
