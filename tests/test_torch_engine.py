"""The port's copy of the graph engine and its client against the JAX
package's, on the same ``.dat`` files written into ``tmp_path`` from a
numpy seed.

Reads (counts, types, weights, neighbors, dense, sparse and binary
features, nodes and edges) must be equal. Samples must be bit-equal after
the same ``eg_seed`` in both libraries: the engine's RNG is thread-local
and ``eg_seed`` seeds the calling thread's, and its OpenMP loops fan out
above fixed sizes (``n * count > 2048`` for neighbor draws,
``n * walk_len > 512`` for walks, ``n > 64`` for typed negatives,
``eg_engine.cc``), after which draws land on other threads' RNGs. Every
call here stays under those sizes, so each runs on the calling thread.
The first test to load the port's engine builds it (about 15 s); the
rest of the file takes a few seconds.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import euler_tpu  # noqa: E402
from euler_tpu import datasets as jdatasets  # noqa: E402
from euler_tpu.graph.convert import convert_dicts as jconvert_dicts  # noqa: E402,E501
from euler_tpu.graph import native as jnative  # noqa: E402

from euler_tpu_torch import datasets as tdatasets  # noqa: E402
from euler_tpu_torch.graph import Graph, MemoryGraph  # noqa: E402
from euler_tpu_torch.graph import convert as tconvert  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 300
META = {
    "node_type_num": 3,
    "edge_type_num": 2,
    "node_uint64_feature_num": 2,
    "node_float_feature_num": 2,
    "node_binary_feature_num": 1,
    "edge_uint64_feature_num": 1,
    "edge_float_feature_num": 1,
    "edge_binary_feature_num": 1,
}


def _nodes(seed: int) -> list:
    """N nodes of 3 types with 2 edge types (weights in [0.1, 2], some
    rows empty), two dense slots, two sparse slots of 0-4 values, a binary
    slot, and one edge record per neighbor with features of each kind."""
    rng = np.random.default_rng(seed)
    nodes = []
    for nid in range(N):
        neighbor, edges = {}, []
        for t in range(2):
            dst = rng.integers(0, N, rng.poisson(4))
            w = rng.uniform(0.1, 2.0, len(dst)).round(3)
            group = {str(int(d)): float(x) for d, x in zip(dst, w)}
            neighbor[str(t)] = group
            for d, x in group.items():
                edges.append({
                    "src_id": nid, "dst_id": int(d), "edge_type": t,
                    "weight": x,
                    "uint64_feature": {"0": [nid * 1000 + int(d)]},
                    "float_feature": {"0": [x, -x]},
                    "binary_feature": {"0": f"e{nid}-{d}"},
                })
        nodes.append({
            "node_id": nid,
            "node_type": int(rng.integers(0, 3)),
            "node_weight": round(float(rng.uniform(0.5, 3.0)), 3),
            "neighbor": neighbor,
            "uint64_feature": {
                str(k): rng.integers(0, 50, rng.integers(0, 5)).tolist()
                for k in range(2)},
            "float_feature": {"0": rng.standard_normal(4).round(3).tolist(),
                              "1": rng.standard_normal(3).round(3).tolist()},
            "binary_feature": {"0": f"n{nid}" * int(rng.integers(1, 4))},
            "edge": edges,
        })
    return nodes


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """The JAX engine and the port's over one seeded graph's ``.dat``
    files (two partitions), written by the port's copy of the converter;
    the JAX converter's files are byte-identical."""
    nodes = _nodes(0)
    d = tmp_path_factory.mktemp("het")
    j = tmp_path_factory.mktemp("het_jax")
    tconvert.convert_dicts(nodes, META, str(d / "part"), 2)
    jconvert_dicts(nodes, META, str(j / "part"), 2)
    for p in range(2):
        assert filecmp.cmp(d / f"part_{p}.dat", j / f"part_{p}.dat",
                           shallow=False)
    jg, tg = euler_tpu.Graph(directory=str(d)), Graph(directory=str(d))
    yield jg, tg, nodes
    jg.close()
    tg.close()


def _eq(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, bytes):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


IDS = np.array([0, 5, 17, 299, 300, -1, 42, 42], np.int64)  # unknowns too


def test_reads_equal_jax(graphs):
    """Counts, types, weights, type weight sums, full and top-k
    neighbors, and every feature kind of nodes and edges."""
    jg, tg, nodes = graphs
    assert tg.num_nodes == jg.num_nodes == N
    assert tg.num_edges == jg.num_edges
    assert (tg.node_type_num, tg.edge_type_num) == (3, 2)
    for kind in range(6):
        assert tg.feature_num(kind) == jg.feature_num(kind)
    for edges in (False, True):
        _eq(tg.type_weight_sums(edges), jg.type_weight_sums(edges))
    _eq(tg.node_types(IDS), jg.node_types(IDS))
    _eq(tg.node_weights(IDS), jg.node_weights(IDS))
    for srt in (False, True):
        for et in ([0], [1], [1, 0]):
            _eq(tg.get_full_neighbor(IDS, et, sorted=srt),
                jg.get_full_neighbor(IDS, et, sorted=srt))
    _eq(tg.get_top_k_neighbor(IDS, [0, 1], 3, default_node=301),
        jg.get_top_k_neighbor(IDS, [0, 1], 3, default_node=301))
    _eq(tg.get_dense_feature(IDS, [1, 0, 7], [2, 4, 3]),
        jg.get_dense_feature(IDS, [1, 0, 7], [2, 4, 3]))
    _eq(tg.get_sparse_feature(IDS, [0, 1]), jg.get_sparse_feature(IDS, [0, 1]))
    _eq(tg.get_binary_feature(IDS, [0]), jg.get_binary_feature(IDS, [0]))
    src, dst = np.array([0, 0, 5, 9], np.int64), np.zeros(4, np.int64)
    typ = np.zeros(4, np.int32)
    for i, s in enumerate(src):
        e = nodes[int(s)]["edge"]
        if e:
            dst[i], typ[i] = e[0]["dst_id"], e[0]["edge_type"]
    args = (src, dst, typ, [0])
    _eq(tg.get_edge_dense_feature(*args, [2]),
        jg.get_edge_dense_feature(*args, [2]))
    _eq(tg.get_edge_sparse_feature(*args), jg.get_edge_sparse_feature(*args))
    _eq(tg.get_edge_binary_feature(*args), jg.get_edge_binary_feature(*args))


@pytest.mark.parametrize("seed", [1, 12345])
def test_samples_bit_equal_after_the_same_seed(graphs, seed):
    """sample_neighbor, sample_fanout, sample_node (typed and not),
    sample_edge, sample_node_with_src and random_walk (plain and biased),
    each after the same eg_seed in both libraries."""
    jg, tg, _ = graphs
    jl, tl = jnative.lib(), tnative.lib()
    roots = np.random.default_rng(seed).integers(-2, N + 2, 20)
    calls = [
        lambda g: g.sample_neighbor(roots, [0, 1], 7, default_node=N),
        lambda g: g.sample_fanout(roots, [[0], [0, 1]], [4, 5], N),
        lambda g: g.sample_node(200, -1),
        lambda g: g.sample_node(200, 2),
        lambda g: g.sample_edge(100, 1),
        lambda g: g.sample_node_with_src(roots, 3),
        lambda g: g.random_walk(roots, [0, 1], 5),
        lambda g: g.random_walk(roots, [[0], [1], [0, 1]], p=0.5, q=2.0,
                                default_node=N),
    ]
    for i, call in enumerate(calls):
        jl.eg_seed(seed + i)
        want = call(jg)
        tl.eg_seed(seed + i)
        _eq(call(tg), want)


def test_two_libraries_keep_their_own_state(graphs):
    """Both engines live in one process, each with its own RNG: draws
    through one do not move the other's stream, and the port's library is
    a file of its own under build/euler_tpu_torch/native."""
    jg, tg, _ = graphs
    jl, tl = jnative.lib(), tnative.lib()
    jl.eg_seed(7)
    tl.eg_seed(8)
    a1 = jg.sample_node(50)
    b1 = tg.sample_node(50)
    tg.sample_node(50)
    jl.eg_seed(7)
    assert np.array_equal(jg.sample_node(50), a1)
    jg.sample_node(50)
    tl.eg_seed(8)
    assert np.array_equal(tg.sample_node(50), b1)
    assert not np.array_equal(a1, b1)
    with open("/proc/self/maps") as f:
        maps = f.read()
    port = tnative.library_path()
    assert port in maps
    assert os.path.realpath(jnative._LIB_PATH) != os.path.realpath(port)
    assert os.sep.join(["build", "euler_tpu_torch", "native"]) in port


def test_build_ppi_writes_the_jax_files(tmp_path):
    """datasets.build_ppi writes .dat files, meta.json and the done
    marker byte-identical to the JAX builder's with the same arguments;
    a second call finds its cache."""
    j, t = tmp_path / "jax", tmp_path / "port"
    kw = dict(num_nodes=2000, feature_dim=12, label_dim=5)
    jdatasets.build_ppi(str(j), **kw)
    assert tdatasets.build_ppi(str(t), **kw) == str(t)
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(t))
    assert "part_3.dat" in names and "meta.json" in names
    for n in names:
        assert filecmp.cmp(j / n, t / n, shallow=False), n
    stamp = os.path.getmtime(t / "part_0.dat")
    tdatasets.build_ppi(str(t), **kw)
    assert os.path.getmtime(t / "part_0.dat") == stamp


def test_tables_from_the_engine_equal_the_memory_graph(tmp_path):
    """Slabs, the root sampler and the feature and label tables built
    from the engine over build_ppi's files equal those built from
    MemoryGraph over the same seed's arrays."""
    kw = dict(num_nodes=1500, avg_degree=15, feature_dim=6, label_dim=4)
    tdatasets.build_ppi(str(tmp_path), **kw)
    eng = Graph(directory=str(tmp_path))
    mem = MemoryGraph(**tdatasets.build_synthetic(**kw))
    max_id = kw["num_nodes"] - 1
    assert eng.num_nodes == mem.num_nodes
    for build in (tdev.build_adjacency, tdev.build_alias_adjacency):
        a, b = build(eng, [0], max_id), build(mem, [0], max_id)
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
    a, b = (tdev.build_node_sampler(g, 0, max_id) for g in (eng, mem))
    for k in a:
        _eq(a[k], b[k])
    m = SupervisedGraphSage(
        label_idx=0, label_dim=4, metapath=[[0], [0]], fanouts=[3, 3],
        dim=8, feature_idx=1, feature_dim=6, max_id=max_id,
        device_features=True, device_sampling=True)
    ca, cb = m.build_consts(eng, "cpu"), m.build_consts(mem, "cpu")
    for k in ("features", "labels"):
        assert torch.equal(ca[k], cb[k])
    for k in ca["adj"]["et0"]:
        assert torch.equal(ca["adj"]["et0"][k], cb["adj"]["et0"][k])
    eng.close()


@pytest.mark.parametrize("kw", [
    {"mode": "remote"}, {"mode": "shared"}, {"stream": True},
    {"feature_cache_mb": 64}, {"placement": True}, {"delta": ["x"]},
    {"registry": "tcp://localhost:1"},
])
def test_local_mode_only_options_raise(graphs, tmp_path, kw):
    """On a local graph (here over an empty directory) each option raises
    what the JAX client raises: a remote graph without a registry, mode
    'shared', the remote client's keys, and a load of no partitions
    (``stream=`` of a local directory included: it loads the files as
    they are). A missing delta file raises in both, and an unknown
    keyword is a TypeError."""
    with pytest.raises(Exception) as jerr:
        euler_tpu.Graph(directory=str(tmp_path), **kw)
    with pytest.raises(type(jerr.value)) as terr:
        Graph(directory=str(tmp_path), **kw)
    assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]
    for g in graphs[:2]:
        with pytest.raises(RuntimeError):
            g.load_delta(str(tmp_path / "x.delta.1"))
    with pytest.raises(TypeError, match="unexpected keyword"):
        Graph(directory=str(tmp_path), no_such_option=1)


NATIVE_DIRS = (os.path.join(ROOT, "euler_tpu", "graph", "_native"),
               os.path.join(ROOT, "euler_tpu_torch", "graph", "_native"))
# the comment lines the copy words without the reference's paths and
# PR numbers; every other line is the reference's
COPY_EDITED_COMMENTS = 5


def _sources(d: str) -> list:
    return sorted(n for n in os.listdir(d) if n.endswith((".cc", ".h")))


def test_engine_copy_is_the_reference_but_five_comment_lines():
    """The port's engine sources are the JAX package's, file for file and
    code line for code line: only the five comment lines the copy edited
    differ (its Makefile, which builds out of tree, is not compared)."""
    ref, port = NATIVE_DIRS
    assert _sources(port) == _sources(ref)
    differing = []
    for name in _sources(ref):
        with open(os.path.join(ref, name)) as f:
            a = f.read().splitlines()
        with open(os.path.join(port, name)) as f:
            b = f.read().splitlines()
        assert len(a) == len(b), name
        differing += [(name, x, y) for x, y in zip(a, b) if x != y]
    assert len(differing) == COPY_EDITED_COMMENTS, differing
    for name, x, y in differing:
        assert x.lstrip().startswith("//") and y.lstrip().startswith(
            "//"), (name, x, y)


def test_bindings_match_the_jax_bindings():
    """Each ``_sig(L.name, ...)`` of the port's ``graph/native.py`` gives
    the function the JAX binding's restype and argtypes."""
    import ast

    with open(tnative.__file__) as f:
        tree = ast.parse(f.read())
    names = sorted({
        node.args[0].attr for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") ==
        "_sig" and isinstance(node.args[0], ast.Attribute)})
    assert len(names) >= 36
    # training's observability families are bound too
    assert {"eg_phase_record", "eg_phase_gauge", "eg_devprof_set_mem",
            "eg_blackbox_init", "eg_blackbox_enabled",
            "eg_blackbox_set_enabled", "eg_blackbox_reset",
            "eg_blackbox_json", "eg_blackbox_history", "eg_blackbox_dump",
            "eg_blackbox_record"} <= set(names)
    tlib, jlib = tnative.lib(), jnative.lib()
    for name in names:
        t, j = getattr(tlib, name), getattr(jlib, name)
        assert t.restype == j.restype, name
        assert t.argtypes == j.argtypes and j.argtypes is not None, name


def test_write_dat_carries_uint64_slots(tmp_path):
    """``datasets.write_dat`` writes a MemoryGraph's sparse slots as uint64
    features: the engine reads back each node's values and types."""
    arrays = tdatasets.build_synthetic(50, 3, 4, 2, seed=2)
    ptr = np.concatenate([[0], np.cumsum(np.arange(50) % 3)])
    values = np.arange(ptr[-1]) * 7
    arrays = dict(arrays, node_types=(np.arange(50) % 4).astype(np.int32),
                  sparse_features=[(ptr, values)])
    tdatasets.write_dat(arrays, str(tmp_path), num_partitions=2)
    eng = Graph(directory=str(tmp_path))
    mem = MemoryGraph(**arrays)
    ids = np.arange(-1, 52)
    for g_vals, m_vals in zip(eng.get_sparse_feature(ids, [0]),
                              mem.get_sparse_feature(ids, [0])):
        for a, b in zip(g_vals, m_vals):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(eng.node_types(ids), mem.node_types(ids))
    eng.close()
