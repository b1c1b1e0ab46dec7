"""Remote and shared graphs of the port against the JAX package's, on a
module-scoped cluster of two shards of each package's ``GraphService``
over ``tests/fixture_graph.py``'s graph (four partitions).

The engine is one copy, so both packages speak one wire protocol: the
port's client reads the JAX shards and the JAX client reads the port's,
and every deterministic read (types, weights, full and top-k
neighbours, features of every kind) must equal the local engine's and
the JAX remote client's, in both directions. Draws run on the shards'
thread-local RNGs, which no client seed reaches, so they are held by
distribution with the JAX tests' own thresholds (``tests/
test_remote.py``). RNGs, heat and registries are per library, but the
engine's counters, span timers and failpoints live in function-local
statics that the linker makes unique across the process (``nm -D``
lists ``eg::Counters::Global()::c``, ``eg::Stats::Global()::s`` and
``eg::FaultInjector::Global()::f`` as ``u``), so with both libraries
loaded they are one ledger: a test reads it through the port's
``graph.native`` and holds no count of one library apart from the
other's.

Services bind port 0 and are read back; every wait is bounded; clients
close before their services.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import euler_tpu  # noqa: E402
from euler_tpu import heat as jheat  # noqa: E402
from euler_tpu import telemetry as JT  # noqa: E402
from euler_tpu.graph import registry as jregistry  # noqa: E402
from euler_tpu.graph.service import GraphService as JService  # noqa: E402

from euler_tpu_torch import heat as theat  # noqa: E402
from euler_tpu_torch import run_loop  # noqa: E402
from euler_tpu_torch import telemetry as T  # noqa: E402
from euler_tpu_torch.graph import Graph, GraphService  # noqa: E402
from euler_tpu_torch.graph import native, registry  # noqa: E402
from euler_tpu_torch.graph.convert import make_delta, pack_delta  # noqa: E402,E501
from euler_tpu_torch.parallel import pipeline  # noqa: E402
from tests.fixture_graph import (FIXTURE_META, TOPOLOGY,  # noqa: E402
                                 fixture_nodes, write_fixture)

NUM_SHARDS = 2
NUM_PARTITIONS = 4
IDS = np.array(sorted(TOPOLOGY) * 2 + [999, -1], dtype=np.int64)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The port's and the JAX package's shards over one data directory,
    a local port graph, and three remote clients: the port's over its own
    shards (``tt``) and over the JAX shards (``tj``), and the JAX
    client over the port's shards (``jt``); ``jj`` is the JAX client
    over the JAX shards, the reference."""
    data = str(tmp_path_factory.mktemp("remote_data"))
    write_fixture(data, num_partitions=NUM_PARTITIONS)
    reg_t = str(tmp_path_factory.mktemp("reg_torch"))
    reg_j = str(tmp_path_factory.mktemp("reg_jax"))
    tsvc = [GraphService(data, s, NUM_SHARDS, registry=reg_t)
            for s in range(NUM_SHARDS)]
    jsvc = [JService(data, s, NUM_SHARDS, registry=reg_j)
            for s in range(NUM_SHARDS)]
    c = {
        "data": data, "reg_t": reg_t, "tsvc": tsvc,
        "local": Graph(directory=data),
        "tt": Graph(mode="remote", registry=reg_t),
        "tj": Graph(mode="remote", registry=reg_j),
        "jt": euler_tpu.Graph(mode="remote", registry=reg_t),
        "jj": euler_tpu.Graph(mode="remote", registry=reg_j),
    }
    yield c
    for k in ("local", "tt", "tj", "jt", "jj"):
        c[k].close()
    for s in tsvc + jsvc:
        s.drain()
        s.stop()


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


def _edges(g):
    """Every edge of the fixture, as the local graph lists them."""
    src = np.repeat(np.array(sorted(TOPOLOGY)),
                    [sum(len(x) for x in TOPOLOGY[i][2].values())
                     for i in sorted(TOPOLOGY)])
    dst = np.array([d for i in sorted(TOPOLOGY)
                    for t in sorted(TOPOLOGY[i][2])
                    for d in TOPOLOGY[i][2][t]])
    typ = np.array([t for i in sorted(TOPOLOGY)
                    for t in sorted(TOPOLOGY[i][2])
                    for _ in TOPOLOGY[i][2][t]])
    return src, dst, typ


READS = {
    "meta": lambda g: (g.num_nodes, g.num_edges, g.node_type_num,
                       g.edge_type_num, g.type_weight_sums(),
                       g.type_weight_sums(edges=True)),
    "node_types": lambda g: g.node_types(IDS),
    "node_weights": lambda g: g.node_weights(IDS),
    "full_neighbor": lambda g: g.get_full_neighbor(IDS, [0, 1]),
    "full_neighbor_sorted": lambda g: g.get_full_neighbor(IDS, [0, 1],
                                                          sorted=True),
    "top_k": lambda g: g.get_top_k_neighbor(IDS, [0, 1], 3),
    "dense": lambda g: g.get_dense_feature(IDS, [0, 1, 2], [2, 3, 3]),
    "sparse": lambda g: g.get_sparse_feature(IDS, [0, 1]),
    "binary": lambda g: g.get_binary_feature(IDS, [0]),
    "edge_dense": lambda g: g.get_edge_dense_feature(*_edges(g), [0], [1]),
    "edge_sparse": lambda g: g.get_edge_sparse_feature(*_edges(g), [0]),
    "edge_binary": lambda g: g.get_edge_binary_feature(*_edges(g), [0]),
}


@pytest.mark.parametrize("client", ["tt", "tj", "jt"])
@pytest.mark.parametrize("read", sorted(READS))
def test_deterministic_reads_equal_local_and_jax(cluster, read, client):
    """Each deterministic read of a remote client, over either package's
    shards, equals the local engine's and the JAX remote client's over
    the JAX shards, value and dtype."""
    got = READS[read](cluster[client])
    _eq(got, READS[read](cluster["local"]))
    _eq(got, READS[read](cluster["jj"]))


def test_discovery_and_routing(cluster):
    """Two shards over four partitions; ``shard_of`` routes each id to
    exactly one shard, ``(id % P) % S`` without a placement map, equal
    to the JAX client's routing; the shards' registry entries."""
    tt, jt = cluster["tt"], cluster["jt"]
    assert (tt.num_shards, tt.num_partitions) == (NUM_SHARDS,
                                                  NUM_PARTITIONS)
    assert not tt.has_placement and tt.has_placement == jt.has_placement
    assert [tt.num_replicas(s) for s in range(NUM_SHARDS)] == [1, 1]
    ids = np.array(sorted(TOPOLOGY))
    route = tt.shard_of(ids)
    np.testing.assert_array_equal(route, (ids % NUM_PARTITIONS) % NUM_SHARDS)
    np.testing.assert_array_equal(route, jt.shard_of(ids))
    owned = [set(ids[route == s]) for s in range(NUM_SHARDS)]
    assert set().union(*owned) == set(ids) and sum(map(len, owned)) == 7
    assert sorted(f.split("#")[0] for f in os.listdir(cluster["reg_t"])) \
        == ["0", "1"]
    local = cluster["local"]
    assert (local.num_shards, local.num_partitions, local.cache_gen,
            local.has_placement, local.num_replicas(0)) == (1, 1, 0, False,
                                                            1)
    for fn in (lambda: local.shard_of(ids), lambda: local.shard_epoch(0)):
        with pytest.raises(ValueError, match="mode='remote'"):
            fn()


def _weights():
    return {nid: w for nid, (t, w, _) in TOPOLOGY.items()}


def _node_dist(g):
    n = 40000
    ids = np.asarray(g.sample_node(n, -1))
    total = sum(_weights().values())
    for nid, w in _weights().items():
        assert (ids == nid).sum() / n == pytest.approx(w / total, abs=0.02)
    types = {nid: t for nid, (t, _, _) in TOPOLOGY.items()}
    assert all(types[int(i)] == 0 for i in g.sample_node(2000, 0))


def _edge_dist(g):
    src, dst, t = (np.asarray(x) for x in g.sample_edge(20000, -1))
    for s, d, ty in zip(src[:200], dst[:200], t[:200]):
        assert int(d) in TOPOLOGY[int(s)][2][int(ty)]
    ew = {(s, d, ty): w for s, (_, _, groups) in TOPOLOGY.items()
          for ty, nbrs in groups.items() for d, w in nbrs.items()}
    total = sum(ew.values())
    for (s, d, ty), w in ew.items():
        freq = ((src == s) & (dst == d) & (t == ty)).mean()
        assert freq == pytest.approx(w / total, abs=0.02)


def _typed_negatives(g):
    src = np.array([10, 11, 12, 13], dtype=np.int64)
    out = np.asarray(g.sample_node_with_src(src, 64))
    types = {nid: t for nid, (t, _, _) in TOPOLOGY.items()}
    for i, s in enumerate(src):
        assert all(types[int(x)] == types[int(s)] for x in out[i])


def _neighbors(nid):
    return set().union(*[set(x) for x in TOPOLOGY[nid][2].values()])


def _neighbor_members(g):
    ids = np.array([10, 12, 14, 16] * 8, dtype=np.int64)
    nbr, w, t = g.sample_neighbor(ids, [0, 1], 4)
    for i, nid in enumerate(ids):
        assert set(np.asarray(nbr)[i].tolist()) <= (_neighbors(int(nid))
                                                     or {-1})


def _walks(g):
    ids = np.array([10, 12, 14, 16] * 4, dtype=np.int64)
    for p, q in [(1.0, 1.0), (4.0, 0.25)]:
        w = np.asarray(g.random_walk(ids, [0, 1], 4, p=p, q=q))
        assert w.shape == (len(ids), 5)
        np.testing.assert_array_equal(w[:, 0], ids)
        for row in w:
            for a, b in zip(row[:-1], row[1:]):
                if a >= 0 and b >= 0:
                    assert int(b) in _neighbors(int(a)), (a, b)


def _fanout_shapes(g):
    hop_ids, hop_w, _ = g.sample_fanout(np.array([10, 12, 16]),
                                        [[0, 1], [0, 1]], [3, 2])
    assert [len(h) for h in hop_ids] == [3, 9, 18]
    assert [len(w) for w in hop_w] == [9, 18]


DRAWS = {"sample_node": _node_dist, "sample_edge": _edge_dist,
         "sample_node_with_src": _typed_negatives,
         "sample_neighbor": _neighbor_members, "random_walk": _walks,
         "sample_fanout": _fanout_shapes}


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_draws_pass_the_jax_thresholds(cluster, draw):
    """The port's client over the port's shards draws by weight across
    shards within the JAX tests' bounds (frequencies within 0.02 of the
    weights' shares), typed draws stay in type, picks and walk steps
    are real edges, fanouts have their shapes."""
    DRAWS[draw](cluster["tt"])


def _truth(local, ids, etypes):
    nbr, w, t, counts = local.get_full_neighbor(ids, etypes)
    out, off = {}, 0
    for src, c in zip(ids, counts):
        out[int(src)] = {int(d): (float(x), int(y)) for d, x, y in zip(
            nbr[off:off + c], w[off:off + c], t[off:off + c])}
        off += c
    return out


def test_async_fanout_deterministic_parts_equal_sync(cluster):
    """``sample_fanout_async``'s handle polls to done and takes once; its
    shapes, root hop, per-edge weights and types, membership and default
    fills meet the sync path's contract against the local graph; on the
    forced rows (one candidate or none) async and sync are bit-equal."""
    tt, local = cluster["tt"], cluster["local"]
    roots = np.array([10, 12, 14, 15, 16, 999] * 4, dtype=np.int64)
    metapath, fanouts = [[0, 1], [0, 1]], [3, 2]
    sync = tt.sample_fanout(roots, metapath, fanouts)
    handle = tt.sample_fanout_async(roots, metapath, fanouts)
    deadline = time.monotonic() + 30
    while not handle.poll():
        assert time.monotonic() < deadline, "async fanout never completed"
        time.sleep(0.001)
    out = handle.take()
    with pytest.raises(RuntimeError, match="twice"):
        handle.take()
    for hop_ids, hop_w, hop_t in (sync, out):
        assert [len(x) for x in hop_ids] == [24, 72, 144]
        np.testing.assert_array_equal(hop_ids[0], roots)
        frontier = roots
        for h, fan in enumerate(fanouts):
            dst = hop_ids[h + 1].reshape(len(frontier), fan)
            w = hop_w[h].reshape(len(frontier), fan)
            t = hop_t[h].reshape(len(frontier), fan)
            truth = _truth(local, frontier, metapath[h])
            for i, src in enumerate(frontier):
                row = truth.get(int(src), {})
                for j in range(fan):
                    if not row:  # dead end or default: default fill
                        assert dst[i, j] == -1 and w[i, j] == 0.0
                        continue
                    tw, tty = row[int(dst[i, j])]
                    assert w[i, j] == np.float32(tw) and t[i, j] == tty
            frontier = dst.reshape(-1)
    forced = np.array([11, 13, 14, 15], dtype=np.int64)
    s_ids, s_w, _ = tt.sample_neighbor(forced, [0], 4)
    a_ids, a_w, _ = tt.sample_fanout_async(forced, [[0]], [4]).take()
    np.testing.assert_array_equal(a_ids[1].reshape(4, 4), s_ids)
    np.testing.assert_array_equal(a_w[0].reshape(4, 4), s_w)
    assert cluster["local"].sample_fanout_async(forced, [[0]], [4]) is None


def test_pipeline_yields_steps_in_order_and_raises_at_its_step():
    """``pipeline`` keeps ``depth`` submits ahead, finishes in order, and
    raises a failing step's exception at that step."""
    live, peak = [0], [0]
    lock = threading.Lock()

    def start_fn(step):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        return step * 10

    def finish_fn(step, pending):
        time.sleep(0.001 * (step % 3))
        with lock:
            live[0] -= 1
        if step == 7:
            raise KeyError("step 7")
        return {"step": step, "pending": pending}

    timings = {}
    got = []
    with pytest.raises(KeyError, match="step 7"):
        for b in pipeline(start_fn, finish_fn, 10, depth=3, start=2,
                          timings=timings):
            got.append(b)
    assert got == [{"step": s, "pending": s * 10} for s in range(2, 7)]
    assert 1 <= peak[0] <= 3
    # the failing step was waited for too
    assert len(timings["input_stall"]) == 6 and len(timings["sample"]) == 5


def test_train_samples_a_remote_graph_through_the_pipeline(cluster):
    """On a remote graph ``train.train`` draws through ``pipeline``
    (SupervisedGraphSage's async fanout, counted ``async_submits``); its
    input-stall history covers it; a local graph keeps prefetch."""
    from euler_tpu_torch import train
    from euler_tpu_torch.models import SupervisedGraphSage

    model = SupervisedGraphSage(
        label_idx=2, label_dim=3, metapath=[[0, 1], [0, 1]], fanouts=[3, 2],
        dim=8, feature_idx=0, feature_dim=2, max_id=16)
    roots = np.array(sorted(TOPOLOGY), dtype=np.int64)
    before = native.counters()["async_submits"]
    for name, submits in (("tt", 4), ("local", 0)):
        _, hist = train.train(model, cluster[name], lambda step: roots, 4,
                              log_every=2, device="cpu",
                              log_fn=lambda m: None)
        assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
        assert all(h["input_stall_ms"] >= 0 for h in hist)
        now = native.counters()["async_submits"]
        assert now - before == submits, name
        before = now


def test_registry_lifecycles(tmp_path, cluster):
    """A flat-file entry lives as long as its shard; a TCP registry lists
    a shard and drops it on drain; ``parse_tcp_url`` and ``query`` agree
    with the JAX package's; an unreachable registry raises."""
    reg = tmp_path / "reg"
    reg.mkdir()
    svc = GraphService(cluster["data"], 0, 1, registry=str(reg))
    files = os.listdir(reg)
    assert len(files) == 1 and files[0] == f"0#127.0.0.1_{svc.port}"
    svc.stop()
    assert os.listdir(reg) == []
    for url in ("tcp://h:1", "tcp://10.0.0.1:9100", "/a/dir"):
        assert registry.parse_tcp_url(url) == jregistry.parse_tcp_url(url)
    for bad in ("tcp://h", "tcp://:1", "tcp://h:x"):
        with pytest.raises(ValueError):
            registry.parse_tcp_url(bad)
    with registry.RegistryServer(host="127.0.0.1", port=0) as rs:
        assert rs.port > 0 and rs.address == f"tcp://127.0.0.1:{rs.port}"
        assert registry.query(rs.address) == {}
        svc = GraphService(cluster["data"], 1, 2, registry=rs.address)
        try:
            want = {1: [svc.address]}
            deadline = time.monotonic() + 10
            while registry.query(rs.address) != want:
                assert time.monotonic() < deadline, "never registered"
                time.sleep(0.05)
            assert jregistry.query(rs.address) == want
        finally:
            svc.drain()
            svc.stop()
        assert registry.query(rs.address) == {}
        port = rs.port
    with pytest.raises(ConnectionError):
        registry.query(f"tcp://127.0.0.1:{port}", timeout_ms=200)


HEAT_TOPS = [
    [{"id": i, "count": int(1e6 * r ** -1.4), "err": 0}
     for i, r in enumerate(range(1, 65))],
    [{"id": 1, "count": 10, "err": 0}, {"id": 2, "count": 5, "err": 0},
     {"id": 3, "count": 1, "err": 0}],
    [{"id": 1, "count": 50, "err": 7}, {"id": 2, "count": 9, "err": 2}],
]


@pytest.mark.parametrize("top", range(len(HEAT_TOPS)))
def test_heat_pure_functions_equal_jax(top):
    t = HEAT_TOPS[top]
    total = sum(e["count"] for e in t) + 17
    assert theat.zipf_fit(t) == jheat.zipf_fit(t)
    for cap in (0, 1, 2, 100):
        assert theat.cache_hit_ceiling(t, total, cap) == \
            jheat.cache_hit_ceiling(t, total, cap)
    data = {"topk": {"client": t, "server": []}, "sketch": {
        "width": 1024, "total": {"client": total, "server": 0}}}
    for side in ("client", "server"):
        assert theat.topk_share(data, side) == jheat.topk_share(data, side)
    assert theat.cms_epsilon(data) == jheat.cms_epsilon(data)
    assert (theat.SIDES, theat.OP_NAMES) == (jheat.SIDES, jheat.OP_NAMES)


def _shape(x):
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()
                if k not in ("hist", "stats", "ids", "counters")}
    if isinstance(x, list):
        return ["list"]
    return type(x).__name__


def test_scrape_ping_spans_and_metrics_shapes_equal_jax(cluster):
    """``scrape``, ``ping``, ``slow_spans`` and ``metrics_text(graph=)``
    from the port's client read the port's shards in the shape the JAX
    client reads them; the shard-labelled families match; heat over the
    wire, the local heat surface, the span journal and the span-timer
    stats answer."""
    tt, jt = cluster["tt"], cluster["jt"]
    tt.node_types(IDS)
    for s in range(NUM_SHARDS):
        assert T.ping(tt, s) and JT.ping(jt, s)
        a, b = T.scrape(tt, s), JT.scrape(jt, s)
        assert _shape(a) == _shape(b)
        assert set(a["counters"]) == set(b["counters"])
        assert a["gauges"]["workers"] == b["gauges"]["workers"] > 0
        sa, sb = T.slow_spans(tt, s), JT.slow_spans(jt, s)
        assert all(isinstance(x["trace"], int) for x in sa + sb)
        assert [sorted(x) for x in sa[:1]] == [sorted(x) for x in sb[:1]]
        assert theat.heat_json(tt, s)["topk"].keys() == \
            jheat.heat_json(jt, s)["topk"].keys()
    fam = [{line.split("{")[0].split(" ")[0]
            for line in text.splitlines() if 'shard="1"' in line}
           for text in (T.metrics_text(graph=tt),
                        JT.metrics_text(graph=jt))]
    assert fam[0] == fam[1] and "eg_counter_total" in fam[0]
    assert T.metrics_text(graph=tt, shard=0).count('shard="1"') == 0
    T.record_span(123456, side="client", outcome=1)
    assert any(s["total_us"] == 123456 for s in T.slow_spans())
    T.set_slow_capacity(64)
    assert "eg_remote" not in native.stats() or native.stats()
    assert theat.heat_json()["topk"].keys() == {"client", "server"}
    assert isinstance(theat.heat_topk(tt, 0, side="server"), list)
    assert theat.estimate(10) >= 0


def test_failpoint_fires_and_is_counted(cluster):
    """``fault=`` installs a failpoint through the port's client: its
    fires show in ``fault_injected`` (one ledger with the JAX library's
    in this process, see the module docstring), retries absorb them, and
    clearing stops them."""
    native.fault_clear()
    g = Graph(mode="remote", registry=cluster["reg_t"], retries=8,
              backoff_ms=1, fault="send_frame:err@0.3", fault_seed=5)
    try:
        for _ in range(10):
            np.testing.assert_array_equal(
                g.node_types(IDS), cluster["local"].node_types(IDS))
        fired = native.fault_injected()["send_frame"]
        assert fired > 0
        assert euler_tpu.fault_injected()["send_frame"] == fired
    finally:
        native.fault_clear()
        g.close()
    assert native.fault_injected()["send_frame"] == 0
    with pytest.raises(ValueError):
        native.fault_config("no_such_point:err@1")
    with pytest.raises(ValueError, match="fault= applies"):
        Graph(directory=cluster["data"], fault="dial:err@1")


def _retarget_14(nodes):
    """Node 14's one type-0 edge moves from 15 to 16 (one candidate
    before and after, so its draws are forced)."""
    n14 = next(n for n in nodes if n["node_id"] == 14)
    n14["neighbor"]["0"] = {"16": 2.0}
    for e in n14["edge"]:
        if e["edge_type"] == 0 and e["dst_id"] == 15:
            e["dst_id"] = 16
            e["uint64_feature"] = {"0": [14 * 100 + 16]}
            e["binary_feature"] = {"0": "e14-16"}
    return nodes


def test_load_delta_bumps_shard_epoch_and_cache_gen(tmp_path):
    """A delta merged by each shard flips its epoch; the client learns it
    (``shard_epoch``, ``epoch``, ``cache_gen``) and reads the new edge; a
    local graph's ``delta=`` and ``load_delta`` give the same graph."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    write_fixture(data, num_partitions=2)
    rm_n, rm_e, blob = make_delta(fixture_nodes(),
                                  _retarget_14(fixture_nodes()),
                                  FIXTURE_META)
    dpath = str(tmp_path / "part.delta.1")
    with open(dpath, "wb") as f:
        f.write(pack_delta(1, rm_n, rm_e, blob))
    svcs = [GraphService(data, s, 2) for s in range(2)]
    g = Graph(mode="remote", shards=[s.address for s in svcs])
    try:
        ids = np.array([14, 14], dtype=np.int64)
        assert g.sample_neighbor(ids, [0], 2)[0].tolist() == [[15, 15]] * 2
        gen0 = g.cache_gen
        with pytest.raises(ValueError, match="shard="):
            g.load_delta(dpath)
        for s in range(2):
            assert g.load_delta(dpath, shard=s) == 1
            assert svcs[s].epoch == 1
        g.sample_neighbor(ids, [0], 2)
        assert [g.shard_epoch(s) for s in range(2)] == [1, 1]
        assert g.epoch() == 1 and g.cache_gen > gen0
        assert g.sample_neighbor(ids, [0], 2)[0].tolist() == [[16, 16]] * 2
    finally:
        g.close()
        for s in svcs:
            s.stop()
    local = Graph(directory=data)
    merged = Graph(directory=data, delta=dpath)
    try:
        assert (local.epoch(), merged.epoch()) == (0, 1)
        with pytest.raises(ValueError, match="shard= applies"):
            local.load_delta(dpath, shard=0)
        assert local.load_delta(dpath) == 1
        for g2 in (local, merged):
            assert g2.get_full_neighbor([14], [0])[0].tolist() == [16]
    finally:
        local.close()
        merged.close()


def _cli(data, ck, *extra):
    # 17 ids at batch 5: 3 steps an epoch
    return ["--data_dir", data, "--model_dir", ck, "--max_id", "16",
            "--feature_idx", "0", "--feature_dim", "2", "--label_idx", "2",
            "--label_dim", "3", "--train_edge_type", "0,1",
            "--all_edge_type", "0,1", "--fanouts", "3,2", "--dim", "8",
            "--batch_size", "5", "--num_epochs", "1", "--log_steps", "1",
            *extra]


@pytest.mark.parametrize("mode", ["remote", "remote_shards",
                                  "remote_device_sampling", "shared_file",
                                  "shared_tcp"])
def test_run_loop_graph_modes(cluster, tmp_path, mode):
    """``--graph_mode remote`` (registry or ``--shards``) and ``shared``
    (a flat-file registry, or ``tcp://`` hosted here on a free port)
    train 3 CPU steps, evaluate and export; a shared run's shard and
    registry are gone after it."""
    ck = str(tmp_path / "ck")
    reg = str(tmp_path / "reg")
    os.makedirs(reg)
    extra = {
        "remote": ["--graph_mode", "remote", "--registry",
                   cluster["reg_t"]],
        "remote_shards": ["--graph_mode", "remote", "--shards", ",".join(
            s.address for s in cluster["tsvc"])],
        # the device tables are built from the remote graph's reads, as
        # the JAX CLI builds them
        "remote_device_sampling": ["--graph_mode", "remote", "--registry",
                                   cluster["reg_t"], "--device_sampling",
                                   "1"],
        "shared_file": ["--graph_mode", "shared", "--registry", reg],
        "shared_tcp": ["--graph_mode", "shared", "--registry",
                       "tcp://127.0.0.1:0"],
    }[mode]
    for m in ("train", "evaluate", "save_embedding"):
        assert run_loop.main(_cli(cluster["data"], ck, "--mode", m, *extra),
                             device="cpu") == 0
    assert os.path.exists(os.path.join(ck, "eval.json"))
    assert np.load(os.path.join(ck, "embedding.npy")).shape == (17, 8)
    assert os.listdir(reg) == []


@pytest.mark.parametrize("extra,err,match", [
    (["--graph_mode", "remote"], ValueError, "registry= or shards="),
    (["--graph_mode", "shared"], ValueError, "needs --registry"),
    (["--graph_mode", "remote", "--registry", "gs://bucket/reg"],
     NotImplementedError, "registry on a remote filesystem"),
    (["--fault", "dial:err@1"], ValueError, "--fault needs"),
    (["--feature_cache_mb", "8"], ValueError, "need --graph_mode"),
    (["--graph_mode", "shared", "--registry", "tcp://127.0.0.1:0",
      "--num_processes", "2", "--process_id", "1"], ValueError,
     "needs the registry's port"),
    (["--graph_mode", "remote", "--stream", "1"], ValueError,
     "--stream is only supported with --graph_mode=local"),
])
def test_run_loop_refusals(cluster, tmp_path, extra, err, match):
    """The JAX CLI's refusals, with its messages: ``--stream`` only on a
    local graph (remote clients read no graph data). A shared cluster
    over several processes needs the registry's port, which process 0
    hosts."""
    with pytest.raises(err, match=match):
        run_loop.main(_cli(cluster["data"], str(tmp_path), *extra),
                      device="cpu")


# a scheme no fsspec driver serves: gcsfs may be installed, and a gs://
# URL would then reach for the network
NO_DRIVER = "definitelynotascheme9://bucket/ppi"


@pytest.mark.parametrize("make", [
    lambda G, S, d, c: G(directory=NO_DRIVER),
    lambda G, S, d, c: G(directory=d, stream=True),
    lambda G, S, d, c: G(directory=d, cache_dir=c),
    lambda G, S, d, c: S(NO_DRIVER),
])
def test_staged_data_raises_naming_a0e(cluster, tmp_path, make):
    """Staged-data options as the JAX client takes them: a URL whose
    scheme has no fsspec driver raises its RuntimeError, naming the
    driver, for a graph and for a shard; a local directory loads the
    same graph with ``stream=`` (its files read into memory) or
    ``cache_dir=`` (unused: nothing to stage) as without them."""
    cache = str(tmp_path / "cache")
    try:
        jg = make(euler_tpu.Graph, JService, cluster["data"], cache)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match="no fsspec driver") as terr:
            make(Graph, GraphService, cluster["data"], cache)
        assert str(terr.value) == str(e)
        return
    tg = make(Graph, GraphService, cluster["data"], cache)
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges)
    assert tg.num_nodes == 7
    assert not os.path.exists(cache)
    tg.close()
    jg.close()


def test_file_urls_config_strings_and_lazy_init(cluster):
    """``file://`` paths load as plain ones; ``config=`` strings and files
    give keywords (explicit ones win); ``init="lazy"`` connects at first
    use and a closed graph stays closed."""
    data = cluster["data"]
    g = Graph(directory="file://" + data)
    assert g.num_nodes == 7
    g.close()
    with GraphService("file://" + data, 0, 1) as svc:
        g = Graph(config=f"mode=remote;shards={svc.address};retries=2",
                  init="lazy")
        assert g._handle is None
        _eq(g.node_types(IDS), cluster["local"].node_types(IDS))
        g.close()
        with pytest.raises(RuntimeError, match="closed"):
            g.node_types(IDS)
    with pytest.raises(ValueError, match="unknown config keys"):
        Graph(config="timout_ms=5")


def test_serving_over_a_remote_graph_follows_a_delta(tmp_path):
    """``EmbedServer`` over a remote graph: served rows equal
    ``embed_direct``; a delta on the shards moves ``cache_gen``, the
    blocks cached before it are evicted (``epoch_stale_hits_evicted``)
    and drawn again, and rows served afterwards equal ``embed_direct``
    on the new graph."""
    from euler_tpu_torch import serve, train
    from euler_tpu_torch.models import SupervisedGraphSage

    data = str(tmp_path / "data")
    os.makedirs(data)
    write_fixture(data, num_partitions=2)
    rm_n, rm_e, blob = make_delta(fixture_nodes(),
                                  _retarget_14(fixture_nodes()),
                                  FIXTURE_META)
    dpath = str(tmp_path / "part.delta.1")
    with open(dpath, "wb") as f:
        f.write(pack_delta(1, rm_n, rm_e, blob))
    svcs = [GraphService(data, s, 2) for s in range(2)]
    g = Graph(mode="remote", shards=[s.address for s in svcs])
    server = None
    try:
        model = SupervisedGraphSage(
            label_idx=2, label_dim=3, metapath=[[0, 1], [0, 1]],
            fanouts=[3, 2], dim=8, feature_idx=0, feature_dim=2, max_id=16)
        state = model.init_state(g, train.get_optimizer("adam", 0.01),
                                 device="cpu")
        server = serve.EmbedServer(model, g, state, max_batch=8).start()
        ids = [14, 10, 16, 14]

        def check():
            rows = server.embed(ids)
            for nid, row in zip(ids, rows):
                np.testing.assert_array_equal(row, server.embed_direct(nid))

        check()
        gen = g.cache_gen
        assert all(server._cache[i][0] == gen for i in ids)
        native.reset_counters()
        for s in range(2):
            g.load_delta(dpath, shard=s)
        g.node_types(IDS)  # the replies carry the new epoch
        assert g.cache_gen > gen
        check()
        # the 3 cached blocks, and the client's native cache entries,
        # which count into the same ledger
        assert native.counters()["epoch_stale_hits_evicted"] >= 3
        assert all(server._cache[i][0] == g.cache_gen for i in ids)
    finally:
        if server is not None:
            server.close()
        g.close()
        for s in svcs:
            s.stop()
