"""The port's embedding serving (``euler_tpu_torch/serve.py``,
``serving/``, ``telemetry.py``) against the JAX package's, on the
shared fixture graph, on the CPU.

Blocks come from each package's engine under the same id-derived
``eg_seed`` and must be equal array for array; the JAX model's
``init_state(PRNGKey(3))`` parameters go into the port's module through
``convert.params_from_flax``, and ``embed_direct`` must then agree within
float32 tolerance (rtol 1e-5, atol 1e-6). Served rows must equal the
port's own ``embed_direct`` bit for bit. Every thread join, socket and
subprocess wait here is bounded.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from euler_tpu import serve as jserve  # noqa: E402
from euler_tpu import telemetry as JT  # noqa: E402
from euler_tpu.graph import native as jnative  # noqa: E402
from euler_tpu.models import SupervisedGraphSage as JSage  # noqa: E402
from euler_tpu.serving import EmbedClient as JClient  # noqa: E402
from euler_tpu.serving import SLOTracker as JSLOTracker  # noqa: E402
from euler_tpu.train import get_optimizer as jget_optimizer  # noqa: E402

from euler_tpu_torch import devprof, run_loop, serve  # noqa: E402
from euler_tpu_torch import telemetry as T  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from euler_tpu_torch.convert import params_from_flax  # noqa: E402
from euler_tpu_torch.graph import Graph  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage as TSage  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from euler_tpu_torch.serving import (  # noqa: E402
    BusyError,
    DeadlineError,
    EmbedClient,
    EmbedFrontend,
    MicroBatcher,
    SLOTracker,
)
from tests.fixture_graph import TOPOLOGY  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 10.0  # every thread join here is bounded by this

SAGE_KW = dict(label_idx=2, label_dim=3, metapath=[[0, 1], [0, 1]],
               fanouts=[3, 2], dim=8, feature_idx=0, feature_dim=2,
               max_id=16)


@pytest.fixture(autouse=True)
def _clean_slate():
    tnative.reset_counters()
    T.telemetry_reset()
    T.set_telemetry(True)
    yield
    tnative.reset_counters()
    T.telemetry_reset()
    T.set_telemetry(True)


@pytest.fixture(scope="module")
def tgraph(fixture_dir):
    g = Graph(directory=fixture_dir)
    yield g
    g.close()


@pytest.fixture(scope="module")
def jstate(graph):
    return JSage(**SAGE_KW).init_state(
        jax.random.PRNGKey(3), graph, np.arange(8),
        jget_optimizer("adam", 0.01))


def _port_state(model, tgraph, jstate):
    st = model.init_state(tgraph, ttrain.get_optimizer("adam", 0.01),
                          device="cpu")
    st["module"].load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate["params"])))
    return st


def _server(tgraph, jstate, **kw):
    model = TSage(**SAGE_KW)
    opts = dict(max_batch=8, max_wait_us=2000, queue_cap=16, slo_ms=500.0)
    opts.update(kw)
    return serve.EmbedServer(model, tgraph,
                             _port_state(model, tgraph, jstate), **opts)


@pytest.fixture()
def server(tgraph, jstate):
    srv = _server(tgraph, jstate).start()
    yield srv
    srv.close()


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "thread did not finish in time"


# ---------------------------------------------------------------- (a), (b)


@pytest.mark.parametrize("seed", [0, 1, 42, 7_777_777, 2 ** 63 - 1])
def test_id_seed_matches_jax(seed):
    ids = [0, 1, 10, 16, 56_943, 2 ** 32 + 5, 2 ** 62, -1]
    assert [serve._id_seed(seed, i) for i in ids] == [
        jserve._id_seed(seed, i) for i in ids]


def test_blocks_bit_equal_and_embed_direct_matches_jax(tgraph, graph,
                                                       jstate):
    """Each id's block under its id seed equals the JAX server's array
    for array; embed_direct then agrees with JAX's in float32."""
    jsrv = jserve.EmbedServer(JSage(**SAGE_KW), graph, jstate, max_batch=8)
    srv = _server(tgraph, jstate)
    for nid in sorted(TOPOLOGY) + [1, 5]:
        tb, jb = srv._block(nid), jsrv._block(nid)
        assert [p for p, _ in tbase.batch_leaves(tb)] == [
            p for p, _ in tbase.batch_leaves(jb)]
        jax.tree_util.tree_map(np.testing.assert_array_equal, tb, jb)
        np.testing.assert_allclose(srv.embed_direct(nid),
                                   jsrv.embed_direct(nid),
                                   rtol=1e-5, atol=1e-6)


def test_concat_blocks_lays_hops_out_as_one_draw(tgraph):
    """The engine lays hop k of B roots out root-major (root r's picks
    contiguous), so B one-root blocks concatenate to the batch of the B
    roots drawn at once."""
    model = TSage(**SAGE_KW)
    roots = np.array([10, 16, 12, 15], dtype=np.int64)
    joint, _, _ = tgraph.sample_fanout(roots, model.metapath, model.fanouts,
                                       model.default_node)
    per_hop = [1, 3, 6]
    for r, root in enumerate(roots):
        nbrs = set(TOPOLOGY[int(root)][2].get(0, {})) | set(
            TOPOLOGY[int(root)][2].get(1, {}))
        picks = joint[1][r * 3:(r + 1) * 3]
        assert set(picks.tolist()) <= (nbrs or {model.default_node})

    class Slices:
        """The joint draw, or root r's slice of it for a one-root call."""

        def sample_fanout(self, ids, *a):
            if len(ids) == len(roots):
                return joint, None, None
            r = roots.tolist().index(int(ids[0]))
            return [h[r * n:(r + 1) * n] for h, n in zip(joint, per_hop)
                    ], None, None

        def get_dense_feature(self, ids, *a):
            return tgraph.get_dense_feature(ids, *a)

    blocks = [model.sample_host_embed(Slices(), [r]) for r in roots]
    whole = model.sample_host_embed(Slices(), roots)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           tbase.concat_blocks(blocks), whole)


def test_block_draws_stay_under_the_engine_threshold(tgraph, jstate):
    """The bound in serve.py's docstring is the engine's: one id's draws
    stay on the calling thread while prod(fanouts) <= OMP_DRAW_BOUND, so
    a block drawn at the bound on another thread is drawn again equal."""
    src = open(os.path.join(REPO, "euler_tpu_torch", "graph", "_native",
                            "eg_engine.cc")).read()
    m = re.search(r"void Engine::SampleNeighbor.*?if \(n \* count > (\d+)\)",
                  src, re.S)
    assert m and int(m.group(1)) == serve.OMP_DRAW_BOUND
    assert 10 * 10 <= serve.OMP_DRAW_BOUND  # ppi's [10, 10]
    kw = dict(SAGE_KW, fanouts=[32, serve.OMP_DRAW_BOUND // 32])
    model = TSage(**kw)
    srv = serve.EmbedServer(model, tgraph, {"module": torch.nn.Linear(1, 1)},
                            sample_cache=1)
    out = []
    for _ in range(3):
        t = threading.Thread(target=lambda: out.append(srv._block(16)))
        t.start()
        _join([t])
        srv._cache.clear()
    assert out[0]["hops"][2]["dense"].shape == (serve.OMP_DRAW_BOUND, 2)
    for b in out[1:]:
        jax.tree_util.tree_map(np.testing.assert_array_equal, b, out[0])


# -------------------------------------------------------------- (c)-(h)


def test_served_rows_bit_equal_under_concurrent_mixed_traffic(tgraph,
                                                              jstate):
    """The requests start together and coalesce within a 100 ms window
    (never reached: 7 distinct ids < max_batch), so some share a
    dispatch however loaded the host is."""
    server = _server(tgraph, jstate, max_wait_us=100_000).start()
    ids = sorted(TOPOLOGY)
    direct = {i: server.embed_direct(i) for i in ids}
    reqs = [[10, 14, 12], [14], [16, 10], [11, 12, 13, 15], [12, 12, 14],
            [16], [11, 15], [13, 10, 16]]
    outs = [None] * len(reqs)
    start = threading.Barrier(len(reqs))

    def go(k):
        start.wait(JOIN_S)
        outs[k] = server.embed(reqs[k])

    ts = [threading.Thread(target=go, args=(k,)) for k in range(len(reqs))]
    try:
        for t in ts:
            t.start()
        _join(ts)
    finally:
        server.close()
    for k, req in enumerate(reqs):
        assert outs[k].shape == (len(req), 8)
        assert outs[k].dtype == np.float32
        for row, nid in zip(outs[k], req):
            np.testing.assert_array_equal(row, direct[nid])
    assert tnative.counters()["serve_batches"] < len(reqs)
    # one bucket served all of it
    assert server.stats()["devprof"]["captures"] == 1


def test_oversize_request_chunks(tgraph, jstate):
    with _server(tgraph, jstate, max_batch=4) as srv:
        ids = sorted(TOPOLOGY)  # 7 unique > max_batch=4
        rows = srv.embed(ids)
        assert rows.shape == (7, 8)
        assert srv.stats()["devprof"]["replays"] == 2
        for row, nid in zip(rows, ids):
            np.testing.assert_array_equal(row, srv.embed_direct(nid))


def test_sample_cache_bounded_and_deterministic(tgraph, jstate):
    with _server(tgraph, jstate, max_batch=4, sample_cache=2) as srv:
        a = srv.embed_direct(16)
        for nid in (10, 11, 12):
            srv.embed_direct(nid)
        assert len(srv._cache) == 2
        cache = srv.stats()["cache"]
        per_block = (1 + 3 + 6) * 2 * 4 + 3 * 4  # hops' features, labels
        assert cache == {"entries": 2, "bytes": 2 * per_block}
        # id 16 was evicted: drawn again under its id seed, it is equal
        np.testing.assert_array_equal(a, srv.embed_direct(16))


def test_shared_state_under_thread_stress(tgraph, jstate):
    """More threads than cores on a tiny switch interval: the bucket's
    counts, the cache's bytes and every row stay exact."""
    srv = _server(tgraph, jstate, sample_cache=3).start()
    ids = sorted(TOPOLOGY)
    want = {i: srv.embed_direct(i) for i in ids}
    n_threads, rounds = 2 * (os.cpu_count() or 4), 5
    bad = []

    def go(k):
        for r in range(rounds):
            nid = ids[(k + r) % len(ids)]
            row = (srv.embed_direct(nid) if (k + r) % 2
                   else srv.embed([nid])[0])
            if not np.array_equal(row, want[nid]):
                bad.append(nid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=go, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        _join(ts)
    finally:
        sys.setswitchinterval(old)
        srv.close()
    assert bad == []
    dev, cache = srv.stats()["devprof"], srv.stats()["cache"]
    direct = sum((k + r) % 2 for k in range(n_threads) for r in range(rounds))
    ctr = tnative.counters()
    assert ctr["serve_requests"] == n_threads * rounds - direct
    # one replay a direct call and a batch (at most 7 ids < max_batch)
    assert dev["replays"] == len(ids) + direct + ctr["serve_batches"]
    assert dev["captures"] == 1
    assert cache["entries"] <= 3
    assert cache["bytes"] == sum(
        x.nbytes for _, blk, _ in srv._cache.values()
        for _, x in tbase.batch_leaves(blk))


def test_first_counter_adds_race_no_partial_name_table(monkeypatch):
    """Threads whose counter_add is the process's first all find every
    name (the table is published whole), and every add lands."""
    monkeypatch.setattr(tnative, "_counter_ids", {})
    n_threads, errors = 2 * (os.cpu_count() or 4), []
    start = threading.Barrier(n_threads)

    def go():
        start.wait(JOIN_S)
        try:
            tnative.counter_add("serve_requests", 1)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=go) for _ in range(n_threads)]
        for t in ts:
            t.start()
        _join(ts)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert tnative.counters()["serve_requests"] == n_threads


def test_rejects_device_sampling_models(tgraph):
    model = TSage(**dict(SAGE_KW, device_sampling=True,
                         device_features=True))
    state = model.init_state(tgraph, ttrain.get_optimizer("adam", 0.01),
                             device="cpu")
    with pytest.raises(ValueError, match="device_sampling"):
        serve.EmbedServer(model, tgraph, state)


def test_stats_shape(server):
    server.embed([1, 2, 3])
    s = server.stats()
    assert s["slo"]["count"] == 1
    assert set(s["serve_phases"]) >= {"queue_wait", "sample", "dispatch",
                                      "total"}
    for ph in s["serve_phases"].values():
        assert ph["count"] >= 1 and ph["p99_us"] >= ph["p50_us"] >= 0
    assert s["counters"]["serve_requests"] == 1
    assert s["batch"] == {"dispatches": 1, "mean_unique_ids": 3.0}
    dev = s["devprof"]
    assert set(dev) == set(devprof.compile_summary()) | {
        "device", "captures", "replays", "recaptures"}
    assert {k: dev[k] for k in ("device", "captures", "replays",
                                "recaptures", "recompiles",
                                "serve_recompiles")} == {
        "device": "cpu", "captures": 1, "replays": 1, "recaptures": 0,
        "recompiles": 0, "serve_recompiles": 0}
    # the padded bucket up, the three rows down
    rows = server.embed([1, 2, 3])
    dev2 = server.stats()["devprof"]
    assert dev2["d2h_bytes"] - dev["d2h_bytes"] == rows.nbytes
    assert dev2["h2d_bytes"] - dev["h2d_bytes"] == dev["h2d_bytes"] > 0
    assert s["cache"]["entries"] == 3


def test_histograms_reach_every_surface_and_kill_switch(server):
    server.embed([4, 7])
    hists = T.serve_hists()
    assert {"queue_wait", "sample", "dispatch", "total"} <= set(hists)
    assert all(h["count"] == 1 for h in hists.values())
    assert hists["total"]["sum_us"] >= hists["dispatch"]["sum_us"]
    text = T.metrics_text()
    assert "# HELP eg_serve_phase_us " in text
    assert 'eg_serve_phase_us_count{phase="total"} 1' in text
    assert "# HELP eg_serve_batch_ids " in text
    batch = T.telemetry_json()["hist"]["serve_batch"]
    assert batch["count"] == 1 and batch["sum_us"] == 2
    assert T.percentiles(hists["total"], (50,))[50] > 0
    T.telemetry_reset()
    T.set_telemetry(False)
    assert not T.telemetry_enabled()
    server.embed([1, 2])
    assert all(h["count"] == 0 for h in T.serve_hists().values())
    assert T.telemetry_json()["hist"]["serve_batch"]["count"] == 0
    T.set_telemetry(True)
    server.embed([1, 2])
    assert T.serve_hists()["total"]["count"] == 1
    # the remote surfaces refuse a graph that is not remote, as JAX's do
    for fn, args in ((T.scrape, (None, 0)), (T.ping, (None, 0)),
                     (T.metrics_text, (server.graph, 0))):
        for mod in (T, JT):
            with pytest.raises(ValueError, match="mode='remote'"):
                getattr(mod, fn.__name__)(*args)
    assert isinstance(T.slow_spans(), list)


def test_bucket_helpers_match_jax():
    for us in (0, 1, 2, 3, 1000, 2 ** 26, 2 ** 40):
        assert T.bucket_of(us) == JT.bucket_of(us)
    assert T.bucket_edges_us() == JT.bucket_edges_us()
    assert (T.NUM_BUCKETS, T.PHASES, T.SERVE_PHASES) == (
        JT.NUM_BUCKETS, JT.PHASES, JT.SERVE_PHASES)
    h = {"b": [0, 3, 0, 5] + [0] * 23 + [2], "count": 10, "sum_us": 0}
    assert T.percentiles(h, (10, 50, 90, 99)) == JT.percentiles(
        h, (10, 50, 90, 99))


# -------------------------------------------------------------- (i), (j)


def _rows_for(uids) -> np.ndarray:
    # a fake embed: row i = [id, id], so the scatter order is checkable
    return np.stack([np.array([i, i], dtype=np.float32) for i in uids])


def test_batcher_coalesces_and_dedups():
    dispatches = []

    def embed(uids):
        dispatches.append(sorted(uids.tolist()))
        return _rows_for(uids)

    # the requests start together and the 200 ms window outlasts any
    # host's thread starts
    mb = MicroBatcher(embed, max_batch=8, max_wait_us=200_000,
                      queue_cap=16).start()
    try:
        outs = {}
        reqs = {0: [1, 2], 1: [2, 3], 2: [3, 1, 4]}
        start = threading.Barrier(len(reqs))

        def go(k):
            start.wait(JOIN_S)
            outs[k] = mb.submit(reqs[k])

        ts = [threading.Thread(target=go, args=(k,)) for k in reqs]
        for t in ts:
            t.start()
        _join(ts)
        assert dispatches == [[1, 2, 3, 4]]
        assert tnative.counters()["serve_requests"] == 3
        assert tnative.counters()["serve_batches"] == 1
        for k, ids in reqs.items():
            np.testing.assert_array_equal(outs[k], _rows_for(ids))
    finally:
        mb.close()


def test_batcher_flushes_on_max_batch():
    """max_batch unique ids pending flush at once: the 10 s window never
    runs out."""
    seen = threading.Event()

    def embed(uids):
        seen.set()
        return _rows_for(uids)

    mb = MicroBatcher(embed, max_batch=2, max_wait_us=10_000_000,
                      queue_cap=16).start()
    try:
        t = threading.Thread(target=mb.submit, args=([7, 8],))
        t.start()
        assert seen.wait(5.0), "batch never flushed on max_batch"
        _join([t])
    finally:
        mb.close()


def test_batcher_busy_shedding_at_queue_cap():
    entered, release = threading.Event(), threading.Event()

    def embed(uids):
        entered.set()
        release.wait(JOIN_S)
        return _rows_for(uids)

    mb = MicroBatcher(embed, max_batch=8, max_wait_us=0, queue_cap=1).start()
    try:
        t1 = threading.Thread(target=mb.submit, args=([1],))
        t1.start()
        assert entered.wait(5.0)  # r1 popped, the dispatcher held
        t2 = threading.Thread(target=mb.submit, args=([2],))
        t2.start()
        deadline = time.monotonic() + 5.0
        while len(mb._queue) < 1:  # r2 queued: the cap is reached
            assert time.monotonic() < deadline
            time.sleep(0.001)
        with pytest.raises(BusyError, match="queue at capacity"):
            mb.submit([3])
        assert tnative.counters()["serve_busy_rejects"] == 1
        release.set()
        _join([t1, t2])
        assert tnative.counters()["serve_requests"] == 3
        assert tnative.counters()["serve_batches"] == 2
    finally:
        release.set()
        mb.close()


@pytest.mark.parametrize("case", ["deadline", "embed_error"])
def test_batcher_request_fails_cleanly(case):
    """A request whose deadline runs out while it coalesces never reaches
    the embed; an embed that raises answers its requests with the
    error."""
    calls = []

    def embed(uids):
        calls.append(uids.tolist())
        if case == "embed_error":
            raise ValueError("device fell over")
        return _rows_for(uids)

    wait_us = 300_000 if case == "deadline" else 0
    mb = MicroBatcher(embed, max_batch=8, max_wait_us=wait_us,
                      queue_cap=16).start()
    try:
        if case == "deadline":
            with pytest.raises(DeadlineError, match="deadline expired"):
                mb.submit([5], deadline_ms=1.0)
            assert tnative.counters()["serve_deadline_rejects"] == 1
            assert calls == []
        else:
            with pytest.raises(ValueError, match="device fell over"):
                mb.submit([1, 2])
            assert calls == [[1, 2]]
    finally:
        mb.close()


def test_batcher_close_drains_queue():
    done = []

    def embed(uids):
        time.sleep(0.01)
        done.extend(uids.tolist())
        return _rows_for(uids)

    mb = MicroBatcher(embed, max_batch=1, max_wait_us=0,
                      queue_cap=64).start()
    outs = []
    ts = [threading.Thread(target=lambda i=i: outs.append(mb.submit([i])))
          for i in range(6)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5.0
    while tnative.counters()["serve_requests"] < 6:  # all six admitted
        assert time.monotonic() < deadline
        time.sleep(0.001)
    mb.close()  # dispatches everything already admitted
    _join(ts)
    assert sorted(done) == [0, 1, 2, 3, 4, 5]
    assert len(outs) == 6
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit([9])


@pytest.mark.parametrize("target,window,samples_us", [
    (10.0, 100, [ms * 1000.0 for ms in range(1, 101)]),
    (100.0, 4, [900e3, 900e3, 1e3, 2e3, 3e3, 4e3]),
    (5.0, 2048, []),
    (2.0, 64, [float(x) for x in
               np.random.default_rng(0).exponential(1500.0, 200)]),
])
def test_slo_tracker_matches_jax(target, window, samples_us):
    """The same samples give the JAX tracker's report, and the gauges
    pushed into each package's engine are equal."""
    jnative.reset_counters()
    JT.telemetry_reset()
    t, j = SLOTracker(target, window), JSLOTracker(target, window)
    for us in samples_us:
        t.record(us)
        j.record(us)
    assert t.report() == j.report()
    for q in (1, 50, 90, 99, 100):
        assert t.percentile(q) == j.percentile(q)
    assert T.telemetry_json()["serve_slo"] == JT.telemetry_json()[
        "serve_slo"]
    JT.telemetry_reset()


def test_slo_tracker_rejects_empty_window():
    with pytest.raises(ValueError, match="window"):
        SLOTracker(1.0, window=0)


# ------------------------------------------------------------------- (k)


def test_frontend_roundtrip_and_a_jax_client_gets_the_same_bytes(server):
    fe = EmbedFrontend(server, port=0)
    try:
        c = EmbedClient(fe.address)
        rows = c.embed([13, 16, 13])
        assert rows.shape == (3, 8) and rows.dtype == np.float32
        np.testing.assert_array_equal(rows[0], server.embed_direct(13))
        np.testing.assert_array_equal(rows[0], rows[2])
        jc = JClient(fe.address)
        assert jc.embed([13, 16, 13]).tobytes() == rows.tobytes()
        assert jc.ping() == c.ping() == {"ok": True, "draining": False}
        s = c.stats()
        assert s["ok"] and s["slo"]["count"] >= 2
        with pytest.raises(RuntimeError, match="embed needs ids"):
            c.embed([])
        jc.close()
        c.close()
    finally:
        fe.stop()


def test_frontend_connection_cap_sheds_busy(server):
    fe = EmbedFrontend(server, port=0, max_conns=1)
    try:
        c1 = EmbedClient(fe.address, timeout_s=5.0)
        assert c1.ping()["ok"]  # holds the only slot
        c2 = EmbedClient(fe.address, timeout_s=5.0)
        with pytest.raises(BusyError):
            c2.ping()
        assert tnative.counters()["serve_busy_rejects"] >= 1
        c2.close()
        c1.close()
    finally:
        fe.stop()


def test_frontend_drain_refuses_new_connections(server):
    fe = EmbedFrontend(server, port=0)
    addr = fe.address
    fe.drain(grace_s=1.0)
    with pytest.raises((ConnectionError, OSError, BusyError)):
        EmbedClient(addr, timeout_s=2.0).ping()
    fe.stop()


# ------------------------------------------------------------- (l)-(n)


def test_check_serve_flags():
    p = run_loop.define_flags()
    a = p.parse_args(["--data_dir", "/d", "--serve_slo_ms", "50"])
    with pytest.raises(ValueError, match="--serve_slo_ms.*--serve_after"):
        run_loop.check_serve_flags(a)
    a = p.parse_args(["--data_dir", "/d", "--mode", "evaluate",
                      "--serve_after", "1"])
    with pytest.raises(ValueError, match="--mode=train"):
        run_loop.check_serve_flags(a)
    run_loop.check_serve_flags(p.parse_args(["--data_dir", "/d"]))
    run_loop.check_serve_flags(p.parse_args(
        ["--data_dir", "/d", "--serve_after", "1", "--serve_port", "9777"]))
    # the flags and their defaults are the JAX package's
    from euler_tpu import serving as jserving
    from euler_tpu_torch import serving as tserving

    assert tserving.SERVE_FLAG_DEFAULTS == jserving.SERVE_FLAG_DEFAULTS


_CLI = ["--max_id", "16", "--feature_idx", "0", "--feature_dim", "2",
        "--label_idx", "2", "--label_dim", "3", "--train_edge_type", "0,1",
        "--all_edge_type", "0,1", "--fanouts", "3,2", "--dim", "8",
        "--batch_size", "8", "--num_epochs", "2", "--log_steps", "100",
        "--model", "graphsage_supervised"]


def test_restore_serving_state_raises_then_serves_the_trained_state(
        fixture_dir, tmp_path):
    ck = str(tmp_path / "ck")
    base = ["--data_dir", fixture_dir, "--model_dir", ck] + _CLI
    args = run_loop.define_flags().parse_args(
        base + ["--serve_port", "0", "--serve_max_batch", "4"])
    args.mode = "evaluate"  # what serve.main sets
    graph, _ = run_loop.build_graph(args)
    server = frontend = None
    try:
        model = run_loop.build_model(args, graph)
        with pytest.raises(ValueError, match="no checkpoint in"):
            serve.build_server(model, graph, args, "cpu")
        assert run_loop.main(base + ["--mode", "train"], device="cpu") == 0
        server, frontend = serve.run_serve(model, graph, args, "cpu",
                                           block=False)
        trained = Checkpointer(ck).restore(model.init_state(
            graph, ttrain.get_optimizer("adam", 0.01), device="cpu"))
        want = trained["module"].state_dict()
        got = server._state["module"].state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        c = EmbedClient(frontend.address, timeout_s=10.0)
        rows = c.embed([10, 16])
        assert rows.shape == (2, 8)
        np.testing.assert_array_equal(rows[0], server.embed_direct(10))
        c.close()
    finally:
        if frontend is not None:
            frontend.drain(grace_s=1.0)
        if server is not None:
            server.close()
        if frontend is not None:
            frontend.stop()
        graph.close()


@pytest.mark.parametrize("strict", [False, True])
def test_bucket_guard(tgraph, jstate, strict):
    """A block of another layout (labels one column wider) bumps
    serve_recompiles and is captured again, its row unchanged; under
    strict_bucket it raises."""
    srv = _server(tgraph, jstate, strict_bucket=strict)
    want = srv.embed_direct(10)
    blk = srv._block(10)
    other = dict(blk, labels=np.zeros((1, 4), np.float32))
    if strict:
        with pytest.raises(devprof.RecompileError,
                           match="embed_step recompiled after warmup"):
            srv._forward([other])
        # the captured bucket stays: its row is served unchanged
        np.testing.assert_array_equal(srv._forward([blk])[0], want)
    else:
        np.testing.assert_array_equal(srv._forward([other])[0], want)
    assert tnative.counters()["serve_recompiles"] == 1
    led = devprof.recompile_ledger()[-1]
    assert led["fn"] == "embed_step" and led["diff"] == [
        "leaf3: (8, 3) float32 -> (8, 4) float32"]
    dev = srv.stats()["devprof"]
    assert (dev["captures"], dev["recaptures"]) == (
        (1, 0) if strict else (2, 1))


# ------------------------------------------------------------------- (o)


def test_serve_after_trains_then_serves_until_sigterm(fixture_dir,
                                                      tmp_path):
    """``run_loop --serve_after 1`` in a subprocess on the CPU: train,
    serve on the flagged port, answer a live embed, drain on SIGTERM,
    exit 0."""
    with socket.create_server(("127.0.0.1", 0)) as s:
        port = s.getsockname()[1]  # a free port (tiny reuse race)
    code = ("import sys\n"
            "from euler_tpu_torch import run_loop\n"
            "sys.exit(run_loop.main(sys.argv[1:], device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--data_dir", fixture_dir,
         "--model_dir", str(tmp_path / "ck"), "--mode", "train",
         "--serve_after", "1", "--serve_port", str(port),
         "--serve_max_batch", "4"] + _CLI,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 60
        client = None
        while time.monotonic() < deadline:
            assert proc.poll() is None, "run_loop died early"
            try:
                client = EmbedClient(f"127.0.0.1:{port}", timeout_s=5)
                break
            except OSError:
                time.sleep(0.1)
        assert client is not None, "the server never came up"
        rows = client.embed([12, 15, 12])
        assert rows.shape == (3, 8)
        np.testing.assert_array_equal(rows[0], rows[2])
        assert client.stats()["slo"]["count"] >= 1
        client.close()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, f"non-zero exit:\n{out[-3000:]}"
        assert "serve SLO at exit" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


def test_serve_main_raises_without_a_card(fixture_dir, tmp_path,
                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--data_dir", fixture_dir, "--model_dir",
                    str(tmp_path / "ck"), "--serve_port", "0"] + _CLI)
