"""The port's survivability drills over live clusters, the counterparts of
``tests/test_rolling_restart.py`` (the rolling restart and the
connection storm) and of ``tests/test_serve.py``'s serving storm. Each
runs for seconds to tens of seconds with shard processes or dozens of
client threads, so each is marked ``slow``.

* Rolling restart: train SupervisedGraphSage on the CPU over two shard
  processes (``python -m euler_tpu_torch.graph.service``) while each
  shard in turn is SIGTERM-drained and restarted on a new port. No call
  may fail, and the final loss must land within the JAX drill's
  tolerance of a restart-free run's.
* Connection storm: a service of 2 workers and 2 pending slots against
  32 clients sheds with BUSY replies, yet every call completes, the
  handlers stay fast and no thread outlives the storm.
* Serving storm: 16 embedding clients against the frontend, the
  micro-batcher and a remote 2-shard graph: every client completes,
  shedding shows, and rows stay bit-equal to the direct path.
* The processes: the TCP registry's and a shard's entry points serve,
  register and drain to exit code 0 on SIGTERM.

Every wait is bounded; every process started is killed on the way out.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from euler_tpu_torch import telemetry as T  # noqa: E402
from euler_tpu_torch.graph import Graph, GraphService, native  # noqa: E402
from tests.fixture_graph import TOPOLOGY, write_fixture  # noqa: E402

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_SHARDS = 2
NUM_PARTITIONS = 4
STEPS = 26
# shard 0 restarts at step 6, shard 1 at step 16: never both down
RESTARTS = {6: 0, 16: 1}


@pytest.fixture(autouse=True)
def _clean_slate():
    native.fault_clear()
    native.reset_counters()
    T.telemetry_reset()
    T.set_telemetry(True)
    yield
    native.fault_clear()
    native.reset_counters()
    T.telemetry_reset()


def _sage():
    from euler_tpu_torch.models import SupervisedGraphSage

    return SupervisedGraphSage(
        label_idx=2, label_dim=3, metapath=[[0, 1], [0, 1]], fanouts=[3, 2],
        dim=8, feature_idx=0, feature_dim=2, max_id=16)


def _launch_shard(idx: int, data: str, reg: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "euler_tpu_torch.graph.service",
         "--data_dir", data, "--shard_idx", str(idx),
         "--shard_num", str(NUM_SHARDS), "--registry", reg],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env=dict(os.environ, PYTHONPATH=REPO))


def _wait_registered(idx: int, reg: str, timeout: float = 90.0) -> None:
    """Until shard ``idx`` has a registry entry that accepts
    connections."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for f in os.listdir(reg):
            if not f.startswith(f"{idx}#"):
                continue
            host, port = f.split("#", 1)[1].rsplit("_", 1)
            try:
                with socket.create_connection((host, int(port)), 1.0):
                    return
            except OSError:
                continue
        time.sleep(0.1)
    raise TimeoutError(f"shard {idx} never came up in {reg}")


def test_rolling_restart_drill_zero_failed_calls(tmp_path):
    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.models import base

    data = str(tmp_path / "data")
    os.makedirs(data)
    write_fixture(data, num_partitions=NUM_PARTITIONS)
    reg = str(tmp_path / "reg")
    os.makedirs(reg)
    model = _sage()
    roots = np.array(sorted(TOPOLOGY), dtype=np.int64)

    def run(graph, hook=None):
        state = model.init_state(graph, train_lib.get_optimizer("adam", 0.05),
                                 device="cpu", seed=0)
        step = model.make_train_step()
        losses = []
        for i in range(STEPS):
            if hook is not None:
                hook(i)
            loss, _ = step(state, base.to_device(model.sample(graph, roots),
                                                 "cpu"))
            losses.append(float(loss))
        return losses

    procs = {}
    try:
        for s in range(NUM_SHARDS):
            procs[s] = _launch_shard(s, data, reg)
        for s in range(NUM_SHARDS):
            _wait_registered(s, reg)
        g = Graph(mode="remote", registry=reg, retries=8, timeout_ms=2000,
                  backoff_ms=2)
        assert g.num_shards == NUM_SHARDS
        clean = run(g)
        g.close()

        native.reset_counters()
        # a call issued while its shard restarts keeps retrying until
        # rediscovery learns the new address; no neighbour cache, so the
        # drill's calls really cross the wire
        g = Graph(mode="remote", registry=reg, retries=40, timeout_ms=2000,
                  backoff_ms=10, quarantine_ms=200, deadline_ms=90000,
                  rediscover_ms=250, neighbor_cache_mb=0)

        def rolling(i):
            shard = RESTARTS.get(i)
            if shard is None:
                return
            p = procs[shard]
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=60) == 0, "SIGTERM must drain, not crash"
            # the drain deregistered the shard before it exited
            assert not [f for f in os.listdir(reg)
                        if f.startswith(f"{shard}#")]
            procs[shard] = _launch_shard(shard, data, reg)
            _wait_registered(shard, reg)

        drilled = run(g, rolling)
        counters = native.counters()
        g.close()
        assert counters["calls_failed"] == 0, counters
        assert counters["rpc_errors"] == 0, counters
        assert all(np.isfinite(x) for x in clean + drilled)
        clean_final = float(np.mean(clean[-5:]))
        drill_final = float(np.mean(drilled[-5:]))
        assert drill_final < drilled[0], (drilled[0], drill_final)
        assert abs(drill_final - clean_final) < 0.4, (clean_final,
                                                     drill_final)
        assert counters["retries"] >= 1, counters
        assert counters["rediscoveries"] >= 1, counters
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            p.wait(timeout=30)


def _thread_count() -> int:
    return len(os.listdir("/proc/self/task"))


def test_connection_storm_sheds_busy_and_every_call_completes(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    write_fixture(data, num_partitions=NUM_PARTITIONS)
    svc = GraphService(data, 0, 1, workers=2, pending=2)
    addr = svc.address
    try:
        # every request stalls 15 ms before its dispatch: two workers
        # saturate at once and the 32 dials overflow the pending budget
        native.fault_config("handler_stall:delay@15", 3)
        native.reset_counters()
        native.stats_reset()
        baseline = _thread_count()
        ids = np.array([10, 11, 12, 13], dtype=np.int64)
        n_clients = 32
        barrier = threading.Barrier(n_clients)
        errors = []
        lock = threading.Lock()

        def client(k):
            try:
                barrier.wait(timeout=60)
                g = Graph(mode="remote", shards=[addr], retries=8,
                          timeout_ms=5000, backoff_ms=1, deadline_ms=60000,
                          dispatch_workers=2)
                try:
                    for _ in range(3):
                        np.testing.assert_array_equal(g.node_types(ids),
                                                      [0, 1, 0, 1])
                finally:
                    g.close()
            except Exception as e:  # reported below
                with lock:
                    errors.append(f"client {k}: {e!r}")

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "storm wedged"
        assert errors == [], errors[:5]
        ctr = native.counters()
        assert ctr["busy_rejects"] > 0, ctr
        assert ctr["calls_failed"] == 0 and ctr["rpc_errors"] == 0, ctr
        native.fault_clear()  # the scrape must not stall
        g = Graph(mode="remote", shards=[addr], retries=4, timeout_ms=5000)
        try:
            scraped = T.scrape(g, 0)
        finally:
            g.close()
        assert scraped["counters"]["busy_rejects"] == ctr["busy_rejects"]
        assert scraped["gauges"]["workers"] == 2
        assert scraped["gauges"]["draining"] == 0
        assert scraped["hist"]["server_handler:node_type"]["count"] >= \
            n_clients * 3
        span = native.stats().get("service_request")
        assert span is not None and span["max_us"] < 500_000, span
        deadline = time.monotonic() + 30.0
        while _thread_count() > baseline and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _thread_count() <= baseline, (_thread_count(), baseline)
    finally:
        native.fault_clear()
        svc.stop()


def test_serve_storm_over_live_cluster(tmp_path):
    from euler_tpu_torch import serve
    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.serving import BusyError, EmbedClient, EmbedFrontend

    data = str(tmp_path / "data")
    reg = str(tmp_path / "reg")
    os.makedirs(data)
    os.makedirs(reg)
    write_fixture(data, num_partitions=4)
    services = [GraphService(data, s, 2, registry=reg) for s in range(2)]
    remote = server = frontend = None
    try:
        remote = Graph(mode="remote", registry=reg, retries=4)
        model = _sage()
        state = model.init_state(
            remote, train_lib.get_optimizer("adam", 0.01), device="cpu",
            seed=3)
        server = serve.EmbedServer(model, remote, state, max_batch=8,
                                   max_wait_us=1000, queue_cap=2,
                                   slo_ms=5000.0).start()
        frontend = EmbedFrontend(server, port=0, max_conns=24)
        server.embed_direct(1)
        ids = sorted(TOPOLOGY)
        per_client = 8
        completed = {}

        def client(cid):
            import random

            rng = random.Random(cid)
            c = EmbedClient(frontend.address)
            done = retries = 0
            try:
                while done < per_client:
                    pick = rng.sample(ids, rng.randint(1, 3))
                    try:
                        rows = c.embed(pick)
                    except BusyError:
                        retries += 1
                        time.sleep(0.002)
                        continue
                    assert rows.shape == (len(pick), 8)
                    done += 1
                completed[cid] = retries
            finally:
                c.close()

        ts = [threading.Thread(target=client, args=(i,), daemon=True)
              for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        scrape = EmbedClient(frontend.address)
        stats = scrape.stats()
        assert len(completed) == 16, "a client thread died"
        assert stats["slo"]["count"] >= 16 * per_client
        assert stats["slo"]["p99_ms"] <= 5000.0
        assert stats["counters"]["serve_busy_rejects"] > 0
        assert (stats["counters"]["serve_batches"]
                < stats["counters"]["serve_requests"])
        row = scrape.embed([ids[3]])[0]
        np.testing.assert_array_equal(row, server.embed_direct(ids[3]))
        scrape.close()
    finally:
        if frontend is not None:
            frontend.drain(grace_s=2.0)
        if server is not None:
            server.close()
        if frontend is not None:
            frontend.stop()
        if remote is not None:
            remote.close()
        for s in services:
            s.drain()
            s.stop()


def test_registry_and_service_processes_drain_on_sigterm(tmp_path):
    """``python -m euler_tpu_torch.graph.registry --port 0`` serves on the
    port it logs; a ``python -m euler_tpu_torch.graph.service`` shard
    registers there; both exit 0 on SIGTERM, the shard deregistered
    first."""
    from euler_tpu_torch.graph import registry

    data = str(tmp_path / "data")
    os.makedirs(data)
    write_fixture(data, num_partitions=2)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    try:
        reg = subprocess.Popen(
            [sys.executable, "-m", "euler_tpu_torch.graph.registry",
             "--host", "127.0.0.1", "--port", "0"], env=env,
            stdout=subprocess.PIPE, text=True)
        procs.append(reg)
        line = reg.stdout.readline()  # the process's first line
        assert "shard registry serving on tcp://127.0.0.1:" in line, line
        url = line.split()[-1]
        shard = subprocess.Popen(
            [sys.executable, "-m", "euler_tpu_torch.graph.service",
             "--data_dir", data, "--registry", url], env=env,
            stdout=subprocess.PIPE, text=True)
        procs.append(shard)
        line = shard.stdout.readline()
        assert "graph shard 0/1 serving on 127.0.0.1:" in line, line
        addr = line.split()[5]
        deadline = time.monotonic() + 30
        while registry.query(url) != {0: [addr]}:
            assert time.monotonic() < deadline, registry.query(url)
            time.sleep(0.05)
        shard.send_signal(signal.SIGTERM)
        assert shard.wait(60) == 0
        assert registry.query(url) == {}
        reg.send_signal(signal.SIGTERM)
        assert reg.wait(60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)
