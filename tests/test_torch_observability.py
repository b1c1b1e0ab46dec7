"""Training's observability plane in the port against the JAX package's:
the step phases and prefetch gauges, ``snapshot``, the device plane
(``devprof``), the merged trace (``trace``), the flight recorder and its
postmortems (``blackbox``), and ``run_loop``'s flags that drive them.

Both engines live in this process. Their counters, span timers and
failpoints are one object (unique symbols of function-local statics);
the telemetry histograms and switches (step phases among them), the
device-memory gauges and the flight recorder are each library's own
(``test_which_native_state_the_two_engines_share`` pins this). Every
case starts with both packages reset.
"""

import gzip
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from euler_tpu import blackbox as JB  # noqa: E402
from euler_tpu import devprof as JD  # noqa: E402
from euler_tpu import telemetry as JT  # noqa: E402
from euler_tpu import trace as JTR  # noqa: E402
from euler_tpu.graph import native as jnative  # noqa: E402
from euler_tpu.parallel import prefetch as jprefetch  # noqa: E402

from euler_tpu_torch import _build  # noqa: E402
from euler_tpu_torch import blackbox as TB  # noqa: E402
from euler_tpu_torch import devprof as TD  # noqa: E402
from euler_tpu_torch import run_loop  # noqa: E402
from euler_tpu_torch import telemetry as TT  # noqa: E402
from euler_tpu_torch import trace as TTR  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402
from euler_tpu_torch.parallel import prefetch as tprefetch  # noqa: E402,E501
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALL_S = 0.025
STALL_BUCKET = 15  # 25 ms -> [16384, 32768) us
TRAIN_STALL_S = 0.2  # bucket 18, [131072, 262144) us


def _reset():
    for nat, tel, dp, bb in ((jnative, JT, JD, JB), (tnative, TT, TD, TB)):
        nat.reset_counters()
        tel.telemetry_reset()
        tel.set_telemetry(True)
        tel.set_trace_sink(None)
        dp.devprof_reset()
        dp.set_devprof(True)
        bb.set_blackbox(True)
        bb.blackbox_reset()


@pytest.fixture(autouse=True)
def _clean_slate():
    _reset()
    yield
    _reset()


def test_which_native_state_the_two_engines_share():
    """Counters are one object; phases, the telemetry switch, the device
    gauges and the flight recorder are each library's own."""
    TT.record_phase("device", 100)
    assert TT.phase_hists()["device"]["count"] == 1
    assert JT.phase_hists()["device"]["count"] == 0
    tnative.lib().eg_devprof_set_mem(12345, 3)
    assert TT.telemetry_json()["resource"]["device_mem_bytes"] == 12345
    assert JT.telemetry_json()["resource"]["device_mem_bytes"] == 0
    TT.set_telemetry(False)
    assert JT.telemetry_enabled() and not TT.telemetry_enabled()
    TB.set_blackbox(False)
    assert JB.blackbox_enabled() and not TB.blackbox_enabled()
    tnative.counter_add("h2d_bytes", 5)
    assert jnative.counters()["h2d_bytes"] == 5


# ------------------------------------------------------------- step phases


def test_phase_names_and_buckets_match_jax():
    assert TT.PHASES == JT.PHASES
    for mod in (JT, TT):
        for i, name in enumerate(mod.PHASES):
            mod.record_phase(name, 10 * (i + 1))
        mod.record_phase("input_stall", 25_000)
    jh, th = JT.phase_hists(), TT.phase_hists()
    assert th == jh and set(th) == set(TT.PHASES)
    for i, name in enumerate(TT.PHASES):
        assert th[name]["sum_us"] == 10 * (i + 1) + (
            25_000 if name == "input_stall" else 0), name
    assert th["input_stall"]["b"][STALL_BUCKET] == 1
    TT.telemetry_reset()
    assert TT.phase_hists()["input_stall"]["count"] == 0


def test_prefetch_gauges_and_snapshot_match_jax():
    for mod in (JT, TT):
        mod.record_phase("input_stall", 2_000)
        mod.record_phase("input_stall", 4_000)
        mod.record_phase("device", 500)
        mod.record_prefetch_gauges(4, 2)
        mod.record_prefetch_gauges(0, 1)
    jd, td = JT.telemetry_json()["hist"], TT.telemetry_json()["hist"]
    for key in ("prefetch_depth", "prefetch_busy"):
        assert td[key] == jd[key]
    js, ts = JT.snapshot(step=3), TT.snapshot(step=3)
    assert abs(ts.pop("unix_ms") - js.pop("unix_ms")) < 60_000
    assert ts == js
    assert ts["input_stall_ms"] == 3.0
    assert ts["prefetch"] == {"mean_queue_depth": 2.0,
                              "mean_workers_busy": 1.5}


@pytest.mark.parametrize("threads", [1, 2])
def test_seeded_stall_lands_in_sample_and_input_stall_never_device(threads):
    """A 25 ms stall in make_batch: every produce lands in ``sample`` at
    bucket 15 or above, the consumer's ``input_stall`` with it, nothing
    in ``device``, in both packages."""
    def make(step):
        time.sleep(STALL_S)
        return step

    steps = 3
    for mod, pf in ((JT, jprefetch), (TT, tprefetch)):
        got = list(pf(make, steps, depth=0 if threads == 1 else 1,
                               num_threads=threads))
        assert got == list(range(steps))
        hists = mod.phase_hists()
        assert hists["sample"]["count"] == steps
        assert sum(hists["sample"]["b"][:STALL_BUCKET]) == 0
        assert hists["input_stall"]["count"] == steps
        if threads == 1:  # every step waited out a whole stall
            assert sum(hists["input_stall"]["b"][:STALL_BUCKET]) == 0
        else:
            assert sum(hists["input_stall"]["b"][STALL_BUCKET:]) >= 1
        assert hists["device"]["count"] == 0
    data = TT.telemetry_json()
    assert data["hist"]["prefetch_depth"]["count"] == steps
    # the produced counter is shared: both packages' produces
    assert tnative.counters()["prefetch_produced"] == 2 * steps


def test_train_records_each_phase_once_a_step_stall_in_sample(fixture_dir):
    """``train.train`` on the CPU: each phase once a step, a 200 ms stall
    of the root draw in ``sample`` and ``input_stall``, never in
    ``device`` (a CPU step of this model takes milliseconds, tens under
    a loaded host: the stall's bucket is far above); h2d and d2h bytes
    counted."""
    from euler_tpu_torch import train as ttrain
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import SupervisedGraphSage

    graph = Graph(directory=fixture_dir)
    model = SupervisedGraphSage(
        label_idx=2, label_dim=3, metapath=[[0, 1], [0, 1]], fanouts=[3, 2],
        dim=8, feature_idx=0, feature_dim=2, max_id=16)
    rng = np.random.default_rng(0)

    def roots(step):
        time.sleep(TRAIN_STALL_S)
        return rng.integers(10, 17, 8)

    steps = 3
    state, _ = ttrain.train(model, graph, lambda s: rng.integers(10, 17, 8),
                            2, device="cpu", log_fn=lambda m: None)  # warm
    _reset()
    ttrain.train(model, graph, roots, steps, log_every=2, seed=1,
                 prefetch_threads=1, state=state, device="cpu",
                 log_fn=lambda m: None)
    graph.close()
    hists = TT.phase_hists()
    for name in ("input_stall", "sample", "h2d", "device", "host", "step"):
        assert hists[name]["count"] == steps, name
    stall = TT.bucket_of(int(TRAIN_STALL_S * 1e6))
    for name in ("sample", "input_stall"):
        assert sum(hists[name]["b"][:stall]) == 0, name
    assert sum(hists["device"]["b"][stall:]) == 0
    ctr = tnative.counters()
    assert ctr["h2d_bytes"] > 0 and ctr["d2h_bytes"] > 0
    assert JT.phase_hists()["device"]["count"] == 0


def test_abandoned_iterator_and_kill_switch():
    it = tprefetch(lambda s: s, 10, depth=3, num_threads=2)
    assert next(it) == 0
    deadline = time.monotonic() + 10.0  # let the workers fill the window
    while (tnative.counters()["prefetch_produced"] < 4
           and time.monotonic() < deadline):
        time.sleep(0.01)
    it.close()
    ctr = tnative.counters()
    assert ctr["prefetch_dropped"] >= 1
    assert ctr["prefetch_produced"] >= ctr["prefetch_dropped"]
    _reset()
    TT.set_telemetry(False)
    assert list(tprefetch(lambda s: s, 4, depth=2,
                            num_threads=2)) == [0, 1, 2, 3]
    TT.record_phase("device", 1000)  # the native switch drops it too
    assert all(h["count"] == 0
               for h in TT.telemetry_json()["hist"].values())
    assert tnative.counters()["prefetch_produced"] == 0


# ------------------------------------------------------------------ devprof


def _drift(watch, make, name):
    """The shapes and dtypes of the JAX package's drift drills through
    ``watch``: warm, in-bucket, drift, drift again, dtype drift; the
    recompiles counted after each call."""
    step = watch(name)
    seen = []
    for shape, dtype in (((8, 2), "float32"), ((8, 2), "float32"),
                         ((5, 2), "float32"), ((5, 2), "float32"),
                         ((5, 2), "int32")):
        step(make(shape, dtype))
        seen.append(jnative.counters()["device_recompiles"])
    return seen


def test_watch_ledger_and_sig_diff_match_jax():
    JD.install()
    jseen = _drift(
        lambda n: JD.watch(jax.jit(lambda x: (x * 2).sum()), name=n),
        lambda s, d: jnp.ones(s, d), "drift_step")
    jled = [(e["fn"], e["diff"], e["sig"], e["prev"])
            for e in JD.recompile_ledger()]
    jnative.reset_counters()
    tseen = _drift(
        lambda n: TD.watch(lambda x: (x * 2).sum(), name=n),
        lambda s, d: torch.ones(s, dtype=getattr(torch, d)), "drift_step")
    tled = [(e["fn"], e["diff"], e["sig"], e["prev"])
            for e in TD.recompile_ledger()]
    assert tseen == jseen == [0, 0, 1, 1, 2]
    assert tled == jled
    assert tled[0][1] == ["leaf0: (8, 2) float32 -> (5, 2) float32"]
    assert tled[1][1] == ["leaf0: (5, 2) float32 -> (5, 2) int32"]
    for old, new in ((None, ((1,), "float32")),
                     ((((1,), "float32"),), (((2,), "float32"),
                                             ((3,), "int32")))):
        assert TD.sig_diff(old, new) == JD.sig_diff(old, new)
    # the wrapper counts the compiles it saw: three signatures
    assert TT.phase_hists()["compile"]["count"] == 3


def test_strict_and_mark_warm_match_jax():
    for dp, fn, make in (
            (JD, jax.jit(lambda x: x.sum()), jnp.ones),
            (TD, lambda x: x.sum(), torch.ones)):
        jnative.reset_counters()
        step = dp.watch(fn, name="strict_step", strict=True)
        step(make((6,)))
        with pytest.raises(dp.RecompileError, match="strict_step"):
            step(make((7,)))
        assert jnative.counters()["device_recompiles"] == 1
        warm = dp.watch(fn, name="warm_step")
        warm.mark_warm()
        warm(make((2, 2)))
        assert jnative.counters()["device_recompiles"] == 2


def test_transfer_bytes_match_jax_and_kill_switch():
    tree = {"a": np.ones((8, 4), np.float32), "b": np.ones(8, np.int32)}
    want = 8 * 4 * 4 + 8 * 4
    assert JD.tree_bytes({k: jnp.asarray(v) for k, v in tree.items()}) \
        == want
    assert TD.tree_bytes(tree) == want
    assert TD.tree_bytes({k: torch.from_numpy(v) for k, v in tree.items()}
                         ) == want
    assert TD.count_h2d([tree, None, 3]) == want
    assert TD.count_d2h(torch.ones(8, 4, dtype=torch.bfloat16)) == 64
    ctr = tnative.counters()
    assert (ctr["h2d_bytes"], ctr["d2h_bytes"]) == (want, 64)
    TD.set_devprof(False)
    step = TD.watch(lambda x: x, name="off_step")
    step(torch.ones(4))
    step(torch.ones(9))
    assert TD.count_h2d(tree) == 0 and TD.count_d2h(tree) == 0
    assert TD.sample_device_mem("cpu") == (0, 0)
    ctr = tnative.counters()
    assert ctr["device_recompiles"] == ctr["device_compiles"] == 0
    assert TD.recompile_ledger() == []


def test_compile_summary_keys_and_kernel_build_hook(monkeypatch, tmp_path):
    assert set(TD.compile_summary()) == set(JD.compile_summary())
    # a kernel build (not a load of an earlier one) is one compile
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "lib.so"))
    monkeypatch.setattr(_build, "_compile_and_link",
                        lambda out: time.sleep(0.002))
    monkeypatch.setattr(_build, "_declare", lambda lib: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: "lib")
    assert _build.load_library() == "lib"
    s = TD.compile_summary()
    assert s["compiles"] == s["compile_events"] == 1
    assert s["compile_ms_total"] >= 2.0


def test_device_mem_gauges_reach_resource_section():
    keep = torch.ones(128, 64)  # held, so the census sees it
    nbytes, buffers = TD.sample_device_mem("cpu")
    assert nbytes >= keep.numel() * 4 and buffers >= 1
    res = TT.telemetry_json()["resource"]
    assert (res["device_mem_bytes"], res["device_buffers"]) == (nbytes,
                                                                buffers)
    assert TD.last_device_mem()["allocated"] == nbytes
    tnative.lib().eg_devprof_set_mem(1, 1)
    res2 = TT.telemetry_json()["resource"]
    assert res2["device_mem_bytes"] == 1
    assert res2["device_mem_peak_bytes"] >= nbytes
    assert "eg_device_mem_bytes 1" in TT.metrics_text()


# -------------------------------------------------------------------- trace


def test_chrome_trace_equals_jax():
    phases = [("input_stall", 100, 20, 0, "MainThread"),
              ("sample", 90, 25, 0, "Thread-1 (worker)"),
              ("device", 130, 400, 0, "MainThread"),
              ("step", 95, 600, None, "MainThread")]
    dump = {"slow_spans": [
        {"end_us": 500, "total_us": 40, "side": side, "op": "sample_fanout",
         "trace": "255", "outcome": "ok", "shard": 0, "queue_us": 1,
         "handler_us": 30, "wire_us": 9}
        for side in ("client", "server")]}
    base = [{"name": "k", "ph": "X", "ts": 1, "dur": 2, "pid": 200}]
    sources = [(dump, TTR.PID_TRAIN, "train"), (dump, 100, "shard 0")]
    got = TTR.chrome_trace(phases, sources, base)
    assert got == JTR.chrome_trace(phases, sources, base)
    TTR.validate_chrome_trace(got)
    assert TTR.correlated_trace_ids(got) == {"0xff"}


def test_recorder_taps_record_phase():
    rec = TTR.TraceRecorder(capacity=8).start()
    try:
        for i in range(10):
            TT.record_phase("host", 10, step=i)
    finally:
        rec.stop()
    assert len(rec.events()) == 8 and rec.dropped == 2
    TT.record_phase("host", 10)
    assert len(rec.events()) == 8


def test_ingest_aligns_a_kineto_file(tmp_path):
    """Kineto's device categories kept, host events dropped, shifted by
    the host marker's offset, the GPU lane remapped to PID_DEVICE_BASE."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "name": "eg_align:1000000",
         "pid": 9, "tid": 9, "ts": 500.5, "dur": 3.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "eg_align:7",
         "pid": 0, "tid": 7, "ts": 510.0, "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 9,
         "tid": 9, "ts": 520.0, "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "fanout2_kernel", "pid": 0,
         "tid": 7, "ts": 600.25, "dur": 7.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 590.0, "dur": 1.25},
    ]
    with gzip.open(tmp_path / "w.1.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    out = TTR.ingest_profiler_dir(str(tmp_path))
    xs = sorted((e for e in out if e["ph"] == "X"), key=lambda e: e["ts"])
    assert [(e["name"], e["ts"], e["dur"], e["pid"], e["tid"])
            for e in xs] == [
        ("Memcpy HtoD", 1000090, 1, 200, 7),
        ("fanout2_kernel", 1000100, 8, 200, 7)]
    assert {"name": "process_name", "ph": "M", "pid": 200,
            "args": {"name": "device: python"}} in out
    TTR.validate_chrome_trace({"traceEvents": out})
    assert TTR.ingest_profiler_dir(str(tmp_path / "none")) == []


def test_a_torch_profiler_capture_is_found_and_aligned(tmp_path):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    prof = profile(activities=[ProfilerActivity.CPU],
                   on_trace_ready=tensorboard_trace_handler(str(tmp_path)))
    prof.start()
    mono = TTR.now_us()
    with TTR.align_annotation(mono):
        pass
    torch.ones(64, 64) @ torch.ones(64, 64)
    prof.stop()
    path = TTR._latest_profiler_trace(str(tmp_path))
    assert path is not None and path.endswith(".pt.trace.json")
    events, offset = TTR.load_profiler_trace(path)
    marker = [e for e in events if e.get("name") == f"eg_align:{mono}"]
    assert len(marker) == 1 and offset == mono - float(marker[0]["ts"])
    assert TTR.ingest_profiler_dir(str(tmp_path)) == []  # no device lane


# ----------------------------------------------------------------- blackbox


def _postmortem_with_gauges(bb, service, fixture_dir: str, path: str):
    """A postmortem of one package's library written while a shard
    service of that library runs: its poller registers the admission
    snapshot within one 250 ms cycle, and from then on every dump of the
    library carries ``gauges``. Returns ``(path, doc)``; waits 10 s at
    most."""
    svc = service(fixture_dir, 0, 1)
    try:
        deadline = time.monotonic() + 10.0
        while True:
            doc = bb.postmortem_read(bb.write_postmortem(path))
            if "gauges" in doc or time.monotonic() > deadline:
                return path, doc
            time.sleep(0.05)
    finally:
        svc.stop()


def test_postmortem_round_trip_and_kill_switch(tmp_path, fixture_dir):
    """A dump of each package's library carries the same keys, the
    admission ``gauges`` included once each library has a shard service's
    snapshot registered (whichever tests ran before in this process)."""
    import euler_tpu
    from euler_tpu_torch.graph import GraphService

    TB.record("app", value=7)
    path, doc = _postmortem_with_gauges(
        TB, GraphService, fixture_dir,
        str(tmp_path / "pm" / "postmortem.a.json"))
    jpath, jdoc = _postmortem_with_gauges(
        JB, euler_tpu.GraphService, fixture_dir,
        str(tmp_path / "pm" / "postmortem.b.json"))
    assert "gauges" in doc and "gauges" in jdoc
    assert set(doc) == set(jdoc)
    assert set(doc["gauges"]) == set(jdoc["gauges"])
    assert doc["signal"] == 0 and doc["pid"] == os.getpid()
    values = [e["value"] for r in doc["rings"] for e in r["events"]
              if e["point"] == "app"]
    assert values == [7]
    # both files, in one package's format (equal mtimes order either way)
    assert sorted(d["path"] for d in TB.postmortem_read(
        str(tmp_path / "pm"))) == [path, jpath]
    with pytest.raises(ValueError):
        TB.record("nowhere")
    TB.blackbox_reset()
    TB.set_blackbox(False)
    TB.record("app", value=8)
    live = TB.blackbox_json()
    assert not live["enabled"] and all(not r["events"]
                                       for r in live["rings"])
    assert TB.history()["history"] is not None


def test_fatal_signal_writes_a_postmortem_in_a_port_only_process(tmp_path):
    """SIGSEGV in a process that imports only the port: its handler
    writes postmortem.<pid>.json with the device-memory gauges, and the
    process still dies by the signal."""
    code = (
        "import os, signal, sys\n"
        "from euler_tpu_torch import blackbox, devprof\n"
        "blackbox.install(sys.argv[1])\n"
        "devprof.sample_device_mem('cpu')\n"
        "blackbox.record('app', value=42)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'euler_tpu')]\n"
        "os.kill(os.getpid(), signal.SIGSEGV)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == -signal.SIGSEGV, out.stderr[-2000:]
    dumps = TB.postmortem_read(str(tmp_path))
    assert len(dumps) == 1, os.listdir(tmp_path)
    doc = dumps[0]
    assert doc["signal"] == signal.SIGSEGV and doc["kind"] != "exception"
    assert doc["resource_history"] and doc["backtrace_symbols"]
    assert any(e["point"] == "app" and e["value"] == 42
               for r in doc["rings"] for e in r["events"])


def test_graph_arms_the_flight_recorder_and_device_plane(fixture_dir,
                                                        tmp_path):
    """``Graph(blackbox=, devprof=, postmortem_dir=)`` arms the process's
    planes as the JAX package's graph does: the recorder's switch and
    postmortem directory, and the device plane's switch."""
    import euler_tpu
    from euler_tpu_torch.graph import Graph

    dirs = {}
    try:
        for name, make, bb, dp in (
                ("port", Graph, TB, TD),
                ("jax", euler_tpu.Graph, JB, JD)):
            pm = str(tmp_path / name)
            g = make(directory=fixture_dir, blackbox=True, devprof=True,
                     postmortem_dir=pm)
            live = bb.blackbox_json()
            assert live["enabled"] and dp.devprof_enabled()
            dirs[name] = live["postmortem_dir"]
            assert dirs[name].startswith(pm)
            g.close()
            g = make(directory=fixture_dir, blackbox=False, devprof=False)
            assert not bb.blackbox_json()["enabled"]
            assert not dp.devprof_enabled()
            g.close()
        assert dirs["port"][len(str(tmp_path / "port")):] == (
            dirs["jax"][len(str(tmp_path / "jax")):])
    finally:
        for bb, dp in ((TB, TD), (JB, JD)):
            bb.set_blackbox(True)
            dp.set_devprof(True)


@pytest.mark.parametrize("blackbox", ["1", "0"])
def test_shard_service_cli_writes_its_postmortem(fixture_dir, tmp_path,
                                                 blackbox):
    """``python -m euler_tpu_torch.graph.service --postmortem_dir D``
    killed by SIGSEGV leaves ``D/postmortem.<pid>.json``, with the
    shard's admission gauges; ``--blackbox 0`` leaves none. Either way
    the process dies by the signal."""
    pm = str(tmp_path / "pm")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "euler_tpu_torch.graph.service",
         "--data_dir", fixture_dir, "--shard_idx", "0", "--shard_num", "1",
         "--postmortem_dir", pm, "--blackbox", blackbox],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()  # "graph shard 0/1 serving on ..."
        assert "serving on" in line, line
        time.sleep(0.5)  # one admission poll cycle: the gauges register
        proc.send_signal(signal.SIGSEGV)
        assert proc.wait(timeout=60) == -signal.SIGSEGV
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    dumps = TB.postmortem_read(pm) if os.path.isdir(pm) else []
    if blackbox == "0":
        assert dumps == []
        return
    assert len(dumps) == 1, os.listdir(pm)
    doc = dumps[0]
    assert doc["signal_name"] == "SIGSEGV" and doc["pid"] == proc.pid
    assert set(doc["gauges"]) >= {"workers", "queue_depth", "conns"}


# ----------------------------------------------------------------- run_loop


def test_run_loop_writes_metrics_trace_profile_and_postmortem(fixture_dir,
                                                              tmp_path):
    """``run_loop`` with every plane on, on the CPU: a metrics line every
    2 steps with the JAX snapshot's keys, a valid merged trace with one
    ``step`` slice a step and the profiler's capture; then an unhandled
    exception writes its postmortem."""
    d = str(tmp_path)
    argv = ["--data_dir", fixture_dir, "--model_dir", d + "/ck",
            "--max_id", "16", "--feature_idx", "0", "--feature_dim", "2",
            "--label_idx", "2", "--label_dim", "3", "--train_edge_type",
            "0,1", "--fanouts", "3,2", "--dim", "8", "--batch_size", "4",
            "--num_epochs", "3", "--log_steps", "4", "--metrics_every", "2",
            "--metrics_file", d + "/m.jsonl", "--trace_file", d + "/t.json",
            "--profile_dir", d + "/prof", "--postmortem_dir", d + "/pm"]
    assert run_loop.main(argv, device="cpu") == 0
    steps = 12
    with open(d + "/m.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines] == list(range(2, steps + 1, 2))
    for mod in (JT,):
        for name in ("input_stall", "device"):
            mod.record_phase(name, 10)
        mod.record_prefetch_gauges(1, 1)
    assert set(lines[-1]) == set(JT.snapshot(1))
    # the hook runs after the step's device phase, before its step phase
    assert lines[-1]["phases"]["device"]["count"] == steps
    assert lines[-1]["phases"]["step"]["count"] == steps - 1
    with open(d + "/t.json") as f:
        trace = json.load(f)
    events = TTR.validate_chrome_trace(trace)
    step_events = [e for e in events
                   if e.get("cat") == "phase" and e["name"] == "step"]
    assert sorted(e["args"]["step"] for e in step_events) == list(
        range(steps))
    # the capture's recorded part carries the alignment marker
    prof_events, offset = TTR.load_profiler_trace(
        TTR._latest_profiler_trace(d + "/prof"))
    assert offset is not None and prof_events
    assert os.listdir(d + "/pm") == []  # armed, nothing died
    with pytest.raises(ValueError, match="unsupported model"):
        run_loop.main(argv + ["--model", "nope"], device="cpu")
    doc = TB.postmortem_read(
        os.path.join(d, "pm", f"postmortem.{os.getpid()}.exception.json"))
    assert doc["signal"] == 0
