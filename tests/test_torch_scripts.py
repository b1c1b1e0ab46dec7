"""The port's operator tools (``euler_tpu_torch/scripts/``) against the
JAX package's ``scripts/`` on the CPU.

Each JAX script is loaded from ``scripts/`` with importlib (it imports
``euler_tpu`` lazily, inside its functions). The same recorded inputs go
through both tools' pure functions: scrapes, heat dumps, the counter
ledger and a postmortem, recorded once from a live in-process cluster of
the port's shards, and a capture in the ``torch.profiler`` format that
both ``ingest_profiler_dir``s read. Printed output must match exactly,
returned numbers within rtol 1e-6. Then every tool's ``--smoke`` (and
``heat_dump --ab-smoke``) and both drills' ``--smoke`` run on the CPU as
``python -m euler_tpu_torch.scripts.<tool>`` subprocesses, all started
together, each wait bounded; the drills at their defaults are ``slow``.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
TOOLS = ("metrics_dump", "trace_dump", "postmortem", "heat_dump",
         "devprof_dump", "epoch_drill", "serve_drill")
# each smoke's wait: they take 2-12 s alone on this CPU, started together
SMOKE_TIMEOUT_S = 240
# the drills at their JAX defaults (slow)
DRILL_TIMEOUT_S = 900


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_script(name):
    return importlib.import_module(f"euler_tpu_torch.scripts.{name}")


def _printed(fn, *args, **kwargs):
    """(return value, stdout) of ``fn``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _close(a, b, path="root"):
    """Equal trees, floats within RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_every_tool_has_the_jax_scripts_functions():
    """Each port tool defines the functions of its JAX script (by name)
    and runs as ``python -m euler_tpu_torch.scripts.<tool>``."""
    import ast

    for name in TOOLS:
        def funcs(path):
            tree = ast.parse(open(path).read())
            return {n.name for n in tree.body
                    if isinstance(n, ast.FunctionDef)}

        jax_fns = funcs(os.path.join(REPO, "scripts", f"{name}.py"))
        port_fns = funcs(os.path.join(REPO, "euler_tpu_torch", "scripts",
                                      f"{name}.py"))
        assert jax_fns <= port_fns, (name, jax_fns - port_fns)
        assert "main" in port_fns


@pytest.mark.parametrize("name", TOOLS)
def test_tool_keeps_the_jax_flags(name, monkeypatch):
    """Every flag of the JAX script is a flag of the port's tool; the
    port adds only ``--device`` (the tools that touch the card)."""
    import argparse

    def flags(mod):
        seen = []

        def grab(self, args=None, namespace=None):
            seen.append({a for act in self._actions
                         for a in act.option_strings})
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        monkeypatch.setattr(sys, "argv", [name])
        with pytest.raises(SystemExit):
            if hasattr(mod, "_parse_args"):
                mod._parse_args([])
            else:
                mod.main()
        return seen[0]

    want, got = flags(_jax_script(name)), flags(_port_script(name))
    assert want <= got and got - want <= {"--device"}, (want, got)


# ---- recorded inputs ----


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """One live in-process 2-shard cluster of the port's shards over the
    power-law fixture, after training-shaped traffic: each shard's scrape
    and heat dump, the client's heat dump and counter ledger, the
    client's trace (``trace.write_trace``) and a postmortem of this
    process (``blackbox.write_postmortem``), read back."""
    from euler_tpu_torch import blackbox, heat
    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch import trace as TR
    from euler_tpu_torch.graph import Graph, GraphService, native
    from euler_tpu_torch.scripts.heat_dump import probe_workload
    from euler_tpu_torch.scripts.powerlaw import build_powerlaw_fixture

    tmp = tmp_path_factory.mktemp("recorded")
    data = str(tmp / "data")
    os.makedirs(data)
    build_powerlaw_fixture(data, 300, 10, 8)
    svcs = [GraphService(data, s, 2) for s in range(2)]
    g = Graph(mode="remote", shards=[s.address for s in svcs], retries=2,
              timeout_ms=3000)
    try:
        T.telemetry_reset()
        native.reset_counters()
        T.record_phase("input_stall", 1500)
        probe = probe_workload(g, steps=3, batch=32, fanouts=(5, 5))
        out = {
            "probe": probe,
            "scrapes": [T.scrape(g, s) for s in range(g.num_shards)],
            "heat": {s: heat.heat_json(g, s) for s in range(g.num_shards)},
            "counters": native.counters(),
        }
        out["heat"][None] = heat.heat_json()
        out["client_trace"] = TR.write_trace(str(tmp / "client.json"), None,
                                             g)
        pm = blackbox.write_postmortem(str(tmp / "postmortem.1.json"))
        out["dumps"] = [blackbox.postmortem_read(pm)]
    finally:
        g.close()
        for s in svcs:
            s.stop()
    assert out["dumps"][0]["rings"], "the postmortem holds no ring"
    return out


class _Shards:
    """The graph the tools see: its shard count and placement flag."""

    def __init__(self, n, placement=False):
        self.num_shards = n
        self.has_placement = placement


def _patch_scrape(monkeypatch, scrapes):
    import euler_tpu.telemetry as jt

    from euler_tpu_torch import telemetry as tt

    for mod in (jt, tt):
        monkeypatch.setattr(mod, "scrape", lambda g, s: scrapes[s])


# ---- metrics_dump ----


def test_metrics_dump_rate_and_served_total_match_jax(recorded):
    jm, tm = _jax_script("metrics_dump"), _port_script("metrics_dump")
    for delta, dt in ((0, 0.0), (7, 0.0), (7, 2.0), (-3, 0.5), (10**6, 3.3),
                      (1, -1.0)):
        assert tm._rate(delta, dt) == jm._rate(delta, dt)
    for data in recorded["scrapes"]:
        assert tm._served_total(data) == jm._served_total(data) > 0


@pytest.mark.parametrize("as_json", [False, True])
def test_metrics_dump_dump_cluster_matches_jax(recorded, monkeypatch,
                                               as_json):
    """``dump_cluster`` on the same scrapes prints the same text (or
    JSON, ``--json``) and returns the same dicts."""
    jm, tm = _jax_script("metrics_dump"), _port_script("metrics_dump")
    _patch_scrape(monkeypatch, recorded["scrapes"])
    g = _Shards(2)
    want, want_out = _printed(jm.dump_cluster, g, as_json=as_json)
    got, got_out = _printed(tm.dump_cluster, g, as_json=as_json)
    assert got_out == want_out and got_out
    _close(want, got)
    if as_json:
        _close(json.loads(want_out), json.loads(got_out))
    else:
        assert "p99_us" in got_out and "input_stall" in got_out


# ---- postmortem ----


def test_postmortem_summarize_merge_and_correlate_match_jax(recorded):
    jp, tp = _jax_script("postmortem"), _port_script("postmortem")
    dumps, base = recorded["dumps"], recorded["client_trace"]
    for d in dumps:
        want, got = io.StringIO(), io.StringIO()
        jp.summarize(d, out=want)
        tp.summarize(d, out=got)
        assert got.getvalue() == want.getvalue() and "ring tid=" in \
            got.getvalue()
        for pid in (200, 251):
            _close(jp._dump_trace_events(d, pid),
                   tp._dump_trace_events(d, pid))
    for b in (None, base):
        want, got = jp.merge_trace(dumps, b), tp.merge_trace(dumps, b)
        _close(want, got)
        assert tp.correlated_fatal_ids(got) == jp.correlated_fatal_ids(want)
    # the client's calls sit in this process's flight recorder too
    assert tp.correlated_fatal_ids(tp.merge_trace(dumps, base))


# ---- heat_dump ----


@pytest.mark.parametrize("with_probe", [True, False])
def test_heat_dump_build_and_print_report_match_jax(recorded, monkeypatch,
                                                    with_probe):
    """``build_report`` over the same heat dumps, counter ledger and probe
    dict gives the same report (numbers within rtol 1e-6) and
    ``print_report`` the same text."""
    import euler_tpu
    import euler_tpu.heat as jh

    from euler_tpu_torch import heat as th
    from euler_tpu_torch.graph import native as tn

    jd, td = _jax_script("heat_dump"), _port_script("heat_dump")
    heat = recorded["heat"]
    for mod in (jh, th):
        monkeypatch.setattr(mod, "heat_json",
                            lambda graph=None, shard=None: heat[shard])
    ctr = dict(recorded["counters"])
    monkeypatch.setattr(euler_tpu, "counters", lambda: ctr)
    monkeypatch.setattr(tn, "counters", lambda: ctr)
    g = _Shards(2)
    probe = recorded["probe"] if with_probe else None
    want = jd.build_report(g, probe, cache_mb=64, row_bytes=128)
    got = td.build_report(g, probe, cache_mb=64, row_bytes=128)
    _close(want, got)
    assert got["shards"][0]["topk"] and got["summary"]["ids_on_wire"] > 0
    assert ("edge_cut" in got) == with_probe
    for top_n in (3, 10):
        _, want_out = _printed(jd.print_report, want, top_n)
        _, got_out = _printed(td.print_report, got, top_n)
        assert got_out == want_out and "== client ==" in got_out


# ---- devprof_dump ----


def _profiler_capture(root):
    """A capture in the ``torch.profiler`` (Kineto) trace format, written
    where each package's ``ingest_profiler_dir`` looks: ``<dir>/*.pt.
    trace.json`` (the port's) and ``<dir>/plugins/profile/<run>/`` (the
    JAX package's). Device kernels on a GPU lane, beside host ops."""
    rng = np.random.default_rng(3)
    events = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"name": "process_name", "ph": "M", "pid": 4242,
         "args": {"name": "python"}},
        {"name": "eg_align:1000000", "ph": "X", "cat": "user_annotation",
         "pid": 4242, "tid": 1, "ts": 500, "dur": 1},
    ]
    names = ["void (anonymous namespace)::fanout2_kernel<8>(int const*)",
             "ampere_sgemm_128x64_nn", "void at::native::index_select",
             "Memcpy HtoD (Pageable -> Device)", "elementwise_kernel"]
    cats = ["kernel", "kernel", "kernel", "gpu_memcpy", "kernel"]
    ts = 1000
    for i in range(60):
        k = int(rng.integers(0, len(names)))
        dur = int(rng.integers(1, 90))
        events.append({"name": names[k], "ph": "X", "cat": cats[k],
                       "pid": 0, "tid": 7, "ts": ts, "dur": dur})
        events.append({"name": "aten::mm", "ph": "X", "cat": "cpu_op",
                       "pid": 4242, "tid": 1, "ts": ts, "dur": 3})
        ts += dur + int(rng.integers(0, 5))
    text = json.dumps({"traceEvents": events})
    os.makedirs(os.path.join(root, "plugins", "profile", "run1"))
    for path in (os.path.join(root, "host.1.pt.trace.json"),
                 os.path.join(root, "plugins", "profile", "run1",
                              "host.pt.trace.json")):
        with open(path, "w") as f:
            f.write(text)


@pytest.mark.parametrize("topk", [3, 15])
def test_devprof_dump_kernel_table_matches_jax(tmp_path, topk):
    jd, td = _jax_script("devprof_dump"), _port_script("devprof_dump")
    _profiler_capture(str(tmp_path))
    want, want_out = _printed(jd.kernel_table, str(tmp_path), topk=topk)
    got, got_out = _printed(td.kernel_table, str(tmp_path), topk=topk)
    assert got_out == want_out and got == want
    assert len(got) == min(topk, 5) and "device kernels" in got_out


def test_devprof_dump_compile_table_matches_jax(recorded):
    jd, td = _jax_script("devprof_dump"), _port_script("devprof_dump")
    sources = [(f"shard {s}", d) for s, d in enumerate(recorded["scrapes"])]
    _, want_out = _printed(jd.compile_table, sources)
    _, got_out = _printed(td.compile_table, sources)
    assert got_out == want_out and "compile table" in got_out


def test_devprof_dump_lists_host_ops_of_a_cpu_capture(tmp_path):
    """A capture with no device lane (the CPU's) lists its host ops."""
    td = _port_script("devprof_dump")
    prof = str(tmp_path)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        torch.ones(64, 32).matmul(torch.ones(32, 64)).sum()
    p.export_chrome_trace(os.path.join(prof, "cpu.pt.trace.json"))
    rows, out = _printed(td.kernel_table, prof, topk=4)
    assert "host ops, no device lane" in out
    assert 0 < len(rows) <= 4 and all(r[2] > 0 for r in rows)
    assert any(r[0].startswith("aten::") for r in rows)


# ---- the smokes, as a user runs them ----


SMOKES = {
    "metrics_dump": ["--smoke"],
    "trace_dump": ["--smoke", "--device", "cpu"],
    "postmortem": ["--smoke"],
    "heat_dump": ["--smoke"],
    "heat_dump_ab": ["--ab-smoke"],
    "devprof_dump": ["--smoke", "--device", "cpu"],
    "epoch_drill": ["--smoke", "--device", "cpu"],
    "serve_drill": ["--smoke", "--device", "cpu"],
}


def _start(tool, argv, tmp, log_name=None):
    """``python -m euler_tpu_torch.scripts.<tool> argv`` with its output
    in ``<log_name or tool>.log``. Each process runs its torch ops on one
    intra-op thread: the smokes all start at once, and more threads than
    cores only contend."""
    log = open(os.path.join(tmp, f"{log_name or tool}.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"euler_tpu_torch.scripts.{tool}", *argv],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, TMPDIR=tmp,
                           OMP_NUM_THREADS="1"),
        stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def _finish(proc, log, timeout_s):
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
        rc = "timeout"
    log.seek(0)
    return rc, log.read()


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """Every smoke started at once, each in its own process."""
    tmp = str(tmp_path_factory.mktemp("smokes"))
    procs = {name: _start(name.removesuffix("_ab"), argv, tmp, name)
             for name, argv in SMOKES.items()}
    yield procs
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        log.close()


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_smoke_exits_zero(smoke_runs, name):
    t0 = time.monotonic()
    rc, out = _finish(*smoke_runs[name], SMOKE_TIMEOUT_S)
    assert rc == 0, f"{name} exited {rc}:\n{out[-3000:]}"
    word = {"heat_dump_ab": "locality A/B smoke: OK",
            "epoch_drill": "== epoch drill OK",
            "serve_drill": "== serve drill OK"}.get(name,
                                                    f"{name} smoke: OK")
    assert word in out, out[-3000:]
    assert time.monotonic() - t0 < SMOKE_TIMEOUT_S


def test_smoke_fails_loudly(tmp_path):
    """A failed check exits non-zero: the epoch drill with too small a
    graph refuses to run (fewer than 20 nodes outside its closure)."""
    proc, log = _start("epoch_drill", ["--num_nodes", "30", "--train_steps",
                                       "2", "--device", "cpu"],
                       str(tmp_path))
    rc, out = _finish(proc, log, SMOKE_TIMEOUT_S)
    log.close()
    assert rc == 1 and "drill config error" in out, out[-2000:]


@pytest.mark.slow
@pytest.mark.parametrize("tool", ["epoch_drill", "serve_drill"])
def test_drill_at_its_defaults(tmp_path, tool):
    """The drills at the JAX scripts' defaults (not ``--smoke``)."""
    proc, log = _start(tool, ["--device", "cpu"], str(tmp_path))
    rc, out = _finish(proc, log, DRILL_TIMEOUT_S)
    log.close()
    assert rc == 0 and " OK (" in out, out[-3000:]


def test_tools_refuse_without_a_card(monkeypatch):
    """``--device`` defaults to the card: with none, the tools that touch
    it raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool, argv in (("devprof_dump", ["--smoke"]),
                       ("trace_dump", ["--smoke"]),
                       ("epoch_drill", ["--smoke"]),
                       ("serve_drill", ["--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            _port_script(tool).main(argv)
