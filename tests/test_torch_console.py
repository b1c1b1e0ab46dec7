"""``python -m euler_tpu_torch.console`` against the JAX package's
console on the fixture graph: each command prints the same lines, the
draws after the same ``eg_seed`` in each engine."""

import io
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from euler_tpu import console as jconsole  # noqa: E402
from euler_tpu import devprof as JD  # noqa: E402
from euler_tpu import telemetry as JT  # noqa: E402
from euler_tpu.graph import native as jnative  # noqa: E402

from euler_tpu_torch import console as tconsole  # noqa: E402
from euler_tpu_torch import devprof as TD  # noqa: E402
from euler_tpu_torch import telemetry as TT  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402

SIDES = ((jconsole, jnative), (tconsole, tnative))


@pytest.fixture(scope="module")
def consoles(fixture_dir):
    out = []
    for mod, _ in SIDES:
        c = mod.Console()
        with redirect_stdout(io.StringIO()):
            c.execute(f'con "directory={fixture_dir}"')
        out.append(c)
    yield out
    for c in out:
        c.graph.close()


@pytest.fixture(autouse=True)
def _clean_slate():
    for nat, tel, dp in ((jnative, JT, JD), (tnative, TT, TD)):
        nat.reset_counters()
        nat.stats_reset()
        tel.telemetry_reset()
        tel.set_telemetry(True)
        dp.devprof_reset()


def _run(console, nat, lines, seed=None) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        for line in lines:
            if seed is not None:
                nat.lib().eg_seed(seed)
            assert console.execute(line)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("lines", [
    ['nf dense "10, 11, 12" "0:2, 1:1"', 'nf sparse "10, 11" "0, 1"',
     'nf binary "10, 13" "0"'],
    ['ef dense "10:11:0, 12:13:1" "0:2"', 'ef sparse "10:11:0" "0"',
     'ef binary "10:11:0" "0"'],
    ['nb "10, 11, 12, 99" "0, 1"', 'nb "10" "1"'],
    ["sn 6", "sn 4 1", "se 5", "se 3 0"],
    ['walk "10, 11, 12" "0, 1" 4', 'walk "10" "0" 3 1.0 2.0'],
    ["epoch", "help nb", "nf dense"],
], ids=["nf", "ef", "nb", "sn_se", "walk", "epoch_help"])
def test_commands_print_what_jax_prints(consoles, lines):
    j, t = (_run(c, nat, lines, seed=7)
            for c, (_, nat) in zip(consoles, SIDES))
    assert t == j and t


def test_stats_print_what_jax_prints(consoles):
    """The same recorded phases and gauges in each package: ``stats
    phases`` and ``stats hist`` print the same lines; bare ``stats``
    (span timers and counters, one object in both engines) too, but for
    the port's roster line, which lists ``devprof``."""
    for mod, _ in ((JT, 0), (TT, 0)):
        for us in (25_000, 1_200, 800):
            mod.record_phase("input_stall", us)
            mod.record_phase("device", us // 2)
        mod.record_prefetch_gauges(2, 1)
    tnative.counter_add("prefetch_worker_errors", 2)
    _run(consoles[1], tnative, ['nb "10" "0"'])  # a span timer
    for sub in (["stats phases"], ["stats hist"], ["stats"]):
        j, t = (_run(c, nat, sub) for c, (_, nat) in zip(consoles, SIDES))
        if sub == ["stats"]:
            assert t[-1] == j[-1].replace("heat | reset",
                                          "heat | devprof | reset")
            j, t = j[:-1], t[:-1]
        assert t == j and t, sub
    assert any("'prefetch_worker_errors': 2" in x
               for x in _run(consoles[1], tnative, ["stats phases"]))


def test_stats_devprof(consoles):
    TD.record_compile(1500)
    tnative.counter_add("h2d_bytes", 4096)
    step = TD.watch(lambda x: x, name="console_step")
    step(torch.ones(3))
    step(torch.ones(4))
    out = _run(consoles[1], tnative, ["stats devprof"])
    assert out[0] == "devprof on  compiles 3  recompiles 1  " \
        "serve_recompiles 0"
    assert out[1].startswith("compile: 3 event(s), total ")
    assert out[2] == "transfers: h2d 4096 B  d2h 0 B"
    assert out[-2] == "recompile ledger (last 1 of 1):"
    assert out[-1].startswith("  console_step ") and out[-1].endswith(
        "us: leaf0: (3,) float32 -> (4,) float32")
