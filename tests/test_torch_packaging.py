"""The port as it installs: ``setup.py`` ships every source the port
builds at first use (the engine's and the kernels'), its four commands
import without JAX, a build directory that cannot be written raises
naming it, and both dress rehearsals run prepare, train and evaluate on
the CPU at a few thousand nodes."""

import ast
import fnmatch
import os
import pathlib
import re
import subprocess
import sys

import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "euler_tpu_torch"


def _setup_literals() -> dict:
    """The ``package_data`` and ``entry_points`` literals of setup.py."""
    tree = ast.parse((REPO / "setup.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "setup")
    kw = {k.arg: k.value for k in call.keywords}
    return {"package_data": ast.literal_eval(kw["package_data"]),
            "entry_points": ast.literal_eval(kw["entry_points"])}


def _shipped(path: pathlib.Path) -> bool:
    """Whether a ``package_data`` glob of setup.py ships ``path``."""
    for pkg, globs in _setup_literals()["package_data"].items():
        root = REPO.joinpath(*pkg.split("."))
        if root in path.parents:
            rel = path.relative_to(root).as_posix()
            if any(fnmatch.fnmatch(rel, g) for g in globs):
                return True
    return False


def _makefile_inputs() -> list:
    """The sources and headers the engine's Makefile compiles."""
    native = PKG / "graph" / "_native"
    text = (native / "Makefile").read_text()
    srcs = re.search(r"^SRCS := (.*)$", text, re.M).group(1).split()
    deps = re.search(r"^\$\(OUT\)/%\.o: %\.cc (.*)$", text, re.M).group(1)
    return [native / "Makefile"] + [native / f for f in srcs + deps.split()]


def test_setup_ships_every_source_the_port_builds():
    inputs = _makefile_inputs() + sorted((PKG / "csrc").glob("*.cu*"))
    assert len(inputs) > 30 and all(p.exists() for p in inputs)
    missing = [str(p.relative_to(REPO)) for p in inputs if not _shipped(p)]
    assert missing == []
    assert _shipped(PKG / "examples" / "dist_train.sh")


def test_commands_import_without_jax():
    """Each ``euler-tpu-torch*`` command's target imports and loads
    neither JAX nor the JAX package."""
    scripts = _setup_literals()["entry_points"]["console_scripts"]
    targets = dict(s.replace(" ", "").split("=") for s in scripts)
    ours = {k: v for k, v in targets.items()
            if k.startswith("euler-tpu-torch")}
    assert sorted(ours) == ["euler-tpu-torch", "euler-tpu-torch-console",
                            "euler-tpu-torch-convert",
                            "euler-tpu-torch-service"]
    code = (
        "import importlib, sys\n"
        f"for t in {sorted(ours.values())!r}:\n"
        "    mod, fn = t.split(':')\n"
        "    assert callable(getattr(importlib.import_module(mod), fn))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'euler_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_dist_train_launches_the_ports_modules():
    text = (PKG / "examples" / "dist_train.sh").read_text()
    modules = re.findall(r"-m (\S+)", text)
    assert modules == ["euler_tpu_torch.graph.service", "euler_tpu_torch"]
    assert subprocess.run(["bash", "-n", str(PKG / "examples" /
                                             "dist_train.sh")]).returncode == 0


@pytest.mark.parametrize("module", ["native", "kernels"])
def test_unwritable_build_dir_raises_naming_it(tmp_path, monkeypatch,
                                               module):
    """A build directory that cannot be made raises before any build,
    with the directory in its message (here a path through a file)."""
    from euler_tpu_torch import _build
    from euler_tpu_torch.graph import native

    blocked = tmp_path / "file"
    blocked.write_text("")
    target = str(blocked / "build")
    if module == "native":
        monkeypatch.setattr(native, "BUILD_DIR", target)
        with pytest.raises(RuntimeError, match=re.escape(target)):
            native.build_native()
    else:
        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setattr(_build, "_build_dir", target)
        monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
        with pytest.raises(RuntimeError, match=re.escape(target)):
            _build.load_library()


def test_ppi_dress_rehearsal_runs_on_the_cpu(tmp_path):
    from euler_tpu_torch.scripts import ppi_dress_rehearsal

    summary = ppi_dress_rehearsal.run(
        num_nodes=2000, num_links=20000, epochs=1, batch_size=512, dim=256,
        workdir=str(tmp_path), device="cpu")
    assert summary["train_rc"] == 0 and summary["evaluate_rc"] == 0
    assert summary["card"] == "cpu"
    s = summary["splits"]
    assert s["train"] > s["val"] > 0 and s["test"] > 0
    assert 0.0 <= summary["val_metrics"]["f1"] <= 1.0


def test_reddit_dress_rehearsal_runs_on_the_cpu(tmp_path):
    from euler_tpu_torch.scripts import reddit_dress_rehearsal

    summary = reddit_dress_rehearsal.run(
        num_nodes=2000, avg_degree=10, epochs=1, batch_size=200,
        workdir=str(tmp_path), device="cpu")
    assert summary["train_rc"] == 0 and summary["evaluate_rc"] == 0
    s = summary["splits"]
    assert s["train"] > s["test"] > s["val"] > 0
    assert s["edges"] == 2000 * 11
    assert 0.0 <= summary["val_metrics"]["f1"] <= 1.0
