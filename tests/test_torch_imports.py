"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, no module of it names them, and its entry points refuse to
fall back to the CPU when no card is present."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "euler_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__"
        )
        for p in PKG.rglob("*.py")
    )


def test_import_loads_no_jax_and_no_euler_tpu():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) or m == 'euler_tpu' "
        "or m.startswith('euler_tpu.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "scripts/torch_step_profile.py"],
)
def test_source_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [
        n for n in names
        if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "euler_tpu")
    ]
    assert bad == [], f"{path} imports {bad}"


def test_scan_covers_the_examples_and_the_rehearsals():
    """The user's way in is scanned too: the examples and the two dress
    rehearsals are modules of the package, in the scan above."""
    scanned = {p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")}
    for path in ("examples/sage.py", "examples/sage_reddit.py",
                 "examples/custom_sage_reddit.py",
                 "scripts/ppi_dress_rehearsal.py",
                 "scripts/reddit_dress_rehearsal.py", "convergence.py"):
        assert f"euler_tpu_torch/{path}" in scanned


def test_resolve_device_raises_without_a_card(monkeypatch):
    from euler_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no.*available|none is available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Model.init_state and device_sample_batch run on the card unless
    asked for the CPU: with no card they raise instead of falling back."""
    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import MemoryGraph
    from euler_tpu_torch.models import SupervisedGraphSage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = MemoryGraph(**build_synthetic(30, 3, 4, 2, max_degree=5))
    m = SupervisedGraphSage(
        label_idx=0, label_dim=2, metapath=[[0], [0]], fanouts=[2, 2],
        dim=8, feature_idx=1, feature_dim=4, max_id=29,
        device_features=True, device_sampling=True,
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_state(g, train.get_optimizer("adam", 0.01))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device_sample_batch([1, 2], seed=0)
    state = m.init_state(g, train.get_optimizer("adam", 0.01), device="cpu")
    assert next(state["module"].parameters()).device.type == "cpu"


def test_kernel_wrapper_routes_by_device():
    """CPU tensors take the plain version without touching the kernel's
    build; tensors on another device are refused."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    adj = {
        "nbr": torch.tensor([[1, 2], [0, 2], [2, 2]], dtype=torch.int32),
        "cum": torch.tensor([[0.5, 1.0], [0.25, 1.0], [1.0, 1.0]]),
        "sampleable": torch.ones(3, dtype=torch.bool),
    }
    roots = torch.tensor([0, 1], dtype=torch.int32)
    before = dict(sampling_kernels.launches)
    h1, h2 = sampling_kernels.sample_fanout2(
        adj, adj, roots, device_graph.seed_words(3), 2, 3
    )
    assert h1.shape == (2, 2) and h2.shape == (4, 3)
    assert h1.dtype == torch.int32 and h2.dtype == torch.int32
    assert sampling_kernels.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sampling_kernels.sample_fanout2(
            adj, adj, roots.to("meta"), (0, 0), 2, 3
        )
    with pytest.raises(ValueError, match="both"):
        sampling_kernels.sample_fanout2(
            adj, adj, roots, (0, 0), 2, 3, u1=torch.zeros(2, 2)
        )


def _tiny_adj():
    return {
        "nbr": torch.tensor([[1, 2], [0, 2], [2, 2]], dtype=torch.int32),
        "cum": torch.tensor([[0.5, 1.0], [0.25, 1.0], [1.0, 1.0]]),
        "sampleable": torch.ones(3, dtype=torch.bool),
    }


def test_single_hop_kernel_wrapper_routes_by_device():
    """sample_neighbor: CPU tensors take the plain version (and leave
    the launch counts alone), other devices and misshapen injected
    uniforms are refused."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    adj = _tiny_adj()
    nodes = torch.tensor([[0, 1, 2], [1, 0, -4]], dtype=torch.int32)
    words = device_graph.seed_words(5)
    before = dict(sampling_kernels.launches)
    out = sampling_kernels.sample_neighbor(adj, nodes, words, 4, hop=2)
    assert out.shape == (2, 3, 4) and out.dtype == torch.int32
    assert torch.equal(out, sampling_kernels.sample_neighbor_reference(
        adj, nodes, words, 4, hop=2))
    assert sampling_kernels.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sampling_kernels.sample_neighbor(adj, nodes.to("meta"), words, 4)
    with pytest.raises(ValueError, match="u must be"):
        sampling_kernels.sample_neighbor(adj, nodes, words, 4,
                                         u=torch.zeros(4, 6))
    u = torch.rand(6, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(
        sampling_kernels.sample_neighbor(adj, nodes, words, 4, u=u),
        sampling_kernels.sample_neighbor(adj, nodes, words, 4,
                                         u=u.reshape(2, 3, 4)),
    )


def test_unsupervised_entry_points_default_to_the_card(monkeypatch):
    """GraphSage.init_state and device_sample_batch run on the card
    unless asked for the CPU; host sampling over device feature tables
    uploads the features alone."""
    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import MemoryGraph
    from euler_tpu_torch.models import GraphSage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = MemoryGraph(**build_synthetic(30, 3, 4, 2, max_degree=5))
    kw = dict(node_type=0, edge_type=[0], max_id=29, metapath=[[0], [0]],
              fanouts=[2, 2], dim=8, num_negs=2, feature_idx=1,
              feature_dim=4, device_features=True)
    host = GraphSage(**kw)
    assert host.device_features and not host.device_sampling
    assert sorted(host.build_consts(g, "cpu")) == ["features"]
    m = GraphSage(**kw, device_sampling=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_state(g, train.get_optimizer("adam", 0.01))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device_sample_batch([1, 2], seed=0)
    state = m.init_state(g, train.get_optimizer("adam", 0.01), device="cpu")
    assert next(state["module"].parameters()).device.type == "cpu"
    assert state["consts"]["negs"]["ids"].device.type == "cpu"


_CTYPE_OF = {"int": "c_int", "uint32_t": "c_uint32"}


def test_c_entries_declared_with_matching_argtypes():
    """Every ``extern "C"`` entry in ``csrc/*.cu`` gets an ``argtypes``
    list of its arity from ``_build._declare``: ``c_void_p`` for every
    pointer (the stream included), ``c_int`` for ``int``, ``c_uint32`` for
    ``uint32_t``, and ``restype`` ``c_int``. An undeclared pointer would
    pass as a 32-bit int and be cut. Parsed from the sources; a stub stands
    in for the ``CDLL``, so no compiler is needed."""
    import ctypes
    import re
    import types

    from euler_tpu_torch import _build

    entries = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for name, params in re.findall(
            r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', src.read_text()
        ):
            want = []
            for param in filter(None, (p.strip() for p in params.split(","))):
                if "*" in param:
                    want.append(ctypes.c_void_p)
                else:
                    ctype = param.rsplit(None, 1)[0].removeprefix("const ")
                    want.append(getattr(ctypes, _CTYPE_OF[ctype]))
            entries[name] = want
    assert {"etpu_sample_fanout2", "etpu_sample_neighbor",
            "etpu_draw_max_width", "etpu_launch_floor"} <= set(entries)

    class Stub:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, types.SimpleNamespace())

    stub = Stub()
    assert _build._declare(stub) is stub
    assert set(stub.fns) == set(entries)
    for name, want in entries.items():
        fn = stub.fns[name]
        assert fn.argtypes == want, name
        assert fn.restype is ctypes.c_int, name


def test_native_builds_and_loads_only_the_ports_engine():
    """graph/native.py builds the engine from the port's copy of its
    sources into build/euler_tpu_torch/native and loads that library: it
    reads no EG_NATIVE_LIB override, and building and loading it (in a
    subprocess under an audit hook) opens, runs and loads nothing under
    the JAX package's directory."""
    src = (PKG / "graph" / "native.py").read_text()
    assert "EG_NATIVE_LIB" not in src and "environ" not in src
    code = (
        "import os, sys\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen', 'subprocess.Popen'):\n"
        "        seen.append(repr(args))\n"
        "sys.addaudithook(hook)\n"
        "from euler_tpu_torch.graph import native\n"
        "native.lib()\n"
        "print(native.NATIVE_DIR)\n"
        "print(native.library_path())\n"
        "bad = [s for s in seen if os.sep + 'euler_tpu' + os.sep in s]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    native_dir, lib, bad = out.stdout.strip().splitlines()
    assert pathlib.Path(native_dir) == PKG / "graph" / "_native"
    assert pathlib.Path(lib).parent == REPO / "build" / "euler_tpu_torch" \
        / "native"
    assert bad == "[]"
