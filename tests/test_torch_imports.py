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
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import SupervisedGraphSage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = Graph(**build_synthetic(30, 3, 4, 2, max_degree=5))
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
    before = sampling_kernels.launches
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
