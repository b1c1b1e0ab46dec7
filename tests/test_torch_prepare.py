"""The port's dataset preparers, their CLI and the planted-community
builder against the JAX package's ``datasets``.

``prepare_ppi`` and ``prepare_reddit`` run on miniature files in the
source formats (the GraphSAGE release's ``-G.json``, ``-feats.npy``,
``-id_map.json``, ``-class_map.json``; DGL's two npz files), written in
``tests/test_prepare_real.py``'s style, and must write the JAX
package's files byte for byte, as must the CLI's four commands (the
synthetic ones at a cut size) and ``build_planted``, whose arrays and
separability bounds must equal JAX's from the same seed.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from euler_tpu import datasets as jd  # noqa: E402

from euler_tpu_torch import datasets as td  # noqa: E402
from euler_tpu_torch.graph import Graph, MemoryGraph  # noqa: E402
from tests.test_prepare_real import (PPI_CLASSES, PPI_LINKS,  # noqa: E402
                                     PPI_NODES)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _ppi_files(prefix: str, unannotated: bool = False) -> str:
    """The miniature GraphSAGE-format PPI (six nodes; a seventh without
    val/test annotations when asked)."""
    nodes = PPI_NODES + ([{"id": 6}] if unannotated else [])
    n = len(nodes)
    with open(prefix + "-G.json", "w") as f:
        json.dump({"nodes": nodes, "links": PPI_LINKS}, f)
    np.save(prefix + "-feats.npy",
            np.random.default_rng(0).standard_normal((n, 4)))
    with open(prefix + "-id_map.json", "w") as f:
        json.dump({str(i): i for i in range(n)}, f)
    with open(prefix + "-class_map.json", "w") as f:
        json.dump({**PPI_CLASSES, "6": 1}, f)  # one scalar label
    return prefix


def _reddit_files(src: str, n: int = 9) -> str:
    """Miniature DGL reddit: a ring with self loops and chords."""
    import scipy.sparse as sp

    os.makedirs(src)
    rows, cols = [], []
    for i in range(n):
        for j in {i, (i + 1) % n, (i - 1) % n, (i * 4) % n}:
            rows.append(i)
            cols.append(j)
    sp.save_npz(os.path.join(src, "reddit_self_loop_graph.npz"),
                sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                              shape=(n, n)).tocsr())
    rng = np.random.default_rng(1)
    np.savez(os.path.join(src, "reddit_data.npz"),
             feature=rng.standard_normal((n, 5)).astype(np.float32),
             node_ids=np.arange(n), label=rng.integers(0, 4, n),
             node_types=rng.integers(1, 4, n))
    return src


@pytest.mark.parametrize("parts,unannotated,normalize", [
    (2, False, True), (1, True, True), (3, False, False)])
def test_prepare_ppi_writes_the_jax_files(tmp_path, parts, unannotated,
                                          normalize):
    prefix = _ppi_files(str(tmp_path / "ppi"), unannotated)
    t = td.prepare_ppi(prefix, str(tmp_path / "t"), parts, normalize)
    j = jd.prepare_ppi(prefix, str(tmp_path / "j"), parts, normalize)
    got = _files(t)
    assert got == _files(j)
    assert sorted(got) == ["meta.json"] + [
        f"part_{p}.dat" for p in range(parts)] + ["test.id", "train.id",
                                                  "val.id"]
    g = Graph(directory=t)
    assert g.num_nodes == 6
    g.close()


@pytest.mark.parametrize("parts", [1, 2])
def test_prepare_reddit_writes_the_jax_files(tmp_path, parts):
    src = _reddit_files(str(tmp_path / "src"))
    t = td.prepare_reddit(src, str(tmp_path / "t"), parts)
    j = jd.prepare_reddit(src, str(tmp_path / "j"), parts)
    assert _files(t) == _files(j)


@pytest.mark.parametrize("cmd", ["ppi", "reddit", "prepare_ppi",
                                 "prepare_reddit"])
def test_cli_commands_write_the_jax_files(tmp_path, monkeypatch, capsys,
                                          cmd):
    """``main`` runs each command; the synthetic graphs at a cut size
    (the builders' dicts shrunk in both packages)."""
    small = dict(num_nodes=40, feature_dim=3, label_dim=4)
    for mod in (td, jd):
        for k, v in small.items():
            monkeypatch.setitem(mod.PPI, k, v)
            monkeypatch.setitem(mod.REDDIT, k, v)
    out = str(tmp_path / "t")
    argv = [cmd, "--out", out, "--partitions", "2"]
    if cmd == "prepare_ppi":
        prefix = _ppi_files(str(tmp_path / "ppi"))
        argv += ["--prefix", prefix]
        want = jd.prepare_ppi(prefix, str(tmp_path / "j"), 2)
    elif cmd == "prepare_reddit":
        src = _reddit_files(str(tmp_path / "src"))
        argv += ["--src", src]
        want = jd.prepare_reddit(src, str(tmp_path / "j"), 2)
    else:
        build = jd.build_ppi if cmd == "ppi" else jd.build_reddit
        want = build(str(tmp_path / "j"), num_partitions=2)
    td.main(argv)
    assert capsys.readouterr().out.strip() == out
    assert _files(out) == _files(want)
    if cmd.startswith("prepare"):
        with pytest.raises(SystemExit):
            td.main([cmd, "--out", out])  # the input flag is required


def test_module_runs_as_a_script(tmp_path):
    """``python -m euler_tpu_torch.datasets prepare_ppi``."""
    prefix = _ppi_files(str(tmp_path / "ppi"))
    out = str(tmp_path / "t")
    r = subprocess.run(
        [sys.executable, "-m", "euler_tpu_torch.datasets", "prepare_ppi",
         "--prefix", prefix, "--out", out], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == out
    assert _files(out) == _files(jd.prepare_ppi(prefix, str(tmp_path / "j")))


@pytest.mark.parametrize("kw", [
    dict(num_nodes=300, seed=3),
    dict(num_nodes=240, num_communities=3, feature_dim=8, noise=0.5,
         num_partitions=3, alpha=1.8, seed=5),
])
def test_build_planted_equals_jax(tmp_path, kw):
    t, tinfo = td.build_planted(str(tmp_path / "t"), **kw)
    j, jinfo = jd.build_planted(str(tmp_path / "j"), **kw)
    assert sorted(tinfo) == sorted(jinfo)
    for k in ("communities", "features", "centroids"):
        np.testing.assert_array_equal(tinfo[k], jinfo[k], err_msg=k)
    assert len(tinfo["neighbors"]) == len(jinfo["neighbors"])
    for a, b in zip(tinfo["neighbors"], jinfo["neighbors"]):
        np.testing.assert_array_equal(a, b)
    assert _files(t) == _files(j)  # the .dat partitions and the marker
    for nb in (False, True):
        assert td.nearest_centroid_accuracy(tinfo, nb) == \
            jd.nearest_centroid_accuracy(jinfo, nb)
    # cached: the same call writes nothing and draws the same info
    mtime = os.path.getmtime(os.path.join(t, "part_0.dat"))
    _, again = td.build_planted(t, **kw)
    assert os.path.getmtime(os.path.join(t, "part_0.dat")) == mtime
    np.testing.assert_array_equal(again["features"], tinfo["features"])
    # the in-memory form holds the engine's graph
    mem, eng = MemoryGraph(**td.planted_arrays(tinfo)), Graph(directory=t)
    ids = np.arange(kw["num_nodes"])
    for x, y in zip(mem.get_full_neighbor(ids, [0]),
                    eng.get_full_neighbor(ids, [0])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for slot, dim in ((0, len(tinfo["centroids"])),
                      (1, tinfo["features"].shape[1])):
        np.testing.assert_array_equal(
            mem.get_dense_feature(ids, [slot], [dim]),
            eng.get_dense_feature(ids, [slot], [dim]))
    eng.close()
