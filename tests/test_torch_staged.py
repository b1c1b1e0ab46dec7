"""Staged data (``euler_tpu_torch/graph/remote_fs.py``, ``Graph(stream=,
cache_dir=)`` and a remote ``directory=``/``files=``, ``GraphService`` on
a remote ``data_dir``) against the JAX package's ``remote_fs`` and graph
client.

Both packages stage from one graph uploaded into fsspec's in-process
``memory://`` filesystem (no network) at a path unique to the test,
removed afterwards: ``tests/fixture_graph.py``'s four partitions and a
``meta.json``. Staged files must equal the JAX package's name for name
and byte for byte, and every load must give the JAX client's graph down
to each query's results.
"""

import os
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")
fsspec = pytest.importorskip("fsspec")

import euler_tpu  # noqa: E402
from euler_tpu.graph import remote_fs as jfs  # noqa: E402
from euler_tpu.graph.service import GraphService as JService  # noqa: E402

from euler_tpu_torch import run_loop  # noqa: E402
from euler_tpu_torch.graph import Graph, GraphService  # noqa: E402
from euler_tpu_torch.graph import remote_fs as tfs  # noqa: E402
from tests.fixture_graph import write_fixture  # noqa: E402

MEM = fsspec.filesystem("memory")
PARTS = ["part_0.dat", "part_1.dat", "part_2.dat", "part_3.dat"]


@pytest.fixture()
def url(tmp_path):
    """The fixture graph in ``memory://`` at a path of its own."""
    src = tmp_path / "src"
    src.mkdir()
    write_fixture(str(src), num_partitions=4)
    root = f"/staged_{uuid.uuid4().hex}"
    for name in os.listdir(src):
        MEM.pipe_file(f"{root}/{name}", (src / name).read_bytes())
    MEM.pipe_file(f"{root}/meta.json", b"{}")
    yield "memory://" + root
    MEM.rm(root, recursive=True)


def _files(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _same_graph(a, b) -> None:
    """Node and edge counts, then every id's full neighbours of each edge
    type set, node types and a dense slot, equal."""
    assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)
    ids = np.arange(18, dtype=np.int64)  # the fixture's 10..16 and misses
    for ets in ([0], [1], [0, 1]):
        for x, y in zip(a.get_full_neighbor(ids, ets, sorted=True),
                        b.get_full_neighbor(ids, ets, sorted=True)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(a.node_types(ids), b.node_types(ids))
    np.testing.assert_array_equal(a.get_dense_feature(ids, [0], [2]),
                                  b.get_dense_feature(ids, [0], [2]))


@pytest.mark.parametrize("path", [
    "gs://bucket/dir", "memory://x", "s3://b/k", "/data/graph",
    "file:///data/graph", "local:///x", "relative/dir",
])
def test_path_rules_match_jax(path):
    assert tfs.is_remote_path(path) == jfs.is_remote_path(path)
    assert tfs.strip_local_scheme(path) == jfs.strip_local_scheme(path)


@pytest.mark.parametrize("name", ["part_3.dat", "graph.dat", "a_12.dat",
                                  "/x/y/p_0.dat", "part_1.dat.tmp"])
def test_partition_index_matches_jax(name):
    assert tfs.partition_index(name) == jfs.partition_index(name)


def test_default_cache_dir_reads_the_same_variable(monkeypatch, tmp_path):
    assert tfs.default_cache_dir() == jfs.default_cache_dir()
    monkeypatch.setenv("EULER_TPU_CACHE", str(tmp_path))
    assert tfs.default_cache_dir() == jfs.default_cache_dir() == str(
        tmp_path)


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_staged_files_equal_jax(url, tmp_path, shard):
    """Each shard stages the partitions ``p % shard_num == shard_idx``
    and meta.json, into the directory key JAX uses, byte for byte."""
    idx, num = shard
    t = tfs.stage_directory(url, cache_dir=str(tmp_path / "t"),
                            shard_idx=idx, shard_num=num)
    j = jfs.stage_directory(url, cache_dir=str(tmp_path / "j"),
                            shard_idx=idx, shard_num=num)
    assert os.path.basename(t) == os.path.basename(j)
    got, want = _files(t), _files(j)
    assert got == want
    assert sorted(got) == ["meta.json"] + PARTS[idx::num]


def test_staging_is_idempotent_and_follows_the_remote(url, tmp_path,
                                                      monkeypatch):
    """A second stage fetches nothing (same sizes); a file grown at the
    remote is fetched again; one removed there leaves the cache."""
    cache = str(tmp_path / "cache")
    out = tfs.stage_directory(url, cache_dir=cache)
    fetched = []
    real = tfs._fetch
    monkeypatch.setattr(tfs, "_fetch",
                        lambda fs, r, local: (fetched.append(r),
                                              real(fs, r, local)))
    assert tfs.stage_directory(url, cache_dir=cache) == out
    assert fetched == []
    root = url[len("memory://"):]
    MEM.pipe_file(f"{root}/part_0.dat",
                  MEM.cat_file(f"{root}/part_0.dat") + b"xxxx")
    MEM.rm(f"{root}/part_3.dat")
    assert tfs.stage_directory(url, cache_dir=cache) == out
    assert [os.path.basename(f) for f in fetched] == ["part_0.dat"]
    assert sorted(os.listdir(out)) == ["meta.json"] + PARTS[:3]
    assert _files(out) == _files(jfs.stage_directory(
        url, cache_dir=str(tmp_path / "j")))


def test_stage_files_mixed_and_refetched_like_jax(url, tmp_path):
    local = str(tmp_path / "local.dat")
    open(local, "wb").close()
    urls = [local, url + "/part_0.dat", "file://" + local + "x"]
    t = tfs.stage_files(urls, cache_dir=str(tmp_path / "t"))
    j = jfs.stage_files(urls, cache_dir=str(tmp_path / "j"))
    assert t[0] == j[0] == local and t[2] == j[2] == local + "x"
    assert os.path.relpath(t[1], str(tmp_path / "t")) == os.path.relpath(
        j[1], str(tmp_path / "j"))
    assert open(t[1], "rb").read() == open(j[1], "rb").read()


@pytest.mark.parametrize("how", ["staged", "streamed", "files_staged",
                                 "files_streamed", "config"])
def test_loads_equal_the_jax_client(url, tmp_path, how):
    """Every way in loads the JAX client's graph (staged the same way),
    down to each query; a streamed load writes nothing to disk."""
    cache = str(tmp_path / "cache")
    kw = {
        "staged": dict(directory=url, cache_dir=cache),
        "streamed": dict(directory=url, stream=True, cache_dir=cache),
        "files_staged": dict(files=[f"{url}/{p}" for p in PARTS],
                             cache_dir=cache),
        "files_streamed": dict(files=[f"{url}/{p}" for p in PARTS],
                               stream=True, cache_dir=cache),
        "config": dict(config=f"directory={url};stream=true"),
    }[how]
    t = Graph(**kw)
    assert os.path.exists(cache) == (how in ("staged", "files_staged"))
    j = euler_tpu.Graph(**kw)
    _same_graph(t, j)
    _same_graph(t, Graph(directory=url, stream=True))
    ids = t.sample_node(16, -1)
    assert ids.shape == (16,)
    t.close()
    j.close()


@pytest.mark.parametrize("stream", [False, True])
def test_sharded_loads_cover_the_graph(url, tmp_path, stream):
    kw = dict(directory=url, stream=stream, cache_dir=str(tmp_path / "c"))
    parts = [Graph(shard_idx=i, shard_num=2, **kw) for i in range(2)]
    full = Graph(**kw)
    for i, g in enumerate(parts):
        j = euler_tpu.Graph(shard_idx=i, shard_num=2, **kw)
        assert (g.num_nodes, g.num_edges) == (j.num_nodes, j.num_edges)
        j.close()
    assert sum(g.num_nodes for g in parts) == full.num_nodes == 7
    for g in parts + [full]:
        g.close()


def test_suffixless_partition_is_shard_zero(tmp_path):
    """A ``.dat`` without a ``_<p>`` suffix is partition 0 in both ingest
    modes, as the engine's local loader reads it."""
    src = tmp_path / "src"
    src.mkdir()
    write_fixture(str(src), num_partitions=2)
    os.rename(src / "part_0.dat", src / "plain.dat")
    root = f"/suffixless_{uuid.uuid4().hex}"
    for name in os.listdir(src):
        MEM.pipe_file(f"{root}/{name}", (src / name).read_bytes())
    try:
        local = Graph(directory=str(src), shard_idx=0, shard_num=2)
        for stream in (False, True):
            g = Graph(directory="memory://" + root, stream=stream,
                      shard_idx=0, shard_num=2,
                      cache_dir=str(tmp_path / "c"))
            assert g.num_nodes == local.num_nodes
            g.close()
        local.close()
    finally:
        MEM.rm(root, recursive=True)


def test_corrupt_streamed_partition_is_named(url):
    MEM.pipe_file(url[len("memory://"):] + "/part_1.dat",
                  b"\x00\x01garbage-not-a-graph")
    with pytest.raises(RuntimeError, match="part_1.dat") as terr:
        Graph(directory=url, stream=True)
    with pytest.raises(RuntimeError, match="part_1.dat") as jerr:
        euler_tpu.Graph(directory=url, stream=True)
    assert str(terr.value) == str(jerr.value)


def test_refusals_match_jax(tmp_path, url):
    """Duplicate URLs (both list paths), a missing remote file, a scheme
    without a driver, an empty shard and ``stream=`` on a remote client
    raise as in JAX, with its messages."""
    f = str(tmp_path / "a.dat")
    open(f, "wb").close()
    cases = [
        (lambda m: m.read_files([f, f]), ValueError),
        (lambda m: m.stage_files([f, f]), ValueError),
        (lambda m: m.stage_files([url + "/nope.dat"],
                                 cache_dir=str(tmp_path)),
         FileNotFoundError),
        (lambda m: m.read_files([url + "/nope.dat"]), FileNotFoundError),
        (lambda m: m.stage_directory("definitelynotascheme9://b/x"),
         RuntimeError),
        (lambda m: m.read_directory(url, shard_idx=5, shard_num=6),
         FileNotFoundError),
    ]
    for call, err in cases:
        with pytest.raises(err) as jerr:
            call(jfs)
        with pytest.raises(err) as terr:
            call(tfs)
        assert str(terr.value) == str(jerr.value)
    assert tfs.stage_files([f]) == [f]
    kw = dict(mode="remote", shards=["127.0.0.1:1"], stream=True)
    with pytest.raises(ValueError) as jerr:
        euler_tpu.Graph(**kw)
    with pytest.raises(ValueError) as terr:
        Graph(**kw)
    assert str(terr.value).split(" (")[0] == str(jerr.value).split(" (")[0]


def test_remote_mode_stages_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("staged in remote mode")

    monkeypatch.setattr(tfs, "stage_directory", boom)
    monkeypatch.setattr(tfs, "read_directory", boom)
    with pytest.raises(RuntimeError, match="remote graph init failed"):
        Graph(mode="remote", directory="memory://never-read",
              shards=["127.0.0.1:1"], retries=0, timeout_ms=50)


def test_service_stages_a_remote_data_dir(url, tmp_path, monkeypatch):
    """A shard on a remote ``data_dir`` stages its partitions into
    ``$EULER_TPU_CACHE`` (the directory JAX's shard stages) and serves
    the whole graph."""
    monkeypatch.setenv("EULER_TPU_CACHE", str(tmp_path / "cache"))
    with GraphService(url, shard_idx=0, shard_num=1) as svc:
        g = Graph(mode="remote", shards=[svc.address])
        _same_graph(g, Graph(directory=url, stream=True))
        g.close()
    staged = os.listdir(str(tmp_path / "cache"))
    with JService(url, shard_idx=0, shard_num=1):
        assert os.listdir(str(tmp_path / "cache")) == staged


def test_run_loop_trains_from_a_stream(url, tmp_path):
    """``python -m euler_tpu_torch --data_dir memory://... --stream 1``
    trains, evaluates and exports."""
    ck = str(tmp_path / "ck")
    argv = ["--data_dir", url, "--model_dir", ck, "--stream", "1",
            "--max_id", "16", "--feature_idx", "0", "--feature_dim", "2",
            "--label_idx", "2", "--label_dim", "3", "--train_edge_type",
            "0,1", "--all_edge_type", "0,1", "--fanouts", "3,2", "--dim",
            "8", "--batch_size", "8", "--num_epochs", "2", "--log_steps",
            "1"]
    for mode in ("train", "evaluate", "save_embedding"):
        assert run_loop.main(argv + ["--mode", mode], device="cpu") == 0
    assert np.load(os.path.join(ck, "embedding.npy")).shape == (17, 8)
