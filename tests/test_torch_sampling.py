"""The port's graph tables and device draws against the JAX package.

Both sides get the same inputs: graphs from one numpy seed, and the
uniforms JAX draws from its keys ("key replay": ``jax.random.uniform``
with the same ``split``/``fold_in`` the JAX function uses, passed to the
port's ``u=`` arguments). Table builders must agree exactly and the
picks bit for bit. The JAX reference for the chained draw is the per-hop
XLA chain of ``device.sample_fanout`` (what it runs on the CPU).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import euler_tpu  # noqa: E402
from euler_tpu import datasets as jdatasets  # noqa: E402
from euler_tpu.graph import device as jdev  # noqa: E402

from euler_tpu_torch.datasets import build_synthetic  # noqa: E402
from euler_tpu_torch.graph import MemoryGraph, sampling_kernels  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402

SYN = dict(num_nodes=300, avg_degree=6, feature_dim=5, label_dim=3,
           max_degree=12, seed=11)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """(engine graph from the JAX package's .dat files, port graph) of
    one synthetic spec."""
    d = str(tmp_path_factory.mktemp("syn"))
    jdatasets.build_synthetic(d, num_partitions=2, **SYN)
    eg = euler_tpu.Graph(directory=d)
    yield eg, MemoryGraph(**build_synthetic(**SYN))
    eg.close()


def _mock_graph():
    """8 nodes, 2 edge types: an all-zero-weight row (node 0), a row of
    degree 5 over both types to truncate (node 1), a zero-weight edge
    among positive ones (node 3), nodes of weight 0 and two node types."""
    groups = {  # (node, edge type) -> [(id, weight)]
        (0, 0): [(1, 0.0), (2, 0.0)],
        (1, 0): [(2, 0.5), (3, 2.0), (4, 1.0), (5, 0.25)],
        (1, 1): [(0, 3.0)],
        (2, 1): [(7, 1.0)],
        (3, 0): [(6, 2.0), (0, 1.0), (1, 0.0)],
        (4, 0): [(5, 1.0), (6, 1.0)],
        (4, 1): [(5, 4.0)],
        (5, 1): [(4, 0.5), (2, 0.5)],
        (6, 0): [(7, 1.0)],
    }
    n, t = 8, 2
    counts = [len(groups.get((i // t, i % t), [])) for i in range(n * t)]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    flat = [e for i in range(n * t) for e in groups.get((i // t, i % t), [])]
    return MemoryGraph(
        indptr, [e[0] for e in flat], [e[1] for e in flat],
        node_weights=[1, 0, 2, 0.5, 1, 0, 3, 1],
        node_types=[0, 1, 0, 1, 0, 0, 1, 0],
        edge_type_num=t,
    )


def _eq_tables(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape))  # writable copy


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors: the plain
    version's generator is the standard one the CUDA kernel implements."""
    out = tdev.philox4x32(
        tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key
    )
    assert tuple(int(w) for w in out) == want


def test_philox_uniform_is_24_bit_and_counter_keyed():
    u = tdev.philox_uniform((5, 9), 1, 64, 7)
    assert u.dtype == torch.float32 and u.shape == (64, 7)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * (1 << 24), torch.floor(u * (1 << 24)))
    # a row's uniforms do not depend on how many rows were asked for
    assert torch.equal(tdev.philox_uniform((5, 9), 1, 8, 7), u[:8])
    assert not torch.equal(tdev.philox_uniform((5, 9), 0, 64, 7), u)
    assert not torch.equal(tdev.philox_uniform((5, 10), 1, 64, 7), u)


def test_synthetic_graph_matches_engine(graphs):
    """Same seed, same graph: neighbors (id-sorted per group, as the
    engine stores them), weights, node weights/types, features, labels."""
    eg, tg = graphs
    ids = np.arange(-2, SYN["num_nodes"] + 3)
    for sorted_ in (False, True):
        for a, b in zip(eg.get_full_neighbor(ids, [0], sorted=sorted_),
                        tg.get_full_neighbor(ids, [0], sorted=sorted_)):
            np.testing.assert_array_equal(a, b)
    known = np.arange(SYN["num_nodes"])
    np.testing.assert_array_equal(eg.node_weights(ids), tg.node_weights(ids))
    np.testing.assert_array_equal(eg.node_types(known), tg.node_types(known))
    dims = [SYN["label_dim"], SYN["feature_dim"]]
    np.testing.assert_array_equal(
        eg.get_dense_feature(ids, [0, 1], dims),
        tg.get_dense_feature(ids, [0, 1], dims),
    )


def test_tables_match_jax_on_synthetic(graphs):
    eg, tg = graphs
    max_id = SYN["num_nodes"] - 1
    j = jdev.build_adjacency(eg, [0], max_id, chunk=64)
    j.pop("truncated_rows")
    _eq_tables(j, tdev.build_adjacency(tg, [0], max_id, chunk=64))
    _eq_tables(jdev.build_node_sampler(eg, -1, max_id),
               tdev.build_node_sampler(tg, -1, max_id))


@pytest.mark.parametrize("ets,max_degree", [
    ([0], None), ([0, 1], None), ([0, 1], 3), ([1, 0], 2),
])
def test_adjacency_matches_jax_on_mock(ets, max_degree):
    """Zero-weight rows keep their neighbors but are not sampleable;
    rows beyond max_degree keep their heaviest neighbors, renormalized."""
    g = _mock_graph()
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jdev.build_adjacency(g, ets, 7, max_degree=max_degree, chunk=3)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = tdev.build_adjacency(g, ets, 7, max_degree=max_degree, chunk=3)
    j.pop("truncated_rows")
    _eq_tables(j, t)
    assert len(jw) == len(tw)
    assert not t["sampleable"][0] and t["deg"][0] == 2
    assert (t["cum"][:, -1] == 1.0).all()


@pytest.mark.parametrize("node_type", [-1, 0, 1])
def test_node_sampler_matches_jax_on_mock(node_type):
    g = _mock_graph()
    _eq_tables(jdev.build_node_sampler(g, node_type, 7),
               tdev.build_node_sampler(g, node_type, 7))


def test_sample_node_key_replay(graphs, monkeypatch):
    """Bit-exact roots under key replay, on one segment and, with SEG
    shrunk on both sides, on many."""
    eg, tg = graphs
    max_id = SYN["num_nodes"] - 1
    for seg in (None, 16):
        if seg:
            monkeypatch.setattr(jdev, "SEG", seg)
            monkeypatch.setattr(tdev, "SEG", seg)
        js = jdev.build_node_sampler(eg, -1, max_id)
        ts = tdev.tensors(tdev.build_node_sampler(tg, -1, max_id), "cpu")
        for seed in range(3):
            key = jax.random.PRNGKey(seed)
            k1, k2 = jax.random.split(key)
            u = (_uniform(k1, (257,)), _uniform(k2, (257,)))
            want = np.asarray(jdev.sample_node(js, key, 257))
            got = tdev.sample_node(ts, 257, u=u)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_sample_node_generator_draws_weighted():
    g = _mock_graph()
    s = tdev.tensors(tdev.build_node_sampler(g, -1, 7), "cpu")
    gen = torch.Generator().manual_seed(0)
    draws = tdev.sample_node(s, 40000, generator=gen).numpy()
    w = np.array([1, 0, 2, 0.5, 1, 0, 3, 1])
    freq = np.bincount(draws, minlength=8) / len(draws)
    np.testing.assert_allclose(freq, w / w.sum(), atol=0.01)


def _odd_nodes(n_rows, rng, m):
    nodes = rng.integers(0, n_rows - 1, m).astype(np.int32)
    nodes[:4] = [-3, n_rows + 5, n_rows - 1, 0]  # unknown, default, row 0
    return nodes


@pytest.mark.parametrize("which", ["synthetic", "mock", "wide"])
def test_sample_neighbor_key_replay(graphs, which):
    """Bit-exact picks under key replay, including negative and
    past-the-slab ids, the default row and zero-weight rows; "wide" is a
    slab of rows wider than 128, past the main paths' width of 32."""
    if which == "synthetic":
        g, max_id = graphs[1], SYN["num_nodes"] - 1
        adj = tdev.build_adjacency(g, [0], max_id)
    elif which == "wide":
        g, max_id = MemoryGraph(**build_synthetic(400, 150, 2, 2, max_degree=300,
                                            seed=5)), 399
        adj = tdev.build_adjacency(g, [0], max_id)
        assert adj["nbr"].shape[1] > 128
    else:
        g, max_id = _mock_graph(), 7
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            adj = tdev.build_adjacency(g, [0, 1], max_id, max_degree=3)
    tadj = tdev.tensors(adj, "cpu")
    nodes = _odd_nodes(max_id + 2, np.random.default_rng(3), 97)
    for seed, count in ((0, 1), (1, 5), (2, 13)):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jdev.sample_neighbor(adj, nodes, key, count))
        u = _uniform(key, (len(nodes), count))
        got = tdev.sample_neighbor(tadj, torch.from_numpy(nodes), count, u=u)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        # the single-hop kernel's wrapper (its plain version on the CPU)
        got = sampling_kernels.sample_neighbor(
            tadj, torch.from_numpy(nodes), None, count, u=u)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("counts", [(3, 2), (4, 1), (2,), (2, 2, 3)])
def test_sample_fanout_key_replay(graphs, counts):
    """device.sample_fanout against the JAX per-hop chain: hop h uses
    uniform(fold_in(key, h), (rows, counts[h])). Two hops run through
    sampling_kernels.sample_fanout2 (its plain version on the CPU)."""
    _, tg = graphs
    max_id = SYN["num_nodes"] - 1
    adj = tdev.build_adjacency(tg, [0], max_id)
    tadj = tdev.tensors(adj, "cpu")
    roots = _odd_nodes(max_id + 2, np.random.default_rng(5), 41)
    key = jax.random.PRNGKey(9)
    want = jdev.sample_fanout([adj] * len(counts), roots, key, list(counts))
    u, rows = [], len(roots)
    for h, c in enumerate(counts):
        u.append(_uniform(jax.random.fold_in(key, h), (rows, c)))
        rows *= c
    got = tdev.sample_fanout([tadj] * len(counts), torch.from_numpy(roots),
                             list(counts), u=u)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_fanout2_reference_key_replay_metapath(graphs):
    """The chained draw over two different slabs of one id space (a
    metapath) equals the JAX per-hop chain bit for bit."""
    g = _mock_graph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a1 = tdev.build_adjacency(g, [0], 7)
        a2 = tdev.build_adjacency(g, [0, 1], 7, max_degree=3)
    roots = _odd_nodes(9, np.random.default_rng(8), 23)
    key = jax.random.PRNGKey(4)
    want = jdev.sample_fanout([a1, a2], roots, key, [3, 4])
    u1 = _uniform(jax.random.fold_in(key, 0), (23, 3))
    u2 = _uniform(jax.random.fold_in(key, 1), (69, 4))
    h1, h2 = sampling_kernels.sample_fanout2_reference(
        tdev.tensors(a1, "cpu"), tdev.tensors(a2, "cpu"),
        torch.from_numpy(roots), None, 3, 4, u1=u1, u2=u2,
    )
    np.testing.assert_array_equal(h1.reshape(-1).numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(h2.reshape(-1).numpy(), np.asarray(want[2]))


def test_philox_fanout_is_the_reference_with_philox_uniforms(graphs):
    """Without injected uniforms the chained draw uses philox_uniform at
    (row, column, hop): hop 1 at hop 0 over m rows, hop 2 at hop 1 over
    m*f1 rows. Every pick is a neighbor of its row."""
    _, tg = graphs
    max_id = SYN["num_nodes"] - 1
    adj = tdev.tensors(tdev.build_adjacency(tg, [0], max_id), "cpu")
    roots = torch.arange(0, 60, dtype=torch.int32)
    words = tdev.seed_words(7 << 32 | 3)
    assert words == (3, 7)
    h1, h2 = sampling_kernels.sample_fanout2(adj, adj, roots, words, 4, 3)
    r1, r2 = sampling_kernels.sample_fanout2_reference(
        adj, adj, roots, None, 4, 3,
        u1=tdev.philox_uniform(words, 0, 60, 4),
        u2=tdev.philox_uniform(words, 1, 240, 3),
    )
    assert torch.equal(h1, r1) and torch.equal(h2, r2)
    for rows, picks in ((roots, h1), (h1.reshape(-1), h2)):
        nbr, _, _, cnt = tg.get_full_neighbor(rows.numpy(), [0])
        offs = np.concatenate([[0], np.cumsum(cnt)])
        for i, r in enumerate(rows.tolist()):
            allowed = set(nbr[offs[i]:offs[i + 1]].tolist()) or {max_id + 1}
            assert set(picks[i].tolist()) <= allowed, r


def test_stream_words_give_distinct_streams():
    """Stream 0 is the plain seed's words; the five streams of a step
    draw different uniforms at the same counters; over the trainer's
    range of step seeds no two (seed, stream) pairs share key words."""
    for seed in (0, 7, 2**32 - 1, 3 << 32 | 5):
        assert tdev.stream_words(seed, 0) == tdev.seed_words(seed)
    draws = [tdev.philox_uniform(tdev.stream_words(11, s), 0, 64, 4)
             for s in range(5)]
    for i in range(5):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    words = {tdev.stream_words(seed, s)
             for seed in range(2000) for s in range(5)}
    assert len(words) == 2000 * 5


def test_sample_node_philox_uniforms(graphs):
    """seed_words= draws the roots from philox_uniform columns 0 and 1,
    the same on every device, and leaves no generator state behind."""
    _, tg = graphs
    s = tdev.tensors(
        tdev.build_node_sampler(tg, -1, SYN["num_nodes"] - 1), "cpu")
    words = tdev.stream_words(4, 1)
    u = tdev.philox_uniform(words, 0, 300, 2)
    got = tdev.sample_node(s, 300, seed_words=words)
    assert torch.equal(got, tdev.sample_node(s, 300, u=u.t().contiguous()))
    assert torch.equal(got, tdev.sample_node(s, 300, seed_words=words))
    assert not torch.equal(
        got, tdev.sample_node(s, 300, seed_words=tdev.stream_words(4, 2)))


def test_chained_draw_is_two_single_hop_draws(graphs):
    """The counter contract the card checks rely on: with Philox, the
    chained draw equals single-hop draws at hop 0 on the roots and at hop
    1 on the hop-1 picks, and a three-hop fanout runs the single-hop draw
    at hops 0, 1, 2."""
    _, tg = graphs
    adj = tdev.tensors(tdev.build_adjacency(tg, [0], SYN["num_nodes"] - 1),
                       "cpu")
    roots = torch.from_numpy(_odd_nodes(SYN["num_nodes"] + 1,
                                        np.random.default_rng(2), 50))
    words = tdev.stream_words(9, 3)
    h1, h2 = sampling_kernels.sample_fanout2(adj, adj, roots, words, 4, 3)
    s1 = sampling_kernels.sample_neighbor(adj, roots, words, 4, hop=0)
    s2 = sampling_kernels.sample_neighbor(adj, s1.reshape(-1), words, 3,
                                          hop=1)
    assert torch.equal(h1, s1) and torch.equal(h2, s2)
    hops = tdev.sample_fanout([adj] * 3, roots, [4, 3, 2], words)
    s3 = sampling_kernels.sample_neighbor(adj, s2.reshape(-1), words, 2,
                                          hop=2)
    assert torch.equal(hops[1], s1.reshape(-1))
    assert torch.equal(hops[2], s2.reshape(-1))
    assert torch.equal(hops[3], s3.reshape(-1))
