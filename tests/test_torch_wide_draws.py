"""Slab draws at every width: the port against the JAX package on slabs
wider than the register layout of the draw kernels (1,024 slots), where
the JAX package draws through its XLA chain (past its TPU kernels'
``MAX_W`` = 512).

The same inputs go to both sides: graphs from one numpy seed, and the
uniforms JAX draws from its keys ("key replay", as
``tests/test_torch_sampling.py`` does). On the CPU the kernels' wrappers
run their plain versions; the card holds the kernels to those plain
versions (``chip_smoke.py`` phase 3 (p)-(q)). Also here: the port's
counterparts of the JAX package's distribution tests
(``tests/test_device_graph.py``), at a narrow width and on rows wider
than 1,024, and ``python -m euler_tpu_torch --device_sampling 1`` with
``--max_degree`` unset on a graph whose widest row passes 1,024.
"""

import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from euler_tpu.graph import device as jdev  # noqa: E402

from euler_tpu_torch.graph import MemoryGraph, sampling_kernels  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

WIDTH = 2048  # the slab width of the key-replay tests
ROWS = 160  # their graph's nodes
REGISTER_WIDTH = 1024  # csrc/draw.cuh kMaxWidth


def _wide_graph(seed: int = 3, zero_row: int = 7) -> MemoryGraph:
    """ROWS nodes with random degrees up to WIDTH (a quarter of the rows
    at WIDTH, distinct neighbours a row), weights in [0.1, 1), one row of
    weight 0 and one empty row."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, WIDTH + 1, ROWS)
    deg[:ROWS // 4] = WIDTH
    deg[ROWS - 1] = 0
    ids = np.arange(WIDTH * 4)  # ids past ROWS name no row: the default's
    rows = [rng.choice(ids, d, replace=False) for d in deg]
    weights = rng.uniform(0.1, 1.0, int(deg.sum())).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    weights[indptr[zero_row]:indptr[zero_row + 1]] = 0.0
    return MemoryGraph(indptr, np.concatenate(rows), weights,
                       node_weights=np.ones(ROWS, np.float32),
                       node_types=np.zeros(ROWS, np.int32))


@pytest.fixture(scope="module")
def wide():
    """(slab arrays, CPU tensors) of ``_wide_graph``, from the port's
    ``build_adjacency``; the JAX package's gives the same arrays."""
    g = _wide_graph()
    adj = tdev.build_adjacency(g, [0], ROWS - 1)
    assert adj["nbr"].shape == (ROWS + 1, WIDTH)
    j = jdev.build_adjacency(g, [0], ROWS - 1)
    j.pop("truncated_rows")
    for k in adj:
        np.testing.assert_array_equal(np.asarray(j[k]), adj[k], k)
    return adj, tdev.tensors(adj, "cpu")


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape))


def _odd_nodes(n_rows, rng, m):
    nodes = rng.integers(0, n_rows - 1, m).astype(np.int32)
    nodes[:5] = [-3, n_rows + 5, n_rows - 1, 7, 0]  # + zero-weight, full
    return nodes


@pytest.mark.parametrize("seed,count", [(0, 1), (1, 10), (2, 33)])
def test_wide_single_hop_key_replay(wide, seed, count):
    """The slab draw at W 2,048 equals the JAX package's XLA draw bit for
    bit under key replay (33 draws: more than the wide path's 32 a
    pass), through ``device.sample_neighbor`` and the kernel's wrapper."""
    adj, tadj = wide
    nodes = _odd_nodes(ROWS + 1, np.random.default_rng(seed), 97)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jdev.sample_neighbor(adj, nodes, key, count))
    u = _uniform(key, (len(nodes), count))
    got = tdev.sample_neighbor(tadj, torch.from_numpy(nodes), count, u=u)
    np.testing.assert_array_equal(got.numpy(), want)
    got = sampling_kernels.sample_neighbor(tadj, torch.from_numpy(nodes),
                                           None, count, u=u)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:4] == ROWS).all()  # unknown, default, zero weight


@pytest.mark.parametrize("counts", [(10, 10), (4, 4), (3, 1)])
def test_wide_fanout_key_replay(wide, counts):
    """The [f1, f2] fanout at W 2,048 equals the JAX per-hop chain
    (``_sample_fanout2_route`` declines a slab past ``MAX_W``) bit for
    bit, through ``device.sample_fanout`` and the chained kernel's
    wrapper."""
    adj, tadj = wide
    f1, f2 = counts
    roots = _odd_nodes(ROWS + 1, np.random.default_rng(f1 * 10 + f2), 64)
    key = jax.random.PRNGKey(f1 + f2)
    want = jdev.sample_fanout([adj, adj], roots, key, [f1, f2])
    u1 = _uniform(jax.random.fold_in(key, 0), (64, f1))
    u2 = _uniform(jax.random.fold_in(key, 1), (64 * f1, f2))
    got = tdev.sample_fanout([tadj, tadj], torch.from_numpy(roots),
                             [f1, f2], u=[u1, u2])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    h1, h2 = sampling_kernels.sample_fanout2(
        tadj, tadj, torch.from_numpy(roots), None, f1, f2, u1=u1, u2=u2)
    np.testing.assert_array_equal(h1.reshape(-1).numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(h2.reshape(-1).numpy(), np.asarray(want[2]))


def test_wide_metapath_fanout_of_mixed_widths(wide):
    """A fanout over two slabs of one id space, one narrower than 1,024
    and one wider, in both orders, equals the JAX per-hop chain."""
    adj, _ = wide
    g = _wide_graph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        narrow = tdev.build_adjacency(g, [0], ROWS - 1, max_degree=96)
    roots = _odd_nodes(ROWS + 1, np.random.default_rng(11), 48)
    key = jax.random.PRNGKey(5)
    for a1, a2 in ((narrow, adj), (adj, narrow)):
        want = jdev.sample_fanout([a1, a2], roots, key, [5, 6])
        u1 = _uniform(jax.random.fold_in(key, 0), (48, 5))
        u2 = _uniform(jax.random.fold_in(key, 1), (48 * 5, 6))
        h1, h2 = sampling_kernels.sample_fanout2(
            tdev.tensors(a1, "cpu"), tdev.tensors(a2, "cpu"),
            torch.from_numpy(roots), None, 5, 6, u1=u1, u2=u2)
        np.testing.assert_array_equal(h1.reshape(-1).numpy(),
                                      np.asarray(want[1]))
        np.testing.assert_array_equal(h2.reshape(-1).numpy(),
                                      np.asarray(want[2]))


def test_wide_references_are_the_slab_draw(wide):
    """The kernels' plain versions at W 2,048 are ``device.sample_neighbor``
    with Philox uniforms: single hop at a given hop, and the chained draw
    at hops 0 then 1."""
    _, tadj = wide
    nodes = torch.from_numpy(_odd_nodes(ROWS + 1, np.random.default_rng(4),
                                        80))
    words = tdev.stream_words(12, 1)
    got = sampling_kernels.sample_neighbor_reference(tadj, nodes, words, 10,
                                                     hop=2)
    assert torch.equal(got, tdev.sample_neighbor(tadj, nodes, 10, words,
                                                 hop=2))
    h1, h2 = sampling_kernels.sample_fanout2_reference(tadj, tadj, nodes,
                                                       words, 10, 4)
    s1 = tdev.sample_neighbor(tadj, nodes, 10, words, hop=0)
    s2 = tdev.sample_neighbor(tadj, s1.reshape(-1), 4, words, hop=1)
    assert torch.equal(h1, s1) and torch.equal(h2, s2)


@pytest.mark.parametrize("rank", [0, 1])
def test_wide_sharded_references_are_the_slab_draw(wide, rank):
    """The sharded routes at W 2,048, through their plain versions, draw
    ``device.sample_neighbor`` at the rank's folded seed words."""
    _, tadj = wide
    mesh = Mesh(2, rank=rank)
    nodes = torch.from_numpy(_odd_nodes(ROWS + 1,
                                        np.random.default_rng(rank), 40))
    words = tdev.seed_words(99)
    fold = sampling_kernels.folded_words(words, rank)
    got = sampling_kernels.sample_neighbor_sharded(
        tadj, nodes, words, 3, mesh, hop=1,
        draw_fn=sampling_kernels.sample_neighbor_reference)
    assert torch.equal(got, tdev.sample_neighbor(tadj, nodes, 3, fold,
                                                 hop=1))
    h1, h2 = sampling_kernels.sample_fanout2_sharded(
        tadj, tadj, nodes, words, 4, 2, mesh,
        draw_fn=sampling_kernels.sample_fanout2_reference)
    s1 = tdev.sample_neighbor(tadj, nodes, 4, fold, hop=0)
    s2 = tdev.sample_neighbor(tadj, s1.reshape(-1), 2, fold, hop=1)
    assert torch.equal(h1, s1) and torch.equal(h2, s2)


@pytest.mark.parametrize("max_degree,sorted_", [
    (None, False), (None, True), (700, False), (1500, True)])
def test_count_over_degree_equals_count_over_width(max_degree, sorted_):
    """The wide path's precondition, on slabs from ``build_adjacency``
    (uncapped, truncated, sorted): a row's count of u >= cum over its
    first deg[row] slots equals its count over W for every uniform, so
    the pick of the wide path, which reads deg[row] slots, is the plain
    version's."""
    g = _wide_graph(seed=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        adj = tdev.build_adjacency(g, [0], ROWS - 1, max_degree=max_degree,
                                   sorted=sorted_)
    cum, deg = adj["cum"], adj["deg"]
    width = cum.shape[1]
    slot = np.arange(width)[None, :]
    assert (cum[slot >= deg[:, None]] >= 1.0).all()
    u = np.random.default_rng(1).random((len(cum), 8)).astype(np.float32)
    u[:, 0] = np.nextafter(np.float32(1), np.float32(0))  # the largest u
    full = (u[:, :, None] >= cum[:, None, :]).sum(-1)
    by_deg = ((u[:, :, None] >= cum[:, None, :])
              & (slot < deg[:, None])[:, None, :]).sum(-1)
    np.testing.assert_array_equal(by_deg, full)


def test_wrappers_take_wide_cuda_slabs(monkeypatch, wide):
    """No width refusal: a slab wider than the register layout, and one
    within it, reach the kernel's C entry with their width and their deg
    column (the C entry picks the path); a slab without a deg is refused.
    The card is stood in for by a stub library (this host has none), so
    only the wrapper's arguments are checked; the card checks the picks
    (chip_smoke.py phase 3 (p))."""
    _, tadj = wide
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    lib = types.SimpleNamespace(
        etpu_sample_neighbor=entry("sample_neighbor"),
        etpu_sample_fanout2=entry("sample_fanout2"))
    from euler_tpu_torch import _build

    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(sampling_kernels, "_device_of",
                        lambda t, name: t.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    narrow = tdev.tensors(tdev.build_adjacency(
        MemoryGraph([0, 2, 3, 3], [1, 2, 0], [1.0, 1.0, 1.0],
                    node_weights=[1, 1, 1], node_types=[0, 0, 0]), [0], 2),
        "cpu")
    nodes = torch.arange(6, dtype=torch.int32)
    # counts of this test's stub launches, kept from the process's own
    monkeypatch.setattr(sampling_kernels, "launches",
                        {"sample_fanout2": 0, "sample_neighbor": 0})
    sampling_kernels.sample_neighbor(tadj, nodes, (1, 2), 3)
    sampling_kernels.sample_neighbor(narrow, nodes[:3], (1, 2), 3)
    sampling_kernels.sample_fanout2(narrow, narrow, nodes[:3], (1, 2), 2, 2)
    big = {k: v[:4].contiguous() for k, v in tadj.items()}
    sampling_kernels.sample_fanout2(narrow, big, nodes[:3], (1, 2), 2, 2)
    (_, a), (_, b), (_, c), (_, d) = calls
    # sample_neighbor: nodes, m, nbr, cum, ok, deg, R, W, ...
    assert a[5] == tadj["deg"].data_ptr() and a[7] == WIDTH
    assert b[5] == narrow["deg"].data_ptr() and b[7] == 2
    # sample_fanout2: roots, m, nbr1, cum1, ok1, deg1, nbr2, cum2, ok2,
    # deg2, R, W1, W2, ...
    assert c[5] == c[9] == narrow["deg"].data_ptr()
    assert (c[11], c[12]) == (2, 2)
    assert (d[11], d[12]) == (2, WIDTH)
    assert d[5] == narrow["deg"].data_ptr() and d[9] == big["deg"].data_ptr()
    assert sampling_kernels.launches == {"sample_neighbor": 2,
                                         "sample_fanout2": 2}
    bad = dict(tadj, deg=tadj["deg"].long())
    with pytest.raises(ValueError, match="deg"):
        sampling_kernels.sample_neighbor(bad, nodes, (1, 2), 3)
    no_deg = {k: v for k, v in narrow.items() if k != "deg"}
    with pytest.raises(ValueError, match="deg"):
        sampling_kernels.sample_fanout2(narrow, no_deg, nodes[:3], (1, 2),
                                        2, 2)
    assert len(calls) == 4
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        sampling_kernels._library_for(width=2**31)


def _chi_square(hits, p, n):
    live = p > 0
    expect = p[live] * n
    return float(((hits[live] - expect) ** 2 / expect).sum()), int(
        live.sum()) - 1


def test_neighbor_distribution_matches_weights(graph):
    """Port counterpart of ``test_device_graph.py::
    test_neighbor_distribution_matches_weights``: the slab draw's
    frequencies on the fixture's node 10 track its edge weights within
    0.02 (the same bar), 20,000 Philox draws through the kernel's
    wrapper."""
    adj = tdev.tensors(tdev.build_adjacency(graph, [0, 1], 16), "cpu")
    node = 10
    nbr, w, _, _ = graph.get_full_neighbor([node], [0, 1])
    draws = sampling_kernels.sample_neighbor(
        adj, torch.full((200,), node, dtype=torch.int32),
        tdev.seed_words(1), 100).reshape(-1).numpy()
    probs = w / w.sum()
    for i, p in zip(nbr, probs):
        assert abs(float((draws == i).mean()) - p) < 0.02, (i, p)


def test_wide_row_distribution_matches_weights():
    """On a row of 2,048 neighbours, wider than the register layout, the
    slot frequencies of 400,000 Philox draws pass a chi-square test
    against the row's weights: the statistic stays under its mean plus
    6 standard deviations (dof + 6 sqrt(2 dof)), and no zero-weight slot
    is ever drawn."""
    rng = np.random.default_rng(21)
    w = (1.0 + np.arange(WIDTH) % 7).astype(np.float32)
    w[::97] = 0.0
    g = MemoryGraph([0, WIDTH, WIDTH], np.arange(2, WIDTH + 2), w,
                    node_weights=[1, 1], node_types=[0, 0])
    adj = tdev.tensors(tdev.build_adjacency(g, [0], WIDTH + 1), "cpu")
    assert adj["nbr"].shape[1] == WIDTH
    hits = np.zeros(WIDTH + 2)
    n = 0
    for chunk in range(20):
        picks = sampling_kernels.sample_neighbor(
            adj, torch.zeros(2000, dtype=torch.int32),
            tdev.stream_words(int(rng.integers(1 << 30)), chunk), 10)
        hits += np.bincount(picks.reshape(-1).numpy(), minlength=WIDTH + 2)
        n += picks.numel()
    hits = hits[2:]
    p = w / w.sum()
    chi2, dof = _chi_square(hits, p, n)
    assert chi2 < dof + 6 * np.sqrt(2 * dof), (chi2, dof)
    assert hits[p == 0].sum() == 0


@pytest.mark.parametrize("width", [2, 1500])
def test_zero_weight_neighbors_exist_but_never_sample(width):
    """Port counterpart of ``test_device_graph.py::
    test_zero_weight_neighbors_exist_but_never_sample``, narrow and past
    the register layout: a node whose edges all weigh 0 keeps them in
    the slab (nbr, deg) but draws only the default node."""
    n = width + 2
    indptr = np.zeros(n + 1, np.int64)
    indptr[1], indptr[2:] = width, width + 1  # node 0: `width` edges, 1: one
    indices = np.concatenate([np.arange(1, width + 1), [2]])
    weights = np.concatenate([np.zeros(width), [1.0]]).astype(np.float32)
    g = MemoryGraph(indptr, indices, weights, node_weights=np.ones(n),
                    node_types=np.zeros(n, np.int32))
    adj = tdev.build_adjacency(g, [0], n - 1)
    assert adj["deg"][0] == width
    assert set(adj["nbr"][0, :width].tolist()) == set(range(1, width + 1))
    assert not adj["sampleable"][0]
    out = sampling_kernels.sample_neighbor(
        tdev.tensors(adj, "cpu"), torch.tensor([0, 1], dtype=torch.int32),
        tdev.seed_words(0), 16).numpy()
    assert (out[0] == n).all()  # the default id, max_id + 1
    assert (out[1] == 2).all()


def test_cli_device_sampling_without_max_degree(tmp_path):
    """``run_loop --device_sampling 1`` with ``--max_degree`` unset trains
    on a ``.dat`` power-law graph whose widest row passes 1,024 (1,226:
    its slab is that wide), as the JAX CLI does."""
    from euler_tpu_torch import datasets, run_loop

    data = datasets.build_powerlaw(5000, 200_000, feature_dim=8,
                                   label_dim=5, multilabel=True, seed=17)
    deg = np.diff(data["indptr"])
    assert deg.max() > REGISTER_WIDTH and (deg > REGISTER_WIDTH).sum() > 10
    datasets.write_dat(data, str(tmp_path / "g"))
    before = dict(sampling_kernels.launches)
    seen = []
    real = sampling_kernels.sample_fanout2

    def spy(adj1, adj2, *args, **kwargs):
        seen.append((adj1["nbr"].shape[1], adj2["nbr"].shape[1]))
        return real(adj1, adj2, *args, **kwargs)

    import unittest.mock

    with unittest.mock.patch.object(sampling_kernels, "sample_fanout2", spy):
        rc = run_loop.main([
            "--data_dir", str(tmp_path / "g"), "--model_dir",
            str(tmp_path / "m"), "--max_id", "4999", "--feature_idx", "1",
            "--feature_dim", "8", "--label_idx", "0", "--label_dim", "5",
            "--fanouts", "4,3", "--dim", "16", "--batch_size", "1024",
            "--num_epochs", "1", "--log_steps", "1", "--device_sampling",
            "1"], device="cpu")
    assert rc == 0
    assert seen == [(int(deg.max()), int(deg.max()))] * 4
    assert sampling_kernels.launches == before  # the plain version, here
