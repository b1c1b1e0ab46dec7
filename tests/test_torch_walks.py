"""The port's walk models (LINE, Node2Vec) and device walks against the
JAX package.

Both sides get the same inputs: graphs built from one numpy seed, and
the uniforms JAX draws from its keys, replayed into the port's ``u=``
arguments ("key replay"). Tables must agree array for array and walk
picks bit for bit. Model tolerances (float32), as in
test_torch_unsup_sage.py: forward atol 1e-5, rtol 1e-4; loss rtol 1e-5;
gradients atol 1e-6, rtol 1e-4; parameters after Adam compared only
where |grad| > 1e-6, atol 1e-5; five-step losses rtol 1e-4. The loss is
a sum over the batch, not a mean.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.graph import device as jdev  # noqa: E402
from euler_tpu.models import LINE as JLINE  # noqa: E402
from euler_tpu.models import Node2Vec as JNode2Vec  # noqa: E402
from euler_tpu.nn import encoders as jencoders  # noqa: E402
from euler_tpu.ops import walk as jwalk  # noqa: E402

from euler_tpu_torch import datasets as tdatasets  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.convert import params_from_flax  # noqa: E402
from euler_tpu_torch.graph import MemoryGraph, sampling_kernels  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.models import LINE as TLINE  # noqa: E402
from euler_tpu_torch.models import Node2Vec as TNode2Vec  # noqa: E402
from euler_tpu_torch.models.shallow import SHALLOW_STREAMS  # noqa: E402
from euler_tpu_torch.nn import encoders as tencoders  # noqa: E402
from euler_tpu_torch.nn.layers import Embedding  # noqa: E402
from euler_tpu_torch.ops import walk as twalk  # noqa: E402
from tests.fixture_graph import TOPOLOGY  # noqa: E402

PL = dict(num_nodes=600, num_edges=12_000, feature_dim=4, label_dim=3,
          alpha=1.6, seed=5)
DIM = 16
NEGS = 3
BATCH = 8
WALK_LEN = 3
LR = 0.01


def _uni(key, shape):
    return np.array(jax.random.uniform(key, shape))  # writable copy


def _strip(table: dict) -> dict:
    """A JAX table without its host-side ``truncated_rows`` count."""
    return {k: v for k, v in table.items() if k != "truncated_rows"}


def _eq_tables(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def _fixture_port_graph():
    """The shared fixture graph (ids 10..16, two edge types) as a port
    graph over ids 0..16."""
    n, t = 17, 2
    groups = {(nid, et): sorted(g.items())
              for nid, (_, _, nbrs) in TOPOLOGY.items()
              for et, g in nbrs.items()}
    flat = [e for i in range(n * t) for e in groups.get((i // t, i % t), [])]
    counts = [len(groups.get((i // t, i % t), [])) for i in range(n * t)]
    return MemoryGraph(np.concatenate([[0], np.cumsum(counts)]),
                 [e[0] for e in flat], [e[1] for e in flat],
                 node_weights=[TOPOLOGY.get(i, (0, 0.0))[1] for i in range(n)],
                 node_types=[TOPOLOGY.get(i, (-1,))[0] for i in range(n)],
                 edge_type_num=t)


def _walk_graph():
    """120 nodes, two edge types, random weights: every 7th node has a
    self-loop, nodes 3 and 4 have no type-0 neighbors (dead ends), node 5
    has only zero-weight type-0 edges (not sampleable)."""
    rng = np.random.default_rng(21)
    n, t = 120, 2
    groups = {}
    for i in range(n):
        for et in range(t):
            d = 0 if (et == 0 and i in (3, 4)) else int(rng.integers(1, 9))
            ids = set(rng.choice(n, d, replace=False).tolist())
            if i % 7 == 0:
                ids.add(i)
            w = rng.uniform(0.1, 1.0, len(ids))
            if et == 0 and i == 5:
                w[:] = 0.0
            groups[(i, et)] = list(zip(sorted(ids), w))
    flat = [e for i in range(n * t) for e in groups[(i // t, i % t)]]
    counts = [len(groups[(i // t, i % t)]) for i in range(n * t)]
    return MemoryGraph(np.concatenate([[0], np.cumsum(counts)]),
                 [e[0] for e in flat], [e[1] for e in flat],
                 node_weights=np.ones(n), node_types=np.zeros(n),
                 edge_type_num=t)


@pytest.fixture(scope="module")
def walk_graph():
    return _walk_graph()


@pytest.fixture(scope="module")
def pl_graph():
    return MemoryGraph(**tdatasets.build_powerlaw(**PL))


# ---- pairs ----


@pytest.mark.parametrize("length,left,right", [
    (6, 5, 5), (4, 1, 1), (3, 5, 5), (5, 0, 2), (1, 3, 3), (5, 2, 0),
])
def test_pair_count_and_indices_match_jax(length, left, right):
    want = jwalk.pair_indices(length, left, right)
    got = twalk.pair_indices(length, left, right)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert twalk.pair_count(length, left, right) == jwalk.pair_count(
        length, left, right) == len(want[0])
    paths = np.random.default_rng(length).integers(0, 50, (3, length))
    np.testing.assert_array_equal(twalk.gen_pair(paths, left, right),
                                  jwalk.gen_pair(paths, left, right))


# ---- sorted tables ----


@pytest.mark.parametrize("which", ["fixture", "powerlaw"])
@pytest.mark.parametrize("form", ["slab", "slab_capped", "alias"])
def test_sorted_tables_match_jax(graph, pl_graph, which, form):
    """Sorted slabs (whole and capped: a truncated row keeps its heaviest
    neighbors in id order) and sorted alias tables equal the JAX
    package's, on the fixture graph over both edge types (the JAX side
    reads the engine) and on a power-law graph."""
    if which == "fixture":
        eg, tg, et, max_id, cap = graph, _fixture_port_graph(), [0, 1], 16, 2
    else:
        eg, tg, et, max_id, cap = (pl_graph, pl_graph, [0],
                                   PL["num_nodes"] - 1, 40)
    if form == "alias":
        want = jdev.build_alias_adjacency(eg, et, max_id, sorted=True)
        got = tdev.build_alias_adjacency(tg, et, max_id, sorted=True)
        unsorted = tdev.build_alias_adjacency(tg, et, max_id)
        # one edge type: rows are id-sorted either way
        assert np.array_equal(unsorted["nbr"], got["nbr"]) == (len(et) == 1)
    else:
        kw = dict(max_degree=cap) if form == "slab_capped" else {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the truncation warning
            want = _strip(jdev.build_adjacency(eg, et, max_id, sorted=True,
                                               **kw))
            got = tdev.build_adjacency(tg, et, max_id, sorted=True, **kw)
        nbr, deg = got["nbr"], got["deg"]
        assert (np.diff(nbr, axis=1) >= 0).all()  # padding = largest id
        if form == "slab_capped":
            assert (deg == cap).sum() > 0
    _eq_tables(got, want)


# ---- walks under key replay ----


def _odd_roots(max_id: int, m: int, seed: int, negative: bool = True):
    """[m] int32 roots led by odd ids: a negative id and one past the
    table (when ``negative``), the default row, the dead ends 3 and 4,
    the zero-weight row 5 and self-loop nodes."""
    odd = ([-7, max_id + 9] if negative else []) + [max_id + 1, 3, 4, 5,
                                                    7, 14]
    rng = np.random.default_rng(seed)
    return np.concatenate([odd, rng.integers(0, max_id + 1,
                                             m - len(odd))]).astype(np.int32)


@pytest.mark.parametrize("form", ["table", "metapath", "alias"])
def test_random_walk_matches_jax_under_key_replay(walk_graph, form):
    """Plain walks (the single-hop draw chained ``walk_len`` times) equal
    JAX's, through dead ends, unknown ids and zero-weight rows; on one
    slab, a metapath list of slabs over the two edge types, and alias
    tables."""
    max_id = walk_graph.max_node_id
    build_j, build_t = (
        (jdev.build_alias_adjacency, tdev.build_alias_adjacency)
        if form == "alias" else (jdev.build_adjacency, tdev.build_adjacency))
    ets = [[0], [1], [0]] if form == "metapath" else [[0]] * WALK_LEN
    jadj = [_strip(build_j(walk_graph, et, max_id)) for et in ets]
    tadj = [tdev.tensors(build_t(walk_graph, et, max_id), "cpu")
            for et in ets]
    m = 40
    roots = _odd_roots(max_id, m, 1)
    key = jax.random.PRNGKey(3)
    jarg = jadj if form == "metapath" else jadj[0]
    want = np.asarray(jdev.random_walk(jarg, roots, key, WALK_LEN))
    if form == "alias":
        u = [tuple(_uni(k, (m, 1)) for k in
                   jax.random.split(jax.random.fold_in(key, i)))
             for i in range(WALK_LEN)]
    else:
        u = [_uni(jax.random.fold_in(key, i), (m, 1))
             for i in range(WALK_LEN)]
    targ = tadj if form == "metapath" else tadj[0]
    got = tdev.random_walk(targ, torch.from_numpy(roots), WALK_LEN, u=u)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    default = max_id + 1
    # the dead ends, the zero-weight row and unknown ids stay default
    assert (want[:6, 1:] == default).all()
    # Philox uniforms run the same route
    assert tdev.random_walk(targ, torch.from_numpy(roots), WALK_LEN,
                            tdev.seed_words(9)).shape == (m, WALK_LEN + 1)


@pytest.mark.parametrize("pq", [(4.0, 0.25), (0.25, 4.0)])
def test_biased_walk_matches_jax_under_key_replay(walk_graph, pq,
                                                  monkeypatch):
    """node2vec-biased slab walks equal JAX's pick for pick, including
    the d_tx = 1-over-1/p precedence on self-loop parents; they reach no
    kernel wrapper (step 0 is the walk's own draw)."""
    def refuse(*a, **k):
        raise AssertionError("a biased walk reached a kernel wrapper")

    monkeypatch.setattr(sampling_kernels, "sample_neighbor", refuse)
    max_id = walk_graph.max_node_id
    jadj = _strip(jdev.build_adjacency(walk_graph, [0], max_id, sorted=True))
    tadj = tdev.tensors(tdev.build_adjacency(walk_graph, [0], max_id,
                                             sorted=True), "cpu")
    m = 200
    roots = _odd_roots(max_id, m, 2, negative=False)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jdev.biased_random_walk(jadj, roots, key, WALK_LEN,
                                              *pq))
    u = [_uni(jax.random.fold_in(key, i), (m, 1)) for i in range(WALK_LEN)]
    got = tdev.biased_random_walk(tadj, torch.from_numpy(roots), WALK_LEN,
                                  *pq, u=u).numpy()
    np.testing.assert_array_equal(got, want)
    # a walker returned to a self-loop parent: the precedence case ran
    loops = {i for i in range(max_id + 1) if i % 7 == 0}
    back = [(w[t - 1] in loops and w[t + 1] == w[t - 1])
            for w in want for t in range(1, WALK_LEN)]
    assert any(back)
    assert (want[:4, 1:] == max_id + 1).all()  # default, dead, zero rows
    # unknown ids walk the default row, as in every port draw (the JAX
    # function indexes the slab with raw ids, so a negative id would wrap
    # numpy-style; no model passes one: roots are clipped)
    odd = tdev.biased_random_walk(tadj, torch.tensor([-7, max_id + 9]),
                                  WALK_LEN, *pq, tdev.seed_words(1))
    assert odd[:, 0].tolist() == [-7, max_id + 9]
    assert (odd[:, 1:] == max_id + 1).all()


def _fallbacks(tab: dict, cur, parent, u, p, q) -> int:
    """Rejection steps (of sampleable rows) whose every proposal was
    rejected, recomputed in numpy from the table and the uniforms."""
    u1, u2, u3 = u
    off, deg, nbr = tab["off"].astype(np.int64), tab["deg"], tab["nbr"]
    d = deg[cur][:, None]
    j = np.minimum((u1 * d).astype(np.int32), np.maximum(d - 1, 0))
    slot = np.minimum(off[cur][:, None] + j, len(nbr) - 1)
    cand = np.where(u2 < tab["prob"][slot], nbr[slot], tab["alias"][slot])
    hit = np.array([np.isin(c, nbr[off[x]:off[x] + deg[x]])
                    for c, x in zip(cand, parent)])
    s = np.where(hit, 1.0, np.where(cand == parent[:, None], 1 / p, 1 / q))
    accepted = (u3 < s / max(1 / p, 1.0, 1 / q)).any(1)
    live = tab["sampleable"][cur] & (deg[cur] > 0)
    return int((live & ~accepted).sum())


@pytest.mark.parametrize("pq,trials", [((4.0, 0.25), 3), ((0.25, 4.0), 64),
                                       ((3.0, 3.0), 2)])
def test_alias_biased_walk_matches_jax_under_key_replay(walk_graph, pl_graph,
                                                        pq, trials,
                                                        monkeypatch):
    """The exact rejection walk over sorted alias tables equals JAX's
    pick for pick, with three uniforms a (walker, trial): on the
    two-edge-type graph and the power-law graph, with few enough trials
    that steps fall back to their first proposal. No kernel wrapper."""
    def refuse(*a, **k):
        raise AssertionError("an alias walk reached a kernel wrapper")

    monkeypatch.setattr(sampling_kernels, "sample_neighbor", refuse)
    p, q = pq
    fell_back = 0
    for g, et in ((walk_graph, [0, 1]), (pl_graph, [0])):
        max_id = g.max_node_id
        jadj = jdev.build_alias_adjacency(g, et, max_id, sorted=True)
        tab = tdev.build_alias_adjacency(g, et, max_id, sorted=True)
        tadj = tdev.tensors(tab, "cpu")
        m = 64
        roots = _odd_roots(max_id, m, 3)
        key = jax.random.PRNGKey(5)
        want = np.asarray(jdev.alias_biased_random_walk(
            jadj, roots, key, WALK_LEN, p, q, trials=trials))
        u = []
        for i in range(WALK_LEN):
            k = jax.random.fold_in(key, i)
            shape = (m, 1) if i == 0 else (m, trials)
            u.append(tuple(_uni(kk, shape)
                           for kk in jax.random.split(k, 2 if i == 0 else 3)))
        got = tdev.alias_biased_random_walk(
            tadj, torch.from_numpy(roots), WALK_LEN, p, q, trials=trials,
            u=u).numpy()
        np.testing.assert_array_equal(got, want)
        for i in range(1, WALK_LEN):
            fell_back += _fallbacks(tab, want[:, i], want[:, i - 1], u[i],
                                    p, q)
        # Philox uniforms: words 0, 1, 2 at (walker, trial, step, 0)
        assert tdev.alias_biased_random_walk(
            tadj, torch.from_numpy(roots), WALK_LEN, p, q, trials=trials,
            seed_words=tdev.seed_words(2)).shape == (m, WALK_LEN + 1)
    if trials < 8:  # with few trials some steps must fall back
        assert fell_back > 0


def test_truncation_guard_warns_and_builds_sorted_alias(pl_graph):
    """A biased Node2Vec whose sorted slab would truncate at max_degree
    gets the exact sorted alias tables, with a warning, equal to the JAX
    package's, and trains through them."""
    kw = dict(node_type=-1, edge_type=[0], max_id=PL["num_nodes"] - 1,
              dim=8, walk_len=2, walk_p=0.25, walk_q=4.0,
              device_sampling=True)
    jm, tm = JNode2Vec(**kw), TNode2Vec(**kw)
    for m in (jm, tm):
        m.set_sampling_options(max_degree=32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        st = tm.init_state(pl_graph, ttrain.get_optimizer("adam", LR),
                           device="cpu")
        jconsts = jm.build_consts(pl_graph)
    msgs = [str(w.message) for w in rec]
    assert sum("alias+rejection" in s for s in msgs) == 2, msgs
    k = tm.adj_key([0], sorted=True)
    assert k == jm.adj_key([0], sorted=True) == "et0_sorted"
    assert "off" in st["consts"]["adj"][k]
    _eq_tables({a: b.numpy() for a, b in st["consts"]["adj"][k].items()},
               jconsts["adj"][k])
    batch = tm.device_sample_batch(np.arange(8), seed=1, device="cpu")
    loss, _ = tm.make_train_step()(st, batch)
    assert np.isfinite(float(loss))


# ---- layers and encoder ----


def test_embedding_init_matches_flax_statistics():
    """Embedding's init is flax's truncated_normal(0.1): a unit normal cut
    at +-2, scaled (no variance correction). Moments of 2^18 draws."""
    n = 1 << 18
    want = np.asarray(jax.nn.initializers.truncated_normal(0.1)(
        jax.random.PRNGKey(0), (n,)))
    emb = Embedding(n, 1)
    emb.reset_parameters(torch.Generator().manual_seed(0))
    got = emb.embeddings.detach().numpy()[:, 0]
    assert np.abs(got).max() <= 0.2 and np.abs(want).max() <= 0.2
    assert abs(got.mean()) < 1e-3 and abs(want.mean()) < 1e-3
    # std of the unit normal truncated at +-2 is 0.8796; x 0.1
    np.testing.assert_allclose([got.std(), want.std()], 0.08796, rtol=5e-3)
    for qt in (0.05, 0.25, 0.75, 0.95):
        assert abs(np.quantile(got, qt) - np.quantile(want, qt)) < 2e-3
    ids = torch.tensor([-3, 0, n - 1, n + 5])
    np.testing.assert_array_equal(emb(ids).detach().numpy()[:, 0],
                                  got[[0, 0, n - 1, n - 1]])


@pytest.mark.parametrize("kind", ["id", "add", "concat_projection"])
def test_shallow_encoder_matches_flax(kind):
    kw = {"id": dict(max_id=30, embedding_dim=6),
          "add": dict(dim=8, feature_dim=5, max_id=30, combiner="add"),
          "concat_projection": dict(dim=8, feature_dim=5, max_id=30,
                                    embedding_dim=6)}[kind]
    rng = np.random.default_rng(2)
    feats = {"ids": rng.integers(-2, 35, 12).astype(np.int32),
             "dense": rng.standard_normal((12, 5)).astype(np.float32)}
    jenc = jencoders.ShallowEncoder(**kw)
    params = jenc.init(jax.random.PRNGKey(1), feats)["params"]
    want = np.asarray(jenc.apply({"params": params}, feats))
    tenc = tencoders.ShallowEncoder(**kw)
    sd = {k.split(".", 1)[1]: v for k, v in params_from_flax(
        {"target": jax.tree_util.tree_map(np.asarray, params)}).items()}
    assert sorted(sd) == sorted(tenc.state_dict())
    tenc.load_state_dict(sd)
    got = tenc({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got.shape == want.shape == (12, tenc.output_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-4)


def test_unsupported_configurations_raise(walk_graph):
    host = TNode2Vec(node_type=0, edge_type=[0], max_id=10, dim=8)
    assert not host.device_sampling and host.build_consts(walk_graph,
                                                          "cpu") == {}
    # sparse slots drawn on the card need their tables there, as in JAX
    kw = dict(node_type=0, edge_type=[0], max_id=10, dim=8,
              sparse_feature_idx=[0], sparse_feature_max_ids=[9],
              device_sampling=True)
    with pytest.raises(ValueError, match="device_features=True"):
        JLINE(**kw)
    with pytest.raises(ValueError, match="device_features=True"):
        TLINE(**kw)
    m = TNode2Vec(node_type=0, edge_type=[0], max_id=10, dim=8,
                  device_sampling=True)
    assert sorted(m.sample(walk_graph, [1, 2])) == ["roots", "seed"]
    # a biased module over an unsorted key refuses to walk
    m = TNode2Vec(node_type=0, edge_type=[0], max_id=walk_graph.max_node_id,
                  dim=8, walk_p=2.0, device_sampling=True)
    st = m.init_state(walk_graph, ttrain.get_optimizer("adam", LR),
                      device="cpu")
    st["module"].adj_key = "et0"
    st["consts"]["adj"]["et0"] = st["consts"]["adj"]["et0_sorted"]
    with pytest.raises(ValueError, match="id-sorted"):
        st["module"](m.device_sample_batch([1, 2], 0, device="cpu"),
                     st["consts"])


# ---- models ----


MODELS = {
    "line1": (JLINE, TLINE, dict(order=1)),
    "line2_features": (JLINE, TLINE, dict(
        order=2, feature_idx=1, feature_dim=PL["feature_dim"],
        device_features=True)),
    "node2vec": (JNode2Vec, TNode2Vec, dict(walk_len=WALK_LEN)),
    "node2vec_biased": (JNode2Vec, TNode2Vec, dict(
        walk_len=WALK_LEN, walk_p=4.0, walk_q=0.25)),
    "node2vec_alias": (JNode2Vec, TNode2Vec, dict(
        walk_len=WALK_LEN, walk_p=0.25, walk_q=4.0, walk_trials=4)),
}


def _models(name):
    jcls, tcls, extra = MODELS[name]
    kw = dict(node_type=0, edge_type=[0], max_id=PL["num_nodes"] - 1,
              dim=DIM, num_negs=NEGS, xent_loss=True, device_sampling=True,
              **extra)
    jm, tm = jcls(**kw), tcls(**kw)
    if name == "node2vec_alias":
        for m in (jm, tm):
            m.set_sampling_options(alias=True)
    return jm, tm


def _host_batch(tm, seed: int) -> dict:
    """Numpy-seeded node sets: B sources, B positives, B * NEGS
    negatives, as both modules' feature dicts take them."""
    rng = np.random.default_rng(seed)
    n = PL["num_nodes"] + 1
    out = {}
    for name, rows in (("src", BATCH), ("pos", BATCH),
                       ("negs", BATCH * NEGS)):
        ids = rng.integers(0, n, rows).astype(np.int32)
        out[name] = {k: v.numpy() for k, v in
                     tm.node_inputs(ids, device="cpu").items()}
    return out


def _jinit(jm, tm, consts):
    """Flax params, traced on a host-given batch (an eager init through
    the device draws takes seconds)."""
    return jax.jit(jm.module.init)(jax.random.PRNGKey(0), _host_batch(tm, 0),
                                   consts)["params"]


def _replayed(jm, seed: int, b: int) -> dict:
    """The uniforms the JAX module draws from batch seed ``seed``, keyed
    by the port's stream names: key = PRNGKey(seed), (walk, neg) =
    split(key); the walk's step i from fold_in(walk, i)."""
    k_walk, k_neg = jax.random.split(jax.random.PRNGKey(seed))
    mod = jm.module
    if mod.walk_len == 0:
        walk = _uni(k_walk, (b, 1))
        n_src = b
    else:
        alias = jm.sampling_alias and (mod.walk_p, mod.walk_q) != (1.0, 1.0)
        walk = []
        for i in range(mod.walk_len):
            k = jax.random.fold_in(k_walk, i)
            if not alias:
                walk.append(_uni(k, (b, 1)))
            elif i == 0:
                walk.append(tuple(_uni(kk, (b, 1))
                                  for kk in jax.random.split(k)))
            else:
                shape = (b, mod.walk_trials or jdev.DEFAULT_WALK_TRIALS)
                walk.append(tuple(_uni(kk, shape)
                                  for kk in jax.random.split(k, 3)))
        n_src = b * jm.batch_size_ratio
    neg = [_uni(k, (n_src * NEGS,)) for k in jax.random.split(k_neg)]
    u = {"walk": walk, "neg": neg}
    assert sorted(u) == sorted(SHALLOW_STREAMS)
    return u


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_and_five_adam_steps_match_flax(pl_graph, name):
    """From the same parameters, under key replay (roots given, walk,
    positives and negatives drawn from the replayed uniforms): step 1's
    loss, mrr and gradients equal flax's, and five Adam steps track
    optax in loss and (after step 1) parameters."""
    jm, tm = _models(name)
    jconsts = jm.build_consts(pl_graph)
    jparams = _jinit(jm, tm, jconsts)
    st = tm.init_state(pl_graph, ttrain.get_optimizer("adam", LR),
                       device="cpu")
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    assert sorted(st["consts"]["adj"]) == sorted(jconsts["adj"])

    def jloss(p, batch, consts):
        out = jm._apply(p, batch, consts)
        return out.loss, out.metric

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    opt = optax.adam(LR)
    jopt = opt.init(jparams)
    tstep = tm.make_train_step()
    rng = np.random.default_rng(7)
    jl, tl = [], []
    for i in range(5):
        seed = 100 + i
        roots = rng.integers(0, PL["num_nodes"] + 1, BATCH).astype(np.int32)
        (loss, mrr), grads = jgrad(
            jparams, {"roots": roots,
                      "seed": np.full(BATCH, seed, np.int32)}, jconsts)
        updates, jopt = opt.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tloss, tmrr = tstep(st, {"roots": torch.from_numpy(roots),
                                 "seed": seed,
                                 "u": _replayed(jm, seed, BATCH)})
        jl.append(float(loss))
        tl.append(float(tloss))
        if i == 0:
            np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
            np.testing.assert_allclose(float(tmrr), float(mrr), rtol=1e-6)
            want_g = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             grads))
            want_p = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
            for k, p in st["module"].named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                           atol=1e-6, rtol=1e-4, err_msg=k)
                mask = p.grad.abs() > 1e-6
                assert int(mask.sum()) > 0
                np.testing.assert_allclose(
                    p.detach()[mask].numpy(), want_p[k][mask].numpy(),
                    atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_scan_train_runs_node2vec_on_cpu_with_philox_draws(walk_graph,
                                                          monkeypatch):
    """make_scan_train on Node2Vec on the CPU: finite losses, the same
    from the same seeds, the walk through the single-hop wrapper (its
    plain version here) once a step of the walk."""
    calls = []
    wrapped = sampling_kernels.sample_neighbor

    def counting(*a, **k):
        calls.append(a[1].shape)
        return wrapped(*a, **k)

    kw = dict(node_type=0, edge_type=[0], max_id=walk_graph.max_node_id,
              dim=DIM, walk_len=WALK_LEN, num_negs=NEGS, xent_loss=True,
              device_sampling=True)
    runs = []
    for _ in range(2):
        tm = TNode2Vec(**kw)
        st = tm.init_state(walk_graph, ttrain.get_optimizer("adam", LR),
                           device="cpu", seed=1)
        scan = ttrain.make_scan_train(tm, 3, BATCH * tm.batch_size_ratio)
        monkeypatch.setattr(sampling_kernels, "sample_neighbor", counting)
        runs.append(torch.cat([scan(st, c)[1] for c in range(2)]))
        monkeypatch.undo()
    assert torch.isfinite(runs[0]).all() and runs[0].shape == (6,)
    assert torch.equal(runs[0], runs[1])
    roots = BATCH * tm.batch_size_ratio
    assert calls == [(roots,)] * (2 * 6 * WALK_LEN)
    assert sampling_kernels.launches == {"sample_fanout2": 0,
                                         "sample_neighbor": 0}


def test_save_embedding_matches_jax(pl_graph):
    """save_embedding's [max_id+1, dim] matrix equals the JAX package's
    on the same parameters (id embedding plus the features' Dense)."""
    jm, tm = _models("line2_features")
    jconsts = jm.build_consts(pl_graph)
    jparams = _jinit(jm, tm, jconsts)
    jstate = {"params": jparams, "opt_state": optax.adam(LR).init(jparams),
              "consts": jconsts}
    want = jtrain.save_embedding(jm, pl_graph, PL["num_nodes"] - 1, jstate,
                                 batch_size=64)
    st = tm.init_state(pl_graph, ttrain.get_optimizer("adam", LR),
                       device="cpu")
    st["module"].load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    got = ttrain.save_embedding(tm, PL["num_nodes"] - 1, st, batch_size=64,
                                device="cpu")
    assert got.shape == want.shape == (PL["num_nodes"], DIM)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
