"""The port's sparse-feature layer and LsHNE against the JAX package:
``MemoryGraph.get_sparse_feature`` against the engine, ``ops.get_sparse_feature``,
``upload_sparse_tables``, ``SparseEmbedding``, ``TypedDense``, the typed
negative sampler, LsHNE's device views, its loss, metric, embedding and
gradients, five Adam steps, ``train.evaluate``, and the walks' route
through the single-hop kernel's wrapper.

Both sides get the same inputs: a heterogeneous graph from one numpy seed
(two edge types, four node types, one of them of zero weight, two ragged
sparse slots; the JAX model builds its tables from the port's in-memory
graph), numpy-seeded rows and roots, the same weights carried across with
``convert.params_from_flax``, and the uniforms JAX draws from each step's
keys replayed into the port's ``batch["u"]`` ("key replay"): walks, pairs
and negatives must then agree id for id. Tolerances (float32): layer
outputs atol 1e-5, rtol 1e-4; losses rtol 1e-5; gradients rtol 1e-4
and atol 1e-6 (the model's: the larger of 1e-6 and 1e-7 of the
parameter's largest gradient, since the loss sums over pairs and cosines
of embeddings that start at stddev 0.0002, so the tables' gradients run
to 1e4 and cancel in float32); mrr atol 1e-6 beyond what ties can move
it (``_mrr_slack``); five-step losses rtol 1e-4; parameters after each
Adam step atol 1e-5 on the elements whose gradient exceeded 1e-6 at
every step so far.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from euler_tpu import ops as jops  # noqa: E402
from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.graph import device as jdev  # noqa: E402
from euler_tpu.models import LsHNE as JLsHNE  # noqa: E402
from euler_tpu.models import base as jbase  # noqa: E402
from euler_tpu.models import lshne as jlshne  # noqa: E402
from euler_tpu.nn import layers as jlayers  # noqa: E402

from euler_tpu_torch import convert  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.datasets import build_synthetic  # noqa: E402
from euler_tpu_torch.graph import MemoryGraph, sampling_kernels  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.models import LsHNE as TLsHNE  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from euler_tpu_torch.models import lshne as tlshne  # noqa: E402
from euler_tpu_torch.nn import layers as tlayers  # noqa: E402
from euler_tpu_torch.ops import feature as tfeature  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


N = 150
TYPES = 5  # node types 0-2 live, 3 of zero weight, 4 absent
MAX_LEN = 6
DIMS = [N + 2, 40]
DIM = 8
NEGS = 3
BATCH = 12
LR = 0.01
# two views: two equal 3-step metapaths over edge type 0, and a 2-step
# metapath over types 0 then {0, 1}
PATTERNS = [[[[0], [0], [0]], [[0], [0], [0]]], [[[0], [0, 1]]]]


def hetero_graph(n: int, seed: int) -> MemoryGraph:
    """A port MemoryGraph of two edge types (a seeded coin per edge of
    ``build_synthetic``'s), node types 0-3 (type 3 of zero weight), two
    rows of zero edge weight, and two ragged uint64 slots: slot 0 the
    node's id, then its next ids, 0 to 9 values a row (past ``MAX_LEN`` for
    some); slot 1 0 to 4 random values below 40."""
    d = build_synthetic(n, 5, 4, 3, seed=seed)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), np.diff(d["indptr"]))
    key = rows * 2 + rng.integers(0, 2, len(rows))
    order = np.argsort(key, kind="stable")
    indptr = np.zeros(2 * n + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=2 * n), out=indptr[1:])
    weights = rng.uniform(0.1, 1.0, len(rows)).astype(np.float32)[order]
    for r in (3, 4):  # node r's type-0 edges weigh nothing
        weights[indptr[2 * r]:indptr[2 * r + 1]] = 0.0
    types = rng.integers(0, 4, n).astype(np.int32)
    node_w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    node_w[types == 3] = 0.0
    node_w[:2] = 0.0
    slots = []
    for hi, width in ((10, None), (5, 40)):
        counts = rng.integers(0, hi, n)
        ptr = np.concatenate([[0], np.cumsum(counts)])
        if width is None:  # the node's own id, then the next ones
            vals = np.repeat(np.arange(n), counts) + (
                np.arange(ptr[-1]) - np.repeat(ptr[:-1], counts))
        else:
            vals = rng.integers(0, width, ptr[-1])
        slots.append((ptr, vals))
    return MemoryGraph(indptr, d["indices"][order], weights, node_w, types,
                 d["dense_features"], edge_type_num=2, sparse_features=slots)


@pytest.fixture(scope="module")
def syn():
    return hetero_graph(N, 4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _uni(key, shape):
    return np.array(jax.random.uniform(key, shape))


def _kw():
    return dict(node_type=-1, path_patterns=PATTERNS, max_id=N - 1, dim=DIM,
                sparse_feature_dims=DIMS, feature_ids=[0, 1],
                sparse_max_len=MAX_LEN, num_negs=NEGS, src_type_num=TYPES,
                device_sampling=True)


def _pair(syn):
    """(JAX model, its state, port model, port state) from the same
    parameters; the state dict is filled strictly."""
    jm, tm = JLsHNE(**_kw()), TLsHNE(**_kw())
    with pytest.warns(UserWarning, match="no weight>0 nodes"):
        consts = jm.build_consts(syn)
    # init_state's steps, the module's init jitted (eager, it takes 15 s)
    params = jax.jit(jm.module.init)(
        jax.random.PRNGKey(0), jm.sample(syn, np.arange(BATCH)),
        consts)["params"]
    jstate = {"params": params, "consts": consts}
    return jm, jstate, tm, _port_state(tm, syn, params)


def _port_state(tm, syn, params):
    """A fresh port state holding the flax ``params``."""
    with pytest.warns(UserWarning, match="no weight>0 nodes"):
        st = tm.init_state(syn, ttrain.get_optimizer("adam", LR),
                           device="cpu")
    sd = convert.params_from_flax(_np(params))
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    return st


@pytest.fixture(scope="module")
def pair(syn):
    return _pair(syn)


def _replayed(jm, roots, seed: int) -> dict:
    """The uniforms of JAX's ``_device_views`` for one step: view v keys
    fold_in(PRNGKey(seed), v); its metapath pi walks step i on
    fold_in(fold_in(kv, pi), i); its negatives split
    fold_in(kv, 1 << 20) into (u1, u2) over [sources, num_negs]."""
    key = jax.random.PRNGKey(seed)
    walk, neg = [], []
    for v, patterns in enumerate(jm.path_patterns):
        kv = jax.random.fold_in(key, v)
        walk.append([[_uni(jax.random.fold_in(jax.random.fold_in(kv, pi), i),
                           (len(roots), 1)) for i in range(len(p))]
                     for pi, p in enumerate(patterns)])
        n_src = len(roots) * sum(
            jops.walk.pair_indices(len(p) + 1, 1, 1)[0].shape[0]
            for p in patterns)
        neg.append(tuple(_uni(k, (n_src, NEGS)) for k in jax.random.split(
            jax.random.fold_in(kv, 1 << 20))))
    return {"walk": walk, "neg": neg}


def _batches(jm, tm, roots, seed: int):
    jb = {"roots": roots.astype(np.int32),
          "seed": np.full(len(roots), seed, np.int32)}
    tb = tm.device_sample_batch(roots, seed, device="cpu")
    tb["u"] = _replayed(jm, roots, seed)
    return jb, tb


def _fixture_port_graph():
    """The engine fixture's nodes (ids 10-16) as a port MemoryGraph of ids
    0-16, ids 0-9 featureless."""
    from tests.fixture_graph import fixture_nodes

    n = 17
    slots = []
    for k in ("0", "1"):
        rows = [[] for _ in range(n)]
        for node in fixture_nodes():
            rows[node["node_id"]] = node["uint64_feature"][k]
        ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        slots.append((ptr, np.concatenate([np.asarray(r, np.int64)
                                           for r in rows])))
    return MemoryGraph(np.zeros(n + 1, np.int64), [], [], np.ones(n, np.float32),
                 np.zeros(n, np.int32), sparse_features=slots)


def test_get_sparse_feature_matches_the_engine(graph):
    """Per slot (values, counts) equal the engine's on the fixture graph,
    unknown ids and an unknown slot giving counts of 0."""
    port = _fixture_port_graph()
    ids = np.array([10, 16, 12, 3, -1, 99, 11, 10])
    fids = [1, 0, 5]
    got, want = port.get_sparse_feature(ids, fids), graph.get_sparse_feature(
        ids, fids)
    assert len(got) == len(want) == 3
    for (gv, gc), (wv, wc) in zip(got, want):
        assert gv.dtype == np.int64 and gc.dtype == np.int32
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gc, wc)


def test_sparse_tables_match_jax(syn):
    """``ops.get_sparse_feature`` (padding, cutting past max_len, empty
    rows, unknown ids) and ``upload_sparse_tables`` (rows 0..max_id+1,
    int32 ids) equal the JAX package's, array for array."""
    ids = np.array([0, 5, 7, N - 1, -3, N, N + 40, 11])
    for max_len, defaults in ((MAX_LEN, [N + 1, 40]), ([3, 9], None)):
        got = tfeature.get_sparse_feature(syn, ids, [0, 1], max_len,
                                          default_values=defaults)
        want = jops.get_sparse_feature(syn, ids, [0, 1], max_len,
                                       default_values=defaults)
        for (gi, gm), (wi, wm) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
    got = tbase.upload_sparse_tables(syn, N - 1, [1, 0], MAX_LEN, [7, 0],
                                     "cpu")
    want = jbase.upload_sparse_tables(syn, N - 1, [1, 0], MAX_LEN, [7, 0])
    for g, w in zip(got, want):
        assert g["ids"].dtype == torch.int32 and g["ids"].shape == (
            N + 1, MAX_LEN)
        np.testing.assert_array_equal(g["ids"].numpy(), np.asarray(w["ids"]))
        np.testing.assert_array_equal(g["mask"].numpy(),
                                      np.asarray(w["mask"]))
    assert (got[1]["mask"].sum(1) > MAX_LEN - 1).any()  # some rows cut


def _vjp_check(jmod, tmod, args, torch_args, params_to_sd,
               table_scale=1.0):
    """Forward and parameter gradients of a port module against its flax
    counterpart (its embedding tables times ``table_scale``) under a
    random cotangent."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(2), *args)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * table_scale if path[-1].key == "embeddings"
        else a, params)
    tmod.load_state_dict(params_to_sd(_np(params)))
    out = tmod(*torch_args)
    ct = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)

    @jax.jit
    def forward_and_vjp(p):
        want, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, *args), p)
        return want, vjp(ct)[0]

    want, grads = forward_and_vjp(params)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    out.backward(torch.from_numpy(ct))
    want_g = params_to_sd(_np(grads))
    for k, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_sparse_embedding_matches_flax(combiner):
    """Ids past the table and negative ones clipped, padding masked out,
    an all-masked row (zeros, and for mean no division by 0)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-3, 25, (9, 5)).astype(np.int32)
    mask = (rng.random((9, 5)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    tmod = tlayers.SparseEmbedding(20, 6, combiner=combiner)
    _vjp_check(jlayers.SparseEmbedding(20, 6, combiner=combiner),
               tmod, (ids, mask), (torch.from_numpy(ids),
                                   torch.from_numpy(mask)),
               lambda p: {"embeddings": torch.from_numpy(
                   np.array(p["embeddings"]))}, table_scale=1000.0)
    assert tmod(torch.from_numpy(ids), torch.from_numpy(mask))[0].abs().max() \
        == 0


def test_typed_dense_matches_flax_and_the_gather_form():
    """Types out of range on both sides (clamped), several block spans:
    flax's gathered-weight einsum and the port's grouped product agree;
    so does the per-row gather written in torch."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, 7)).astype(np.float32)
    t = rng.integers(-2, TYPES + 2, 300).astype(np.int32)
    t[:200] = 1  # one type past a block of rows
    tmod = tlshne.TypedDense(TYPES, 7, 4)
    _vjp_check(jlshne.TypedDense(TYPES, 4), tmod, (x, t),
               (torch.from_numpy(x), torch.from_numpy(t)), lambda p: {
                   "kernel": torch.from_numpy(np.array(p["kernel"])),
                   "bias": torch.from_numpy(np.array(p["bias"]))})
    with torch.no_grad():
        tmod.bias.uniform_(-1.0, 1.0)
    tc = torch.from_numpy(t).long().clamp(0, TYPES - 1)
    gathered = (torch.einsum("bi,bio->bo", torch.from_numpy(x),
                             tmod.kernel[tc]) + tmod.bias[tc])
    np.testing.assert_allclose(
        tmod(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy(),
        gathered.detach().numpy(), atol=1e-5, rtol=1e-4)


def test_typed_node_sampler_matches_jax(syn):
    """``build_typed_node_sampler`` array for array, with the warning for
    the type whose nodes all weigh 0."""
    with pytest.warns(UserWarning, match=r"node types \[3\]"):
        got = tdev.build_typed_node_sampler(syn, TYPES, N - 1)
    with pytest.warns(UserWarning, match=r"node types \[3\]"):
        want = jdev.build_typed_node_sampler(syn, TYPES, N - 1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sample_node_with_src_matches_jax_under_key_replay(syn, pair,
                                                           monkeypatch):
    """Sources of every type, the default row (type 0), type 3 (no node
    of positive weight: the default node) and ids past the table, under
    the uniforms of JAX's split key, with a small SEG so both levels of
    the search have several segments; every live pick has its source's
    type."""
    monkeypatch.setattr(tdev, "SEG", 4)
    monkeypatch.setattr(jdev, "SEG", 4)
    with pytest.warns(UserWarning):
        t_s = tdev.tensors(tdev.build_typed_node_sampler(syn, TYPES, N - 1),
                           "cpu")
    with pytest.warns(UserWarning):
        j_s = jdev.build_typed_node_sampler(syn, TYPES, N - 1)
    assert j_s["seg_cum"].shape[0] > TYPES
    src = np.random.default_rng(6).integers(0, N, 64).astype(np.int32)
    src[:3] = [N, N, N + 5]  # the default row, twice, and past it
    key = jax.random.PRNGKey(11)
    u = tuple(_uni(k, (64, 7)) for k in jax.random.split(key))
    got = tdev.sample_node_with_src(t_s, torch.from_numpy(src), 7,
                                    u=u).numpy()
    # the JAX function takes ids inside its table: past it the port reads
    # the default row, as the clip gives JAX
    want = np.asarray(jdev.sample_node_with_src(j_s, np.minimum(src, N),
                                                key, 7))
    assert got.dtype == np.int32 and got.shape == (64, 7)
    np.testing.assert_array_equal(got, want)
    types = syn.node_types(np.arange(N))
    src_t = np.where(src < N, types[np.minimum(src, N - 1)], 0)
    live = got < N
    np.testing.assert_array_equal(types[got[live]],
                                  np.broadcast_to(src_t[:, None],
                                                  got.shape)[live])
    assert (got[src_t == 3] == N).all()
    assert live[src_t != 3].all()
    # Philox draws: the same on a second call, in the sampler's types
    words = tdev.stream_words(3, 1)
    a = tdev.sample_node_with_src(t_s, torch.from_numpy(src), 7, words)
    assert torch.equal(a, tdev.sample_node_with_src(
        t_s, torch.from_numpy(src), 7, words))


def test_device_views_match_jax_under_key_replay(pair, monkeypatch):
    """Per view the sources, positives and negatives (ids) and the pair
    masks equal JAX's, on roots led by the default row and a zero-weight
    row (dead walks: masked pairs), with two equal metapaths walking
    different walks; without injected uniforms the Philox streams keep
    them apart too."""
    jm, jstate, tm, st = pair
    roots = np.random.default_rng(7).integers(0, N, BATCH).astype(np.int32)
    roots[:2] = [N, 3]
    jb, tb = _batches(jm, tm, roots, 21)
    ident = lambda self, ids, consts: {"ids": ids}  # noqa: E731
    monkeypatch.setattr(jlshne._LsHNEModule, "_dev_node", ident)
    monkeypatch.setattr(tlshne._LsHNEModule, "_dev_node", ident)
    want, _ = jax.jit(lambda p, b, c: jm.module.apply(
        {"params": p}, b, c, method=jlshne._LsHNEModule._device_views))(
            jstate["params"], jb, jstate["consts"])
    got, root = st["module"]._device_views(tb, st["consts"])
    np.testing.assert_array_equal(root["ids"].numpy(), roots)
    for v, (g, w) in enumerate(zip(got, want)):
        for k in ("src", "pos", "negs"):
            np.testing.assert_array_equal(g[k]["ids"].numpy(),
                                          np.asarray(w[k]["ids"]),
                                          err_msg=f"view {v} {k}")
        np.testing.assert_array_equal(g["mask"].numpy(),
                                      np.asarray(w["mask"]))
    per_root = 2 * 6  # two metapaths of 4 nodes, windows 1/1
    src = got[0]["src"]["ids"].reshape(BATCH, per_root)
    assert (got[0]["mask"].reshape(BATCH, per_root)[:2] == 0).all()
    assert not torch.equal(src[2:, :6], src[2:, 6:])  # two distinct walks
    del tb["u"]
    views, _ = st["module"]._device_views(tb, st["consts"])
    src = views[0]["src"]["ids"].reshape(BATCH, per_root)
    assert not torch.equal(src[2:, :6], src[2:, 6:])


def _mrr_slack(module, batch, consts) -> float:
    """How far the two mrrs may differ through ties alone: a negative
    whose cosine lies within 1e-6 of its positive's (the same node drawn
    as both, or two nodes of equal features) may rank either side of it,
    as float32 rounding falls in each package, moving that pair's 1/rank
    by at most 1/2. The bound, per view over the masked pairs, then
    averaged over the views as the metric is."""
    with torch.no_grad():
        views, _ = module._device_views(batch, consts)
        slack = []
        for v, view in enumerate(views):
            emb = module.att_embedding(view["src"],
                                       module.encode_src(view["src"], v), v)
            pos = tlshne._cosine(emb, module.encode_tar(view["pos"]))
            neg = tlshne._cosine(emb[:, None, :], module.encode_tar(
                view["negs"]).reshape(emb.shape[0], NEGS, -1))[..., 0]
            ties = ((neg - pos).abs() <= 1e-6).sum(-1) * view["mask"]
            slack.append(0.5 * float(ties.sum())
                         / max(float(view["mask"].sum()), 1.0))
    return float(np.mean(slack))


def _jgrad(jm, jstate):
    """JAX's jitted (loss, (metric, embedding)) and gradients, compiled
    once a state."""
    if "grad_fn" not in jstate:
        jconsts = jax.tree_util.tree_map(jnp.asarray, jstate["consts"])

        def loss_fn(p, b):
            out = jm._apply(p, b, jconsts)
            return out.loss, (out.metric, out.embedding)

        jstate["grad_fn"] = jax.jit(jax.value_and_grad(loss_fn,
                                                       has_aux=True))
    return jstate["grad_fn"]


def test_lshne_matches_flax_under_key_replay(pair):
    """Loss, mrr, embedding and every parameter's gradient equal flax's
    on device-drawn views."""
    jm, jstate, tm, st = pair
    roots = np.random.default_rng(8).integers(0, N, BATCH).astype(np.int32)
    jb, tb = _batches(jm, tm, roots, 33)
    (loss, (mrr, emb)), grads = _jgrad(jm, jstate)(jstate["params"], jb)
    st["module"].zero_grad()
    out = st["module"](tb, st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(out.metric), float(mrr),
        atol=1e-6 + _mrr_slack(st["module"], tb, st["consts"]))
    np.testing.assert_allclose(out.embedding.detach().numpy(),
                               np.asarray(emb), atol=1e-5, rtol=1e-4)
    want = convert.params_from_flax(_np(grads))
    for k, p in st["module"].named_parameters():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=max(1e-6, 1e-7 * scale), rtol=1e-4,
                                   err_msg=k)


def test_lshne_adam_steps_track_optax(syn, pair):
    """Five steps from the same parameters under key replay: losses and
    parameters track optax's Adam after every step (over the elements
    whose gradient stayed above 1e-6, at least half of them)."""
    jm, jstate, tm, _ = pair
    st = _port_state(tm, syn, jstate["params"])
    jgrad = _jgrad(jm, jstate)
    opt = optax.adam(LR)
    jparams, jopt = jstate["params"], opt.init(jstate["params"])
    tstep = tm.make_train_step()
    rng = np.random.default_rng(20)
    jl, tl, tracked = [], [], {}
    for i in range(5):
        roots = rng.integers(0, N, BATCH).astype(np.int32)
        jb, tb = _batches(jm, tm, roots, 50 + i)
        (loss, _), grads = jgrad(jparams, jb)
        updates, jopt = opt.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jl.append(float(loss))
        tl.append(float(tstep(st, tb)[0]))
        want = convert.params_from_flax(_np(jparams))
        for k, p in st["module"].named_parameters():
            tracked[k] = tracked.get(k, True) & (p.grad.abs() > 1e-6)
            np.testing.assert_allclose(p.detach()[tracked[k]].numpy(),
                                       want[k][tracked[k]].numpy(),
                                       atol=1e-5, err_msg=f"{k}, step {i}")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    n_tracked = sum(int(m.sum()) for m in tracked.values())
    assert n_tracked > 0.5 * sum(m.numel() for m in tracked.values())


def test_evaluate_and_embed_match_jax(syn, pair):
    """``train.evaluate`` (mrr, a running mean) over three batches equals
    JAX's eval steps on the same views, accumulated with the JAX package's
    ``_metric_*``; the embed step equals JAX's; ``save_embedding`` gives
    every node a finite row."""
    jm, jstate, tm, st = pair
    rng = np.random.default_rng(9)
    source = [rng.integers(0, N, BATCH) for _ in range(3)]
    got = ttrain.evaluate(tm, syn, source, st, device="cpu", seed=70)
    eval_fn = jax.jit(jm.make_eval_step())
    jvars = {"params": jstate["params"], "consts": jstate["consts"]}
    acc, losses, slack = jtrain._metric_zero("mrr"), [], []
    for i, ids in enumerate(source):
        # the port's Philox views of batch i, handed to JAX as given views
        tb = tm.device_sample_batch(ids, 70 + i, device="cpu")
        views, root = st["module"]._device_views(tb, st["consts"])
        loss, metric = eval_fn(jvars, jax.tree_util.tree_map(
            lambda t: t.numpy(), {"views": views, "root": root}))
        acc = jtrain._metric_accumulate("mrr", acc, metric)
        losses.append(float(loss))
        slack.append(_mrr_slack(st["module"], tb, st["consts"]))
    np.testing.assert_allclose(got["mrr"], jtrain._metric_value("mrr", acc),
                               atol=1e-6 + np.mean(slack))
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=1e-5)
    ids = np.arange(BATCH)
    np.testing.assert_allclose(
        tm.make_embed_step()(st, tm.sample_embed(ids, "cpu")).numpy(),
        np.asarray(jax.jit(jm.make_embed_step())(
            jvars, {"roots": ids.astype(np.int32)})),
        atol=1e-5, rtol=1e-4)
    emb = ttrain.save_embedding(tm, N - 1, st, batch_size=64, device="cpu")
    assert emb.shape == (N, DIM) and np.isfinite(emb).all()


def test_walks_go_through_the_single_hop_wrapper(syn, monkeypatch):
    """make_scan_train on LsHNE: each step's walks call the single-hop
    wrapper once a walk step with [B] nodes and count 1, 3 + 3 + 2 = 8
    a step here (run_loop's two 3-step metapaths make 6), the chained
    wrapper never; finite losses, the same from the same seeds."""
    calls = []
    wrapped = sampling_kernels.sample_neighbor

    def counting(*a, **k):
        calls.append((tuple(a[1].shape), a[3]))
        return wrapped(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("LsHNE reached the chained kernel's wrapper")

    runs = []
    for _ in range(2):
        tm = TLsHNE(**_kw())
        with pytest.warns(UserWarning):
            st = tm.init_state(syn, ttrain.get_optimizer("adam", LR),
                               device="cpu", seed=1)
        monkeypatch.setattr(sampling_kernels, "sample_neighbor", counting)
        monkeypatch.setattr(sampling_kernels, "sample_fanout2", refuse)
        scan = ttrain.make_scan_train(tm, 2, BATCH)
        runs.append(torch.cat([scan(st, c)[1] for c in range(2)]))
        monkeypatch.undo()
    assert all(torch.isfinite(r).all() and r.shape == (4,) for r in runs)
    assert torch.equal(runs[0], runs[1])
    assert calls == [((BATCH,), 1)] * (8 * 4 * 2)
    assert sampling_kernels.launches == {"sample_fanout2": 0,
                                         "sample_neighbor": 0}


def test_params_from_flax_fills_every_parameter(pair):
    """Every port parameter comes from the flax tree, shapes as they
    stand: the TypedDenses' [T, in, out] kernels, the slots' tables and
    att_vec [V, dim]."""
    jm, jstate, tm, st = pair
    module = tm.make_module()
    module.load_state_dict(convert.params_from_flax(_np(jstate["params"])))
    assert module.src_hidden[1].kernel.shape == (TYPES, 32, 256)
    assert module.tar_out.kernel.shape == (TYPES, 256, DIM)
    assert module.feature_embeddings[0].embeddings.shape == (N + 2, 16)
    assert module.att_vec.shape == (2, DIM)
    np.testing.assert_array_equal(
        module.att_vec.detach().numpy(),
        np.asarray(jstate["params"]["att_vec"]))


def test_lshne_entry_points_default_to_the_card(monkeypatch, syn):
    """init_state and device_sample_batch run on the card unless asked
    for the CPU; host sampling builds no device table."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = ttrain.get_optimizer("adam", LR)
    host = TLsHNE(**{**_kw(), "device_sampling": False})
    assert not host.device_sampling and host.build_consts(syn, "cpu") == {}
    m = TLsHNE(**_kw())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_state(syn, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device_sample_batch([1, 2], seed=0)
    assert sorted(m.sample(syn, [1, 2])) == ["roots", "seed"]
    with pytest.warns(UserWarning):
        state = m.init_state(syn, opt, device="cpu")
    assert state["consts"]["tsampler"]["ids"].device.type == "cpu"
    assert state["consts"]["sparse"][0]["ids"].dtype == torch.int32
