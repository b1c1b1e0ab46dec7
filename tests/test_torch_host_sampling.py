"""Host sampling of every model of the port against the JAX package.

Both packages load the same small ``.dat`` graphs through their own copy
of the engine: a homogeneous one (``datasets.build_ppi`` at small
overrides) and a heterogeneous one (two edge types, four node types, two
uint64 slots). After the same ``eg_seed``, ``model.sample(graph, inputs)``
gives equal batches, leaf by leaf: ids bit for bit and of the same
dtype, features exactly. Every engine call stays under its OpenMP bound
(``graph/_native/eg_engine.cc``: a neighbor draw fans out past 2,048
picks, a walk past 512 steps, typed negatives past 64 sources), where
each thread would draw from an RNG ``eg_seed`` does not reach.

From the same parameters (flax's carried across with
``convert.params_from_flax``, the stores with ``convert.load_stores``),
step 1's loss and gradients are held to flax's and five Adam steps on
fresh batches to optax's. Tolerances (float32): step-1 loss rtol 1e-5;
gradients rtol 1e-4 and atol the larger of 1e-6 and 1e-7 of the
parameter's largest gradient (the sparse models' tables sum gradients
over every pair, tower and hop, to tens and more), 1e-6 of it for
LsHNE's (its cosines of embeddings that start near zero give table
gradients in the thousands that cancel to units, and the two packages
sum them in different orders: one element of 1,952 here differs by 2e-7
of the largest); the parameters after step 1 atol 1e-5,
where |grad| > 1e-6 (below that the sign of Adam's first step is noise);
the five steps' losses rtol 1e-4; stores and grad-stores after them
atol 1e-5, rtol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import euler_tpu  # noqa: E402
from euler_tpu import models as jmodels  # noqa: E402
from euler_tpu.graph import native as jnative  # noqa: E402
from euler_tpu.run_loop import SavedEmbedding as JSaved  # noqa: E402

from euler_tpu_torch import convert, datasets  # noqa: E402
from euler_tpu_torch import models as tmodels  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.graph import Graph  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from euler_tpu_torch.run_loop import SavedEmbedding as TSaved  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


PPI_SMALL = dict(num_nodes=200, avg_degree=5, feature_dim=6, label_dim=4,
                 max_degree=10, seed=3, num_partitions=2)
MAX_ID = PPI_SMALL["num_nodes"] - 1
HET_N = 120
BATCH = 8
LR = 0.01
STEPS = 5

SUP = dict(label_idx=0, label_dim=PPI_SMALL["label_dim"], feature_idx=1,
           feature_dim=PPI_SMALL["feature_dim"], max_id=MAX_ID)


def _gcn(**kw):
    # caps no hop of 8 roots outgrows on this graph (degrees <= 10)
    return dict(SUP, metapath=[[0], [0]], dim=16,
                max_nodes_per_hop=[BATCH * 10, 200],
                max_edges_per_hop=[BATCH * 10, BATCH * 100],
                aggregator="mean", **kw)


def _gat(**kw):
    return dict(SUP, head_num=2, hidden_dim=8, nb_num=3, **kw)


def _walk(**kw):
    return dict(node_type=0, edge_type=[0], max_id=MAX_ID, dim=16,
                num_negs=3, **kw)


LASGNN_METAPATHS = [[[[0], [0, 1]]], [[[0], [0, 1]], [[1], [0, 1]]]]

# name -> (JAX class, port class, kwargs, graph, inputs)
CASES = {
    "gcn": (jmodels.SupervisedGCN, tmodels.SupervisedGCN, _gcn(), "ppi",
            "roots"),
    "gcn_device_features": (jmodels.SupervisedGCN, tmodels.SupervisedGCN,
                            _gcn(device_features=True), "ppi", "roots"),
    "scalable_gcn": (jmodels.ScalableGCN, tmodels.ScalableGCN, dict(
        SUP, edge_type=[0], num_layers=2, dim=16, max_neighbors=10,
        aggregator="mean", store_learning_rate=0.003), "ppi", "roots"),
    "scalable_sage": (jmodels.ScalableSage, tmodels.ScalableSage, dict(
        SUP, edge_type=[0], fanout=3, num_layers=2, dim=16,
        store_learning_rate=0.003), "ppi", "roots"),
    "gat": (jmodels.GAT, tmodels.GAT, _gat(), "ppi", "roots"),
    "gat_device_features": (jmodels.GAT, tmodels.GAT,
                            _gat(device_features=True), "ppi", "roots"),
    "line": (jmodels.LINE, tmodels.LINE, _walk(order=2), "ppi", "roots"),
    "node2vec": (jmodels.Node2Vec, tmodels.Node2Vec, _walk(walk_len=3),
                 "ppi", "roots"),
    "node2vec_biased": (jmodels.Node2Vec, tmodels.Node2Vec,
                        _walk(walk_len=3, walk_p=4.0, walk_q=0.25), "ppi",
                        "roots"),
    # 4 roots: 48 and 16 sources a view, under the typed negatives' bound
    "lshne": (jmodels.LsHNE, tmodels.LsHNE, dict(
        node_type=-1, path_patterns=[[[[0], [0], [0]], [[0], [0], [0]]],
                                     [[[0], [0, 1]]]],
        max_id=HET_N - 1, dim=16, sparse_feature_dims=[HET_N + 2, 40],
        feature_ids=[0, 1], sparse_max_len=4, num_negs=2,
        src_type_num=4), "het", "lshne_roots"),
    "lasgnn": (jmodels.LasGNN, tmodels.LasGNN, dict(
        metapaths_of_groups=LASGNN_METAPATHS, fanouts=[3, 2], dim=16,
        feature_ixs=[0, 1], feature_dims=[HET_N, 40], group_sizes=[1, 2],
        max_id=HET_N - 1, sparse_max_len=4), "het", "groups"),
    "saved_embedding": (JSaved, TSaved, None, "ppi", "roots"),
}


def _het_arrays(n: int, seed: int) -> dict:
    """``build_synthetic``'s graph with each edge typed 0 or 1 by a seeded
    coin, random edge weights, node types 0-3 and two ragged uint64 slots:
    slot 0 the node's id and its next ids (0 to 5 values), slot 1 0 to 4
    values below 40."""
    d = datasets.build_synthetic(n, 5, 4, 3, seed=seed)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), np.diff(d["indptr"]))
    key = rows * 2 + rng.integers(0, 2, len(rows))
    order = np.argsort(key, kind="stable")
    indptr = np.zeros(2 * n + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=2 * n), out=indptr[1:])
    slots = []
    for hi, width in ((6, None), (5, 40)):
        counts = rng.integers(0, hi, n)
        ptr = np.concatenate([[0], np.cumsum(counts)])
        if width is None:
            vals = (np.repeat(np.arange(n), counts) + np.arange(ptr[-1])
                    - np.repeat(ptr[:-1], counts)) % n
        else:
            vals = rng.integers(0, width, ptr[-1])
        slots.append((ptr, vals))
    return dict(
        d, indptr=indptr, indices=d["indices"][order],
        weights=rng.uniform(0.1, 1.0, len(rows)).astype(np.float32),
        edge_type_num=2, node_types=rng.integers(0, 4, n).astype(np.int32),
        sparse_features=slots)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """{"ppi": (jax graph, port graph), "het": ...} over the same files."""
    ppi = str(tmp_path_factory.mktemp("ppi"))
    datasets.build_ppi(ppi, **PPI_SMALL)
    het = str(tmp_path_factory.mktemp("het"))
    datasets.write_dat(_het_arrays(HET_N, 5), het, num_partitions=2)
    out = {k: (euler_tpu.Graph(directory=d), Graph(directory=d))
           for k, d in (("ppi", ppi), ("het", het))}
    yield out
    for jg, tg in out.values():
        jg.close()
        tg.close()


def _inputs(kind: str, rng):
    if kind == "roots":
        return rng.integers(0, MAX_ID + 1, BATCH)
    if kind == "lshne_roots":
        return rng.integers(0, HET_N, 4)
    return {"label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32),
            "groups": [rng.integers(0, HET_N, (BATCH, 1)),
                       rng.integers(-1, HET_N + 3, (BATCH, 2))]}


def _models(name):
    jcls, tcls, kw, _, _ = CASES[name]
    if kw is None:  # SavedEmbedding over a seeded table of max_id + 1 rows
        emb = np.random.default_rng(7).standard_normal(
            (MAX_ID + 1, 8)).astype(np.float32)
        args = (emb, 0, PPI_SMALL["label_dim"])
        return jcls(*args), tcls(*args)
    return jcls(**kw), tcls(**kw)


def _check_equal(tb, jb, path="batch"):
    """Leaf by leaf: the same structure, dtypes and values."""
    if isinstance(jb, dict):
        assert isinstance(tb, dict) and list(tb) == list(jb), path
        for k in jb:
            _check_equal(tb[k], jb[k], f"{path}[{k!r}]")
    elif isinstance(jb, (list, tuple)):
        assert type(tb) is type(jb) and len(tb) == len(jb), path
        for i, (a, b) in enumerate(zip(tb, jb)):
            _check_equal(a, b, f"{path}[{i}]")
    else:
        assert np.asarray(tb).dtype == np.asarray(jb).dtype, path
        np.testing.assert_array_equal(tb, jb, err_msg=path)


def _batches(jm, tm, jg, tg, inputs, seed):
    """The same host batch from both packages' engines after eg_seed."""
    jnative.lib().eg_seed(seed)
    jb = jm.sample(jg, inputs)
    tnative.lib().eg_seed(seed)
    tb = tm.sample(tg, inputs)
    _check_equal(tb, jb)
    return jb, tbase.to_device(tb, "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sd(params, name):
    if name == "saved_embedding":  # the classifier is flax's Dense_0
        params = {"predict": params["Dense_0"]}
    return convert.params_from_flax(_np(params))


class _JitInit:
    """A flax module whose ``init`` is jitted (eager, the sparse models'
    init takes seconds); everything else is the module's."""

    def __init__(self, module):
        self._module = module
        self.init = jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jax_state(jm, jg, inputs):
    """The JAX model's ``init_state`` with its module's init jitted."""
    module = jm.module
    jm.module = _JitInit(module)
    try:
        return jm.init_state(jax.random.PRNGKey(0), jg, inputs,
                             optax.adam(LR))
    finally:
        jm.module = module


def _jax_grad_fn(jm, jstate):
    """Jitted ``(params, batch) -> (loss, grads)`` of step 1: the model's
    forward, or for a store model its ``forward_train`` over the stores'
    rows."""
    consts = jstate.get("consts")
    if "stores" not in jstate:
        def loss(p, batch):
            return jm._apply(p, batch, consts).loss
    else:
        def loss(p, batch):
            reads = [s[batch["neigh_ids"]] for s in jstate["stores"]]
            return jm.module.apply({"params": p}, batch, reads, consts,
                                   method=jm.module.forward_train)[0]
    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_batches_and_steps_match_jax(graphs, name):
    """Equal host batches from both engines; step 1's loss and gradients
    against flax; five Adam steps against optax (stores included)."""
    _, _, _, gname, kind = CASES[name]
    jg, tg = graphs[gname]
    jm, tm = _models(name)
    assert not tm.device_sampling
    rng = np.random.default_rng(11)
    jstate = _jax_state(jm, jg, _inputs(kind, rng))
    st = tm.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu")
    # host features: no table on the card; device features: the feature
    # and label tables, no sampling tables
    assert sorted(st["consts"]) == sorted(jstate.get("consts") or {})
    sd = _sd(jstate["params"], name)
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    if "stores" in jstate:
        convert.load_stores(st, _np(jstate["stores"]),
                            _np(jstate["grad_stores"]))

    jstep = jax.jit(jm.make_train_step(optax.adam(LR)))
    tstep = tm.make_train_step()
    jl, tl = [], []
    for i in range(STEPS):
        jb, tb = _batches(jm, tm, jg, tg, _inputs(kind, rng), 100 + i)
        if i == 0:
            want_l, want_g = _jax_grad_fn(jm, jstate)(jstate["params"], jb)
        jstate, loss, _ = jstep(jstate, jb)
        jl.append(float(loss))
        tl.append(float(tstep(st, tb)[0]))
        if i == 0:
            np.testing.assert_allclose(tl[0], float(want_l), rtol=1e-5)
            np.testing.assert_allclose(jl[0], float(want_l), rtol=1e-6)
            want_g, want_p = _sd(want_g, name), _sd(jstate["params"], name)
            for k, p in st["module"].named_parameters():
                scale = float(want_g[k].abs().max()) * (
                    1e-6 if name == "lshne" else 1e-7)
                np.testing.assert_allclose(
                    p.grad.numpy(), want_g[k].numpy(),
                    atol=max(1e-6, scale), rtol=1e-4, err_msg=k)
                mask = p.grad.abs() > 1e-6
                np.testing.assert_allclose(p.detach()[mask].numpy(),
                                           want_p[k][mask].numpy(),
                                           atol=1e-5, err_msg=k)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for key in ("stores", "grad_stores"):
        for t, w in zip(st.get(key, ()), jstate.get(key, ())):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", ["gcn", "scalable_sage", "gat", "node2vec",
                                  "lshne", "lasgnn"])
def test_host_embed_batches_match_jax(graphs, name):
    """The export's batch (``sample_host_embed``, the JAX package's
    ``sample_embed``) equals JAX's after the same eg_seed, and
    ``train.save_embedding`` on the host gives finite rows of every id."""
    _, _, _, gname, _ = CASES[name]
    jg, tg = graphs[gname]
    jm, tm = _models(name)
    ids = np.arange(8) if gname == "het" else np.arange(0, 40, 5)
    jnative.lib().eg_seed(3)
    jb = jm.sample_embed(jg, ids)
    tnative.lib().eg_seed(3)
    _check_equal(tm.sample_host_embed(tg, ids), jb)
    st = tm.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu")
    max_id = tm.max_id
    emb = ttrain.save_embedding(tm, max_id, st, batch_size=len(ids),
                                device="cpu", graph=tg)
    assert emb.shape[0] == max_id + 1 and np.isfinite(emb).all()


def test_gcn_host_caps_raise_like_jax(graphs):
    """At run_loop's cap rule (batch * cap**h, cap 2 here as 10 at ppi's
    defaults) hop 1 outgrows its cap: both host expansions raise the same
    error, where the device expansion drops ids."""
    jg, tg = graphs["ppi"]
    kw = dict(_gcn(), max_nodes_per_hop=[BATCH * 2, BATCH * 4],
              max_edges_per_hop=[BATCH * 2, BATCH * 4])
    jm, tm = jmodels.SupervisedGCN(**kw), tmodels.SupervisedGCN(**kw)
    roots = np.arange(BATCH)
    with pytest.raises(ValueError, match="hop 0") as want:
        jm.sample(jg, roots)
    with pytest.raises(ValueError, match="hop 0") as got:
        tm.sample(tg, roots)
    assert str(got.value) == str(want.value)
