"""The port's optimizers and model options against the JAX package.

Optimizers: five steps of SupervisedGraphSage (with ``use_id`` and
``embedding_dim``: an id embedding beside the features) under ``sgd``,
``momentum``, ``adagrad`` and ``adam`` from the same flax parameters on
the same numpy-seeded batches, against optax: losses within rtol 1e-5,
every parameter after every step within atol 1e-6 (adam: where
|grad| > 1e-6, atol 1e-5, as test_torch_sage.py holds its first step).

Options, each against flax or the JAX function on numpy-seeded inputs:
``shared_negs_decoder``; GraphSage with ``shared_negs`` (the JAX package
sets it on its module) and with ``use_id``/``embedding_dim``; LINE and
Node2Vec with a sparse slot; ``metrics.accuracy``; the
``EULER_TPU_FEATURE_DTYPE`` variable.
Forward tolerances (float32): loss rtol 1e-5, embeddings atol 1e-5 and
rtol 1e-4, gradients atol 1e-6 and rtol 1e-4.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.models import LINE as JLINE  # noqa: E402
from euler_tpu.models import GraphSage as JUnsup  # noqa: E402
from euler_tpu.models import Node2Vec as JNode2Vec  # noqa: E402
from euler_tpu.models import SupervisedGraphSage as JSage  # noqa: E402
from euler_tpu.models import base as jbase  # noqa: E402
from euler_tpu.nn import metrics as jmetrics  # noqa: E402

from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.convert import params_from_flax  # noqa: E402
from euler_tpu_torch.datasets import build_synthetic  # noqa: E402
from euler_tpu_torch.graph import Graph, MemoryGraph  # noqa: E402
from euler_tpu_torch.models import LINE as TLINE  # noqa: E402
from euler_tpu_torch.models import GraphSage as TUnsup  # noqa: E402
from euler_tpu_torch.models import Node2Vec as TNode2Vec  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage as TSage  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from euler_tpu_torch.nn import metrics as tmetrics  # noqa: E402

SYN = dict(num_nodes=120, avg_degree=5, feature_dim=6, label_dim=4,
           max_degree=10, seed=3)
N = SYN["num_nodes"]
FANOUTS = [3, 2]
DIM = 8
EMB = 4
NEGS = 3
BATCH = 8
LR = 0.05
SPARSE_MAX = 30  # the sparse slot's values lie in [0, SPARSE_MAX]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def graph():
    """The synthetic graph with one ragged uint64 slot (0-4 values a
    node below SPARSE_MAX + 1)."""
    d = build_synthetic(**SYN)
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 5, N)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    d["sparse_features"] = [(ptr, rng.integers(0, SPARSE_MAX + 1, ptr[-1]))]
    return MemoryGraph(**d)


def _ids(rng, rows):
    return rng.integers(0, N + 1, rows).astype(np.int32)


def _hops(rng, rows, use_id=False):
    """One node set's fanout-shaped hops, as feature dicts."""
    out = []
    for f in [1] + FANOUTS:
        rows *= f
        ids = _ids(rng, rows)
        out.append({"gids": ids, "ids": ids} if use_id else {"gids": ids})
    return out


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def _port_state(tm, g, params, opt="adam"):
    st = tm.init_state(g, ttrain.get_optimizer(opt, LR), device="cpu")
    sd = params_from_flax(_np(params))
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    return st


def _check_forward(jm, params, jconsts, st, batch):
    """One forward and backward of both sides on ``batch``: loss, metric,
    embedding and every gradient."""
    def jloss(p):
        out = jm._apply(p, batch, jconsts)
        return out.loss, (out.embedding, out.metric)

    (jl, (jemb, jmetric)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    out = st["module"](_torch(batch), st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(out.embedding.detach().numpy(),
                               np.asarray(jemb), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.metric.detach()),
                               np.asarray(jmetric), rtol=1e-6)
    want = params_from_flax(_np(jg))
    for k, p in st["module"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


# ---- optimizers ----


# host-given batches over device tables: the JAX side then builds no
# sampling tables
def _sup_kw(**extra):
    return dict(label_idx=0, label_dim=SYN["label_dim"], metapath=[[0], [0]],
                fanouts=FANOUTS, dim=DIM, feature_idx=1,
                feature_dim=SYN["feature_dim"], max_id=N - 1,
                device_features=True, **extra)


OPTAX = {"sgd": optax.sgd(LR), "momentum": optax.sgd(LR, momentum=0.9),
         "adagrad": optax.adagrad(LR), "adam": optax.adam(LR)}
USE_ID = dict(use_id=True, embedding_dim=EMB)


@pytest.fixture(scope="module")
def sup(graph):
    """The JAX SupervisedGraphSage with an id embedding, its consts and
    flax parameters (one init for every optimizer)."""
    jm = JSage(**_sup_kw(**USE_ID))
    jconsts = jm.build_consts(graph)
    batch = {"hops": _hops(np.random.default_rng(0), BATCH, True)}
    params = jax.jit(jm.module.init)(jax.random.PRNGKey(1), batch,
                                     jconsts)["params"]
    return jm, jconsts, params


@pytest.mark.parametrize("name", sorted(OPTAX))
def test_five_steps_track_optax(graph, sup, name):
    """``train.get_optimizer(name)`` against the JAX package's optax
    optimizer of that name, five steps on the same batches."""
    assert jtrain.get_optimizer(name, LR) is not None
    jm, jconsts, params = sup
    jstate = {"params": params, "opt_state": OPTAX[name].init(params),
              "consts": jconsts}
    jstep = jax.jit(jm.make_train_step(OPTAX[name]))
    tm = TSage(**_sup_kw(**USE_ID))
    st = _port_state(tm, graph, params, name)
    assert "node_encoder.embedding.embeddings" in st["module"].state_dict()
    tstep = tm.make_train_step()
    rng = np.random.default_rng(1)
    for i in range(5):
        batch = {"hops": _hops(rng, BATCH, True)}
        jstate, jl, _ = jstep(jstate, batch)
        tl, _ = tstep(st, _torch(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        want = params_from_flax(_np(jstate["params"]))
        for k, p in st["module"].named_parameters():
            got, exp = p.detach().numpy(), want[k].numpy()
            if name == "adam":  # the sign of adam's step is noise below
                mask = p.grad.abs().numpy() > 1e-6
                got, exp = got[mask], exp[mask]
                atol = 1e-5
            else:
                atol = 1e-6
            np.testing.assert_allclose(got, exp, atol=atol,
                                       err_msg=f"{k} step {i}")


def test_adagrad_is_optax_adagrad_at_its_edges():
    """An accumulator of 0 gives an update of 0 (optax's
    ``where(acc > 0, ...)``), where ``torch.optim.Adagrad`` would divide
    by its eps; the first step of the default is ``g / sqrt(0.1 + g^2 +
    1e-7)``."""
    g = np.array([0.0, 1e-3, -2.0, 5.0], np.float32)
    for init in (0.0, 0.1):
        tx = optax.adagrad(1.0, initial_accumulator_value=init)
        params = np.ones(4, np.float32)
        updates, _ = tx.update(g, tx.init(params))
        p = torch.ones(4, requires_grad=True)
        opt = ttrain.Adagrad([p], lr=1.0, initial_accumulator_value=init)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   params + np.asarray(updates), atol=1e-6)
    assert float(p.detach()[0]) == 1.0


@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad"])
def test_run_loop_trains_and_resumes_with(tmp_path, name):
    """``--optimizer name`` trains, checkpoints its optimizer state and
    resumes from it: a second launch for more epochs restores the
    accumulators or momenta the first saved."""
    from euler_tpu_torch import run_loop
    from euler_tpu_torch.checkpoint import Checkpointer
    from tests.fixture_graph import write_fixture

    data, ck = str(tmp_path / "g"), str(tmp_path / "ck")
    os.makedirs(data)
    write_fixture(data, num_partitions=2)
    argv = ["--data_dir", data, "--model_dir", ck, "--optimizer", name,
            "--max_id", "16", "--feature_idx", "0", "--feature_dim", "2",
            "--label_idx", "2", "--label_dim", "3", "--train_edge_type",
            "0,1", "--fanouts", "3,2", "--dim", "8", "--batch_size", "4",
            "--log_steps", "1"]
    assert run_loop.main(argv + ["--num_epochs", "1"], device="cpu") == 0
    first = Checkpointer(ck).latest_step()
    g = Graph(directory=data)
    m = run_loop.build_model(run_loop.define_flags().parse_args(argv), g)
    st = m.init_state(g, ttrain.get_optimizer(name, LR), device="cpu")
    g.close()
    saved = Checkpointer(ck).restore(st)["optimizer"].state_dict()
    kinds = {k for st in saved["state"].values() for k in st}
    assert kinds == {"sgd": set(), "momentum": {"momentum_buffer"},
                     "adagrad": {"sum"}}[name]
    assert run_loop.main(argv + ["--num_epochs", "2"], device="cpu") == 0
    assert Checkpointer(ck).latest_step() == 2 * first


def test_run_loop_flags_name_every_optimizer():
    from euler_tpu_torch import run_loop

    for name in OPTAX:
        args = run_loop.define_flags().parse_args(["--optimizer", name])
        run_loop.check_flags(args)
        assert ttrain.get_optimizer(args.optimizer, LR) is not None
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.get_optimizer("rmsprop", LR)


# ---- model options ----


@pytest.mark.parametrize("xent", [True, False])
def test_shared_negs_decoder_matches_jax(xent):
    rng = np.random.default_rng(1)
    emb, pos = (rng.standard_normal((16, 1, 8)).astype(np.float32)
                for _ in range(2))
    negs = rng.standard_normal((40, 8)).astype(np.float32)
    jl, jmrr = jbase.shared_negs_decoder(emb, pos, negs, xent)
    tl, tmrr = tbase.shared_negs_decoder(
        *(torch.from_numpy(x) for x in (emb, pos, negs)), xent)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmrr), float(jmrr), rtol=1e-6)


def _unsup_kw(**extra):
    return dict(node_type=0, edge_type=[0], max_id=N - 1,
                metapath=[[0], [0]], fanouts=FANOUTS, dim=DIM,
                num_negs=NEGS, feature_idx=1,
                feature_dim=SYN["feature_dim"], concat=True, xent_loss=True,
                device_features=True, **extra)


@pytest.mark.parametrize("shared,use_id", [(True, True), (False, True)])
def test_graphsage_options_match_flax(graph, shared, use_id):
    """GraphSage with ``shared_negs`` (each root against all B * NEGS
    negatives) and ``use_id`` (an id embedding of ``embedding_dim`` in
    both towers): loss, mrr, embeddings and gradients against flax's
    module with the same fields."""
    extra = dict(use_id=use_id, embedding_dim=EMB)
    jm = JUnsup(**_unsup_kw(**extra))
    jm.module = jm.module.clone(shared_negs=shared)
    tm = TUnsup(**_unsup_kw(shared_negs=shared, **extra))
    rng = np.random.default_rng(2)
    batch = {name: _hops(rng, rows, use_id) for name, rows in (
        ("src_hops", BATCH), ("pos_hops", BATCH),
        ("neg_hops", BATCH * NEGS))}
    jconsts = jm.build_consts(graph)
    params = jax.jit(jm.module.init)(jax.random.PRNGKey(0), batch,
                                     jconsts)["params"]
    st = _port_state(tm, graph, params)
    assert ("embedding" in str(sorted(st["module"].state_dict()))) == use_id
    _check_forward(jm, params, jconsts, st, batch)


def test_supervised_use_id_draws_feed_the_embedding(graph):
    """Device sampling hands the drawn ids to the id embedding too, as
    the JAX module's ``{"gids": i, "ids": i}`` hops."""
    dm = TSage(**_sup_kw(device_sampling=True, **USE_ID))
    st = dm.init_state(graph, ttrain.get_optimizer("adam", LR),
                       device="cpu")
    hops = st["module"]._hops({"roots": torch.arange(4, dtype=torch.int32),
                               "seed": 1}, st["consts"])
    assert [len(h["ids"]) for h in hops] == [4, 12, 24]
    assert all(torch.equal(h["ids"], h["gids"]) for h in hops)
    out = st["module"]({"roots": torch.arange(4, dtype=torch.int32),
                        "seed": 1}, st["consts"])
    assert torch.isfinite(out.loss)


@pytest.mark.parametrize("jcls,tcls", [(JLINE, TLINE),
                                       (JNode2Vec, TNode2Vec)])
def test_walk_models_with_a_sparse_slot_match_flax(graph, jcls, tcls):
    """LINE and Node2Vec with the id embedding, dense features and a
    sparse slot (one SparseEmbedding over the padded device table)."""
    kw = dict(node_type=0, edge_type=[0], max_id=N - 1, dim=DIM,
              num_negs=NEGS, feature_idx=1, feature_dim=SYN["feature_dim"],
              sparse_feature_idx=[0], sparse_feature_max_ids=[SPARSE_MAX],
              sparse_max_len=3, device_features=True, xent_loss=True)
    jm, tm = jcls(**kw), tcls(**kw)
    # distinct ids: LINE's first order scores a node against itself, and
    # an exact tie may round to either side of the positive
    ids = np.random.default_rng(4).permutation(N + 1).astype(np.int32)
    batch, at = {}, 0
    for name, rows in (("src", BATCH), ("pos", BATCH),
                       ("negs", BATCH * NEGS)):
        batch[name] = {"ids": ids[at:at + rows], "gids": ids[at:at + rows]}
        at += rows
    jconsts = jm.build_consts(graph)
    params = jax.jit(jm.module.init)(jax.random.PRNGKey(0), batch,
                                     jconsts)["params"]
    st = _port_state(tm, graph, params)
    for a, b in zip(st["consts"]["sparse"], jconsts["sparse"]):
        for k in ("ids", "mask"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    _check_forward(jm, params, jconsts, st, batch)
    assert sorted(tm.host_node_inputs(graph, [1, 2])) == ["gids", "ids"]
    with pytest.raises(ValueError, match="device_features=True"):
        tcls(**{**kw, "device_features": False, "device_sampling": True})


def test_accuracy_matches_jax():
    rng = np.random.default_rng(5)
    labels = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 64)]
    preds = rng.integers(0, 3, (64, 6)).astype(np.float32)  # with ties
    want = float(jmetrics.accuracy(labels, preds))
    got = tmetrics.accuracy(torch.from_numpy(labels), torch.from_numpy(preds))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-7)


def test_feature_dtype_variable_matches_jax(graph, monkeypatch):
    """``EULER_TPU_FEATURE_DTYPE`` narrows the feature table as the
    kwarg does, the kwarg winning; a bad name raises naming both."""
    kw = _sup_kw()
    want = TSage(**kw, feature_dtype="bfloat16").build_consts(graph, "cpu")
    monkeypatch.setenv("EULER_TPU_FEATURE_DTYPE", "bfloat16")
    got = TSage(**kw).build_consts(graph, "cpu")
    jgot = JSage(**kw).build_consts(graph)
    assert got["features"].dtype == torch.bfloat16
    assert torch.equal(got["features"], want["features"])
    np.testing.assert_array_equal(
        got["features"].float().numpy(),
        np.asarray(jgot["features"]).astype(np.float32))
    assert TSage(**kw, feature_dtype="float32").build_consts(
        graph, "cpu")["features"].dtype == torch.float32
    ids = torch.tensor([0, 5, N], dtype=torch.int32)
    rows = tbase.gather_consts({"gids": ids}, got)["dense"]
    assert torch.equal(rows, tbase.gather_consts({"gids": ids},
                                                 want)["dense"])
    monkeypatch.setenv("EULER_TPU_FEATURE_DTYPE", "bf16")
    with pytest.raises(ValueError, match="EULER_TPU_FEATURE_DTYPE") as terr:
        TSage(**kw).build_consts(graph, "cpu")
    with pytest.raises(ValueError, match="EULER_TPU_FEATURE_DTYPE") as jerr:
        JSage(**kw).build_consts(graph)
    assert str(terr.value).split(" (")[0] == str(jerr.value).split(" (")[0]
