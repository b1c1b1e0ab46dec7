"""The port's ScalableSage and ``train.evaluate`` against the JAX package.

Both sides get the same inputs: a graph from one numpy seed (the JAX
model builds its tables from the port's in-memory graph), numpy-seeded
roots with a duplicate, node rows and store reads, the same weights and
stores carried across with ``convert.params_from_flax`` and
``convert.load_stores``, and the uniforms JAX draws from each step's key
replayed into the port's ``batch["u"]`` ("key replay"): the draws must
then agree id for id. Tolerances (float32): forward atol 1e-5, rtol
1e-4; loss rtol 1e-5; gradients atol 1e-6, rtol 1e-4; over five steps,
losses rtol 1e-4, parameters atol 1e-5 on the elements whose gradient
exceeded 1e-6 at every step so far (below that the sign of an Adam step
is noise), stores and grad-stores atol 1e-5, rtol 1e-4.

A root drawn twice in one batch draws its own neighbors at each
occurrence, so its two layer-0 embeddings differ. The JAX store write
``.at[ids].set(rows)`` keeps the last occurrence's row on the CPU; the
port writes that row at every occurrence (``write_rows_last_wins``), so
its write is the same and deterministic on CUDA as well.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.models import ScalableSage as JSage  # noqa: E402
from euler_tpu.nn import encoders as jencoders  # noqa: E402

from euler_tpu_torch import convert  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.datasets import build_synthetic  # noqa: E402
from euler_tpu_torch.graph import MemoryGraph, sampling_kernels  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.models import GraphSage as TGraphSage  # noqa: E402
from euler_tpu_torch.models import ScalableSage as TSage  # noqa: E402
from euler_tpu_torch.models.base import write_rows_last_wins  # noqa: E402
from euler_tpu_torch.nn import encoders as tencoders  # noqa: E402

SYN = dict(num_nodes=200, avg_degree=5, feature_dim=6, label_dim=4,
           max_degree=10, seed=3)
DIM = 16
FANOUT = 4
BATCH = 16
LR = 0.01


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sd(params) -> dict:
    return convert.params_from_flax(_np(params))


@pytest.fixture(scope="module")
def syn():
    return MemoryGraph(**build_synthetic(**SYN))


def _kw(aggregator="mean", concat=True, use_id=False):
    return dict(label_idx=0, label_dim=SYN["label_dim"], edge_type=[0],
                fanout=FANOUT, num_layers=2, dim=DIM,
                max_id=SYN["num_nodes"] - 1, aggregator=aggregator,
                concat=concat, feature_idx=1, feature_dim=SYN["feature_dim"],
                use_id=use_id, store_learning_rate=0.003,
                device_features=True, device_sampling=True,
                train_node_type=0)


def _roots(rng, syn):
    """BATCH roots whose first two are one node of degree >= 3 (a
    duplicate that draws different neighbors at its two occurrences)."""
    roots = rng.integers(0, SYN["num_nodes"], BATCH).astype(np.int32)
    deg = tdev.build_adjacency(syn, [0], syn.max_node_id)["deg"]
    roots[1] = roots[0] = rng.choice(np.flatnonzero(deg >= 3))
    return roots


def _batches(tm, roots, seed):
    """The JAX batch and the port batch of one step: the same roots and
    seed, the port's draw fed JAX's uniforms."""
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                    (len(roots), FANOUT)))
    jb = {"roots": roots, "seed": np.full(len(roots), seed, np.int32)}
    tb = tm.device_sample_batch(roots, seed, device="cpu")
    tb["u"] = u
    return jb, tb


def _pair(syn, **kw):
    """(JAX model, its state, port model, port state) from the same
    parameters and stores."""
    jm, tm = JSage(**_kw(**kw)), TSage(**_kw(**kw))
    jstate = jm.init_state(jax.random.PRNGKey(0), syn, np.arange(BATCH),
                           optax.adam(LR))
    st = tm.init_state(syn, ttrain.get_optimizer("adam", LR), device="cpu")
    sd = _sd(jstate["params"])
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    convert.load_stores(st, _np(jstate["stores"]), _np(jstate["grad_stores"]))
    return jm, jstate, tm, st


# ---- the encoder ----


@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("aggregator", ["mean", "gcn", "meanpool", "maxpool"])
def test_scalable_sage_encoder_matches_flax(aggregator, concat):
    """Both layers' embeddings, and the gradients of a random projection
    of them by the parameters, the node rows, the fanout rows and the
    store reads (the gcn aggregator has no concat form: both cases of it
    must give the same tree)."""
    rng = np.random.default_rng(7)
    b, d0 = 8, 6
    node = rng.standard_normal((b, d0)).astype(np.float32)
    neigh = rng.standard_normal((b * FANOUT, d0)).astype(np.float32)
    reads = [rng.standard_normal((b * FANOUT, DIM)).astype(np.float32)]
    cts = [rng.standard_normal((b, DIM)).astype(np.float32)
           for _ in range(2)]
    jenc = jencoders.ScalableSageEncoder(FANOUT, 2, DIM, aggregator, concat)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(1), node, neigh,
                                reads)["params"]
    tenc = tencoders.ScalableSageEncoder(d0, FANOUT, 2, DIM, aggregator,
                                         concat)
    sd = {k.split(".", 1)[1]: v for k, v in convert.params_from_flax(
        {"encoder": _np(params)}).items()}
    assert sorted(sd) == sorted(tenc.state_dict())
    tenc.load_state_dict(sd)

    def project(final, embs, cts):
        return (final * cts[1]).sum() + (embs[0] * cts[0]).sum()

    @jax.jit
    def jax_side(p, node, neigh, reads):
        def f(p, node, neigh, reads):
            final, embs = jenc.apply({"params": p}, node, neigh, reads)
            return project(final, embs, cts), (final, embs)
        return jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                  has_aux=True)(p, node, neigh, reads)

    (want, (jfinal, jembs)), grads = jax_side(params, node, neigh, reads)
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (node, neigh, reads[0])]
    final, embs = tenc(leaves[0], leaves[1], [leaves[2]])
    assert len(embs) == 2 and embs[1] is final
    assert embs[0].shape == (b, DIM)  # the store width, concat or not
    for got, w in zip(embs, jembs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4)
    out = project(final, embs, [torch.from_numpy(c) for c in cts])
    np.testing.assert_allclose(float(out.detach()), float(want), rtol=1e-5)
    out.backward()
    for leaf, g in zip(leaves, (grads[1], grads[2], grads[3][0])):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=1e-6, rtol=1e-4)
    want_g = {k.split(".", 1)[1]: v for k, v in convert.params_from_flax(
        {"encoder": _np(grads[0])}).items()}
    for k, p in tenc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


# ---- the model ----


@pytest.mark.parametrize("use_id", [False, True])
def test_expand_batch_matches_jax_under_key_replay(syn, use_id):
    """The device expansion: node and neighbor ids (and their feature
    and embedding indices) equal JAX's, value for value and dtype for
    dtype, on roots with a duplicate, the default row and an id past the
    tables (both clipped by ``device_sample_batch``)."""
    jm, tm = JSage(**_kw(use_id=use_id)), TSage(**_kw(use_id=use_id))
    jconsts = jm.build_consts(syn)
    tconsts = tm.build_consts(syn, "cpu")
    for k in ("nbr", "cum", "sampleable"):
        np.testing.assert_array_equal(tconsts["adj"]["et0"][k].numpy(),
                                      np.asarray(jconsts["adj"]["et0"][k]))
    roots = _roots(np.random.default_rng(4), syn)
    roots[2:4] = [SYN["num_nodes"], SYN["num_nodes"] + 50]
    jb, tb = _batches(tm, roots, 11)
    jb = jm.device_sample_batch(roots) | {"seed": jb["seed"]}
    want = _np(jm._expand_batch(jb, jconsts))
    got = tm._expand_batch(tb, tconsts)
    assert sorted(got) == sorted(want)
    for k in ("node_ids", "neigh_ids"):
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("node_feats", "neigh_feats"):
        assert sorted(got[k]) == sorted(want[k])
        for f in want[k]:
            np.testing.assert_array_equal(got[k][f].numpy(), want[k][f])
    neigh = got["neigh_ids"].reshape(BATCH, FANOUT)
    assert not torch.equal(neigh[0], neigh[1])  # the duplicate's draws
    assert bool((neigh[2:4] == SYN["num_nodes"]).all())  # the default row


def test_store_write_keeps_the_last_occurrence_like_jax():
    """``write_rows_last_wins`` equals JAX's ``.at[ids].set(rows)`` on
    the CPU, ids repeated up to five times: the last occurrence's row
    wins."""
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 40, 256)
    assert np.bincount(ids).max() >= 5
    rows = rng.standard_normal((256, 3)).astype(np.float32)
    table = rng.standard_normal((41, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, i, r: t.at[i].set(r))(table, ids,
                                                               rows))
    last = {int(i): k for k, i in enumerate(ids)}
    np.testing.assert_array_equal(want[list(last)], rows[list(last.values())])
    got = torch.from_numpy(table.copy())
    write_rows_last_wins(got, torch.from_numpy(ids), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_flax_fills_every_parameter(syn):
    """With id embeddings on, every port parameter (node encoder, both
    aggregators, classifier) comes from the flax tree, strictly."""
    jm, jstate, tm, st = _pair(syn, use_id=True)
    sd = _sd(jstate["params"])
    module = tm.make_module()
    assert sorted(sd) == sorted(module.state_dict())
    module.load_state_dict(sd)  # strict
    assert "node_encoder.embedding.embeddings" in sd
    np.testing.assert_array_equal(
        module.predict.linear.weight.detach().numpy(),
        np.asarray(jstate["params"]["predict"]["kernel"]).T)
    assert [s.shape for s in st["stores"]] == [(SYN["num_nodes"] + 1, DIM)]


def test_eval_and_embed_steps_match_jax(syn):
    """The eval step's loss and f1 counts and the embed step's rows equal
    JAX's over the same stores, under key replay."""
    jm, jstate, tm, st = _pair(syn)
    roots = _roots(np.random.default_rng(5), syn)
    jb, tb = _batches(tm, roots, 3)
    jloss, jmetric = jm.make_eval_step()(jstate, jb)
    tloss, tmetric = tm.make_eval_step()(st, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(tmetric.numpy(), np.asarray(jmetric))
    np.testing.assert_allclose(tm.make_embed_step()(st, tb).numpy(),
                               np.asarray(jm.make_embed_step()(jstate, jb)),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("aggregator,concat", [("mean", True),
                                               ("maxpool", False)])
def test_scalable_sage_steps_match_jax(syn, aggregator, concat):
    """Five steps from the same parameters and stores, each on roots
    with a duplicate and under key replay: losses, parameters, stores
    and grad-stores track the JAX ScalableStoreModel step after every
    step; the duplicate's store row is its last occurrence's."""
    jm, jstate, tm, st = _pair(syn, aggregator=aggregator, concat=concat)
    jstep = jax.jit(jm.make_train_step(optax.adam(LR)))
    tstep = tm.make_train_step()
    rng = np.random.default_rng(30)
    jl, tl, tracked = [], [], {}
    for i in range(5):
        roots = _roots(rng, syn)
        jb, tb = _batches(tm, roots, 100 + i)
        jstate, loss, _ = jstep(jstate, jb)
        jl.append(float(loss))
        tl.append(float(tstep(st, tb)[0]))
        want = _sd(jstate["params"])
        for k, p in st["module"].named_parameters():
            tracked[k] = tracked.get(k, True) & (p.grad.abs() > 1e-6)
            np.testing.assert_allclose(p.detach()[tracked[k]].numpy(),
                                       want[k][tracked[k]].numpy(),
                                       atol=1e-5, err_msg=k)
        for name in ("stores", "grad_stores"):
            for t, w in zip(st[name], jstate[name]):
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           atol=1e-5, rtol=1e-4,
                                           err_msg=f"{name}, step {i}")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    n_tracked = sum(int(m.sum()) for m in tracked.values())
    assert n_tracked > 0.8 * sum(m.numel() for m in tracked.values())
    assert float(np.abs(np.asarray(jstate["grad_stores"][0])).max()) > 0


def test_duplicate_root_store_row_is_the_last_occurrence(syn):
    """After one step on roots whose first two are one node drawing
    different neighbors, that node's store row is the layer-0 embedding
    of its second occurrence (computed at the step's old parameters),
    which differs from the first's, and equals JAX's row."""
    jm, jstate, tm, st = _pair(syn)
    roots = _roots(np.random.default_rng(6), syn)
    jb, tb = _batches(tm, roots, 7)
    batch = tm._expand_batch(tb, st["consts"])
    reads = [s.index_select(0, batch["neigh_ids"].long())
             for s in st["stores"]]
    with torch.no_grad():
        _, _, embs, _ = st["module"].forward_train(batch, reads,
                                                   st["consts"])
    assert not torch.allclose(embs[0][0], embs[0][1])
    tm.make_train_step()(st, tb)
    jstate, _, _ = jax.jit(jm.make_train_step(optax.adam(LR)))(jstate, jb)
    row = st["stores"][0][int(roots[0])]
    np.testing.assert_allclose(row.numpy(), embs[0][1].numpy(), atol=1e-6)
    np.testing.assert_allclose(row.numpy(),
                               np.asarray(jstate["stores"][0])[roots[0]],
                               atol=1e-5, rtol=1e-4)


def test_evaluate_matches_jax_eval_steps(syn):
    """``train.evaluate`` over three batches equals JAX's eval steps over
    the same expanded batches and state, accumulated with the JAX
    package's ``_metric_*`` helpers: f1 and the mean loss."""
    jm, jstate, tm, st = _pair(syn)
    rng = np.random.default_rng(9)
    source = [rng.integers(0, SYN["num_nodes"], BATCH) for _ in range(3)]
    logs = []
    got = ttrain.evaluate(tm, syn, iter(source), st, device="cpu", seed=40,
                          log_fn=logs.append)
    eval_fn = jm.make_eval_step()
    acc, losses = jtrain._metric_zero("f1"), []
    for i, ids in enumerate(source):
        batch = tm._expand_batch(
            tm.device_sample_batch(ids, 40 + i, device="cpu"), st["consts"])
        jb = jax.tree_util.tree_map(lambda t: t.numpy(), batch)
        loss, metric = eval_fn(jstate, jb)
        acc = jtrain._metric_accumulate("f1", acc, metric)
        losses.append(float(loss))
    assert sorted(got) == ["f1", "loss"]
    np.testing.assert_allclose(got["f1"], jtrain._metric_value("f1", acc),
                               rtol=1e-6)
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=1e-5)
    assert 0 < got["f1"] < 1 and logs == [f"eval: {got}"]


def test_evaluate_keeps_a_running_mean_of_mrr(syn):
    """For an mrr model (the unsupervised GraphSage) ``train.evaluate``
    is the JAX package's running mean of the eval steps' batch values,
    here over the port's own eval steps on the same batches."""
    tm = TGraphSage(node_type=0, edge_type=[0], max_id=syn.max_node_id,
                    metapath=[[0], [0]], fanouts=[2, 2], dim=8,
                    feature_idx=1, feature_dim=SYN["feature_dim"],
                    device_features=True, device_sampling=True)
    st = tm.init_state(syn, ttrain.get_optimizer("adam", LR), device="cpu")
    rng = np.random.default_rng(10)
    source = [rng.integers(0, SYN["num_nodes"], BATCH) for _ in range(3)]
    got = ttrain.evaluate(tm, syn, source, st, device="cpu", seed=3)
    acc, losses = jtrain._metric_zero("mrr"), []
    for i, ids in enumerate(source):
        loss, mrr = tm.make_eval_step()(
            st, tm.device_sample_batch(ids, 3 + i, device="cpu"))
        acc = jtrain._metric_accumulate("mrr", acc, mrr.numpy())
        losses.append(float(loss))
    assert sorted(got) == ["loss", "mrr"]
    np.testing.assert_allclose(got["mrr"], jtrain._metric_value("mrr", acc),
                               rtol=1e-6)
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=1e-6)


def test_scan_train_runs_scalable_sage_on_cpu(syn, monkeypatch):
    """make_scan_train drives ScalableSage (its consts carry the roots
    sampler): finite losses, the same from the same seeds, one draw a
    step through the single-hop wrapper (its plain version here, which
    counts no launch)."""
    calls = []
    wrapped = sampling_kernels.sample_neighbor

    def counting(*a, **k):
        calls.append((tuple(a[1].shape), a[3]))
        return wrapped(*a, **k)

    runs = []
    for _ in range(2):
        tm = TSage(**_kw())
        st = tm.init_state(syn, ttrain.get_optimizer("adam", LR),
                           device="cpu", seed=1)
        scan = ttrain.make_scan_train(tm, 3, BATCH)
        monkeypatch.setattr(sampling_kernels, "sample_neighbor", counting)
        runs.append(torch.cat([scan(st, c)[1] for c in range(2)]))
        monkeypatch.undo()
    assert torch.isfinite(runs[0]).all() and runs[0].shape == (6,)
    assert torch.equal(runs[0], runs[1])
    assert calls == [((BATCH,), FANOUT)] * 12
    assert sampling_kernels.launches == {"sample_fanout2": 0,
                                         "sample_neighbor": 0}


def test_scalable_sage_entry_points_default_to_the_card(monkeypatch, syn):
    """init_state and device_sample_batch run on the card unless asked
    for the CPU; unported aggregators are refused; host sampling builds no
    sampling table."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = ttrain.get_optimizer("adam", LR)
    host = TSage(**{**_kw(), "device_sampling": False})
    assert host.device_features and not host.device_sampling
    assert sorted(host.build_consts(syn, "cpu")) == ["features", "labels"]
    m = TSage(**_kw())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_state(syn, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device_sample_batch([1, 2], seed=0)
    assert sorted(m.sample(syn, [1, 2])) == ["roots", "seed"]
    with pytest.raises(ValueError, match="not ported"):
        TSage(**{**_kw(), "aggregator": "attention"}).make_module()
    state = m.init_state(syn, opt, device="cpu")
    assert next(state["module"].parameters()).device.type == "cpu"
    assert state["stores"][0].device.type == "cpu"
