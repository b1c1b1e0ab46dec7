"""The port's LasGNN, SparseSageEncoder, DotAttention, AUC metric and the
sparse slots of the GraphSAGE node encoder against the JAX package: the
groups' fanouts under key replay, loss, metric, embedding and gradients,
five Adam steps, ``train.evaluate`` with auc, the one registered copy of
the shared embeddings, and the fanouts' route through the chained
kernel's wrapper over two slabs of different widths.

Both sides get the same inputs: the heterogeneous graph of
``tests/test_torch_lshne.py`` (two edge types, two ragged sparse slots;
the JAX model builds its tables from the port's in-memory graph),
numpy-seeded labels and groups, the same weights carried across with
``convert.params_from_flax``, and the uniforms JAX draws from each
fanout's key replayed into the port's ``batch["u"]`` ("key replay"): the
fanouts must then agree id for id. Tolerances (float32): outputs atol
1e-5, rtol 1e-4; losses rtol 1e-5; auc histograms exact; gradients rtol
1e-4 and atol 1e-6 (the models': the larger of 1e-6 and 1e-7 of the
parameter's largest gradient, since the shared tables' gradients, summed
over every tower and hop, run to tens); five-step losses rtol 1e-4;
parameters after each Adam step atol 1e-5 on the elements whose gradient
exceeded 1e-6 at every step so far.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.graph import device as jdev  # noqa: E402
from euler_tpu.models import LasGNN as JLasGNN  # noqa: E402
from euler_tpu.models import SupervisedGraphSage as JSage  # noqa: E402
from euler_tpu.models import lasgnn as jlasgnn  # noqa: E402
from euler_tpu.nn import encoders as jencoders  # noqa: E402
from euler_tpu.nn import metrics as jmetrics  # noqa: E402

from euler_tpu_torch import convert  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.graph import sampling_kernels  # noqa: E402
from euler_tpu_torch.models import LasGNN as TLasGNN  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage as TSage  # noqa: E402
from euler_tpu_torch.models import lasgnn as tlasgnn  # noqa: E402
from euler_tpu_torch.nn import encoders as tencoders  # noqa: E402
from euler_tpu_torch.nn import metrics as tmetrics  # noqa: E402
from tests.test_torch_lshne import (_jgrad, _np, _vjp_check,  # noqa: E402
                                    hetero_graph)

N = 150
MAX_LEN = 6
FEATURE_DIMS = [N + 8, 40]  # slot 0 holds ids up to N + 7
FANOUTS = [3, 2]
DIM = 8
BATCH = 10
LR = 0.01
# the JAX package's LasGNN structure (tests/test_device_graph.py): the
# target over [0] then [0, 1], the context over that and [1] then [0, 1]
METAPATHS = [[[[0], [0, 1]]], [[[0], [0, 1]], [[1], [0, 1]]]]
GROUP_SIZES = [1, 2]


@pytest.fixture(scope="module")
def syn():
    return hetero_graph(N, 5)


def _kw():
    return dict(metapaths_of_groups=METAPATHS, fanouts=FANOUTS, dim=DIM,
                feature_ixs=[0, 1], feature_dims=FEATURE_DIMS,
                group_sizes=GROUP_SIZES, max_id=N - 1, sparse_max_len=MAX_LEN,
                device_sampling=True)


def _inputs(rng, b: int = BATCH) -> dict:
    """LasGNN's structured inputs: labels, targets and two context ids a
    row, the default row and an id past the tables among them."""
    groups = [rng.integers(0, N, (b, 1)), rng.integers(0, N, (b, 2))]
    groups[0][0, 0], groups[1][1, 1] = N, N + 30
    return {"label": rng.integers(0, 2, (b, 1)).astype(np.float32),
            "groups": groups}


def _port_state(tm, syn, params):
    st = tm.init_state(syn, ttrain.get_optimizer("adam", LR), device="cpu")
    sd = convert.params_from_flax(_np(params))
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    return st


@pytest.fixture(scope="module")
def pair(syn):
    """(JAX model, its params and consts, port model, port state) from
    the same parameters (the JAX module's init jitted)."""
    jm, tm = JLasGNN(**_kw()), TLasGNN(**_kw())
    consts = jm.build_consts(syn)
    params = jax.jit(jm.module.init)(
        jax.random.PRNGKey(0), jm.sample(syn, _inputs(
            np.random.default_rng(0))), consts)["params"]
    jstate = {"params": params, "consts": consts}
    return jm, jstate, tm, _port_state(tm, syn, params)


def _replayed(seed: int, b: int = BATCH) -> dict:
    """JAX's fanout uniforms: (group g, metapath m) keys
    fold_in(PRNGKey(seed), (g << 8) | m), its hop h fold_in(that, h)."""
    u = {}
    for g, metapaths in enumerate(METAPATHS):
        for m in range(len(metapaths)):
            k = jax.random.fold_in(jax.random.PRNGKey(seed), (g << 8) | m)
            rows, hops = b * GROUP_SIZES[g], []
            for h, f in enumerate(FANOUTS):
                hops.append(np.array(jax.random.uniform(
                    jax.random.fold_in(k, h), (rows, f))))
                rows *= f
            u[(g, m)] = hops
    return u


def _batches(jm, tm, inputs, seed: int):
    jb = jm.sample(None, inputs) | {"seed": np.full(BATCH, seed, np.int32)}
    tb = tm.device_sample_batch(inputs, seed, device="cpu")
    tb["u"] = _replayed(seed)
    return jb, tb


def test_dot_attention_matches_flax():
    x = np.random.default_rng(1).standard_normal((5, 2, 3, 4)).astype(
        np.float32)
    _vjp_check(jlasgnn.DotAttention(), tlasgnn.DotAttention(3, 4), (x,),
               (torch.from_numpy(x),),
               lambda p: {"kernel": torch.from_numpy(np.array(p["kernel"]))})


def test_auc_matches_jax():
    """The [2, 200] histograms equal JAX's, scores 0 and 1 included (1
    clipped into the last bin); auc from summed histograms equals JAX's,
    and a batch of one class gives 0.5."""
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, (300, 1)).astype(np.float32)
    scores = rng.random((300, 1)).astype(np.float32)
    scores[:3, 0] = [0.0, 1.0, 0.999999]
    got = tmetrics.auc_counts(torch.from_numpy(labels),
                              torch.from_numpy(scores))
    want = jmetrics.auc_counts(jnp.asarray(labels), jnp.asarray(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, tmetrics.AUC_BINS) and float(got[:, -1].sum()) >= 1
    total = got + got.flip(0)
    assert tmetrics.auc_from_counts(total) == jmetrics.auc_from_counts(
        np.asarray(want) + np.asarray(want)[::-1])
    assert tmetrics.auc_from_counts(got) == jmetrics.auc_from_counts(want)
    assert tmetrics.auc_from_counts(got * torch.tensor([[0.0], [1.0]])) == 0.5


def test_sparse_sage_encoder_matches_flax():
    """Its own tables (``feature_dims[k] + 2`` rows), two slots of
    different lengths, three hops of a [2, 3] fanout."""
    rng = np.random.default_rng(3)
    hops = []
    for rows in (4, 8, 24):
        hops.append([(rng.integers(0, 12, (rows, 3)).astype(np.int32),
                      (rng.random((rows, 3)) < 0.8).astype(np.float32)),
                     (rng.integers(0, 7, (rows, 2)).astype(np.int32),
                      np.ones((rows, 2), np.float32))])
    t_hops = [[(torch.from_numpy(i), torch.from_numpy(m)) for i, m in hop]
              for hop in hops]

    tmod = tencoders.SparseSageEncoder([2, 3], DIM, feature_dims=(10, 5))
    assert [e.embeddings.shape for e in tmod.embeddings] == [(12, 16),
                                                              (7, 16)]
    _vjp_check(jencoders.SparseSageEncoder((2, 3), DIM, feature_dims=(10, 5)),
               tmod, (hops,), (t_hops,), convert.params_from_flax,
               table_scale=1000.0)


def test_groups_match_jax_under_key_replay(pair, monkeypatch):
    """Every (group, metapath) fanout, hop for hop and id for id, and the
    sparse rows gathered at them; the targets led by the default row and
    the context holding an id past the tables (both clipped)."""
    jm, jstate, tm, st = pair
    inputs = _inputs(np.random.default_rng(4))
    jb, tb = _batches(jm, tm, inputs, 17)
    drawn = {"jax": [], "port": []}
    for name, mod in (("jax", jdev), ("port", tdev)):
        def recording(*a, _f=mod.sample_fanout, _n=name, **k):
            out = _f(*a, **k)
            drawn[_n].append(out)
            return out

        monkeypatch.setattr(mod, "sample_fanout", recording)
    want = jm.module.apply({"params": jstate["params"]}, jb,
                           jstate["consts"],
                           method=jlasgnn._LasGNNModule._device_groups)
    got = st["module"]._device_groups(tb, st["consts"])
    assert len(drawn["port"]) == len(drawn["jax"]) == 3
    for g_hops, w_hops in zip(drawn["port"], drawn["jax"]):
        for g, w in zip(g_hops, w_hops):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g in range(2):
        for m in range(len(METAPATHS[g])):
            for hg, hw in zip(got[g][m]["hops"], want[g][m]["hops"]):
                for (gi, gm), (wi, wm) in zip(hg, hw["sparse"]):
                    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
                    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert int(drawn["port"][0][0][0]) == N  # the clipped default target


def test_lasgnn_matches_flax_under_key_replay(pair):
    """Loss, auc histograms, the target embedding and every parameter's
    gradient equal flax's on device-drawn groups."""
    jm, jstate, tm, st = pair
    jb, tb = _batches(jm, tm, _inputs(np.random.default_rng(5)), 23)
    (loss, (counts, emb)), grads = _jgrad(jm, jstate)(jstate["params"], jb)
    st["module"].zero_grad()
    out = st["module"](tb, st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(loss),
                               rtol=1e-5)
    np.testing.assert_array_equal(out.metric.numpy(), np.asarray(counts))
    np.testing.assert_allclose(out.embedding.detach().numpy(),
                               np.asarray(emb), atol=1e-5, rtol=1e-4)
    want = convert.params_from_flax(_np(grads))
    for k, p in st["module"].named_parameters():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=max(1e-6, 1e-7 * scale), rtol=1e-4,
                                   err_msg=k)


def test_lasgnn_adam_steps_track_optax(syn, pair):
    """Five steps from the same parameters under key replay: losses and
    parameters track optax's Adam after every step (over the elements
    whose gradient stayed above 1e-6, at least half of them), the shared
    tables updated once a step."""
    jm, jstate, tm, _ = pair
    st = _port_state(tm, syn, jstate["params"])
    jgrad = _jgrad(jm, jstate)
    opt = optax.adam(LR)
    jparams, jopt = jstate["params"], opt.init(jstate["params"])
    tstep = tm.make_train_step()
    rng = np.random.default_rng(20)
    jl, tl, tracked = [], [], {}
    for i in range(5):
        jb, tb = _batches(jm, tm, _inputs(rng), 50 + i)
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


def test_shared_embeddings_are_registered_once(pair):
    """One copy of each shared table: the towers hold the parent's
    modules, the parameters and the state dict list each table once."""
    _, _, tm, st = pair
    module = st["module"]
    tables = list(module.sparse_embeddings)
    for group in module.towers:
        for tower in group:
            assert all(a is b for a, b in zip(tower.embeddings, tables))
            assert not any("sparse" in k for k in tower.state_dict())
    names = [k for k, _ in module.named_parameters() if "sparse" in k]
    assert names == ["sparse_embeddings.0.embeddings",
                     "sparse_embeddings.1.embeddings"]
    assert sum(1 for _ in module.parameters()) == len(module.state_dict())


def test_evaluate_matches_jax_eval_steps(syn, pair):
    """``train.evaluate`` over three structured batches: the summed
    histograms' auc and the mean loss equal JAX's eval steps on the
    port's drawn groups, accumulated with the JAX package's
    ``_metric_*``; ``save_embedding`` gives every node a finite row."""
    jm, jstate, tm, st = pair
    rng = np.random.default_rng(8)
    source = [_inputs(rng) for _ in range(3)]
    got = ttrain.evaluate(tm, syn, source, st, device="cpu", seed=70)
    eval_fn = jax.jit(jm.make_eval_step())
    jvars = {"params": jstate["params"], "consts": jstate["consts"]}
    acc, losses = jtrain._metric_zero("auc"), []
    for i, item in enumerate(source):
        tb = tm.device_sample_batch(item, 70 + i, device="cpu")
        groups = st["module"]._device_groups(tb, st["consts"])
        jb = jax.tree_util.tree_map(lambda t: t.numpy(), {
            "groups": [[{"hops": [{"sparse": h} for h in m["hops"]]}
                        for m in g] for g in groups],
            "label": tb["label"]})
        loss, metric = eval_fn(jvars, jb)
        acc = jtrain._metric_accumulate("auc", acc, metric)
        losses.append(float(loss))
    assert got["auc"] == jtrain._metric_value("auc", acc)
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=1e-5)
    emb = ttrain.save_embedding(tm, N - 1, st, batch_size=64, device="cpu")
    assert emb.shape == (N, DIM) and np.isfinite(emb).all()


def test_fanouts_go_through_the_chained_wrapper(syn, pair, monkeypatch):
    """A train step calls the chained wrapper once a (group, metapath):
    three times, twice over two slabs of different widths (et0 or et1,
    then et0_1), the targets' [B] roots and the context's [2B]; the
    single-hop wrapper never. Losses are finite and repeat from the same
    seeds."""
    _, jstate, tm, _ = pair
    calls = []
    wrapped = sampling_kernels.sample_fanout2

    def counting(adj1, adj2, roots, *a, **k):
        calls.append((adj1["nbr"].shape[1], adj2["nbr"].shape[1],
                      tuple(roots.shape)))
        return wrapped(adj1, adj2, roots, *a, **k)

    def refuse(*a, **k):
        raise AssertionError("LasGNN reached the single-hop wrapper")

    monkeypatch.setattr(sampling_kernels, "sample_fanout2", counting)
    monkeypatch.setattr(sampling_kernels, "sample_neighbor", refuse)
    losses = []
    for _ in range(2):
        st = _port_state(tm, syn, jstate["params"])
        step = tm.make_train_step()
        rng = np.random.default_rng(30)
        losses.append([float(step(st, tm.device_sample_batch(
            _inputs(rng), s, device="cpu"))[0]) for s in range(2)])
    assert np.isfinite(losses).all() and losses[0] == losses[1]
    w = {k: v["nbr"].shape[1] for k, v in st["consts"]["adj"].items()}
    assert w["et0"] != w["et0_1"] and w["et1"] != w["et0_1"]
    assert calls == [(w["et0"], w["et0_1"], (BATCH,)),
                     (w["et0"], w["et0_1"], (2 * BATCH,)),
                     (w["et1"], w["et0_1"], (2 * BATCH,))] * 4
    assert sampling_kernels.launches == {"sample_fanout2": 0,
                                         "sample_neighbor": 0}


def test_params_from_flax_fills_every_parameter(pair):
    """The shared tables ``sparse_embeddings_{k}``, the towers
    ``towers_{g}_{m}/sage``, ``attentions_{g}`` ([M, dim]) and the two
    Denses fill every port parameter, strictly."""
    _, jstate, tm, _ = pair
    module = tm.make_module()
    module.load_state_dict(convert.params_from_flax(_np(jstate["params"])))
    assert module.sparse_embeddings[0].embeddings.shape == (N + 10, 16)
    assert [a.kernel.shape for a in module.attentions] == [(1, DIM),
                                                           (2, DIM)]
    assert module.context_ff.linear.weight.shape == (DIM, 2 * DIM)
    np.testing.assert_array_equal(
        module.attentions[1].kernel.detach().numpy(),
        np.asarray(jstate["params"]["attentions_1"]["kernel"]))


def test_lasgnn_entry_points_default_to_the_card(monkeypatch, syn):
    """init_state, device_sample_batch and sample_embed run on the card
    unless asked for the CPU; host sampling builds no device table."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = ttrain.get_optimizer("adam", LR)
    host = TLasGNN(**{**_kw(), "device_sampling": False})
    assert not host.device_sampling and host.build_consts(syn, "cpu") == {}
    with pytest.raises(ValueError, match="max_id"):
        TLasGNN(**{**_kw(), "max_id": -1})
    m = TLasGNN(**_kw())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_state(syn, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device_sample_batch(_inputs(np.random.default_rng(0)), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.sample_embed([1, 2])
    assert sorted(m.sample(syn, _inputs(np.random.default_rng(0)))) == [
        "group0", "group1", "label", "seed"]
    batch = m.device_sample_batch(_inputs(np.random.default_rng(0)), 3,
                                  device="cpu")
    assert sorted(batch) == ["group0", "group1", "label", "seed"]
    assert batch["group1"].dtype == torch.int32
    assert int(batch["group1"].max()) == N  # clipped to the default row


def test_supervised_sage_with_a_sparse_slot_matches_flax(syn):
    """SupervisedGraphSage with dense features and one sparse slot: the
    tables (``"sparse"`` padded with the slot's max id + 1), the node
    encoder's ``SparseEmbedding_0``, and loss, f1 counts and every
    gradient on host-given hops equal flax's."""
    kw = dict(label_idx=0, label_dim=3, metapath=[[0], [0, 1]],
              fanouts=FANOUTS, dim=DIM, feature_idx=1, feature_dim=4,
              max_id=N - 1, sparse_feature_idx=[0],
              sparse_feature_max_ids=[N + 8], sparse_max_len=MAX_LEN,
              device_features=True, device_sampling=True)
    jm, tm = JSage(**kw), TSage(**kw)
    consts = jm.build_consts(syn)
    rng = np.random.default_rng(11)
    ids = [rng.integers(0, N + 1, BATCH * r).astype(np.int32)
           for r in (1, FANOUTS[0], FANOUTS[0] * FANOUTS[1])]
    jb = {"hops": [{"gids": i} for i in ids]}
    params = jax.jit(jm.module.init)(jax.random.PRNGKey(0), jb,
                                     consts)["params"]
    assert "SparseEmbedding_0" in params["node_encoder"]
    st = _port_state(tm, syn, params)
    np.testing.assert_array_equal(st["consts"]["sparse"][0]["ids"].numpy(),
                                  np.asarray(consts["sparse"][0]["ids"]))
    jconsts = jax.tree_util.tree_map(jnp.asarray, consts)
    (loss, metric), grads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o.loss, o.metric))(jm._apply(p, jb, jconsts)),
        has_aux=True))(params)
    out = st["module"]({"hops": [{"gids": torch.from_numpy(i)} for i in ids]},
                       st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(loss),
                               rtol=1e-5)
    np.testing.assert_array_equal(out.metric.numpy(), np.asarray(metric))
    want = convert.params_from_flax(_np(grads))
    for k, p in st["module"].named_parameters():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=max(1e-6, 1e-7 * scale), rtol=1e-4,
                                   err_msg=k)
