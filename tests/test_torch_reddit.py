"""The port's Reddit recipes against the JAX package: the power-law
builder, the exact alias sampler, the bfloat16 feature table, and one
supervised step on each table form.

Graphs come from one numpy seed through each package's builder; the JAX
package's graphs are read back through ``euler_tpu.Graph``. Draws are
compared under key replay: the uniforms JAX draws from its keys are passed
to the port's ``u=`` arguments (for an alias table, the pair of
``split(key)``). Tables and picks must agree bit for bit. Tolerances of
the step (float32): loss rtol 1e-5; gradients atol 1e-6, rtol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import euler_tpu  # noqa: E402
from euler_tpu import datasets as jdatasets  # noqa: E402
from euler_tpu.graph import device as jdev  # noqa: E402
from euler_tpu.models import SupervisedGraphSage as JSage  # noqa: E402
from euler_tpu.models import base as jbase  # noqa: E402

from euler_tpu_torch import datasets as tdatasets  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.convert import params_from_flax  # noqa: E402
from euler_tpu_torch.graph import MemoryGraph, sampling_kernels  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage as TSage  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402

# hub_degree is max(2048, n // 64) = 2048 here and d_cap n // 4 = 2,250,
# so the largest rows take the Gumbel race
PL = dict(num_nodes=9000, num_edges=270_000, feature_dim=12, label_dim=5,
          alpha=1.8, seed=23)
# Reddit's synthetic recipe, narrow: one-hot labels, Poisson degrees
SYN = dict(num_nodes=400, avg_degree=10, feature_dim=12, label_dim=5,
           multilabel=False, max_degree=20, seed=4)
FANOUTS = [4, 4]
BATCH = 16
LR = 0.03


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """{"pl": (engine graph, port graph), "syn": (...)} of the two specs:
    each built by both packages from one seed."""
    out = {}
    d = str(tmp_path_factory.mktemp("pl"))
    jdatasets.build_powerlaw(d, num_partitions=2, **PL)
    out["pl"] = (euler_tpu.Graph(directory=d),
                 MemoryGraph(**tdatasets.build_powerlaw(**PL)))
    d = str(tmp_path_factory.mktemp("syn"))
    jdatasets.build_synthetic(d, num_partitions=1, **SYN)
    out["syn"] = (euler_tpu.Graph(directory=d),
                  MemoryGraph(**tdatasets.build_synthetic(**SYN)))
    yield out
    for eg, _ in out.values():
        eg.close()


def _mixed_graph():
    """A port graph of 120 rows covering every case of the alias build:
    random weights, equal non-power-of-two weights (0.3), single entries,
    zero totals, rows with some zero weights, and empty rows, the last
    three rows empty so their offsets sit at the CSR's end."""
    rng = np.random.default_rng(8)
    n = 120
    nbrs, ws = [], []
    for i in range(n):
        d = 0 if (i % 6 == 4 or i >= n - 3) else int(rng.integers(1, 30))
        d = 1 if i % 6 == 2 else d
        w = [rng.uniform(0.0, 2.0, d), np.full(d, 0.3),
             rng.uniform(0.1, 1.0, d), np.zeros(d), np.zeros(d),
             rng.exponential(1.0, d) * (rng.random(d) < 0.7)][i % 6]
        nbrs.append(np.sort(rng.choice(n, d, replace=False)))
        ws.append(w.astype(np.float32))
    indptr = np.concatenate([[0], np.cumsum([len(x) for x in nbrs])])
    return MemoryGraph(indptr, np.concatenate(nbrs), np.concatenate(ws),
                 node_weights=np.ones(n), node_types=np.zeros(n))


def _replay_pair(key, shape):
    """The (u1, u2) uniforms of ``_alias_sample_neighbor`` under ``key``."""
    k1, k2 = jax.random.split(key)
    return tuple(np.array(jax.random.uniform(k, shape)) for k in (k1, k2))


def test_build_powerlaw_matches_jax(graphs):
    eg, tg = graphs["pl"]
    ids = np.arange(PL["num_nodes"])
    want = eg.get_full_neighbor(ids, [0])
    got = tg.get_full_neighbor(ids, [0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert int(got[3].max()) >= max(2048, PL["num_nodes"] // 64)
    dims = [PL["label_dim"], PL["feature_dim"]]
    np.testing.assert_array_equal(tg.get_dense_feature(ids, [0, 1], dims),
                                  eg.get_dense_feature(ids, [0, 1], dims))
    with pytest.raises(ValueError, match="alpha > 1"):
        tdatasets.powerlaw_degrees(10, 40, 1.0, np.random.default_rng(0))


@pytest.mark.parametrize("which", ["mixed", "powerlaw"])
def test_alias_tables_match_native_build(graphs, which):
    """``build_alias_adjacency`` (its ``_build_alias_rows``) against the
    JAX package's, which runs the engine's native ``eg_build_alias_csr``:
    every array bit for bit."""
    if which == "mixed":
        tg = _mixed_graph()
        eg = tg  # the JAX builder reads any graph with get_full_neighbor
        max_id = tg.max_node_id
    else:
        eg, tg = graphs["pl"]
        max_id = PL["num_nodes"] - 1
    want = jdev.build_alias_adjacency(eg, [0], max_id)
    got = tdev.build_alias_adjacency(tg, [0], max_id)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if which == "mixed":
        assert (got["prob"] < 1).sum() > 100  # the Vose loop ran
        assert not got["sampleable"][3]  # a zero-total row


def test_alias_draws_and_fanout_match_jax_under_key_replay(monkeypatch):
    """Single-hop alias draws and a two-hop alias fanout equal JAX's picks
    on odd ids (negative, past the end, the default, zero-weight, the
    empty rows at the CSR's end); the fanout never reaches a kernel
    wrapper."""
    tg = _mixed_graph()
    max_id = tg.max_node_id
    jadj = jdev.build_alias_adjacency(tg, [0], max_id)
    tadj = tdev.tensors(tdev.build_alias_adjacency(tg, [0], max_id), "cpu")
    assert int(tadj["off"][-2]) == int(tadj["prob"].shape[0])  # off == E
    rng = np.random.default_rng(1)
    nodes = np.concatenate([[-5, max_id + 9, max_id + 1, max_id, 3, 4],
                            rng.integers(0, max_id + 1, 90)]).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jdev.sample_neighbor(jadj, nodes, key, 7))
    got = tdev._alias_sample_neighbor(
        tadj, torch.from_numpy(nodes), 7, u=_replay_pair(key, (96, 7)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:6] == max_id + 1).all()

    def refuse(*a, **k):
        raise AssertionError("an alias table reached a kernel wrapper")

    monkeypatch.setattr(sampling_kernels, "sample_fanout2", refuse)
    monkeypatch.setattr(sampling_kernels, "sample_neighbor", refuse)
    before = dict(sampling_kernels.launches)
    roots = nodes[:24]
    key = jax.random.PRNGKey(12)
    want = jax.jit(lambda k: jdev.sample_fanout([jadj, jadj], roots, k,
                                               [3, 2]))(key)
    u = [_replay_pair(jax.random.fold_in(key, h), (24 * r, c))
         for h, (r, c) in enumerate([(1, 3), (3, 2)])]
    got = tdev.sample_fanout([tadj, tadj], torch.from_numpy(roots), [3, 2],
                             u=u)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Philox uniforms take the same route
    hops = tdev.sample_fanout([tadj, tadj], torch.from_numpy(roots), [3, 2],
                              tdev.seed_words(4))
    assert [h.shape[0] for h in hops] == [24, 72, 144]
    assert sampling_kernels.launches == before


def test_set_sampling_options_raises_where_jax_raises():
    kw = dict(label_idx=0, label_dim=5, metapath=[[0], [0]], fanouts=FANOUTS,
              dim=8, feature_idx=1, feature_dim=12, max_id=99,
              device_features=True, device_sampling=True)
    for model in (JSage(**kw), TSage(**kw)):
        with pytest.raises(ValueError, match="exact"):
            model.set_sampling_options(max_degree=8, alias=True)
        model.set_sampling_options(max_degree=8)
        assert (model.sampling_max_degree, model.sampling_alias) == (8, False)
        model.set_sampling_options(alias=True)
        assert (model.sampling_max_degree, model.sampling_alias) == (None,
                                                                     True)
        model.alias_sampling_ok = False
        with pytest.raises(ValueError, match="slab"):
            model.set_sampling_options(alias=True)


def _kw(max_id, **extra):
    return dict(label_idx=0, label_dim=SYN["label_dim"], metapath=[[0], [0]],
                fanouts=FANOUTS, dim=16, feature_idx=1,
                feature_dim=SYN["feature_dim"], max_id=max_id,
                device_features=True, device_sampling=True, **extra)


def test_capped_slab_consts_match_jax(graphs):
    """``set_sampling_options(max_degree=...)`` caps the device slab as
    JAX's does: the same rows keep the same heaviest neighbors, and the
    capped slab carries no alias keys."""
    eg, tg = graphs["syn"]
    max_id, cap = SYN["num_nodes"] - 1, 8
    consts = []
    for model, graph, dev in ((JSage(**_kw(max_id)), eg, ()),
                              (TSage(**_kw(max_id)), tg, ("cpu",))):
        model.set_sampling_options(max_degree=cap)
        with pytest.warns(UserWarning, match=f"max_degree={cap}"):
            consts.append(model.build_consts(graph, *dev)["adj"]["et0"])
    want, got = consts
    assert got["nbr"].shape == (max_id + 2, cap)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_bf16_table_matches_jax(graphs):
    """The bfloat16 table equals JAX's bit for bit, labels stay float32,
    gathered rows come back float32 and equal JAX's; a bad dtype raises
    in both packages."""
    eg, tg = graphs["syn"]
    max_id = SYN["num_nodes"] - 1
    jc = JSage(**_kw(max_id, feature_dtype="bfloat16")).build_consts(eg)
    tc = TSage(**_kw(max_id, feature_dtype="bfloat16")).build_consts(tg,
                                                                     "cpu")
    assert tc["features"].dtype == torch.bfloat16
    assert tc["labels"].dtype == torch.float32
    np.testing.assert_array_equal(tc["features"].view(torch.int16).numpy(),
                                  np.asarray(jc["features"]).view(np.int16))
    np.testing.assert_array_equal(tc["labels"].numpy(),
                                  np.asarray(jc["labels"]))
    gids = np.array([0, 5, max_id, max_id + 1, 17], np.int32)
    want = jbase.gather_consts({"gids": gids}, jc)["dense"]
    got = tbase.gather_consts({"gids": torch.from_numpy(gids)}, tc)["dense"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for model, graph, dev in ((JSage(**_kw(max_id, feature_dtype="nope")),
                               eg, ()),
                              (TSage(**_kw(max_id, feature_dtype="nope")),
                               tg, ("cpu",))):
        with pytest.raises(ValueError, match="bad feature table dtype"):
            model.build_consts(graph, *dev)


@pytest.fixture(scope="module")
def jparams():
    """Flax parameters, in the layout of the JAX module's params tree,
    that both packages start the step from: lecun-scaled normal kernels
    and a nonzero bias, from a numpy seed."""
    rng = np.random.default_rng(2)
    dim, f, c = 16, SYN["feature_dim"], SYN["label_dim"]

    def kernel(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(
            np.float32)

    encoder = {
        f"MeanAggregator_{layer}": {
            "Dense_0": {"Dense_0": {"kernel": kernel(n_in, dim)}},
            "Dense_1": {"Dense_0": {"kernel": kernel(n_in, dim)}},
        }
        for layer, n_in in enumerate([f, dim])
    }
    return {"encoder": encoder,
            "predict": {"kernel": kernel(dim, c),
                        "bias": (0.1 * rng.standard_normal(c)).astype(
                            np.float32)}}


@pytest.mark.parametrize("form", ["slab", "slab_bf16", "alias"])
@pytest.mark.parametrize("sigmoid", [True, False])
def test_supervised_step_matches_jax_under_key_replay(graphs, jparams, form,
                                                      sigmoid):
    """Loss and gradients of one device-sampling step at the Reddit
    recipe's fanouts and one-hot labels: the JAX module's fanout keyed by
    PRNGKey(seed), hop h by fold_in(key, h), replayed into the port."""
    eg, tg = graphs["pl" if form == "alias" else "syn"]
    n = tg.num_nodes
    extra = dict(sigmoid_loss=sigmoid)
    if form == "slab_bf16":
        extra["feature_dtype"] = "bfloat16"
    jm, tm = JSage(**_kw(n - 1, **extra)), TSage(**_kw(n - 1, **extra))
    if form == "alias":
        jm.set_sampling_options(alias=True)
        tm.set_sampling_options(alias=True)
    jconsts = jm.build_consts(eg)
    assert ("off" in jconsts["adj"]["et0"]) == (form == "alias")
    jconsts = jax.tree_util.tree_map(jax.numpy.asarray, jconsts)
    seed = 9
    roots = np.random.default_rng(seed).integers(0, n, BATCH).astype(np.int32)
    jbatch = {"roots": roots, "seed": np.full(BATCH, seed, np.int32)}

    def jloss(p):
        return jm._apply(p, jbatch, jconsts).loss

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    key, u, rows = jax.random.PRNGKey(seed), [], BATCH
    for h, f in enumerate(FANOUTS):
        k = jax.random.fold_in(key, h)
        u.append(_replay_pair(k, (rows, f)) if form == "alias"
                 else np.array(jax.random.uniform(k, (rows, f))))
        rows *= f

    st = tm.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu")
    st["module"].load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    out = st["module"]({"roots": torch.from_numpy(roots), "seed": seed,
                        "u": u}, st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(jl), rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    for k, p in st["module"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_thirty_alias_steps_lower_the_loss(graphs, monkeypatch):
    """Alias tables on the power-law graph train on the CPU with Philox
    draws (as JAX's ``test_model_alias_option_trains``); without a card
    the same model's init refuses to fall back to the CPU."""
    _, tg = graphs["pl"]
    tm = TSage(**_kw(tg.max_node_id, sigmoid_loss=False))
    tm.set_sampling_options(alias=True)
    st = tm.init_state(tg, ttrain.get_optimizer("adam", 0.05), device="cpu")
    assert "off" in st["consts"]["adj"]["et0"]
    scan = ttrain.make_scan_train(tm, 10, BATCH)
    losses = []
    for c in range(3):
        st, chunk = scan(st, c)
        losses.append(chunk)
    losses = torch.cat(losses)
    assert bool(torch.isfinite(losses).all())
    assert float(losses[-10:].mean()) < float(losses[:10].mean())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_state(tg, ttrain.get_optimizer("adam", 0.05))
