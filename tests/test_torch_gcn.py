"""The port's GCN family against the JAX package: the full-neighbor
expansion, the segment-op and dense aggregators, GCNEncoder,
SupervisedGCN and ScalableGCN with its stores.

Both sides get the same inputs: graphs from one numpy seed (the JAX
models build their tables from the port's in-memory graph, which answers
the engine's reads), numpy-seeded roots, node rows and adjacencies, and
the same weights carried across with ``convert.params_from_flax`` (and
``convert.load_stores``). The expansion must agree exactly, array for
array and dtype for dtype. Tolerances (float32): forward atol 1e-5, rtol
1e-4; loss rtol 1e-5; gradients atol 1e-6, rtol 1e-4; parameters after
Adam atol 1e-5, only where |grad| > 1e-6 (below that the sign of an
Adam step is noise; over ScalableGCN's five steps, where it held at
every step); five-step
losses rtol 1e-4; stores and grad-stores after five steps atol 1e-5,
rtol 1e-4.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from euler_tpu.graph import device as jdev  # noqa: E402
from euler_tpu.models import ScalableGCN as JScalable  # noqa: E402
from euler_tpu.models import SupervisedGCN as JGCN  # noqa: E402
from euler_tpu.nn import aggregators as jdense  # noqa: E402
from euler_tpu.nn import encoders as jencoders  # noqa: E402
from euler_tpu.nn import sparse_aggregators as jsparse  # noqa: E402

from euler_tpu_torch import convert  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.datasets import PPI, build_synthetic  # noqa: E402
from euler_tpu_torch.graph import Graph, sampling_kernels  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.models import ScalableGCN as TScalable  # noqa: E402
from euler_tpu_torch.models import SupervisedGCN as TGCN  # noqa: E402
from euler_tpu_torch.nn import aggregators as tdense  # noqa: E402
from euler_tpu_torch.nn import encoders as tencoders  # noqa: E402
from euler_tpu_torch.nn import sparse_aggregators as tsparse  # noqa: E402

SYN = dict(num_nodes=200, avg_degree=5, feature_dim=6, label_dim=4,
           max_degree=10, seed=3)
DIM = 16
BATCH = 16
LR = 0.01
# run_loop's SupervisedGCN caps (batch * cap**h) at a cap of 2: hop 1
# overflows on this graph, as the defaults overflow on PPI
CAPS = [BATCH * 2, BATCH * 4]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sd(params) -> dict:
    return convert.params_from_flax(_np(params))


@pytest.fixture(scope="module")
def syn():
    return Graph(**build_synthetic(**SYN))


# ---- the full-neighbor expansion ----


def _expansion_case(name):
    """(graph, roots, caps) of one expansion case."""
    if name == "ppi_defaults":
        g = Graph(**build_synthetic(**PPI, seed=1))
        roots = np.random.default_rng(1).integers(0, g.num_nodes, 512)
        return g, roots, [512 * 10, 512 * 100]
    g = Graph(**build_synthetic(2000, 15, 4, 3, seed=11))
    rng = np.random.default_rng(12)
    roots = rng.integers(0, g.num_nodes, 64)
    # duplicates, the default id and an id past the slab
    roots[:6] = [roots[7], roots[7], g.num_nodes, g.num_nodes + 40, 0, 0]
    caps = {"generous": [64 * 60, 64 * 60 * 15], "tight": [300, 1000]}[name]
    return g, roots, caps


@pytest.mark.parametrize("name", ["generous", "tight", "ppi_defaults"])
def test_multi_hop_neighbor_matches_jax_exactly(name):
    """nodes, src, dst, mask (and w) equal the JAX function's, array for
    array, on the same numpy slab; the tight caps and run_loop's default
    caps [5,120, 51,200] on a PPI-scale graph overflow at hop 1."""
    g, roots, caps = _expansion_case(name)
    slab = tdev.build_adjacency(g, [0], g.max_node_id)
    roots = roots.astype(np.int32)
    want = _np(jax.jit(jdev.multi_hop_neighbor, static_argnums=2)(
        [slab] * 2, roots, tuple(caps)))
    got = tdev.multi_hop_neighbor([tdev.tensors(slab, "cpu")] * 2,
                                  torch.from_numpy(roots), caps)
    default = g.max_node_id + 1
    for h, (w, t) in enumerate(zip(want, got)):
        assert sorted(t) == sorted(w)
        for k in w:
            assert t[k].numpy().dtype == w[k].dtype, (h, k)
            np.testing.assert_array_equal(t[k].numpy(), w[k],
                                          err_msg=f"hop {h} {k}")
        assert t["w"] is t["mask"]
        real = int((w["nodes"] != default).sum())
        assert real > 0 and w["mask"].sum() > 0
    # the overflow is covered where it is meant to be
    cur = roots
    deg = slab["deg"][np.clip(cur, 0, default)]
    nbrs = slab["nbr"][np.clip(cur, 0, default)]
    hop1 = np.unique(nbrs[np.arange(nbrs.shape[1])[None, :] < deg[:, None]])
    assert (len(hop1) > caps[0]) == (name != "generous")


# ---- segment softmax and the sparse aggregators ----


def _coo(seed: int, n: int = 12, m: int = 30, e: int = 60):
    """A padded COO adjacency of ``e`` edges from ``n`` nodes to ``m``:
    node n-1 has no edge (an empty segment), node n-2 only masked ones,
    a quarter of the rest masked."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n - 1, e)).astype(np.int32)
    src[-3:] = n - 2
    mask = (rng.random(e) > 0.25).astype(np.float32)
    mask[src == n - 2] = 0.0
    return {"src": src, "dst": rng.integers(0, m, e).astype(np.int32),
            "mask": mask}


def test_segment_softmax_matches_jax():
    adj = _coo(0)
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal(len(adj["src"])) * 4).astype(np.float32)
    ct = rng.standard_normal(len(logits)).astype(np.float32)

    @jax.jit
    def jax_side(z):
        out, vjp = jax.vjp(lambda x: jsparse.segment_softmax(
            x, adj["src"], 12, adj["mask"]), z)
        return out, vjp(ct)[0]

    want, jgrad = jax_side(logits)
    x = torch.from_numpy(logits).requires_grad_()
    got = tsparse.segment_softmax(x, torch.from_numpy(adj["src"]), 12,
                                  torch.from_numpy(adj["mask"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-5)
    assert float(got.detach()[torch.from_numpy(adj["mask"]) == 0]
                 .abs().max()) == 0
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               atol=1e-6, rtol=1e-4)


SPARSE_CASES = {
    "gcn": (jsparse.GCNAggregator, tsparse.GCNAggregator, {}),
    "gcn_renorm": (jsparse.GCNAggregator, tsparse.GCNAggregator,
                   dict(renorm=True)),
    "mean": (jsparse.MeanAggregator, tsparse.MeanAggregator, {}),
    "mean_concat": (jsparse.MeanAggregator, tsparse.MeanAggregator,
                    dict(concat=True)),
    "single_attention": (jsparse.SingleAttentionAggregator,
                         tsparse.SingleAttentionAggregator, {}),
    "single_attention_renorm": (jsparse.SingleAttentionAggregator,
                                tsparse.SingleAttentionAggregator,
                                dict(renorm=True)),
    "attention": (jsparse.AttentionAggregator, tsparse.AttentionAggregator,
                  {}),
}
SPARSE_CLASS = {"gcn": "GCNAggregator", "mean": "MeanAggregator",
                "single": "SingleAttentionAggregator",
                "attention": "AttentionAggregator"}


def _check_agg(jagg, tagg, cls, inputs, j_inputs):
    """Forward, input and parameter gradients of a port aggregator
    against its flax counterpart under a random cotangent."""
    params = jax.jit(jagg.init)(jax.random.PRNGKey(3), j_inputs)["params"]
    sd = convert._aggregator(cls, _np(params))
    assert sorted(sd) == sorted(tagg.state_dict())
    tagg.load_state_dict(sd)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_()
              for x in inputs[:2]]
    out = tagg(*leaves, *inputs[2:])
    ct = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)

    @jax.jit
    def forward_and_vjp(p, a, b, rest):
        want, vjp = jax.vjp(
            lambda p, a, b: jagg.apply({"params": p}, (a, b, *rest)),
            p, a, b)
        return want, vjp(ct)

    want, (g_params, g_self, g_neigh) = forward_and_vjp(
        params, *j_inputs[:2], tuple(j_inputs[2:]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    out.backward(torch.from_numpy(ct))
    for leaf, g in zip(leaves, (g_self, g_neigh)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=1e-6, rtol=1e-4)
    want_g = convert._aggregator(cls, _np(g_params))
    for k, p in tagg.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_aggregator_matches_flax(name):
    jcls, tcls, kw = SPARSE_CASES[name]
    adj = _coo(5)
    rng = np.random.default_rng(6)
    self_emb = rng.standard_normal((12, 6)).astype(np.float32)
    neigh_emb = rng.standard_normal((30, 6)).astype(np.float32)
    t_adj = {k: torch.from_numpy(v) for k, v in adj.items()}
    _check_agg(jcls(DIM, **kw), tcls(6, DIM, **kw),
               SPARSE_CLASS[name.split("_")[0]],
               (self_emb, neigh_emb, t_adj), (self_emb, neigh_emb, adj))


DENSE_CASES = {
    "gcn": ("GCNAggregator", {}),
    "meanpool": ("MeanPoolAggregator", {}),
    "meanpool_concat": ("MeanPoolAggregator", dict(concat=True)),
    "maxpool": ("MaxPoolAggregator", {}),
    "maxpool_concat": ("MaxPoolAggregator", dict(concat=True)),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_aggregator_matches_flax(name):
    cls, kw = DENSE_CASES[name]
    rng = np.random.default_rng(7)
    self_emb = rng.standard_normal((10, 6)).astype(np.float32)
    neigh_emb = rng.standard_normal((10, 4, 6)).astype(np.float32)
    _check_agg(getattr(jdense, cls)(DIM, **kw),
               getattr(tdense, cls)(6, DIM, **kw), cls,
               (self_emb, neigh_emb), (self_emb, neigh_emb))


@pytest.mark.parametrize("residual", [False, True])
def test_gcn_encoder_matches_flax(residual):
    """A 2-layer GCNEncoder over a real two-hop expansion (gcn
    aggregator): forward and parameter gradients."""
    g = Graph(**build_synthetic(**SYN))
    slab = tdev.build_adjacency(g, [0], g.max_node_id)
    roots = np.random.default_rng(8).integers(0, 200, 8).astype(np.int32)
    hops = tdev.multi_hop_neighbor([tdev.tensors(slab, "cpu")] * 2,
                                   torch.from_numpy(roots), [40, 100])
    width = DIM if residual else 5
    feats = np.random.default_rng(9).standard_normal(
        (g.num_nodes + 1, width)).astype(np.float32)
    sets = [roots] + [h["nodes"].numpy() for h in hops]
    hidden = [feats[s] for s in sets]
    j_adjs = [{k: v.numpy() for k, v in h.items()} for h in hops]
    jenc = jencoders.GCNEncoder(2, DIM, "gcn", residual)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(4), hidden,
                                j_adjs)["params"]
    tenc = tencoders.GCNEncoder(width, 2, DIM, "gcn", residual)
    sd = {k.split(".", 1)[1]: v for k, v in convert.params_from_flax(
        {"encoder": _np(params)}).items()}
    assert sorted(sd) == sorted(tenc.state_dict())
    tenc.load_state_dict(sd)
    out = tenc([torch.from_numpy(h) for h in hidden], hops)
    want, grads = jax.jit(jax.value_and_grad(
        lambda p: jenc.apply({"params": p}, hidden, j_adjs).sum()))(params)
    np.testing.assert_allclose(out.sum().item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax.jit(jenc.apply)({"params": params}, hidden, j_adjs)),
        atol=1e-5, rtol=1e-4)
    out.sum().backward()
    want_g = {k.split(".", 1)[1]: v for k, v in convert.params_from_flax(
        {"encoder": _np(grads)}).items()}
    for k, p in tenc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


# ---- the models ----


def _gcn_kw(aggregator):
    return dict(label_idx=0, label_dim=SYN["label_dim"], metapath=[[0], [0]],
                dim=DIM, max_nodes_per_hop=CAPS,
                max_edges_per_hop=[BATCH * 4, BATCH * 8],
                aggregator=aggregator, feature_idx=1,
                feature_dim=SYN["feature_dim"], max_id=SYN["num_nodes"] - 1,
                device_features=True, device_sampling=True)


def _roots(rng):
    roots = rng.integers(0, SYN["num_nodes"], BATCH).astype(np.int32)
    roots[1] = roots[0]  # a duplicate root
    return roots


def _track_adam(jloss_fn, jparams, st, tstep, batches):
    """Step 1's loss and gradients, then five Adam steps: the port's loss
    curve tracks optax's, and the parameters after step 1 agree where
    |grad| > 1e-6."""
    jgrad = jax.jit(jax.value_and_grad(jloss_fn))
    opt = optax.adam(LR)
    jopt = opt.init(jparams)
    jl, tl = [], []
    for i, (jb, tb) in enumerate(batches):
        loss, grads = jgrad(jparams, jb)
        updates, jopt = opt.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jl.append(float(loss))
        tl.append(float(tstep(st, tb)[0]))
        if i == 0:
            np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
            want_g, want_p = _sd(grads), _sd(jparams)
            for k, p in st["module"].named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                           atol=1e-6, rtol=1e-4, err_msg=k)
                mask = p.grad.abs() > 1e-6
                np.testing.assert_allclose(
                    p.detach()[mask].numpy(), want_p[k][mask].numpy(),
                    atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("aggregator", ["gcn", "mean", "attention"])
def test_supervised_gcn_steps_match_flax(syn, aggregator):
    """From the same parameters, on injected roots with a duplicate, the
    device expansion at caps that overflow at hop 1: step 1's loss and
    gradients equal flax's, and five Adam steps track optax."""
    jm, tm = JGCN(**_gcn_kw(aggregator)), TGCN(**_gcn_kw(aggregator))
    jconsts = jax.tree_util.tree_map(jnp.asarray, jm.build_consts(syn))
    rng = np.random.default_rng(20)
    roots = [_roots(rng) for _ in range(5)]
    jparams = jax.jit(jm.module.init)(
        jax.random.PRNGKey(0), {"roots": roots[0]}, jconsts)["params"]
    st = tm.init_state(syn, ttrain.get_optimizer("adam", LR), device="cpu")
    assert "roots" not in st["consts"]  # as in JAX: no roots sampler
    assert sorted(st["consts"]["adj"]) == sorted(jconsts["adj"])
    sd = _sd(jparams)
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)

    def jloss(p, batch):
        return jm._apply(p, batch, jconsts).loss

    _track_adam(jloss, jparams, st, tm.make_train_step(), [
        ({"roots": r}, tm.device_sample_batch(r, 0, device="cpu"))
        for r in roots])
    embed = tm.make_embed_step()(st, tm.device_sample_batch(roots[0], 0,
                                                            device="cpu"))
    assert embed.shape == (BATCH, DIM) and torch.isfinite(embed).all()


def _scalable_kw(aggregator):
    return dict(label_idx=0, label_dim=SYN["label_dim"], edge_type=[0],
                num_layers=2, dim=DIM, max_id=SYN["num_nodes"] - 1,
                max_neighbors=4, aggregator=aggregator, feature_idx=1,
                feature_dim=SYN["feature_dim"], store_learning_rate=0.003,
                device_features=True, device_sampling=True,
                train_node_type=0)


@pytest.mark.parametrize("aggregator", ["mean", "attention"])
def test_scalable_gcn_steps_match_jax(syn, aggregator):
    """Five ScalableGCN steps from the same parameters and stores, on
    the same roots (with a duplicate), after the eval and embed steps
    over the same stores agree: losses, parameters (over 90% of their
    elements: those whose gradient exceeded 1e-6 at every step so far),
    stores and grad-stores track the JAX ScalableStoreModel step after
    every step."""
    jm, tm = JScalable(**_scalable_kw(aggregator)), TScalable(
        **_scalable_kw(aggregator))
    with pytest.warns(UserWarning, match="max_degree"):
        jstate = jm.init_state(jax.random.PRNGKey(0), syn, np.arange(BATCH),
                               optax.adam(LR))
    with pytest.warns(UserWarning, match="max_degree"):
        st = tm.init_state(syn, ttrain.get_optimizer("adam", LR),
                           device="cpu")
    assert st["consts"]["adj"]["et0"]["nbr"].shape[1] == 4
    sd = _sd(jstate["params"])
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    assert [s.shape for s in st["stores"]] == [(SYN["num_nodes"] + 1, DIM)]
    convert.load_stores(st, _np(jstate["stores"]),
                        _np(jstate["grad_stores"]))
    rng = np.random.default_rng(30)
    roots = _roots(rng)
    tb = tm.device_sample_batch(roots, 0, device="cpu")
    jloss, jmetric = jm.make_eval_step()(jstate, {"roots": roots})
    tloss, tmetric = tm.make_eval_step()(st, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(tmetric.numpy(), np.asarray(jmetric))
    np.testing.assert_allclose(
        tm.make_embed_step()(st, tb).numpy(),
        np.asarray(jm.make_embed_step()(jstate, {"roots": roots})),
        atol=1e-5, rtol=1e-4)
    jstep = jax.jit(jm.make_train_step(optax.adam(LR)))
    tstep = tm.make_train_step()
    jl, tl, tracked = [], [], {}
    for _ in range(5):
        roots = _roots(rng)
        jstate, loss, _ = jstep(jstate, {"roots": roots})
        jl.append(float(loss))
        tl.append(float(tstep(st, tm.device_sample_batch(
            roots, 0, device="cpu"))[0]))
        want = _sd(jstate["params"])
        for k, p in st["module"].named_parameters():
            # an element whose gradient was ever below 1e-6 took an Adam
            # step of rounding noise's sign, on both sides
            tracked[k] = tracked.get(k, True) & (p.grad.abs() > 1e-6)
            np.testing.assert_allclose(p.detach()[tracked[k]].numpy(),
                                       want[k][tracked[k]].numpy(),
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    n_tracked = sum(int(m.sum()) for m in tracked.values())
    assert n_tracked > 0.9 * sum(m.numel() for m in tracked.values())
    for name in ("stores", "grad_stores"):
        for t, w in zip(st[name], jstate[name]):
            assert float(np.abs(np.asarray(w)).max()) > 0
            np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-4, err_msg=name)


def test_scalable_gcn_scan_train_runs_on_cpu(syn):
    """make_scan_train drives ScalableGCN (its consts carry the roots
    sampler): finite losses, reproducible from seeds, no kernel."""
    runs = []
    for _ in range(2):
        tm = TScalable(**_scalable_kw("mean"))
        with pytest.warns(UserWarning, match="max_degree"):
            st = tm.init_state(syn, ttrain.get_optimizer("adam", LR),
                               device="cpu", seed=1)
        scan = ttrain.make_scan_train(tm, 3, BATCH)
        runs.append(torch.cat([scan(st, c)[1] for c in range(2)]))
    assert torch.isfinite(runs[0]).all() and runs[0].shape == (6,)
    assert torch.equal(runs[0], runs[1])
    assert sampling_kernels.launches == {"sample_fanout2": 0,
                                         "sample_neighbor": 0}


def test_gcn_entry_points_default_to_the_card(monkeypatch, syn):
    """SupervisedGCN and ScalableGCN: init_state and device_sample_batch
    run on the card unless asked for the CPU; host sampling, alias
    tables and aggregators that are not sparse are refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = ttrain.get_optimizer("adam", LR)
    for cls, kw in ((TGCN, _gcn_kw("mean")), (TScalable,
                                              _scalable_kw("mean"))):
        with pytest.raises(NotImplementedError, match="device_sampling"):
            cls(**{**kw, "device_sampling": False})
        m = cls(**kw)
        with pytest.raises(ValueError, match="alias"):
            m.set_sampling_options(alias=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            m.init_state(syn, opt)
        with pytest.raises(RuntimeError, match="CUDA"):
            m.device_sample_batch([1, 2], seed=0)
        with pytest.raises(NotImplementedError, match="engine client"):
            m.sample(syn, [1, 2])
        with pytest.raises(ValueError, match="sparse aggregator"):
            cls(**{**kw, "aggregator": "meanpool"}).make_module()
        with (pytest.warns(UserWarning) if cls is TScalable
              else contextlib.nullcontext()):
            state = m.init_state(syn, opt, device="cpu")
        assert next(state["module"].parameters()).device.type == "cpu"
        assert state["consts"]["adj"]["et0"]["nbr"].device.type == "cpu"
