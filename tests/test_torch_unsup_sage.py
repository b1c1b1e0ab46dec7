"""The port's unsupervised GraphSAGE against the flax model.

Flax parameters are carried across with ``convert.params_from_flax``; the
graph comes from one numpy seed through each package's
``build_synthetic``; batches are numpy-seeded node sets (``"src_hops"``,
``"pos_hops"``, ``"neg_hops"``) or, for the device-sampling step, the
uniforms JAX draws from its keys, replayed into the port's ``batch["u"]``.
Tolerances (float32), as in test_torch_sage.py: forward atol 1e-5, rtol
1e-4; loss rtol 1e-5; gradients atol 1e-6, rtol 1e-4; parameters after
Adam compared only where |grad| > 1e-6, atol 1e-5. The loss is a sum over
the batch, not a mean.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import euler_tpu  # noqa: E402
from euler_tpu import datasets as jdatasets  # noqa: E402
from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.models import GraphSage as JSage  # noqa: E402
from euler_tpu.models import base as jbase  # noqa: E402
from euler_tpu.nn import metrics as jmetrics  # noqa: E402

from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.convert import params_from_flax  # noqa: E402
from euler_tpu_torch.datasets import build_synthetic  # noqa: E402
from euler_tpu_torch.graph import MemoryGraph  # noqa: E402
from euler_tpu_torch.graph import device as tdev  # noqa: E402
from euler_tpu_torch.models import GraphSage as TSage  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from euler_tpu_torch.models.graphsage import UNSUP_STREAMS  # noqa: E402
from euler_tpu_torch.nn import metrics as tmetrics  # noqa: E402

SYN = dict(num_nodes=200, avg_degree=5, feature_dim=6, label_dim=4,
           max_degree=10, seed=3)
FANOUTS = [3, 2]
DIM = 16
NEGS = 3
BATCH = 8
LR = 0.01


def _kw(concat):
    return dict(
        node_type=0, edge_type=[0], max_id=SYN["num_nodes"] - 1,
        metapath=[[0], [0]], fanouts=FANOUTS, dim=DIM, num_negs=NEGS,
        feature_idx=1, feature_dim=SYN["feature_dim"], concat=concat,
        xent_loss=True, device_features=True, device_sampling=True,
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per ``concat``: the JAX model and state on the engine graph, and
    the port model; plus the port graph of the same seed."""
    d = str(tmp_path_factory.mktemp("syn"))
    jdatasets.build_synthetic(d, num_partitions=1, **SYN)
    eg = euler_tpu.Graph(directory=d)
    models = {}
    for concat in (True, False):
        jm = JSage(**_kw(concat))
        # init_state's steps, with the flax init traced on a host-given
        # batch: an eager init through the device draws takes seconds
        consts = jm.build_consts(eg)
        params = jax.jit(jm.module.init)(
            jax.random.PRNGKey(0), _jbatch(_hops_batch(0)), consts
        )["params"]
        jstate = {"params": params, "opt_state": optax.adam(LR).init(params),
                  "consts": consts}
        models[concat] = (jm, jstate, TSage(**_kw(concat)))
    yield models, MemoryGraph(**build_synthetic(**SYN))
    eg.close()


def _port_state(tm, tg, jparams):
    st = tm.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu")
    st["module"].load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    )
    return st


def _hops_batch(seed):
    """Numpy-seeded node sets: the fanout-shaped hops of B roots, B
    positives and B * NEGS negatives."""
    rng = np.random.default_rng(seed)
    n = SYN["num_nodes"] + 1
    out = {}
    for name, rows in (("src_hops", BATCH), ("pos_hops", BATCH),
                       ("neg_hops", BATCH * NEGS)):
        hops = []
        for f in [1] + FANOUTS:
            rows *= f
            hops.append(rng.integers(0, n, rows).astype(np.int32))
        out[name] = hops
    return out


def _jbatch(hops):
    return {k: [{"gids": h} for h in v] for k, v in hops.items()}


def _tbatch(hops):
    return {k: [{"gids": torch.from_numpy(h)} for h in v]
            for k, v in hops.items()}


def test_mrr_matches_jax_with_ties():
    """Ties count against the positive on both sides."""
    rng = np.random.default_rng(0)
    logits = rng.integers(-2, 3, (40, 1, 1)).astype(np.float32)
    neg = rng.integers(-2, 3, (40, 1, 5)).astype(np.float32)
    assert (neg == logits).any()
    want = float(jmetrics.mrr(logits, neg))
    got = float(tmetrics.mrr(torch.from_numpy(logits), torch.from_numpy(neg)))
    assert got == pytest.approx(want, rel=1e-6)
    # a tied negative ranks above the positive
    one = tmetrics.mrr(torch.zeros(1, 1, 1), torch.tensor([[[0.0, -1.0]]]))
    assert float(one) == 0.5


@pytest.mark.parametrize("xent", [True, False])
def test_unsupervised_decoder_matches_jax(xent):
    rng = np.random.default_rng(1)
    emb, pos = (rng.standard_normal((16, 1, 8)).astype(np.float32)
                for _ in range(2))
    negs = rng.standard_normal((16, 5, 8)).astype(np.float32)
    jl, jm = jbase.unsupervised_decoder(emb, pos, negs, xent)
    tl, tm = tbase.unsupervised_decoder(
        *(torch.from_numpy(x) for x in (emb, pos, negs)), xent)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-6)


def test_consts_match_jax_and_negs_alias_roots(setup):
    models, tg = setup
    jm, jstate, tm = models[True]
    tconsts = tm.build_consts(tg, "cpu")
    jc = jstate["consts"]
    assert sorted(tconsts) == sorted(jc)
    assert tconsts["roots"] is tconsts["negs"]
    assert jc["roots"] is jc["negs"]
    np.testing.assert_array_equal(tconsts["features"].numpy(),
                                  np.asarray(jc["features"]))
    for k in ("ids", "cum", "seg_cum"):
        np.testing.assert_array_equal(tconsts["negs"][k].numpy(),
                                      np.asarray(jc["negs"][k]))
    for k in ("nbr", "cum", "deg", "sampleable"):
        np.testing.assert_array_equal(tconsts["adj"]["et0"][k].numpy(),
                                      np.asarray(jc["adj"]["et0"][k]))


@pytest.mark.parametrize("concat", [True, False])
def test_params_from_flax_fills_every_parameter(setup, concat):
    models, _ = setup
    _, jstate, tm = models[concat]
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                 jstate["params"]))
    module = tm.make_module()
    assert sorted(sd) == sorted(module.state_dict())
    module.load_state_dict(sd)  # strict
    k = np.asarray(jstate["params"]["context_encoder"]["MeanAggregator_1"]
                   ["Dense_1"]["Dense_0"]["kernel"])
    assert k.shape == (DIM, DIM // 2 if concat else DIM)
    np.testing.assert_array_equal(
        module.context_encoder.aggregators[1].neigh_dense.linear.weight
        .detach().numpy(), k.T)


@pytest.mark.parametrize("concat", [True, False])
def test_forward_loss_mrr_grads_match_flax(setup, concat):
    models, tg = setup
    jm, jstate, tm = models[concat]
    hops = _hops_batch(int(concat))

    def jloss(p):
        out = jm._apply(p, _jbatch(hops), jstate["consts"])
        return out.loss, (out.embedding, out.metric)

    (jl, (jemb, jmrr)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jstate["params"])
    st = _port_state(tm, tg, jstate["params"])
    out = st["module"](_tbatch(hops), st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(out.embedding.detach().numpy(),
                               np.asarray(jemb), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(out.loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(out.metric), float(jmrr), rtol=1e-6)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: p.grad for k, p in st["module"].named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_five_adam_steps_track_optax(setup):
    models, tg = setup
    jm, jstate, tm = models[True]
    jstep = jax.jit(jm.make_train_step(optax.adam(LR)))
    tstep = tm.make_train_step()
    js = jstate
    st = _port_state(tm, tg, jstate["params"])
    jl, tl = [], []
    for i in range(5):
        hops = _hops_batch(10 + i)
        js, loss, _ = jstep(js, _jbatch(hops))
        jl.append(float(loss))
        loss, _ = tstep(st, _tbatch(hops))
        tl.append(float(loss))
        if i == 0:
            want = params_from_flax(
                jax.tree_util.tree_map(np.asarray, js["params"]))
            for k, p in st["module"].named_parameters():
                mask = p.grad.abs() > 1e-6
                np.testing.assert_allclose(
                    p.detach()[mask].numpy(), want[k][mask].numpy(),
                    atol=1e-5, err_msg=k,
                )
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def _replayed_uniforms(seed):
    """The uniforms of one JAX make_scan_train step (inner_steps=1): roots
    from split(fold_in(PRNGKey(seed), 0)); the module's five keys from
    split(PRNGKey(seed), 5), fanout hop h from fold_in(k, h)."""
    uni = lambda k, shape: np.array(jax.random.uniform(k, shape))  # noqa: E731
    k_roots = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    u_roots = [uni(k, (BATCH,)) for k in k_roots]
    k_pos, k_neg, k_src, k_p, k_n = jax.random.split(
        jax.random.PRNGKey(seed), 5)

    def fanout(key, rows):
        out = []
        for h, f in enumerate(FANOUTS):
            out.append(uni(jax.random.fold_in(key, h), (rows, f)))
            rows *= f
        return out

    u = {
        "pos": uni(k_pos, (BATCH, 1)),
        "neg": [uni(k, (BATCH * NEGS,)) for k in jax.random.split(k_neg)],
        "src_hops": fanout(k_src, BATCH),
        "pos_hops": fanout(k_p, BATCH),
        "neg_hops": fanout(k_n, BATCH * NEGS),
    }
    assert sorted(u) == sorted(UNSUP_STREAMS)
    return u_roots, u


def test_device_sampling_step_matches_jax_scan_under_key_replay(setup):
    """One step of JAX's make_scan_train against the port's train step fed
    the same uniforms: roots, positives, negatives and the three fanouts
    are then equal, and loss and parameters agree."""
    models, tg = setup
    jm, jstate, tm = models[True]
    seed = 5
    js, jlosses = jax.jit(
        jtrain.make_scan_train(jm, optax.adam(LR), 1, BATCH)
    )(jstate, seed)
    u_roots, u = _replayed_uniforms(seed)
    st = _port_state(tm, tg, jstate["params"])
    roots = tdev.sample_node(st["consts"]["roots"], BATCH, u=u_roots)
    from euler_tpu.graph import device as jdev

    want_roots = jdev.sample_node(
        jstate["consts"]["roots"],
        jax.random.fold_in(jax.random.PRNGKey(seed), 0), BATCH)
    np.testing.assert_array_equal(roots.numpy(), np.asarray(want_roots))
    loss, _ = tm.make_train_step()(st, {"roots": roots, "seed": seed,
                                        "u": u})
    np.testing.assert_allclose(float(loss), float(jlosses[0]), rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, js["params"]))
    for k, p in st["module"].named_parameters():
        mask = p.grad.abs() > 1e-6
        assert int(mask.sum()) > 0
        np.testing.assert_allclose(p.detach()[mask].numpy(),
                                   want[k][mask].numpy(), atol=1e-5,
                                   err_msg=k)


def test_scan_train_runs_on_cpu_with_philox_draws(setup):
    """make_scan_train on the CPU: finite losses of the chunk's length,
    the same from the same seeds; the negatives come from the Philox
    stream, so a batch embeds the same way twice."""
    models, tg = setup
    tm = models[True][2]
    runs = []
    for _ in range(2):
        st = tm.init_state(tg, ttrain.get_optimizer("adam", LR),
                           device="cpu", seed=1)
        scan = ttrain.make_scan_train(tm, 3, BATCH)
        chunks = []
        for c in range(2):
            st, losses = scan(st, c)
            assert losses.shape == (3,)
            chunks.append(losses)
        runs.append(torch.stack(chunks))
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])
    batch = tm.device_sample_batch(np.arange(BATCH), seed=3, device="cpu")
    module = st["module"]
    with torch.no_grad():
        out = module(batch, st["consts"])
        again = module(batch, st["consts"])
        emb = module.embed(batch, st["consts"])
    assert out.metric_name == "mrr" and 0 < float(out.metric) <= 1
    assert torch.equal(out.loss, again.loss)
    assert torch.equal(emb, out.embedding)
