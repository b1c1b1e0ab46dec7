"""The port's supervised GraphSAGE against the flax model.

Flax parameters are carried across with ``convert.params_from_flax``; the
graph comes from one numpy seed through each package's
``build_synthetic``; batches are numpy-seeded node ids (``"hops"``) or,
for the device-sampling step, root and neighbor uniforms replayed from
JAX's keys. Tolerances (float32): forward atol 1e-5, rtol 1e-4; loss
rtol 1e-5; gradients atol 1e-6, rtol 1e-4; parameters after Adam
compared only where |grad| > 1e-6 (below that the sign of Adam's first
step is noise), atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import euler_tpu  # noqa: E402
from euler_tpu import datasets as jdatasets  # noqa: E402
from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.models import SupervisedGraphSage as JSage  # noqa: E402
from euler_tpu.models import base as jbase  # noqa: E402
from euler_tpu.nn import metrics as jmetrics  # noqa: E402

from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.convert import params_from_flax  # noqa: E402
from euler_tpu_torch.datasets import build_synthetic  # noqa: E402
from euler_tpu_torch.graph import Graph  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage as TSage  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from euler_tpu_torch.nn import metrics as tmetrics  # noqa: E402
from euler_tpu_torch.nn.layers import Dense  # noqa: E402

SYN = dict(num_nodes=200, avg_degree=5, feature_dim=6, label_dim=4,
           max_degree=10, seed=3)
FANOUTS = [3, 2]
DIM = 16
BATCH = 8
LR = 0.01


def _kw():
    return dict(
        label_idx=0, label_dim=SYN["label_dim"], metapath=[[0], [0]],
        fanouts=FANOUTS, dim=DIM, feature_idx=1,
        feature_dim=SYN["feature_dim"], max_id=SYN["num_nodes"] - 1,
        device_features=True, device_sampling=True,
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX model + state on the engine graph, port model + state (flax
    params loaded) on the port graph of the same seed."""
    d = str(tmp_path_factory.mktemp("syn"))
    jdatasets.build_synthetic(d, num_partitions=1, **SYN)
    eg = euler_tpu.Graph(directory=d)
    jm = JSage(**_kw())
    jstate = jm.init_state(jax.random.PRNGKey(0), eg, np.arange(BATCH),
                           optax.adam(LR))
    tm = TSage(**_kw())
    tg = Graph(**build_synthetic(**SYN))
    yield jm, jstate, tm, tg
    eg.close()


def _port_state(tm, tg, jparams):
    st = tm.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu")
    st["module"].load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    )
    return st


def _hops_batch(seed):
    """Numpy-seeded per-hop node ids: roots, then fanout-shaped hops."""
    rng = np.random.default_rng(seed)
    n, rows, hops = SYN["num_nodes"] + 1, BATCH, []
    for f in [1] + FANOUTS:
        rows *= f
        hops.append(rng.integers(0, n, rows).astype(np.int32))
    return hops


def _jbatch(hops):
    return {"hops": [{"gids": h} for h in hops]}


def _tbatch(hops):
    return {"hops": [{"gids": torch.from_numpy(h)} for h in hops]}


def _named_grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


def test_dense_init_is_lecun_normal():
    """flax's lecun_normal: truncated at +-2 std of the truncated draw,
    variance 1/fan_in; zero bias."""
    d = Dense(400, 300)
    d.reset_parameters(torch.Generator().manual_seed(0))
    w = d.linear.weight.detach()
    std = np.sqrt(1 / 400) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    np.testing.assert_allclose(float(w.std()), np.sqrt(1 / 400), rtol=0.02)
    assert float(d.linear.bias.detach().abs().max()) == 0.0
    e = Dense(400, 300)
    e.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(e.linear.weight, w)


def test_params_from_flax_fills_every_parameter(setup):
    jm, jstate, tm, tg = setup
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                 jstate["params"]))
    module = tm.make_module()
    assert sorted(sd) == sorted(module.state_dict())
    module.load_state_dict(sd)  # strict
    k = np.asarray(jstate["params"]["predict"]["kernel"])
    np.testing.assert_array_equal(
        module.predict.linear.weight.detach().numpy(), k.T
    )


def test_consts_match_jax(setup):
    jm, jstate, tm, tg = setup
    tconsts = tm.build_consts(tg, "cpu")
    jc = jstate["consts"]
    for k in ("features", "labels"):
        np.testing.assert_array_equal(tconsts[k].numpy(), np.asarray(jc[k]))
    for k in ("nbr", "cum", "deg", "sampleable"):
        np.testing.assert_array_equal(
            tconsts["adj"]["et0"][k].numpy(), np.asarray(jc["adj"]["et0"][k])
        )
    for k in ("ids", "cum", "seg_cum"):
        np.testing.assert_array_equal(
            tconsts["roots"][k].numpy(), np.asarray(jc["roots"][k])
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_loss_grads_match_flax(setup, seed):
    jm, jstate, tm, tg = setup
    hops = _hops_batch(seed)
    consts = jstate["consts"]

    def jloss(p):
        out = jm._apply(p, _jbatch(hops), consts)
        return out.loss, (out.embedding, out.metric)

    (jl, (jemb, jmetric)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jstate["params"]
    )
    st = _port_state(tm, tg, jstate["params"])
    out = st["module"](_tbatch(hops), st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(out.embedding.detach().numpy(),
                               np.asarray(jemb), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(float(out.loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(out.metric.numpy(), np.asarray(jmetric))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    got = _named_grads(st["module"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_five_adam_steps_track_optax(setup):
    """Five Adam steps on the same batches: the loss curves agree, and so
    do the parameters after the first step where |grad| > 1e-6."""
    jm, jstate, tm, tg = setup
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


def test_device_sampling_step_matches_jax_scan_under_key_replay(setup):
    """One step of JAX's make_scan_train (inner_steps=1) against the
    port's train step fed the same uniforms: roots from
    split(fold_in(PRNGKey(seed), 0)), hop h from
    fold_in(PRNGKey(seed * 1 + 0), h). Roots and picks are then equal,
    loss and parameters agree."""
    jm, jstate, tm, tg = setup
    seed = 5
    js, jlosses = jax.jit(
        jtrain.make_scan_train(jm, optax.adam(LR), 1, BATCH)
    )(jstate, seed)
    k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    hop_key = jax.random.PRNGKey(seed)
    u_roots = [np.array(jax.random.uniform(k, (BATCH,))) for k in (k1, k2)]
    u_hops, rows = [], BATCH
    for h, f in enumerate(FANOUTS):
        u_hops.append(np.array(
            jax.random.uniform(jax.random.fold_in(hop_key, h), (rows, f))))
        rows *= f

    st = _port_state(tm, tg, jstate["params"])
    from euler_tpu_torch.graph import device as tdev

    roots = tdev.sample_node(st["consts"]["roots"], BATCH, u=u_roots)
    from euler_tpu.graph import device as jdev

    want_roots = jdev.sample_node(
        jstate["consts"]["roots"], jax.random.fold_in(
            jax.random.PRNGKey(seed), 0), BATCH)
    np.testing.assert_array_equal(roots.numpy(), np.asarray(want_roots))
    loss, _ = tm.make_train_step()(
        st, {"roots": roots, "seed": seed, "u": u_hops}
    )
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
    falling from the first chunk to the last, reproducible from seeds."""
    _, _, tm, tg = setup
    runs = []
    for _ in range(2):
        st = tm.init_state(tg, ttrain.get_optimizer("adam", LR),
                           device="cpu", seed=1)
        scan = ttrain.make_scan_train(tm, 4, BATCH)
        chunks = []
        for c in range(3):
            st, losses = scan(st, c)
            assert losses.shape == (4,)
            chunks.append(losses)
        runs.append(torch.stack(chunks))
    assert torch.isfinite(runs[0]).all()
    assert float(runs[0][-1].mean()) < float(runs[0][0].mean())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("sigmoid", [True, False])
def test_supervised_decoder_matches_jax(sigmoid):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((32, 7)).astype(np.float32) * 3
    if sigmoid:
        labels = rng.integers(0, 2, (32, 7)).astype(np.float32)
    else:
        labels = np.eye(7, dtype=np.float32)[rng.integers(0, 7, 32)]
    jl, jp = jbase.supervised_decoder(logits, labels, sigmoid)
    tl, tp = tbase.supervised_decoder(torch.from_numpy(logits),
                                      torch.from_numpy(labels), sigmoid)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_f1_matches_jax():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, (50, 9)).astype(np.float32)
    preds = rng.integers(0, 2, (50, 9)).astype(np.float32)
    jc = np.asarray(jmetrics.f1_counts(labels, preds))
    tc = tmetrics.f1_counts(torch.from_numpy(labels), torch.from_numpy(preds))
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert tmetrics.f1_from_counts(tc) == jmetrics.f1_from_counts(jc)
