"""The port's GAT against the JAX package: the attention head, the
encoder, the model on host-given and device-drawn sequences, five Adam
steps, the bfloat16 table, and the draw's route through the single-hop
kernel's wrapper.

Both sides get the same inputs: a graph from one numpy seed (the JAX
model builds its tables from the port's in-memory graph), numpy-seeded
rows and roots, the same weights carried across with
``convert.params_from_flax``, and the uniforms JAX draws from each step's
key replayed into the port's ``batch["u"]`` ("key replay"): the sequences
must then agree id for id. Tolerances (float32): forward atol 1e-5, rtol
1e-4; loss rtol 1e-5; gradients atol 1e-6, rtol 1e-4; five-step losses
rtol 1e-4; parameters after each Adam step atol 1e-5 on the elements
whose gradient exceeded 1e-6 at every step so far (below that the sign
of an Adam step is noise: an attention gate whose logits all sit on one
side of leaky_relu's kink has a gradient of 0 in exact arithmetic).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from euler_tpu import train as jtrain  # noqa: E402
from euler_tpu.models import GAT as JGAT  # noqa: E402
from euler_tpu.models.gat import _GATModule as JGATModule  # noqa: E402
from euler_tpu.nn import encoders as jencoders  # noqa: E402

from euler_tpu_torch import convert  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.datasets import build_synthetic  # noqa: E402
from euler_tpu_torch.graph import MemoryGraph, sampling_kernels  # noqa: E402
from euler_tpu_torch.models import GAT as TGAT  # noqa: E402
from euler_tpu_torch.nn import encoders as tencoders  # noqa: E402

SYN = dict(num_nodes=200, avg_degree=5, feature_dim=6, label_dim=4,
           max_degree=10, seed=3)
HIDDEN = 8
NB = 5
BATCH = 16
LR = 0.01


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sd(params) -> dict:
    return convert.params_from_flax(_np(params))


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def syn():
    return MemoryGraph(**build_synthetic(**SYN))


def _kw(head_num=1, feature_dtype=None):
    return dict(label_idx=0, label_dim=SYN["label_dim"], feature_idx=1,
                feature_dim=SYN["feature_dim"], max_id=SYN["num_nodes"] - 1,
                head_num=head_num, hidden_dim=HIDDEN, nb_num=NB, edge_type=0,
                device_features=True, device_sampling=True,
                feature_dtype=feature_dtype, train_node_type=0)


def _batches(tm, roots, seed):
    """The JAX batch and the port batch of one step: the same roots and
    seed, the port's draw fed JAX's uniforms."""
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                    (len(roots), NB)))
    jb = {"roots": roots, "seed": np.full(len(roots), seed, np.int32)}
    tb = tm.device_sample_batch(roots, seed, device="cpu")
    tb["u"] = u
    return jb, tb


def _pair(syn, **kw):
    """(JAX model, its params and consts, port model, port state) from
    the same parameters."""
    jm, tm = JGAT(**_kw(**kw)), TGAT(**_kw(**kw))
    jstate = jm.init_state(jax.random.PRNGKey(0), syn, np.arange(BATCH),
                           optax.adam(LR))
    st = tm.init_state(syn, ttrain.get_optimizer("adam", LR), device="cpu")
    sd = _sd(jstate["params"])
    assert sorted(sd) == sorted(st["module"].state_dict())
    st["module"].load_state_dict(sd)
    return jm, jstate, tm, st


def _check_vjp(jmod, tmod, prefix, seq):
    """Forward, input and parameter gradients of a port attention module
    against its flax counterpart under a random cotangent."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(2), seq)["params"]
    wrap = (lambda t: {"encoder": {"_AttHead_0": t}}) if "heads" in prefix \
        else (lambda t: {"encoder": t})
    sd = _strip(convert.params_from_flax(wrap(_np(params))), prefix)
    assert sorted(sd) == sorted(tmod.state_dict())
    tmod.load_state_dict(sd)
    x = torch.from_numpy(seq).requires_grad_()
    out = tmod(x)
    ct = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)

    @jax.jit
    def forward_and_vjp(p, s):
        want, vjp = jax.vjp(lambda p, s: jmod.apply({"params": p}, s), p, s)
        return want, vjp(ct)

    want, (g_params, g_seq) = forward_and_vjp(params, seq)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_seq), atol=1e-6,
                               rtol=1e-4)
    want_g = _strip(convert.params_from_flax(wrap(_np(g_params))), prefix)
    for k, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_att_head_matches_flax():
    """One head over [4, 6, 5]: logits on both sides of leaky_relu's kink,
    the row softmax, the bias and the ELU."""
    seq = np.random.default_rng(1).standard_normal((4, 6, 5)).astype(
        np.float32) * 3
    _check_vjp(jencoders._AttHead(HIDDEN), tencoders._AttHead(5, HIDDEN),
               "encoder.heads.0.", seq)


@pytest.mark.parametrize("head_num", [1, 2])
def test_att_encoder_matches_flax(head_num):
    """The hidden round concatenated, the output round averaged,
    position 0 returned."""
    seq = np.random.default_rng(3).standard_normal((8, NB + 1, 6)).astype(
        np.float32)
    _check_vjp(jencoders.AttEncoder(head_num, HIDDEN, SYN["label_dim"]),
               tencoders.AttEncoder(6, head_num, HIDDEN, SYN["label_dim"]),
               "encoder.", seq)


def test_params_from_flax_fills_every_parameter(syn):
    """At two heads: the hidden heads ``_AttHead_0..1`` of width HIDDEN,
    the output heads ``_AttHead_2..3`` of width num_classes, strictly."""
    jm, jstate, tm, st = _pair(syn, head_num=2)
    tree = jstate["params"]["encoder"]
    assert sorted(tree) == [f"_AttHead_{i}" for i in range(4)]
    module = tm.make_module()
    module.load_state_dict(_sd(jstate["params"]))  # strict
    for i, width in enumerate([HIDDEN] * 2 + [SYN["label_dim"]] * 2):
        head = module.encoder.heads[i]
        assert head.bias.shape == (width,)
        np.testing.assert_array_equal(
            head.f2.linear.weight.detach().numpy(),
            np.asarray(tree[f"_AttHead_{i}"]["Dense_2"]["kernel"]).T)


def test_gat_on_host_seq_ids_matches_flax(syn):
    """On host-given seq_ids (the default row among them): loss, logits,
    f1 counts and parameter gradients equal flax's."""
    jm, jstate, tm, st = _pair(syn, head_num=2)
    rng = np.random.default_rng(4)
    seq_ids = rng.integers(0, SYN["num_nodes"] + 1,
                           (BATCH, NB + 1)).astype(np.int32)
    seq_ids[0, 3:] = SYN["num_nodes"]
    jconsts = jax.tree_util.tree_map(jnp.asarray, jstate["consts"])

    def jloss(p):
        out = jm._apply(p, {"seq_ids": seq_ids}, jconsts)
        return out.loss, (out.embedding, out.metric)

    (loss, (logits, metric)), grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jstate["params"])
    out = st["module"]({"seq_ids": torch.from_numpy(seq_ids)}, st["consts"])
    np.testing.assert_allclose(float(out.loss.detach()), float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(out.embedding.detach().numpy(),
                               np.asarray(logits), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(out.metric.numpy(), np.asarray(metric))
    out.loss.backward()
    want_g = _sd(grads)
    for k, p in st["module"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_device_seq_ids_match_jax_under_key_replay(syn):
    """Each root followed by its nb_num draws, id for id and dtype for
    dtype, on roots led by the default row and an id past the tables
    (clipped by ``device_sample_batch``)."""
    jm, jstate, tm, st = _pair(syn)
    roots = np.random.default_rng(5).integers(
        0, SYN["num_nodes"], BATCH).astype(np.int32)
    roots[:2] = [SYN["num_nodes"], SYN["num_nodes"] + 30]
    jb, tb = _batches(tm, roots, 12)
    jb = jm.device_sample_batch(roots) | {"seed": jb["seed"]}
    want = np.asarray(jm.module.apply({"params": jstate["params"]}, jb,
                                      jstate["consts"],
                                      method=JGATModule._seq_ids))
    got = st["module"]._seq_ids(tb, st["consts"]).numpy()
    assert got.dtype == want.dtype and got.shape == (BATCH, NB + 1)
    np.testing.assert_array_equal(got, want)
    assert (got[:2] == SYN["num_nodes"]).all()  # the default row draws itself
    assert len(np.unique(got[2:, 1:])) > NB


def test_eval_and_embed_steps_match_jax(syn):
    """``Model.make_eval_step`` (loss and f1 counts, no gradients) and the
    embed step (the logits) equal JAX's under key replay."""
    jm, jstate, tm, st = _pair(syn)
    roots = np.random.default_rng(6).integers(0, SYN["num_nodes"], BATCH)
    jb, tb = _batches(tm, roots.astype(np.int32), 13)
    jloss, jmetric = jm.make_eval_step()(jstate, jb)
    tloss, tmetric = tm.make_eval_step()(st, tb)
    assert not tloss.requires_grad
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(tmetric.numpy(), np.asarray(jmetric))
    np.testing.assert_allclose(tm.make_embed_step()(st, tb).numpy(),
                               np.asarray(jm.make_embed_step()(jstate, jb)),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("head_num", [1, 2])
def test_gat_adam_steps_track_optax(syn, head_num):
    """Five steps from the same parameters under key replay, each on
    roots with a duplicate: losses and parameters track optax's Adam
    after every step (over the elements whose gradient stayed above
    1e-6, at least 80% of them)."""
    jm, jstate, tm, st = _pair(syn, head_num=head_num)
    jconsts = jax.tree_util.tree_map(jnp.asarray, jstate["consts"])
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jm._apply(p, b, jconsts).loss))
    opt = optax.adam(LR)
    jparams, jopt = jstate["params"], opt.init(jstate["params"])
    tstep = tm.make_train_step()
    rng = np.random.default_rng(20)
    jl, tl, tracked = [], [], {}
    for i in range(5):
        roots = rng.integers(0, SYN["num_nodes"], BATCH).astype(np.int32)
        roots[1] = roots[0]
        jb, tb = _batches(tm, roots, 50 + i)
        loss, grads = jgrad(jparams, jb)
        updates, jopt = opt.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jl.append(float(loss))
        tl.append(float(tstep(st, tb)[0]))
        if i == 0:
            np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
            want_g = _sd(grads)
            for k, p in st["module"].named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                           atol=1e-6, rtol=1e-4, err_msg=k)
        want = _sd(jparams)
        for k, p in st["module"].named_parameters():
            tracked[k] = tracked.get(k, True) & (p.grad.abs() > 1e-6)
            np.testing.assert_allclose(p.detach()[tracked[k]].numpy(),
                                       want[k][tracked[k]].numpy(),
                                       atol=1e-5, err_msg=f"{k}, step {i}")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    n_tracked = sum(int(m.sum()) for m in tracked.values())
    assert n_tracked > 0.8 * sum(m.numel() for m in tracked.values())


def test_bfloat16_table_matches_jax(syn):
    """``feature_dtype="bfloat16"``: the table's bits equal JAX's, and
    the loss over it (cast back to float32 after the gather) equals
    JAX's under key replay, and differs from the float32 table's."""
    jm, jstate, tm, st = _pair(syn, feature_dtype="bfloat16")
    table = st["consts"]["features"]
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        table.view(torch.int16).numpy(),
        np.asarray(jstate["consts"]["features"]).view(np.int16))
    roots = np.random.default_rng(7).integers(0, SYN["num_nodes"], BATCH)
    jb, tb = _batches(tm, roots.astype(np.int32), 14)
    jloss, _ = jm.make_eval_step()(jstate, jb)
    tloss, _ = tm.make_eval_step()(st, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    f32 = TGAT(**_kw()).build_consts(syn, "cpu")["features"]
    assert not torch.equal(table.to(torch.float32), f32)
    assert jnp.asarray(jstate["consts"]["features"]).dtype == jnp.bfloat16


def test_evaluate_matches_jax_eval_steps(syn):
    """``train.evaluate`` over three batches equals JAX's eval steps over
    the same sequences and parameters, accumulated with the JAX
    package's ``_metric_*`` helpers."""
    jm, jstate, tm, st = _pair(syn, head_num=2)
    rng = np.random.default_rng(8)
    source = [rng.integers(0, SYN["num_nodes"], BATCH) for _ in range(3)]
    got = ttrain.evaluate(tm, syn, source, st, device="cpu", seed=70)
    eval_fn = jm.make_eval_step()
    acc, losses = jtrain._metric_zero("f1"), []
    for i, ids in enumerate(source):
        tb = tm.device_sample_batch(ids, 70 + i, device="cpu")
        seq_ids = st["module"]._seq_ids(tb, st["consts"]).numpy()
        loss, metric = eval_fn(jstate, {"seq_ids": seq_ids})
        acc = jtrain._metric_accumulate("f1", acc, metric)
        losses.append(float(loss))
    np.testing.assert_allclose(got["f1"], jtrain._metric_value("f1", acc),
                               rtol=1e-6)
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=1e-5)


def test_draws_go_through_the_single_hop_wrapper(syn, monkeypatch):
    """make_scan_train on GAT: each step's draw calls the single-hop
    wrapper once with the [B] roots and count nb_num (the wrapper is what
    launches B2 on CUDA tensors; here, on CPU tensors, its plain version
    runs and counts no launch); finite losses, the same from the same
    seeds. Over alias tables the wrapper is not reached."""
    calls = []
    wrapped = sampling_kernels.sample_neighbor

    def counting(*a, **k):
        calls.append((tuple(a[1].shape), a[3]))
        return wrapped(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("an alias draw reached the kernel wrapper")

    runs = []
    for wrapper, alias in ((counting, False), (counting, False),
                           (refuse, True)):
        tm = TGAT(**_kw())
        if alias:
            tm.set_sampling_options(alias=True)
        st = tm.init_state(syn, ttrain.get_optimizer("adam", LR),
                           device="cpu", seed=1)
        scan = ttrain.make_scan_train(tm, 3, BATCH)
        monkeypatch.setattr(sampling_kernels, "sample_neighbor", wrapper)
        runs.append(torch.cat([scan(st, c)[1] for c in range(2)]))
        monkeypatch.undo()
    assert all(torch.isfinite(r).all() and r.shape == (6,) for r in runs)
    assert torch.equal(runs[0], runs[1])
    assert calls == [((BATCH,), NB)] * 12
    assert sampling_kernels.launches == {"sample_fanout2": 0,
                                         "sample_neighbor": 0}


def test_gat_entry_points_default_to_the_card(monkeypatch, syn):
    """init_state and device_sample_batch run on the card unless asked
    for the CPU; device sampling without a device feature table is
    refused; host sampling builds no sampling table."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = ttrain.get_optimizer("adam", LR)
    host = TGAT(**{**_kw(), "device_sampling": False})
    assert host.device_features and not host.device_sampling
    assert sorted(host.build_consts(syn, "cpu")) == ["features", "labels"]
    with pytest.raises(ValueError, match="feature_idx"):
        TGAT(**{**_kw(), "feature_idx": -1})
    m = TGAT(**_kw())
    assert m.edge_type == [0]
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_state(syn, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device_sample_batch([1, 2], seed=0)
    assert sorted(m.sample(syn, [1, 2])) == ["roots", "seed"]
    state = m.init_state(syn, opt, device="cpu")
    assert next(state["module"].parameters()).device.type == "cpu"
    assert state["consts"]["adj"]["et0"]["nbr"].device.type == "cpu"
