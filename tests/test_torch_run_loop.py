"""The port's host-sampling path, ``train.train``, ``Checkpointer`` and
``run_loop`` against the JAX package.

Host batches come from each package's engine over the same ``.dat``
files after the same ``eg_seed``, so they are equal array for array;
flax parameters are carried across with ``convert.params_from_flax``.
Tolerances (float32): loss rtol 1e-5; gradients atol 1e-6, rtol 1e-4;
five Adam steps' losses rtol 1e-4, and the parameters after the first
compared where |grad| > 1e-6 (below that the sign of Adam's first step
is noise), atol 1e-5.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import euler_tpu  # noqa: E402
from euler_tpu import datasets as jdatasets  # noqa: E402
from euler_tpu.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from euler_tpu.graph import native as jnative  # noqa: E402
from euler_tpu.models import GraphSage as JUnsup  # noqa: E402
from euler_tpu.models import SupervisedGraphSage as JSage  # noqa: E402

from euler_tpu_torch import run_loop  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from euler_tpu_torch.convert import (params_from_flax,  # noqa: E402
                                     state_from_checkpoint_arrays)
from euler_tpu_torch.graph import Graph  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402
from euler_tpu_torch.models import GraphSage as TUnsup  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage as TSage  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from euler_tpu_torch.parallel import prefetch  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


SYN = dict(num_nodes=200, avg_degree=5, feature_dim=6, label_dim=4,
           max_degree=10, seed=3)
MAX_ID = SYN["num_nodes"] - 1
BATCH = 8
LR = 0.01


def _sup_kw():
    return dict(label_idx=0, label_dim=SYN["label_dim"], metapath=[[0], [0]],
                fanouts=[3, 2], dim=16, feature_idx=1,
                feature_dim=SYN["feature_dim"], max_id=MAX_ID)


def _unsup_kw():
    return dict(node_type=0, edge_type=[0], max_id=MAX_ID,
                metapath=[[0], [0]], fanouts=[3, 2], dim=16, num_negs=3,
                feature_idx=1, feature_dim=SYN["feature_dim"],
                xent_loss=True)


MODELS = {"supervised": (JSage, TSage, _sup_kw),
          "unsupervised": (JUnsup, TUnsup, _unsup_kw)}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("syn"))
    jdatasets.build_synthetic(d, num_partitions=2, **SYN)
    jg, tg = euler_tpu.Graph(directory=d), Graph(directory=d)
    yield jg, tg, d
    jg.close()
    tg.close()


def _roots(seed):
    return np.random.default_rng(seed).integers(0, SYN["num_nodes"], BATCH)


def _batches(jm, tm, jg, tg, seed):
    """The same host batch from both packages' engines after eg_seed."""
    roots = _roots(seed)
    jnative.lib().eg_seed(seed)
    jb = jm.sample(jg, roots)
    tnative.lib().eg_seed(seed)
    tb = tm.sample(tg, roots)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tb, jb)
    return jb, tbase.to_device(tb, "cpu")


def _port_state(tm, tg, jparams):
    st = tm.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu")
    st["module"].load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    return st


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_host_batch_step_matches_flax(graphs, kind):
    """Host-sampled batches are equal in both packages; step 1's loss and
    gradients agree, then five Adam steps track optax."""
    jg, tg, _ = graphs
    jcls, tcls, kw = MODELS[kind]
    jm, tm = jcls(**kw()), tcls(**kw())
    assert not tm.device_sampling and tm.build_consts(tg, "cpu") == {}
    jstate = jm.init_state(jax.random.PRNGKey(0), jg, _roots(0),
                           optax.adam(LR))
    jb, tb = _batches(jm, tm, jg, tg, 1)

    def jloss(p):
        return jm._apply(p, jb, None).loss

    jl, jgrad = jax.value_and_grad(jloss)(jstate["params"])
    st = _port_state(tm, tg, jstate["params"])
    out = st["module"](tb, st["consts"])
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(jl),
                               rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    got = {k: p.grad for k, p in st["module"].named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)

    jstep = jax.jit(jm.make_train_step(optax.adam(LR)))
    tstep = tm.make_train_step()
    st = _port_state(tm, tg, jstate["params"])
    js, jls, tls = jstate, [], []
    for i in range(5):
        jb, tb = _batches(jm, tm, jg, tg, 10 + i)
        js, loss, _ = jstep(js, jb)
        jls.append(float(loss))
        tls.append(float(tstep(st, tb)[0]))
        if i == 0:
            want = params_from_flax(
                jax.tree_util.tree_map(np.asarray, js["params"]))
            for k, p in st["module"].named_parameters():
                mask = p.grad.abs() > 1e-6
                np.testing.assert_allclose(p.detach()[mask].numpy(),
                                           want[k][mask].numpy(), atol=1e-5,
                                           err_msg=k)
    np.testing.assert_allclose(tls, jls, rtol=1e-4)


def test_train_with_prefetch_equals_direct_steps(graphs):
    """train.train (two prefetch workers, batches out of order) gives the
    losses of the same batches stepped directly, in step order."""
    _, tg, _ = graphs
    made = {}

    class Recording(TSage):
        def sample(self, graph, inputs):
            batch = super().sample(graph, inputs)
            made[np.asarray(inputs).tobytes()] = batch
            return batch

    m = Recording(**_sup_kw())
    st, history = ttrain.train(
        m, tg, _roots, num_steps=12, log_every=1, seed=3, device="cpu",
        prefetch_depth=3, prefetch_threads=2)
    assert len(history) == 12 and len(made) == 12
    assert all(h["sample_ms"] >= 0 and h["stalled_steps"] in (0, 1)
               for h in history)
    ref = m.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu",
                       seed=3)
    step = m.make_train_step()
    direct = [float(step(ref, tbase.to_device(
        made[_roots(i).tobytes()], "cpu"))[0]) for i in range(12)]
    np.testing.assert_allclose([h["loss"] for h in history], direct,
                               rtol=1e-6)
    for a, b in zip(st["module"].parameters(), ref["module"].parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_prefetch_keeps_order_and_raises_at_the_failing_step():
    def make(step):
        if step == 5:
            raise KeyError("boom")
        return step

    timings = {}
    got = []
    with pytest.raises(KeyError, match="boom"):
        for b in prefetch(make, 8, depth=2, num_threads=3, start=0,
                          timings=timings):
            got.append(b)
    assert got == [0, 1, 2, 3, 4]
    # the wait for step 5, whose batch is the worker's error, counts too
    assert len(timings["input_stall"]) == 6
    assert list(prefetch(lambda s: s, 4, num_threads=1, start=10)) == [
        10, 11, 12, 13]


def _trained_state(tg, seed=0, kw=_sup_kw):
    m = TSage(**kw())
    st = m.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu",
                      seed=seed)
    step = m.make_train_step()
    tnative.lib().eg_seed(seed)
    step(st, tbase.to_device(m.sample(tg, _roots(seed)), "cpu"))
    return m, st


def test_checkpoint_round_trip_excludes_consts(graphs, tmp_path):
    """save/restore gives back the module and Adam's state; the device
    tables are not in the file and the live ones are kept."""
    _, tg, _ = graphs
    dev_kw = dict(_sup_kw(), device_features=True, device_sampling=True)
    m = TSage(**dev_kw)
    st = m.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu")
    m.make_train_step()(st, m.device_sample_batch(_roots(0), 1, "cpu"))
    ck = Checkpointer(str(tmp_path / "c"))
    ck.save(5, st)
    with pytest.raises(ValueError, match="already exists"):
        ck.save(5, st)
    saved = torch.load(tmp_path / "c" / "5" / "state.pt", weights_only=True)
    assert sorted(saved) == ["module", "optimizer"]
    fresh = m.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu",
                         seed=9)
    consts = fresh["consts"]
    got = Checkpointer(str(tmp_path / "c")).restore(fresh)
    assert got["consts"] is consts and ck.latest_step() == 5
    for a, b in zip(got["module"].state_dict().values(),
                    st["module"].state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = got["optimizer"].state_dict(), st["optimizer"].state_dict()
    for k in sb["state"]:
        for name, v in sb["state"][k].items():
            assert torch.equal(sa["state"][k][name], v)
    for s in (6, 7, 8):
        ck.save(s, st)
    assert ck.all_steps() == [6, 7, 8]


def test_checkpoint_loud_errors(graphs, tmp_path):
    """An empty directory, a missing step and a structure mismatch raise
    ValueError naming what is there, as the JAX Checkpointer does."""
    _, tg, _ = graphs
    m, st = _trained_state(tg)
    empty = str(tmp_path / "never_trained")
    with pytest.raises(ValueError, match="no checkpoint in .*never_trained"):
        Checkpointer(empty).restore(st)
    with pytest.raises(ValueError, match="--model_dir"):
        Checkpointer(empty).restore(st)
    ck = Checkpointer(str(tmp_path / "c"))
    ck.save(5, st)
    with pytest.raises(ValueError,
                       match=r"no checkpoint for step 7 .*available steps: "
                             r"\[5\]"):
        ck.restore(st, step=7)
    other = TUnsup(**_unsup_kw()).init_state(
        tg, ttrain.get_optimizer("adam", LR), device="cpu")
    with pytest.raises(ValueError,
                       match="does not match the provided state_like"):
        ck.restore(other, step=5)


def test_state_from_jax_checkpoint_evaluates_like_jax(graphs, tmp_path):
    """A JAX Checkpointer save, restored and turned to numpy, loads into a
    port state whose loss on a host batch equals the JAX model's."""
    jg, tg, _ = graphs
    jm, tm = JSage(**_sup_kw()), TSage(**_sup_kw())
    jstate = jm.init_state(jax.random.PRNGKey(4), jg, _roots(0),
                           optax.adam(LR))
    ck = JCheckpointer(str(tmp_path / "j"))
    ck.save(1, jstate, force=True)
    ck.wait()
    restored = jax.tree_util.tree_map(np.asarray, ck.restore(jstate))
    ck.close()
    st = tm.init_state(tg, ttrain.get_optimizer("adam", LR), device="cpu",
                       seed=1)
    st = state_from_checkpoint_arrays(restored, st)
    jb, tb = _batches(jm, tm, jg, tg, 2)
    want = jm._apply(jstate["params"], jb, None)
    got = tm.make_eval_step()(st, tb)
    np.testing.assert_allclose(float(got[0]), float(want.loss), rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.metric))


COMMON = [
    "--max_id", "16", "--feature_idx", "0", "--feature_dim", "2",
    "--label_idx", "2", "--label_dim", "3", "--train_edge_type", "0,1",
    "--all_edge_type", "0,1", "--fanouts", "3,2", "--dim", "8",
    "--batch_size", "8", "--num_epochs", "4", "--log_steps", "2",
]


def _args(fixture_dir, model_dir, *extra):
    return ["--data_dir", fixture_dir, "--model_dir", model_dir] + COMMON + \
        list(extra)


# every --model of the JAX CLI: its held-out metric and embedding width
# at COMMON's sizes (gat's embedding is its logits, lshne's dim is 128)
CLI_MODELS = {
    "graphsage_supervised": ("f1", 8), "graphsage": ("mrr", 8),
    "gcn": ("f1", 8), "scalable_gcn": ("f1", 8), "scalable_sage": ("f1", 8),
    "gat": ("f1", 3), "line": ("mrr", 8), "node2vec": ("mrr", 8),
    "lshne": ("mrr", 128), "saved_embedding": ("f1", 8),
}


def _cycle(fixture_dir, tmp_path, model, *flags):
    """train, evaluate, save_embedding on one --model_dir, then a
    relaunch that resumes at the last step and trains nothing new; the
    checks of each mode's output. saved_embedding classifies the export
    of a graphsage_supervised run first."""
    if model == "saved_embedding":
        src = str(tmp_path / "src")
        for mode in ("train", "save_embedding"):
            run_loop.main(_args(fixture_dir, src, "--mode", mode),
                          device="cpu")
        flags += ("--embedding_file", os.path.join(src, "embedding.npy"))
    ck = str(tmp_path / "ck")
    args = ["--model", model, *flags]
    for mode in ("train", "evaluate", "save_embedding", "train"):
        assert run_loop.main(_args(fixture_dir, ck, *args, "--mode", mode),
                             device="cpu") == 0
    assert Checkpointer(ck).latest_step() == run_loop._num_steps(
        run_loop.define_flags().parse_args(COMMON)) == 8
    with open(os.path.join(ck, "eval.json")) as f:
        import json

        result = json.load(f)
    metric, width = CLI_MODELS[model]
    assert 0.0 <= result[metric] <= 1.0 and result["model"] == model
    emb = np.load(os.path.join(ck, "embedding.npy"))
    assert emb.shape == (17, width) and np.isfinite(emb).all()
    ids = np.loadtxt(os.path.join(ck, "id.txt"), dtype=np.int64)
    assert len(ids) == 17


@pytest.mark.parametrize("device_sampling", ["0", "1"])
@pytest.mark.parametrize("model", sorted(CLI_MODELS))
def test_train_eval_save_cycle(fixture_dir, tmp_path, model,
                               device_sampling):
    """run_loop.main on the CPU at the CLI's defaults, every --model,
    host-sampled and with --device_sampling 1, as tests/test_run_loop.py
    runs the JAX CLI."""
    _cycle(fixture_dir, tmp_path, model, "--device_sampling",
           device_sampling)


@pytest.mark.parametrize("model", ["graphsage_supervised", "graphsage",
                                   "gcn", "scalable_gcn", "scalable_sage",
                                   "gat"])
def test_host_sampling_over_device_tables_cycle(fixture_dir, tmp_path,
                                                model):
    """--device_features 1 without --device_sampling: host-sampled node
    sets, features and labels read from the tables on the device."""
    _cycle(fixture_dir, tmp_path, model, "--device_features", "1")


def test_save_embedding_is_the_restored_states(fixture_dir, tmp_path):
    """--mode save_embedding writes train.save_embedding of the restored
    state, the engine RNG seeded from --seed."""
    ck = str(tmp_path / "ck")
    for mode in ("train", "save_embedding"):
        run_loop.main(_args(fixture_dir, ck, "--mode", mode), device="cpu")
    args = run_loop.define_flags().parse_args(
        _args(fixture_dir, ck, "--mode", "save_embedding"))
    graph, _ = run_loop.build_graph(args)
    model = run_loop.build_model(args, graph)
    state = run_loop._restore_state(model, graph, args, "cpu")
    want = ttrain.save_embedding(model, 16, state, batch_size=8,
                                 device="cpu", graph=graph)
    np.testing.assert_array_equal(np.load(os.path.join(ck, "embedding.npy")),
                                  want)


@pytest.mark.parametrize("extra,item", [
    (["--stream", "1"], "A0e"),
    (["--graph_mode", "remote", "--stream", "1"], "A0e"),
    (["--compile_cache", "1"], "A11"),
    (["--compile_cache", "0"], "A11"),
    (["--optimizer", "sgd"], "A4"),
])
def test_unported_flags_raise(fixture_dir, tmp_path, extra, item,
                              monkeypatch):
    """The flags of ROADMAP items A0e, A11 and A4, which raised until
    they were ported: ``--stream`` (a local directory read into memory),
    ``--compile_cache`` (1: the kernels' build cache; 0: this launch's
    own build directory) and ``--optimizer sgd`` train; ``--stream`` off
    a local graph raises the JAX CLI's ValueError."""
    from euler_tpu_torch import _build

    ck = str(tmp_path / "ck")
    if "--graph_mode" in extra:
        with pytest.raises(ValueError, match="--stream is only supported "
                           "with --graph_mode=local"):
            run_loop.main(_args(fixture_dir, ck, *extra), device="cpu")
        return
    monkeypatch.setattr(_build, "_build_dir", _build.BUILD_DIR)
    assert run_loop.main(_args(fixture_dir, ck, *extra), device="cpu") == 0
    assert Checkpointer(ck).latest_step() is not None
    launch_dir = os.path.dirname(_build.library_path())
    if extra == ["--compile_cache", "0"]:
        assert os.path.dirname(launch_dir) == _build.BUILD_DIR
        assert os.path.basename(launch_dir).startswith("launch-")
        _build.set_compile_cache(None)
        shutil.rmtree(launch_dir)
    else:
        assert launch_dir == _build.BUILD_DIR


@pytest.mark.parametrize("extra", [
    ["--metrics_file", "m.jsonl"],
    ["--metrics_every", "5"],
    ["--trace_file", "t.json"],
    ["--serve_after", "1", "--trace_file", "t.json"],
    ["--postmortem_dir", "pm"],
    ["--profile_dir", "prof"],
    ["--telemetry", "0", "--blackbox", "0", "--devprof", "0"],
])
def test_observability_flags_pass_check_flags(fixture_dir, tmp_path, extra):
    """The observability flags are ported: check_flags lets them
    through (run_loop's own runs of them are in
    test_torch_observability.py)."""
    args = run_loop.define_flags().parse_args(
        _args(fixture_dir, str(tmp_path / "ck"), *extra))
    run_loop.check_flags(args)
    assert not hasattr(run_loop, "_DEFAULT_ON")


def test_entry_points_default_to_the_card(fixture_dir, tmp_path,
                                          monkeypatch, graphs):
    """With no card, main, train.train and to_device raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_loop.main(_args(fixture_dir, str(tmp_path / "ck")))
    assert not os.path.exists(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train(TSage(**_sup_kw()), graphs[1], _roots, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbase.to_device({"x": np.zeros(2)})
