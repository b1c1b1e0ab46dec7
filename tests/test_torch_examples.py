"""The port's examples (``euler_tpu_torch/examples/``) on the CPU: the
custom model of ``custom_sage_reddit`` held to the JAX example's on one
host batch of a small Reddit-shaped graph (loss, f1 counts, gradients),
and each example's model through ``train.train`` for two steps on a
small graph. ``main`` builds the full-size graphs, so it is not called
here; ``chip_smoke.py`` runs the examples at their widths on the card."""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from euler_tpu_torch import datasets  # noqa: E402
from euler_tpu_torch.examples import custom_sage_reddit  # noqa: E402
from euler_tpu_torch.examples import sage, sage_reddit  # noqa: E402
from euler_tpu_torch.graph import Graph  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 300  # a few hundred nodes of Reddit's shape
FEATURES = 32  # Reddit's 602 features cut to 32
CLASSES = 41


@pytest.fixture(scope="module")
def reddit_dir(tmp_path_factory):
    return datasets.build_reddit(
        str(tmp_path_factory.mktemp("reddit")), num_nodes=N,
        feature_dim=FEATURES, avg_degree=5)


def _jax_example():
    """The JAX example module, loaded from its path (not edited)."""
    path = REPO / "examples" / "custom_sage_reddit.py"
    spec = importlib.util.spec_from_file_location("jax_custom_sage_reddit",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_custom_sage_matches_the_jax_example(reddit_dir):
    """One host batch from both engines after the same ``eg_seed``; the
    flax parameters carried across by ``params_from_flax``: the loss
    within rtol 1e-5, the f1 counts exactly, every gradient within atol
    1e-5."""
    import euler_tpu
    from euler_tpu.graph import native as jnative

    jex = _jax_example()
    kw = dict(fanouts=[4, 4], dim=64, feature_idx=1, feature_dim=FEATURES,
              label_idx=0, label_dim=CLASSES)
    jm, tm = jex.CustomSage(**kw), custom_sage_reddit.CustomSage(**kw)
    jg, tg = euler_tpu.Graph(directory=reddit_dir), Graph(
        directory=reddit_dir)
    try:
        roots = np.random.default_rng(0).integers(0, N, 64)
        jnative.lib().eg_seed(5)
        jb = jm.sample(jg, roots)
        tnative.lib().eg_seed(5)
        tb = tm.sample(tg, roots)
    finally:
        jg.close()
        tg.close()
    for a, b in zip(jb["hops"] + [jb["labels"]], tb["hops"] + [tb["labels"]]):
        np.testing.assert_array_equal(a, b)

    # jitted: eager flax traces op by op, for seconds
    params = jax.jit(jm.module.init)(jax.random.PRNGKey(0), jb)["params"]

    def loss_fn(p, b):
        out = jm.module.apply({"params": p}, b)
        return out.loss, out.metric

    (jloss, jf1), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jb)
    module = tm.make_module()
    np_params = jax.tree_util.tree_map(np.asarray, params)
    module.load_state_dict(custom_sage_reddit.params_from_flax(np_params))
    out = module(tbase.to_device(tb, "cpu"))
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_array_equal(out.metric.detach().numpy(),
                                  np.asarray(jf1))
    want = custom_sage_reddit.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("example", ["sage", "sage_reddit",
                                     "custom_sage_reddit"])
def test_example_model_trains_two_steps(tmp_path, reddit_dir, example):
    """Each example's model (its widths but the features', labels' and
    ids' counts) through the example's ``fit`` (``train.train``) for two
    steps on the CPU: the window's loss finite, its f1 in [0, 1]."""
    if example == "sage":
        data = datasets.build_ppi(str(tmp_path / "ppi"), num_nodes=N,
                                  feature_dim=8, label_dim=5)
        model = sage.build_model(feature_dim=8, label_dim=5, max_id=N - 1)
    elif example == "sage_reddit":
        data = reddit_dir
        model = sage_reddit.build_model(feature_dim=FEATURES, max_id=N - 1)
    else:
        data = reddit_dir
        model = custom_sage_reddit.build_model(feature_dim=FEATURES)
    graph = Graph(directory=data)
    try:
        _, history = sage.fit(model, graph, 2, 32, 0.01, "cpu")
    finally:
        graph.close()
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert 0.0 <= history[0]["f1"] <= 1.0
