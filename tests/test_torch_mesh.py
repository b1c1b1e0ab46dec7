"""The port's multi-device training (``euler_tpu_torch.parallel.mesh``)
against the JAX package's mesh (``euler_tpu.parallel``), on the CPU.

The JAX side runs in this process on the conftest's 8 virtual CPU
devices. The port's ranks run as processes of one gloo group on the CPU
(``tests.conftest.run_worker_processes``, each wait bounded): the same
host batches and JAX's initial parameters go in, and the losses,
parameters and stores come out for comparison.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

from euler_tpu.graph import native as jnative  # noqa: E402
from euler_tpu.graph import pallas_sampling  # noqa: E402
from euler_tpu.models import ScalableSage as JScalable  # noqa: E402
from euler_tpu.models import SupervisedGraphSage as JSage  # noqa: E402
from euler_tpu.parallel import mesh as jmesh  # noqa: E402

from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.graph import Graph  # noqa: E402
from euler_tpu_torch.graph import sampling_kernels  # noqa: E402
from euler_tpu_torch.models import ScalableSage as TScalable  # noqa: E402
from euler_tpu_torch.models import SupervisedGraphSage as TSage  # noqa: E402
from euler_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from tests.conftest import free_port, run_worker_processes  # noqa: E402

# parity tolerances: losses of the same steps, and float32 stores after
# two steps of both optimizers
LOSS_RTOL = 1e-5
STORE_ATOL = 1e-6
STORE_RTOL = 1e-5
LR = 0.01
BATCH = 8
# each worker's wait (they run a few steps on a 7-node graph)
WORKER_TIMEOUT_S = 120


def _sage_kw():
    # tests/test_model_parallel.py's _model sizes
    return dict(label_idx=2, label_dim=3, metapath=[[0, 1], [0, 1]],
                fanouts=[3, 2], dim=8, feature_idx=0, feature_dim=2,
                max_id=16, device_features=True)


def _scalable_kw():
    return dict(label_idx=2, label_dim=3, edge_type=[0, 1], fanout=3,
                num_layers=2, dim=8, max_id=16, feature_idx=0,
                feature_dim=2, device_features=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_states(graph):
    """JAX initial states of SupervisedGraphSage and ScalableSage on the
    fixture graph, as numpy trees (each use puts its own copy on the
    devices)."""
    opt = optax.adam(LR)
    return {"sage": _np(JSage(**_sage_kw()).init_state(
                jax.random.PRNGKey(0), graph, np.arange(4), opt)),
            "scalable": _np(JScalable(**_scalable_kw()).init_state(
                jax.random.PRNGKey(1), graph, np.arange(4), opt))}


# ---- the grid ----


def test_mesh_grid_matches_jax():
    """``make_mesh(8, 2)`` is data 4 x model 2 and ``make_mesh(6, 4)``
    raises, as in the JAX package; each rank's grid position, batch
    slice and table rows are those of JAX's device at that place."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jm = jmesh.make_mesh(8, model_parallel=2)
    tm = tmesh.make_mesh(8, 2)
    assert tm.shape == dict(jm.shape) == {"data": 4, "model": 2}
    for make in (lambda: jmesh.make_mesh(6, model_parallel=4),
                 lambda: tmesh.make_mesh(6, 4)):
        with pytest.raises(ValueError):
            make()
    for mp in (2, 4):
        jm = jmesh.make_mesh(8, model_parallel=mp)
        grid = np.vectorize(lambda d: d.id)(jm.devices)
        batch = NamedSharding(jm, P("data")).devices_indices_map((16,))
        # 18 table rows pad to 18 at model 2 and to 20 at model 4
        padded = 18 + (-18) % mp
        rows = NamedSharding(jm, P("model")).devices_indices_map(
            (padded, 3))
        for dev in jm.devices.reshape(-1):
            r = dev.id
            m = tmesh.Mesh(8, mp, rank=r)
            assert tuple(np.argwhere(grid == r)[0]) == m.coords()
            assert batch[dev][0] == m.batch_slice(16)
            assert (rows[dev][0].start, rows[dev][0].stop) == (
                m.row_range(18))
            assert set(m.peers("data")) == {
                int(i) for i in grid[:, m.model_rank]}
            assert set(m.peers("model")) == {
                int(i) for i in grid[m.data_rank, :]}
    with pytest.raises(ValueError, match="divisible"):
        tm.batch_slice(6)


@pytest.mark.parametrize("kind", ["sage", "scalable"])
def test_pad_tables_and_is_table_match_jax(jax_states, fixture_dir, kind):
    """Over the same model's state, the port and the JAX package call the
    same leaves tables, and both pad them from 18 rows to 20 at
    ``model_parallel`` 4; the parameters are left as they are."""
    jcls, tcls, kw = {"sage": (JSage, TSage, _sage_kw),
                      "scalable": (JScalable, TScalable, _scalable_kw)}[kind]
    jstate = jax_states[kind]
    tg = Graph(directory=fixture_dir)
    try:
        tstate = tcls(**kw()).init_state(
            tg, ttrain.get_optimizer("adam", LR), device="cpu")
    finally:
        tg.close()

    def key(k):
        return getattr(k, "key", getattr(k, "idx", None))

    jtables, jall = [], []
    for path, x in jax.tree_util.tree_leaves_with_path(jstate):
        keys = tuple(key(k) for k in path)
        if keys[0] in tmesh._TABLE_KEYS:
            jall.append((keys, x))
            if jmesh._is_table(path, x):
                jtables.append(keys)
    for keys, x in jall:
        assert tmesh._is_table(keys, x) == (keys in jtables), keys
    assert sorted(p for p, _ in tmesh.table_leaves(tstate)) == sorted(
        jtables)
    jmp = jmesh.make_mesh(8, model_parallel=4)
    jpad = jmesh.pad_tables_for_mesh(jstate, jmp)
    tpad = tmesh.pad_tables_for_mesh(tstate, tmesh.Mesh(8, 4))
    for path, x in tmesh.table_leaves(tstate):
        assert x.shape[0] == 18
    for (path, x), (_, y) in zip(tmesh.table_leaves(tpad),
                                 tmesh.table_leaves(tstate)):
        want = jpad
        for k in path:
            want = want[k]
        assert tuple(x.shape) == tuple(want.shape) == (20, *y.shape[1:])
        np.testing.assert_array_equal(x[:18].numpy(), y.numpy())
        assert not x[18:].any()
    assert tpad["module"] is tstate["module"]
    assert jax.tree.structure(jpad["params"]) == jax.tree.structure(
        jstate["params"])


def test_padded_jax_stores_load_into_row_shards(jax_states, fixture_dir):
    """A JAX ScalableSage state padded for a 4-wide model axis
    (``pad_tables_for_mesh``: 18 store rows become 20) loads through
    ``convert.state_from_checkpoint_arrays`` into each rank's row-sharded
    port state: rank r holds rows 5r..5r+4 of the padded stores."""
    from euler_tpu_torch.convert import state_from_checkpoint_arrays

    jpad = jmesh.pad_tables_for_mesh(jax_states["scalable"],
                                     jmesh.make_mesh(8, model_parallel=4))
    tg = Graph(directory=fixture_dir)
    try:
        for r in range(4):
            mesh = tmesh.Mesh(4, 4, rank=r)
            st = TScalable(**_scalable_kw()).init_state(
                tg, ttrain.get_optimizer("adam", LR), device="cpu",
                mesh=mesh)
            state_from_checkpoint_arrays(_np(jpad), st)
            for name in ("stores", "grad_stores"):
                (shard,) = st[name]
                assert tuple(shard.shape) == (20, 8)
                np.testing.assert_array_equal(
                    shard.local.numpy(), jpad[name][0][5 * r:5 * r + 5])
    finally:
        tg.close()


# ---- the sharded draws ----


def _recorded_words(sharded, n_shards: int):
    """The seed words each shard's body passes its ``draw_fn``, recorded
    into the draw's output on a ``n_shards``-device CPU mesh."""
    import jax.numpy as jnp

    mesh = jmesh.make_mesh(n_shards)
    seed = jnp.asarray([123456789, -987654321], jnp.int32)
    adj = {"nbr": jnp.zeros((4, 2), jnp.int32)}
    nodes = jnp.arange(n_shards, dtype=jnp.int32)
    if sharded == "neighbor":
        out = pallas_sampling.sample_neighbor_sharded(
            adj, nodes, seed, 2, mesh,
            draw_fn=lambda a, n, s, c: jnp.broadcast_to(s, (n.shape[0], 2)))
    else:
        out, _ = pallas_sampling.sample_fanout2_sharded(
            adj, adj, nodes, seed, 2, 1, mesh,
            draw_fn=lambda a1, a2, r, s, f1, f2: (
                jnp.broadcast_to(s, (r.shape[0], 2)),
                jnp.zeros((r.shape[0] * f1, f2), jnp.int32)))
    return (np.asarray(seed).view(np.uint32).tolist(),
            np.asarray(out).view(np.uint32).tolist())


@pytest.mark.parametrize("sharded", ["neighbor", "fanout2"])
def test_folded_seed_words_match_jax(sharded):
    """Each rank's folded seed words are those the JAX package's sharded
    bodies pass the kernel on a 4-shard CPU mesh, and the port's sharded
    routes pass them to their ``draw_fn``."""
    seed, per_shard = _recorded_words(sharded, 4)
    got = []
    for r in range(4):
        words = sampling_kernels.folded_words(seed, r)
        assert list(words) == per_shard[r]
        mesh = tmesh.Mesh(4, rank=r)
        nodes = torch.zeros(3, dtype=torch.int32)
        if sharded == "neighbor":
            sampling_kernels.sample_neighbor_sharded(
                None, nodes, seed, 2, mesh,
                draw_fn=lambda a, n, w, c, hop: got.append(w))
        else:
            sampling_kernels.sample_fanout2_sharded(
                None, None, nodes, seed, 2, 1, mesh,
                draw_fn=lambda a1, a2, n, w, f1, f2: got.append(w))
    assert [list(w) for w in got] == per_shard


def test_cpu_mesh_draws_equal_one_device():
    """On CPU tensors under a kernel mesh, each rank draws its rows from
    the global batch's uniforms: the ranks' picks, joined, are one
    device's over the whole batch, for the chained and single-hop
    draws."""
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import MemoryGraph
    from euler_tpu_torch.graph import device as tdev

    g = MemoryGraph(**build_synthetic(300, 6, 4, 3, seed=2))
    adj = tdev.tensors(tdev.build_adjacency(g, [0], 299), "cpu")
    roots = torch.as_tensor(np.random.default_rng(0).integers(
        -1, 302, 12).astype(np.int32))
    words = (77, 99)
    one = tdev.sample_fanout([adj, adj], roots, [3, 2], words)
    one_nb = tdev.neighbor_draw(adj, roots, 4, words, hop=2)
    parts, parts_nb = [], []
    try:
        for r in range(3):
            tdev.set_kernel_mesh(tmesh.Mesh(3, rank=r))
            local = roots[4 * r:4 * (r + 1)]
            parts.append(tdev.sample_fanout([adj, adj], local, [3, 2],
                                            words))
            parts_nb.append(tdev.neighbor_draw(adj, local, 4, words, hop=2))
    finally:
        tdev.set_kernel_mesh(None)
    for h in range(3):
        np.testing.assert_array_equal(
            torch.cat([p[h] for p in parts]).numpy(), one[h].numpy())
    np.testing.assert_array_equal(torch.cat(parts_nb).numpy(),
                                  one_nb.numpy())
    assert tdev.kernel_mesh() is None


def test_worker_seed_fold_matches_jax(graph, jax_states, monkeypatch):
    """The prefetch workers' engine seeds: the JAX package's ``seed *
    1_000_003 + process_index * 8_191 + widx + 1``, recorded from its
    ``train``, and the port's ``worker_seed`` on data rows 0-3."""
    from euler_tpu import train as jtrain
    from euler_tpu.graph import native as jnative_mod

    seen = []
    real = jnative_mod.lib()

    class Lib:
        """The engine library, its ``eg_seed`` calls recorded."""

        def eg_seed(self, s):
            seen.append(int(s))
            real.eg_seed(s)

        def __getattr__(self, name):
            return getattr(real, name)

    monkeypatch.setattr(jnative_mod, "lib", Lib)
    jtrain.train(JSage(**_sage_kw()), graph,
                 lambda step: np.arange(10, 10 + BATCH), num_steps=1,
                 seed=7, state=jax_states["sage"], prefetch_threads=2,
                 log_every=1, learning_rate=LR, mesh=jmesh.make_mesh(1))
    assert sorted(seen) == [ttrain.worker_seed(7, 0, w) for w in (0, 1)]
    for rank in range(4):
        for w in range(3):
            assert ttrain.worker_seed(7, rank, w) == (
                7 * 1_000_003 + rank * 8_191 + w + 1)


# ---- one 2-process gloo group on the CPU ----

_WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from euler_tpu_torch import train
from euler_tpu_torch.convert import load_stores, params_from_flax
from euler_tpu_torch.graph import Graph
from euler_tpu_torch.models import ScalableSage, SupervisedGraphSage, base
from euler_tpu_torch.parallel import mesh as M

pid, addr, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = pickle.load(open(path, "rb"))
backend, dev = M.init_distributed(addr, 2, pid, "cpu")
g = Graph(directory=job["dir"])
res = {"backend": backend}

def port_state(cls, kw, params, mesh, opt="adam"):
    st = cls(**kw).init_state(g, train.get_optimizer(opt, job["lr"]),
                              device="cpu")
    st["module"].load_state_dict(params_from_flax(params))
    return st

for mp in (1, 2):
    mesh = M.make_mesh(2, mp)
    model = SupervisedGraphSage(**job["sage_kw"])
    st = M.shard_state(port_state(SupervisedGraphSage, job["sage_kw"],
                                  job["sage_params"], mesh), mesh)
    step = model.make_train_step(mesh)
    losses = []
    for b in job["sage_batches"]:
        local = base.to_device(M.shard_batch(b, mesh, job["batch"]), "cpu")
        losses.append(float(step(st, local)[0]))
    res[mp] = {"losses": losses,
               "params": {k: v.numpy() for k, v in
                          st["module"].state_dict().items()},
               "features": st["consts"]["features"].local.numpy()
               if mp > 1 else None}

# the same steps at model 2 under optax's adagrad
mesh = M.make_mesh(2, 2)
st = M.shard_state(port_state(SupervisedGraphSage, job["sage_kw"],
                              job["sage_params"], mesh, "adagrad"), mesh)
step = SupervisedGraphSage(**job["sage_kw"]).make_train_step(mesh)
res["adagrad"] = [
    float(step(st, base.to_device(M.shard_batch(b, mesh, job["batch"]),
                                  "cpu"))[0])
    for b in job["sage_batches"]]

res["scalable"] = {}
for mp in (1, 2):
    mesh = M.make_mesh(2, mp)
    model = ScalableSage(**job["scalable_kw"])
    st = port_state(ScalableSage, job["scalable_kw"],
                    job["scalable_params"], mesh)
    load_stores(st, job["stores"], job["grad_stores"])
    st = M.shard_state(st, mesh)
    step = model.make_train_step(mesh)
    losses = [
        float(step(st, base.to_device(M.shard_batch(b, mesh, job["batch"]),
                                      "cpu"))[0])
        for b in job["scalable_batches"]]
    st = M.full_tables(st)  # the whole padded stores at model 2
    res["scalable"][mp] = {
        "losses": losses,
        "stores": [s.numpy() for s in st["stores"]],
        "grad_stores": [s.numpy() for s in st["grad_stores"]]}
g.close()
M.shutdown_distributed()
pickle.dump(res, open(path + f".{pid}", "wb"))
"""


def _host_batches(model, graph, roots_list, seed0):
    out = []
    for i, roots in enumerate(roots_list):
        jnative.lib().eg_seed(seed0 + i)
        out.append(_np(model.sample(graph, np.asarray(roots))))
    return out


def _jax_mesh_steps(model, state, batches, mp, opt=None):
    mesh = jmesh.make_mesh(2, model_parallel=mp)
    if opt is None:
        opt = optax.adam(LR)
    else:  # the state's moments are adam's: start the given optimizer's
        state = dict(state, opt_state=opt.init(state["params"]))
    state = jmesh.pad_tables_for_mesh(state, mesh)
    shardings = jmesh.state_sharding(mesh, state)
    state = jax.device_put(state, shardings)
    rep = jmesh.replicated_sharding(mesh)
    step = jax.jit(model.make_train_step(opt),
                   in_shardings=(shardings, jmesh.batch_sharding(mesh)),
                   out_shardings=(shardings, rep, rep))
    losses = []
    for b in batches:
        state, loss, _ = step(state, jmesh.shard_batch(b, mesh))
        losses.append(float(loss))
    return state, losses


@pytest.fixture(scope="module")
def gloo_run(graph, jax_states, fixture_dir, tmp_path_factory):
    """The JAX mesh runs and the port's 2-rank gloo group on the same
    parameters and host batches (roots with ids shared across the two
    data halves, so the stores' writes meet duplicates across ranks)."""
    rng = np.random.default_rng(5)
    roots = [rng.integers(10, 17, BATCH) for _ in range(3)]
    roots[0][:2] = roots[0][BATCH // 2:BATCH // 2 + 2]
    sage, scal = JSage(**_sage_kw()), JScalable(**_scalable_kw())
    s0, c0 = jax_states["sage"], jax_states["scalable"]
    sage_batches = _host_batches(sage, graph, roots, 100)
    scal_batches = _host_batches(scal, graph, roots[:2], 200)
    jax_losses = {mp: _jax_mesh_steps(sage, s0, sage_batches, mp)[1]
                  for mp in (1, 2)}
    jax_losses["adagrad"] = _jax_mesh_steps(sage, s0, sage_batches, 2,
                                            optax.adagrad(LR))[1]
    scal_jax = {mp: _jax_mesh_steps(scal, c0, scal_batches, mp)
                for mp in (1, 2)}
    job = dict(dir=fixture_dir, lr=LR, batch=BATCH, sage_kw=_sage_kw(),
               scalable_kw=_scalable_kw(), sage_params=_np(s0["params"]),
               scalable_params=_np(c0["params"]), stores=_np(c0["stores"]),
               grad_stores=_np(c0["grad_stores"]),
               sage_batches=sage_batches, scalable_batches=scal_batches)
    path = str(tmp_path_factory.mktemp("gloo") / "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    addr = f"127.0.0.1:{free_port()}"
    run_worker_processes(_WORKER, [(pid, addr, path) for pid in (0, 1)],
                         timeout=WORKER_TIMEOUT_S)
    ranks = []
    for pid in (0, 1):
        with open(f"{path}.{pid}", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(jax=jax_losses,
                scal={mp: (_np(end), losses)
                      for mp, (end, losses) in scal_jax.items()},
                ranks=ranks, features=_np(s0["consts"]["features"]))


@pytest.mark.parametrize("mp", [1, 2])
def test_gloo_sage_matches_jax_mesh(gloo_run, mp):
    """SupervisedGraphSage over two gloo ranks (data 2, or model 2 with
    the feature and label tables row-sharded) from JAX's parameters:
    three steps' losses equal JAX's mesh run within rtol 1e-5, and the
    two ranks end with identical parameters."""
    r0, r1 = (r[mp] for r in gloo_run["ranks"])
    assert gloo_run["ranks"][0]["backend"] == "gloo"
    np.testing.assert_allclose(r0["losses"], gloo_run["jax"][mp],
                               rtol=LOSS_RTOL)
    assert r0["losses"] == r1["losses"]
    assert sorted(r0["params"]) == sorted(r1["params"])
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
    if mp == 2:  # each rank holds half of the padded rows
        full = np.concatenate([r0["features"], r1["features"]])
        want = np.pad(gloo_run["features"], [(0, 0), (0, 0)])
        assert r0["features"].shape[0] == 9
        np.testing.assert_array_equal(full, want)


def test_gloo_sage_adagrad_matches_jax_mesh(gloo_run):
    """``--optimizer adagrad`` over the mesh: the same three steps at
    model 2 under the port's optax-exact Adagrad track JAX's mesh run
    under ``optax.adagrad`` within rtol 1e-5, equal on both ranks."""
    r0, r1 = (r["adagrad"] for r in gloo_run["ranks"])
    np.testing.assert_allclose(r0, gloo_run["jax"]["adagrad"],
                               rtol=LOSS_RTOL)
    assert r0 == r1
    assert r0 != gloo_run["ranks"][0][2]["losses"]  # not adam's


@pytest.mark.parametrize("mp", [1, 2])
def test_gloo_scalable_stores_match_jax_mesh(gloo_run, mp):
    """ScalableSage from JAX's parameters and stores, at data 2 (a root
    shared by the two data halves keeps the later half's row) and at
    model 2 (the stores row-sharded: reads summed over the model group,
    each rank writing and adding only the rows it owns): after two steps
    the losses equal JAX's mesh run within rtol 1e-5, and both ranks'
    whole padded stores and grad-stores equal JAX's within float32
    tolerance."""
    r0, r1 = (r["scalable"][mp] for r in gloo_run["ranks"])
    end, losses = gloo_run["scal"][mp]
    np.testing.assert_allclose(r0["losses"], losses, rtol=LOSS_RTOL)
    assert r0["losses"] == r1["losses"]
    for name in ("stores", "grad_stores"):
        for a, b, want in zip(r0[name], r1[name], end[name]):
            assert a.shape == want.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, want, atol=STORE_ATOL,
                                       rtol=STORE_RTOL)


# ---- the dryrun and the CLI ----


def test_dryrun_multichip_two_ranks():
    """The port of the JAX package's multichip dryrun: two gloo ranks on
    the CPU at ``model_parallel`` 2 train the full step with the feature
    and label tables row-sharded; the loss falls over 10 steps (the
    dryrun raises otherwise), and device sampling and ScalableSage step
    to finite losses."""
    res = tmesh.dryrun_multichip(2, model_parallel=2, timeout_s=240)
    assert len(res["host"]) == 10
    assert len(res["device_sampling"]) == len(res["scalable"]) == 2


@pytest.mark.slow
def test_dryrun_multichip_four_ranks():
    """The dryrun at the JAX package's default: four ranks, data 2 x
    model 2."""
    res = tmesh.dryrun_multichip(4, timeout_s=300)
    assert res["host"][-1] < res["host"][0]


_CLI = ["--max_id", "16", "--feature_idx", "0", "--feature_dim", "2",
        "--label_idx", "2", "--label_dim", "3", "--train_edge_type", "0,1",
        "--all_edge_type", "0,1", "--fanouts", "3,2", "--dim", "8",
        "--batch_size", "8", "--num_epochs", "2", "--log_steps", "2"]


@pytest.mark.parametrize("extra,entry", [
    (["--model_parallel", "2"], "run_loop"),
    (["--num_devices", "3", "--model_parallel", "2"], "run_loop"),
    (["--num_devices", "4", "--model_parallel", "3"], "serve"),
])
def test_mesh_flags_that_do_not_divide_raise(fixture_dir, tmp_path, extra,
                                             entry):
    """A mesh whose counts do not divide raises ``ValueError`` before any
    rank starts, as the JAX package's ``make_mesh`` does: one CPU device
    at ``--model_parallel 2``, three devices at 2, four at 3."""
    from euler_tpu_torch import run_loop, serve

    main = run_loop.main if entry == "run_loop" else serve.main
    match = "not divisible"
    with pytest.raises(ValueError, match=match):
        main(["--data_dir", fixture_dir, "--model_dir", str(tmp_path),
              *_CLI, *extra], device="cpu")


# the serve flags of a --serve_after run (a free port each; max_batch 4)
_SERVE = ["--serve_after", "1", "--serve_port", "0", "--serve_max_batch", "4"]


def _reference_server(fixture_dir, model_dir, *extra):
    """``serve.main``'s restore of ``model_dir`` (the inference config, a
    host-sampling model, tables padded for ``--model_parallel``), as an
    in-process server on the CPU, with the graph it reads."""
    from euler_tpu_torch import run_loop, serve

    args = run_loop.define_flags().parse_args(
        ["--data_dir", fixture_dir, "--model_dir", model_dir, *_CLI,
         *extra])
    args.mode = "evaluate"
    graph, _ = run_loop.build_graph(args)
    return serve.build_server(run_loop.build_model(args, graph), graph, args,
                              "cpu"), graph


def test_serve_after_mesh_restores_the_padded_checkpoint(fixture_dir,
                                                         tmp_path):
    """``--serve_after`` over a mesh (``run_loop.serve_after_mesh``, here
    in-process with ``block=False``) restores the checkpoint rank 0 of a
    ``--model_parallel 2`` run writes, ScalableSage's 19-row store
    (``--max_id 17``) padded to 20, and serves rows bit-equal to those of
    ``serve.main``'s restore of it, over the wire."""
    from euler_tpu_torch import run_loop
    from euler_tpu_torch.checkpoint import Checkpointer
    from euler_tpu_torch.serving import EmbedClient

    ck = str(tmp_path / "ck")
    model_flags = ["--max_id", "17", "--model", "scalable_sage",
                   "--device_features", "1", "--num_devices", "2",
                   "--model_parallel", "2"]
    args = run_loop.define_flags().parse_args(
        ["--data_dir", fixture_dir, "--model_dir", ck, *_CLI, *model_flags,
         *_SERVE])
    graph, _ = run_loop.build_graph(args)
    try:
        state = run_loop.build_model(args, graph).init_state(
            graph, ttrain.get_optimizer("adam", 0.01), device="cpu", seed=3)
    finally:
        graph.close()
    state = tmesh.pad_tables_for_mesh(state, 2)
    assert [tuple(s.shape) for s in state["stores"]] == [(20, 8)]
    Checkpointer(ck).save(7, state)

    server, frontend, g, services = run_loop.serve_after_mesh(
        args, "cpu", block=False)
    ref, ref_graph = _reference_server(fixture_dir, ck, *model_flags)
    try:
        np.testing.assert_array_equal(server._state["stores"][0].numpy(),
                                      state["stores"][0].numpy())
        ids = [0, 3, 16, 3, 9, 12, 1]
        client = EmbedClient(frontend.address, timeout_s=10)
        try:
            rows = client.embed(ids)
        finally:
            client.close()
        want = np.stack([ref.embed_direct(i) for i in ids])
        assert rows.shape == (len(ids), 8) and np.isfinite(rows).all()
        np.testing.assert_array_equal(rows, want)
    finally:
        frontend.stop()
        server.close()
        g.close()
        run_loop.stop_services(services)
        ref.close()
        ref_graph.close()


def test_serve_after_refuses_a_shared_graph_over_processes(fixture_dir,
                                                           tmp_path):
    """Under ``--coordinator_addr`` process 0 serves after the others
    exit, and over ``--graph_mode shared`` their shards leave with them:
    that raises ``ValueError`` before any process joins."""
    from euler_tpu_torch import run_loop

    with pytest.raises(ValueError, match="shards stop with them"):
        run_loop.main(["--data_dir", fixture_dir, "--model_dir",
                       str(tmp_path), *_CLI, "--graph_mode", "shared",
                       "--registry", "tcp://127.0.0.1:1",
                       "--coordinator_addr", "127.0.0.1:1",
                       "--num_processes", "2", *_SERVE], device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("launch", ["num_devices", "coordinator_addr"])
def test_serve_after_two_ranks_serves_until_sigterm(fixture_dir, tmp_path,
                                                    launch):
    """``python -m euler_tpu_torch --model_parallel 2 --device_sampling 1
    --serve_after 1`` over two gloo ranks on the CPU, spawned by
    ``--num_devices 2`` or as two ``--coordinator_addr`` processes: the
    ranks train, then the launching process (or process 0, the other
    exiting 0) serves their padded checkpoint, host-sampled as
    ``serve.main --device_sampling 0 --device_features 1`` serves it,
    rows bit-equal to that restore's, and drains to exit 0 on SIGTERM."""
    import signal
    import subprocess
    import sys
    import time

    from euler_tpu_torch.serving import EmbedClient

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    ck = str(tmp_path / "ck")
    code = ("import sys\n"
            "from euler_tpu_torch import run_loop\n"
            "sys.exit(run_loop.main(sys.argv[1:], device='cpu'))\n")
    argv = [sys.executable, "-c", code, "--data_dir", fixture_dir,
            "--model_dir", ck, *_CLI, "--model_parallel", "2",
            "--device_sampling", "1", "--serve_after", "1", "--serve_port",
            str(port), "--serve_max_batch", "4"]
    if launch == "num_devices":
        ranks = [argv + ["--num_devices", "2"]]
    else:
        coord = f"127.0.0.1:{free_port()}"
        ranks = [argv + ["--coordinator_addr", coord, "--num_processes",
                         "2", "--process_id", str(i)] for i in range(2)]
    procs = [subprocess.Popen(
        a, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=repo), cwd=repo) for a in ranks]
    server = procs[0]
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        client = None
        while time.monotonic() < deadline:
            assert server.poll() is None, server.communicate()[0][-3000:]
            try:
                client = EmbedClient(f"127.0.0.1:{port}", timeout_s=10)
                break
            except OSError:
                time.sleep(0.2)
        assert client is not None, "the server never came up"
        ids = [1, 5, 16, 5, 0, 11]
        rows = client.embed(ids)
        client.close()
        ref, ref_graph = _reference_server(
            fixture_dir, ck, "--num_devices", "2", "--model_parallel", "2",
            "--device_sampling", "0", "--device_features", "1")
        try:
            want = np.stack([ref.embed_direct(i) for i in ids])
        finally:
            ref.close()
            ref_graph.close()
        np.testing.assert_array_equal(rows, want)
        for p in procs[1:]:
            assert p.wait(60) == 0, p.communicate()[0][-3000:]
        server.send_signal(signal.SIGTERM)
        out, _ = server.communicate(timeout=60)
        assert server.returncode == 0, out[-3000:]
        assert "serve SLO at exit" in out
        if launch == "num_devices":
            assert out.count("kernel launches") == 2  # one line a rank
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)


def _cycle(fixture_dir, model_dir, *extra):
    from euler_tpu_torch import run_loop

    for mode in ("train", "evaluate", "save_embedding"):
        assert run_loop.main(["--data_dir", fixture_dir, "--model_dir",
                              model_dir, *_CLI, *extra, "--mode", mode],
                             device="cpu") == 0
    with open(os.path.join(model_dir, "eval.json")) as f:
        import json

        result = json.load(f)
    return result, np.load(os.path.join(model_dir, "embedding.npy"))


@pytest.mark.slow
@pytest.mark.parametrize("device_sampling", ["0", "1"])
def test_run_loop_two_ranks_against_one(fixture_dir, tmp_path,
                                        device_sampling):
    """``--num_devices 2`` spawns two gloo ranks on the CPU, which train,
    checkpoint (rank 0 writes), evaluate and export like one process: the
    same files, of the same shapes, with finite values, and the ranks'
    checkpoint restores into a single-device state."""
    from euler_tpu_torch import run_loop
    from euler_tpu_torch.checkpoint import Checkpointer

    flags = ["--device_sampling", device_sampling, "--device_features", "1"]
    one, emb1 = _cycle(fixture_dir, str(tmp_path / "one"), *flags)
    two, emb2 = _cycle(fixture_dir, str(tmp_path / "two"), *flags,
                       "--num_devices", "2")
    assert sorted(one) == sorted(two) and 0.0 <= two["f1"] <= 1.0
    assert emb1.shape == emb2.shape == (17, 8)
    assert np.isfinite(emb2).all()
    ck = Checkpointer(str(tmp_path / "two"))
    assert ck.latest_step() == Checkpointer(
        str(tmp_path / "one")).latest_step()
    args = run_loop.define_flags().parse_args(
        ["--data_dir", fixture_dir, "--model_dir", str(tmp_path / "two"),
         *_CLI, *flags, "--mode", "save_embedding"])
    graph, _ = run_loop.build_graph(args)
    try:
        state = run_loop._restore_state(run_loop.build_model(args, graph),
                                        graph, args, "cpu")
    finally:
        graph.close()
    assert all(bool(torch.isfinite(p).all())
               for p in state["module"].parameters())


@pytest.mark.slow
def test_cli_scalable_checkpoint_round_trip_model_parallel(fixture_dir,
                                                           tmp_path):
    """A Scalable model trained over four ranks at ``--model_parallel 4``
    (18-row tables pad to 20, 5 rows a rank) checkpoints its whole padded
    stores, evaluates and exports under the same flags, and
    ``serve.restore_serving_state`` reads the padded checkpoint into one
    process (tests/test_model_parallel.py's JAX round trip)."""
    import torch as _torch

    from euler_tpu_torch import run_loop, serve

    ck = str(tmp_path / "ck")
    flags = ["--model", "scalable_sage", "--device_features", "1",
             "--num_devices", "4", "--model_parallel", "4"]
    result, emb = _cycle(fixture_dir, ck, *flags)
    assert emb.shape == (17, 8) and np.isfinite(emb).all()
    from euler_tpu_torch.checkpoint import Checkpointer

    step = str(Checkpointer(ck).latest_step())
    saved = _torch.load(os.path.join(ck, step, "state.pt"),
                        weights_only=True)
    assert [tuple(s.shape) for s in saved["stores"]] == [(20, 8)]
    args = run_loop.define_flags().parse_args(
        ["--data_dir", fixture_dir, "--model_dir", ck, *_CLI, *flags])
    graph, _ = run_loop.build_graph(args)
    try:
        state = serve.restore_serving_state(
            run_loop.build_model(args, graph), graph, args, "cpu")
    finally:
        graph.close()
    np.testing.assert_array_equal(state["stores"][0].numpy(),
                                  saved["stores"][0].numpy())
