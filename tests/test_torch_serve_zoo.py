"""Embedding serving of the whole model zoo (``serve.EmbedServer`` over
each model's ``serving_layout``, ``models/base.py``) against the JAX
package, on the CPU.

Both packages load the same small ``.dat`` graphs (those of
``test_torch_host_sampling.py``), and the JAX model's parameters (and
stores) go into the port's. An id's answer is the one the JAX package
gives for that id alone: its embed step over the id's own
``sample_embed`` block, drawn after ``eg_seed(_id_seed(seed, id))``.
Every row the port serves to mixed traffic from four threads (at
``max_batch=4``, so dispatches join blocks and pad) is held to it within
rtol 1e-5 and atol 1e-6, and equals the port's ``embed_direct`` bit for
bit. SupervisedGCN's blocks, whose sizes differ from id to id, are held
to the JAX blocks with their padding cut, and its buckets split where a
dispatch outgrows their caps. The JAX server's own GCN rows are not the
single-block answer (its leaf-by-leaf concatenation mixes the blocks'
adjacencies; ROADMAP Queue C), and a test pins that. Every thread join
here is bounded.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from euler_tpu import models as jmodels  # noqa: E402
from euler_tpu import serve as jserve  # noqa: E402
from euler_tpu.graph import native as jnative  # noqa: E402

from euler_tpu_torch import convert, serve  # noqa: E402
from euler_tpu_torch import models as tmodels  # noqa: E402
from euler_tpu_torch import train as ttrain  # noqa: E402
from euler_tpu_torch.graph import native as tnative  # noqa: E402
from euler_tpu_torch.models import base as tbase  # noqa: E402
from tests.test_torch_host_sampling import (  # noqa: E402,F401
    CASES,
    HET_N,
    MAX_ID,
    _gcn,
    _inputs,
    _jax_state,
    _models,
    _np,
    _sd,
    graphs,
)

SEED = 42
MAX_BATCH = 4
THREADS = 4
REQUESTS = 12
JOIN_S = 10.0
RTOL, ATOL = 1e-5, 1e-6

# every --model of the JAX CLI that serves, LasGNN and the device-table
# variants of the feature models
SERVED = ["gcn", "gcn_device_features", "scalable_gcn", "scalable_sage",
          "gat", "gat_device_features", "line", "node2vec", "lshne",
          "lasgnn", "saved_embedding"]


_JAX_STATES: dict = {}


def _states(name, jm, tm, jg, tg):
    """The JAX state of case ``name`` (made once a module: its jitted init
    is most of a case's time; a GCN's parameters do not depend on its
    caps) and the port's, with its parameters (and stores)."""
    if name not in _JAX_STATES:
        _JAX_STATES[name] = _jax_state(
            jm, jg, _inputs(CASES[name][4], np.random.default_rng(11)))
    jstate = _JAX_STATES[name]
    st = tm.init_state(tg, ttrain.get_optimizer("adam", 0.01), device="cpu")
    st["module"].load_state_dict(_sd(jstate["params"], name))
    if "stores" in jstate:
        convert.load_stores(st, _np(jstate["stores"]),
                            _np(jstate["grad_stores"]))
    return jstate, st


def _single_block_rows(jm, jg, jstate, ids) -> dict:
    """{id: the JAX embed step's row over that id's own block}."""
    embed = jax.jit(jm.make_embed_step())
    rows = {}
    for nid in ids:
        jnative.lib().eg_seed(serve._id_seed(SEED, int(nid)))
        blk = jm.sample_embed(jg, np.array([nid], np.int64))
        rows[int(nid)] = np.asarray(embed(jstate, blk))[0]
    return rows


def _ids(gname: str, n: int, seed: int) -> list:
    """n distinct ids of the graph, each with a neighbor."""
    top = HET_N if gname == "het" else MAX_ID + 1
    return [int(i) for i in
            np.random.default_rng(seed).choice(np.arange(1, top), n,
                                               replace=False)]


def _traffic(srv, ids, seed: int):
    """REQUESTS requests of 1-3 ids (repeats allowed) from THREADS client
    threads; returns the requests and their rows."""
    rng = np.random.default_rng(seed)
    reqs = [[int(i) for i in rng.choice(ids, rng.integers(1, 4))]
            for _ in range(REQUESTS)]
    rows = [None] * len(reqs)
    errors = []

    def client(k0):
        try:
            for k in range(k0, len(reqs), THREADS):
                rows[k] = srv.embed(reqs[k])
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(repr(e))

    ts = [threading.Thread(target=client, args=(k,))
          for k in range(THREADS)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
        assert not t.is_alive(), "a client did not finish in time"
    assert errors == []
    return reqs, rows


@pytest.mark.parametrize("name", SERVED)
def test_served_rows_are_the_jax_single_block_embeds(graphs, name):
    """Mixed traffic from four threads: every row bit-equal to the port's
    embed_direct and within rtol 1e-5, atol 1e-6 of the JAX embed step
    over the id's own block; one bucket, never changed (strict)."""
    gname = CASES[name][3]
    jg, tg = graphs[gname]
    jm, tm = _models(name)
    jstate, st = _states(name, jm, tm, jg, tg)
    ids = _ids(gname, 6, 5)
    want = _single_block_rows(jm, jg, jstate, ids)
    srv = serve.EmbedServer(tm, tg, st, max_batch=MAX_BATCH, seed=SEED,
                            max_wait_us=2000, strict_bucket=True)
    with srv:
        reqs, rows = _traffic(srv, ids, 9)
    direct = {nid: srv.embed_direct(nid) for nid in ids}
    for req, got in zip(reqs, rows):
        assert got.shape == (len(req), want[ids[0]].shape[0])
        for nid, row in zip(req, got):
            np.testing.assert_array_equal(row, direct[nid])
            np.testing.assert_allclose(row, want[nid], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} id {nid}")
    dev = srv.stats()["devprof"]
    assert (dev["captures"], dev["recaptures"],
            dev["serve_recompiles"]) == (1, 0, 0)


def test_gcn_serving_block_is_the_jax_block_unpadded(graphs):
    """SupervisedGCN's serving block is the JAX sample_embed block of the
    id with each hop's padding cut; the padding it cuts is edges of mask
    0 and the default node's rows."""
    jg, tg = graphs["ppi"]
    jm, tm = _models("gcn")
    for nid in _ids("ppi", 4, 6):
        jb = jm.sample_embed(jg, np.array([nid], np.int64))
        tb = tm.sample_serve_block(tg, nid)
        jl, tl = tbase.batch_leaves(jb), tbase.batch_leaves(tb)
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (path, t), (_, j) in zip(tl, jl):
            assert t.dtype == j.dtype, path
            assert len(t) <= len(j), path
            np.testing.assert_array_equal(t, j[:len(t)], err_msg=str(path))
        for h, adj in enumerate(tb["adjs"]):
            n = len(adj["src"])
            assert adj["mask"].all() and n > 0
            assert not np.asarray(jb["adjs"][h]["mask"])[n:].any()


def _block_caps(tm, tg, ids) -> tuple:
    """Each hop's most nodes and edges over the ids' blocks: caps every
    one block fits."""
    blocks = [tm.sample_serve_block(tg, nid) for nid in ids]
    nodes = [max(len(b["hops"][h + 1]["dense"]) for b in blocks)
             for h in range(2)]
    edges = [max(len(b["adjs"][h]["src"]) for b in blocks)
             for h in range(2)]
    return nodes, edges


def test_gcn_dispatch_past_its_caps_splits(graphs):
    """At caps the largest of eight blocks just fits, one dispatch of the
    eight runs as more forwards than max_batch asks (the largest block
    alone), and its rows are still the JAX single-block embeds and the
    port's embed_direct."""
    jg, tg = graphs["ppi"]
    ids = _ids("ppi", 8, 7)
    nodes, edges = _block_caps(_models("gcn")[1], tg, ids)
    kw = dict(_gcn(), max_nodes_per_hop=nodes, max_edges_per_hop=edges)
    jm, tm = jmodels.SupervisedGCN(**kw), tmodels.SupervisedGCN(**kw)
    jstate, st = _states("gcn", _models("gcn")[0], tm, jg, tg)
    want = _single_block_rows(jm, jg, jstate, ids)
    srv = serve.EmbedServer(tm, tg, st, max_batch=MAX_BATCH, seed=SEED,
                            strict_bucket=True)
    tnative.reset_counters()
    groups = srv._layout.split([srv._block(i) for i in ids])
    assert len(groups) > len(ids) // MAX_BATCH
    assert [len(g) for g in groups if len(g) == 1]
    rows = srv._embed_unique(np.array(ids))
    assert srv.stats()["devprof"]["replays"] == len(groups)
    assert tnative.counters()["serve_batches"] == len(groups) - 1
    for nid, row in zip(ids, rows):
        np.testing.assert_array_equal(row, srv.embed_direct(nid))
        np.testing.assert_allclose(row, want[nid], rtol=RTOL, atol=ATOL)
    assert srv.stats()["devprof"]["captures"] == 1


def test_gcn_over_cap_id_raises_as_the_host_expansion(graphs):
    """One id whose hop 0 outgrows the model's cap raises the host
    expansion's error, in both packages' words."""
    jg, tg = graphs["ppi"]
    kw = dict(_gcn(), max_nodes_per_hop=[2, 4], max_edges_per_hop=[2, 4])
    jm, tm = jmodels.SupervisedGCN(**kw), tmodels.SupervisedGCN(**kw)
    st = tm.init_state(tg, ttrain.get_optimizer("adam", 0.01), device="cpu")
    srv = serve.EmbedServer(tm, tg, st, max_batch=MAX_BATCH, seed=SEED)
    nid = next(i for i in range(MAX_ID + 1)
               if len(np.unique(tg.get_full_neighbor([i], [0])[0])) > 2)
    with pytest.raises(ValueError, match="hop 0") as want:
        jm.sample(jg, np.array([nid]))
    with pytest.raises(ValueError, match="hop 0") as got:
        srv.embed_direct(nid)
    assert str(got.value) == str(want.value)


def test_jax_server_mixes_gcn_blocks_where_the_port_does_not(graphs):
    """The reference's fault (ROADMAP Queue C): the JAX EmbedServer joins
    SupervisedGCN blocks leaf by leaf, so every block's edges land on row
    0 and read block 0's hop arrays; at max_batch 2 its second row is not
    the id's single-block embed. The port's is."""
    jg, tg = graphs["ppi"]
    jm, tm = _models("gcn")
    jstate, st = _states("gcn", jm, tm, jg, tg)
    a, b = _ids("ppi", 2, 8)
    truth = _single_block_rows(jm, jg, jstate, [b])[b]
    jsrv = jserve.EmbedServer(jm, jg, jstate, max_batch=2, seed=SEED)
    jrow = jsrv._forward([jsrv._block(a), jsrv._block(b)])[1]
    assert not np.allclose(jrow, truth, rtol=RTOL, atol=ATOL)
    tsrv = serve.EmbedServer(tm, tg, st, max_batch=2, seed=SEED)
    trow = tsrv._forward([tsrv._block(a), tsrv._block(b)])[1]
    np.testing.assert_allclose(trow, truth, rtol=RTOL, atol=ATOL)


def test_deterministic_segment_sum():
    """Within deterministic_sums a segment's sum is its edges' in edge
    order from 0: bit-equal to index_add's on the CPU (rows and 1-D
    values), empty segments 0, unchanged when other segments' edges come
    before it, and padding edges (mask 0) skipped."""
    from euler_tpu_torch.nn import sparse_aggregators as sa

    g = torch.Generator().manual_seed(0)
    src = torch.randint(0, 50, (400,), generator=g, dtype=torch.int32)
    vals = torch.randn(400, 7, generator=g)
    sink = torch.full((100,), 59, dtype=torch.int32)
    mask = torch.cat([torch.ones(400), torch.zeros(100)])
    with sa.deterministic_sums():
        got = sa._gather_sum(vals, src, 60)
        col = sa._gather_sum(vals[:, 0], src, 60)
        shifted = sa._gather_sum(
            torch.cat([torch.randn(30, 7, generator=g), vals]),
            torch.cat([sink[:30], src]), 60)
        padded = sa._gather_sum(torch.cat([vals, torch.zeros(100, 7)]),
                                torch.cat([src, sink]), 60, mask)
    assert torch.equal(got, torch.zeros(60, 7).index_add(0, src, vals))
    assert torch.equal(col, got[:, 0])
    assert not got[50:].any()
    assert torch.equal(shifted[:50], got[:50])
    assert torch.equal(padded, got)


def test_serve_cli_serves_a_gcn_checkpoint(tmp_path):
    """``run_loop`` trains ``--model gcn``; ``serve.run_serve`` (the serve
    CLI's path, in the inference config) restores it and answers over
    the wire, bit-equal to ``embed_direct``."""
    from euler_tpu_torch import datasets, run_loop
    from euler_tpu_torch.serving import EmbedClient

    data = str(tmp_path / "ppi")
    datasets.build_ppi(data, num_nodes=200, avg_degree=5, feature_dim=6,
                       label_dim=4, max_degree=10, seed=3)
    argv = ["--data_dir", data, "--model_dir", str(tmp_path / "ck"),
            "--model", "gcn", "--max_id", "199", "--feature_idx", "1",
            "--feature_dim", "6", "--label_idx", "0", "--label_dim", "4",
            "--fanouts", "10,10", "--dim", "8", "--batch_size", "64",
            "--num_epochs", "1"]
    run_loop.main(argv, device="cpu")
    args = run_loop.define_flags().parse_args(
        argv + ["--serve_port", "0", "--serve_max_batch", "4"])
    args.mode = "evaluate"
    graph, _ = run_loop.build_graph(args)
    model = run_loop.build_model(args, graph)
    srv, front = serve.run_serve(model, graph, args, "cpu", block=False)
    try:
        client = EmbedClient(front.address, timeout_s=JOIN_S)
        rows = client.embed([12, 15, 12])
        client.close()
        np.testing.assert_array_equal(rows[1], srv.embed_direct(15))
        np.testing.assert_array_equal(rows[0], rows[2])
    finally:
        front.drain(grace_s=1.0)
        srv.close()
        front.stop()
        graph.close()
