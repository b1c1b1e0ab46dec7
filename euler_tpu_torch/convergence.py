"""The convergence gate (counterpart of ``tests/test_convergence.py``):
does a model that trains also *learn*?

Each case trains one model family to convergence on the planted-community
graph (``datasets.build_planted``: 2,000 nodes, 4 communities, 16-dim
features) and scores it against targets computed from the generator's
arrays, as the JAX package's gate does:

  feat_acc  nearest-centroid accuracy on raw node features (what a
            classifier blind to the graph reaches, ~0.56)
  hop1_acc  the same after averaging each node's 1-hop neighbourhood
            (~0.94): the separability one aggregation layer exposes

Supervised cases gate the micro-F1 of ``train.evaluate`` over every node;
unsupervised ones the MRR of the last training window and the community
accuracy of the exported embeddings (a nearest-centroid fit on even
nodes, scored on odd ones). The model sizes, steps, batches, learning
rates, seeds and thresholds are the JAX file's. ``run_case`` trains and
scores one case on a device (the tests on the CPU, ``chip_smoke.py`` on
the card) and returns its figures beside their floors; ``check`` raises
on a miss.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from euler_tpu_torch import train as train_lib
from euler_tpu_torch.graph import sampling_kernels

MARGIN = 0.08  # slack below hop1_acc: finite training + eval sampling noise
NUM_NODES = 2000
NUM_CLASSES = 4
FEATURE_DIM = 16

SUPERVISED = ("graphsage", "graphsage_device_sampling", "scan_train", "gat",
              "gcn_and_scalable_gcn")
# family -> floor of the embeddings' community accuracy (random = 0.25);
# each family's MRR floor is MRR_FLOOR
UNSUPERVISED = {
    "line2": 0.7,
    "node2vec_biased": 0.9,
    "node2vec_biased_device": 0.9,
    "node2vec_biased_alias": 0.9,
    "unsup_sage": 0.55,
}
MRR_FLOOR = 0.5
CASES = SUPERVISED + tuple(UNSUPERVISED)
# unsup_sage's loss, the reference's -sum(logit - logsumexp(neg_logits)),
# is unbounded below (about -1e13 by step 300 in both packages), and where
# a run lands is chaotic: it clears the JAX floors, settles in a weaker
# mode, or collapses (most ReLUs of the first layer dead, a tenth or more
# of the embedding rows exactly zero, accuracy down to chance), in either
# package: the JAX package's own runs collapse in 6 of 48 seeds. Which it
# does depends on the initial draw, and the two packages draw differently
# from one seed, so one run at seed 42 in each compares two unrelated
# draws. The port's case trains UNSUP_SAGE_RUNS runs, run i from the
# initial parameters of seed 42 + i, holds each to the JAX floors (a
# collapsed run misses them), and asks that the share of runs that clear
# them, and the share that do not collapse, be each no lower than the JAX
# package's share over distinct seeds (JAX_UNSUP_SAGE: its own training,
# init and sampling, one run a seed) less two standard errors of the
# difference of the two shares.
UNSUP_SAGE_RUNS = 16
COLLAPSED_ROWS = NUM_NODES // 10  # a run with this many zero rows collapsed
# the JAX package's case at seeds 100-147 on a CPU, one run a seed
# (python -m tests.unsup_sage_share jax 100 147)
JAX_UNSUP_SAGE = {"runs": 48, "cleared": 40, "collapsed": 6}


def unsup_sage_min_share(jax_count: int) -> float:
    """The share of the UNSUP_SAGE_RUNS unsup_sage runs that must do what
    ``jax_count`` of the JAX package's runs did: the JAX share less two
    standard errors of the difference of the two shares."""
    total = JAX_UNSUP_SAGE["runs"]
    share = jax_count / total
    se = math.sqrt(share * (1 - share) * (1 / UNSUP_SAGE_RUNS + 1 / total))
    return share - 2 * se


@dataclasses.dataclass
class Planted:
    graph: object  # graph.Graph over the planted .dat files
    info: dict  # build_planted's generation arrays
    feat_acc: float
    hop1_acc: float


def planted(out_dir: str) -> Planted:
    """The gate's graph, written to ``out_dir`` (cached there) and opened
    through the engine client, with its two separability bounds. The
    generator must make aggregation the thing that solves the task, or
    the gates prove nothing: feat_acc < 0.7 and hop1_acc > 0.9."""
    from euler_tpu_torch.datasets import (build_planted,
                                          nearest_centroid_accuracy)
    from euler_tpu_torch.graph import Graph

    out_dir, info = build_planted(out_dir)
    feat_acc = nearest_centroid_accuracy(info, use_neighbors=False)
    hop1_acc = nearest_centroid_accuracy(info, use_neighbors=True)
    if not (feat_acc < 0.7 and hop1_acc > 0.9):
        raise AssertionError(f"planted graph: feat_acc {feat_acc:.3f}, "
                             f"hop1_acc {hop1_acc:.3f}")
    return Planted(Graph(directory=out_dir), info, feat_acc, hop1_acc)


class _Launches:
    """The kernel launches (``sampling_kernels.launches``) made inside a
    ``with`` block."""

    def __enter__(self):
        self._before = dict(sampling_kernels.launches)
        return self

    def __exit__(self, *exc):
        self.counts = {k: v - self._before.get(k, 0)
                       for k, v in sampling_kernels.launches.items()}


def _eval_batches() -> list:
    ids = np.arange(NUM_NODES, dtype=np.int64)
    return [ids[i:i + 400] for i in range(0, NUM_NODES, 400)]


def _train_and_eval(model, graph, device, num_steps=300, batch=128,
                    lr=0.01, seed=3) -> tuple:
    """``train.train`` on roots of any type, then ``train.evaluate`` over
    every node in batches of 400; ``(f1, launches while training)``."""

    def source_fn(step):
        return graph.sample_node(batch, -1)

    with _Launches() as launched:
        state, _ = train_lib.train(
            model, graph, source_fn, num_steps=num_steps, learning_rate=lr,
            optimizer="adam", log_every=100, seed=seed, device=device)
    result = train_lib.evaluate(model, graph, _eval_batches(), state,
                                device=device)
    return result["f1"], launched.counts


def _sage(**kw):
    from euler_tpu_torch.models import SupervisedGraphSage

    return SupervisedGraphSage(
        label_idx=0, label_dim=NUM_CLASSES, metapath=[[0], [0]],
        fanouts=[10, 10], dim=32, feature_idx=1, feature_dim=FEATURE_DIM,
        max_id=NUM_NODES - 1, sigmoid_loss=False, **kw)


def _supervised(name: str, p: Planted, device) -> dict:
    """One supervised case: ``{"figures": {...}, "checks": [(label,
    value, floor)], "steps", "launches"}``; a check passes when its
    value is above its floor."""
    feat, hop1 = p.feat_acc + 0.2, p.hop1_acc - MARGIN
    if name in ("graphsage", "graphsage_device_sampling"):
        dev = name.endswith("device_sampling")
        f1, launches = _train_and_eval(
            _sage(device_features=dev, device_sampling=dev), p.graph, device)
        return dict(figures={"f1": f1}, steps=300, launches=launches,
                    checks=[("f1", f1, feat), ("f1", f1, hop1)])
    if name == "scan_train":
        # roots drawn on the card, 50 steps a call, 6 calls
        model = _sage(device_features=True, device_sampling=True)
        state = model.init_state(
            p.graph, train_lib.get_optimizer("adam", 0.01), device=device,
            seed=3)
        scan = train_lib.make_scan_train(model, inner_steps=50,
                                         batch_size=128)
        with _Launches() as launched:
            for chunk in range(6):  # 300 steps
                state, _ = scan(state, chunk)
        f1 = train_lib.evaluate(model, p.graph, _eval_batches(), state,
                                device=device)["f1"]
        return dict(figures={"f1": f1}, steps=300,
                    launches=launched.counts, checks=[("f1", f1, hop1)])
    if name == "gat":
        from euler_tpu_torch.models import GAT

        # single-layer attention over the 1-hop neighbourhood: it must
        # clearly beat the features; hop1_acc is its ceiling
        f1, launches = _train_and_eval(GAT(
            label_idx=0, label_dim=NUM_CLASSES, feature_idx=1,
            feature_dim=FEATURE_DIM, max_id=NUM_NODES - 1, head_num=2,
            hidden_dim=32, nb_num=10, sigmoid_loss=False), p.graph, device)
        return dict(figures={"f1": f1}, steps=300, launches=launches,
                    checks=[("f1", f1, feat)])
    if name == "gcn_and_scalable_gcn":
        from euler_tpu_torch.models import ScalableGCN, SupervisedGCN

        # the full-neighbour GCN and ScalableGCN (stale historical
        # stores, host- and device-sampled) must both learn, the stores
        # costing at most 0.05 F1
        f1_gcn, l1 = _train_and_eval(SupervisedGCN(
            label_idx=0, label_dim=NUM_CLASSES, metapath=[[0], [0]], dim=32,
            # caps sized for the eval batches (400 roots, the whole 2-hop
            # expansion of a mean-degree-10 graph)
            max_nodes_per_hop=[4096, 4096],
            max_edges_per_hop=[16384, 32768],
            feature_idx=1, feature_dim=FEATURE_DIM, max_id=NUM_NODES - 1,
            sigmoid_loss=False), p.graph, device, batch=96)
        scal = dict(label_idx=0, label_dim=NUM_CLASSES, edge_type=[0],
                    num_layers=2, dim=32, max_id=NUM_NODES - 1,
                    max_neighbors=10, feature_idx=1,
                    feature_dim=FEATURE_DIM, sigmoid_loss=False)
        f1_scal, l2 = _train_and_eval(ScalableGCN(**scal), p.graph, device,
                                      batch=96)
        f1_dev, l3 = _train_and_eval(
            ScalableGCN(**scal, device_features=True, device_sampling=True),
            p.graph, device, batch=96)
        launches = {k: l1.get(k, 0) + l2.get(k, 0) + l3.get(k, 0)
                    for k in {**l1, **l2, **l3}}
        return dict(
            figures={"f1_gcn": f1_gcn, "f1_scalable_gcn": f1_scal,
                     "f1_scalable_gcn_device": f1_dev},
            steps=900, launches=launches,
            checks=[("f1_gcn", f1_gcn, feat),
                    ("f1_scalable_gcn", f1_scal, feat),
                    ("f1_scalable_gcn", f1_scal, f1_gcn - 0.05),
                    ("f1_scalable_gcn_device", f1_dev, f1_gcn - 0.05)])
    raise ValueError(f"unknown supervised case {name!r}")


def embedding_community_accuracy(emb, communities) -> float:
    """Nearest-centroid community recovery in embedding space: centroids
    fit from the true communities on even nodes, accuracy on odd nodes.
    Random = 1 / NUM_CLASSES = 0.25."""
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    n = len(communities)
    fit = np.arange(n) % 2 == 0
    centroids = np.stack([emb[fit & (communities == c)].mean(0)
                          for c in range(NUM_CLASSES)])
    pred = (emb[~fit] @ centroids.T).argmax(1)
    return float((pred == communities[~fit]).mean())


def unsupervised_model(family: str):
    """The JAX gate's model of an unsupervised family."""
    from euler_tpu_torch import models

    n = NUM_NODES
    if family == "line2":
        return models.LINE(node_type=-1, edge_type=[0], max_id=n - 1,
                           dim=32, order=2, num_negs=5)
    if family.startswith("node2vec_biased"):
        m = models.Node2Vec(
            node_type=-1, edge_type=[0], max_id=n - 1, dim=32, walk_len=3,
            walk_p=0.5, walk_q=2.0, num_negs=5,
            device_sampling=family != "node2vec_biased")
        if family.endswith("_alias"):
            # the exact rejection walk over flat-CSR alias tables must
            # learn the same structure as the slab walk
            m.set_sampling_options(alias=True)
        return m
    if family == "unsup_sage":
        return models.GraphSage(
            node_type=-1, edge_type=[0], max_id=n - 1,
            metapath=[[0], [0]], fanouts=[5, 5], dim=32, num_negs=5,
            use_id=True, embedding_dim=32)
    raise ValueError(f"unknown unsupervised family {family!r}")


def _unsupervised_run(family: str, p: Planted, device,
                      seed: int = 42) -> tuple:
    """One training of ``family`` from the JAX gate's worker, from the
    initial parameters of ``seed``: ``(mrr of the last window, community
    accuracy, rows of the embeddings that are all zero, steps,
    launches)``."""
    model = unsupervised_model(family)
    steps = 400 if family == "line2" else 300
    with _Launches() as launched:
        state, hist = train_lib.train(
            model, p.graph, lambda s: p.graph.sample_node(128, -1),
            num_steps=steps, learning_rate=0.05, optimizer="adam",
            log_every=200, seed=seed, device=device)
    emb = train_lib.save_embedding(model, NUM_NODES - 1, state,
                                   batch_size=400, device=device,
                                   graph=p.graph)
    acc = embedding_community_accuracy(emb, p.info["communities"])
    zero_rows = int((np.abs(emb).sum(1) == 0).sum())
    return hist[-1]["mrr"], acc, zero_rows, steps, launched.counts


def _unsupervised(family: str, p: Planted, device) -> dict:
    """Id embeddings trained from the graph alone (no input features):
    the MRR of the last window above MRR_FLOOR, and the community
    recoverable from the exported embeddings above the family's floor;
    for unsup_sage, the shares of UNSUP_SAGE_RUNS runs that clear both and
    that do not collapse, each above ``unsup_sage_min_share``."""
    acc_floor = UNSUPERVISED[family]
    if family != "unsup_sage":
        mrr, acc, zero_rows, steps, launches = _unsupervised_run(
            family, p, device)
        return dict(figures={"mrr": mrr, "acc": acc,
                             "zero_rows": zero_rows},
                    steps=steps, launches=launches,
                    checks=[("mrr", mrr, MRR_FLOOR), ("acc", acc, acc_floor)])
    runs = [_unsupervised_run(family, p, device, seed=42 + i)
            for i in range(UNSUP_SAGE_RUNS)]
    mrrs, accs = [r[0] for r in runs], [r[1] for r in runs]
    cleared = sum(m > MRR_FLOOR and a > acc_floor
                  for m, a in zip(mrrs, accs))
    collapsed = sum(r[2] >= COLLAPSED_ROWS for r in runs)
    jax = JAX_UNSUP_SAGE
    launches = {k: sum(r[4].get(k, 0) for r in runs) for k in runs[0][4]}
    return dict(
        figures={"mrr": mrrs, "acc": accs,
                 "zero_rows": [r[2] for r in runs], "cleared": cleared,
                 "collapsed": collapsed},
        steps=sum(r[3] for r in runs), launches=launches,
        checks=[(f"share of {UNSUP_SAGE_RUNS} runs clearing mrr "
                 f"{MRR_FLOOR} and acc {acc_floor}",
                 cleared / UNSUP_SAGE_RUNS,
                 unsup_sage_min_share(jax["cleared"])),
                (f"share of {UNSUP_SAGE_RUNS} runs with fewer than "
                 f"{COLLAPSED_ROWS} zero rows",
                 1 - collapsed / UNSUP_SAGE_RUNS,
                 unsup_sage_min_share(jax["runs"] - jax["collapsed"]))])


def run_case(name: str, p: Planted, device=None) -> dict:
    """Train and score case ``name`` (one of ``CASES``) on ``device``
    (the card unless ``"cpu"`` is asked for). Returns ``{"figures",
    "checks": [(label, value, floor)], "steps", "launches"}``: the
    launches are the kernels' while training (not while scoring)."""
    if name in UNSUPERVISED:
        return _unsupervised(name, p, device)
    return _supervised(name, p, device)


def misses(result: dict) -> list:
    """The checks of a ``run_case`` result whose value is not above its
    floor."""
    return [c for c in result["checks"] if not c[1] > c[2]]


def describe(name: str, result: dict) -> str:
    """Each check's figure beside its floor, one line, then the figures
    of several runs."""
    runs = {k: [round(x, 4) for x in v]
            for k, v in result.get("figures", {}).items()
            if isinstance(v, list)}
    return f"{name}: " + ", ".join(
        f"{label} {value:.4f} (floor {floor:.4f})"
        for label, value, floor in result["checks"]) + (
        f"; runs {runs}" if runs else "")


def check(name: str, result: dict) -> None:
    """Raise ``AssertionError`` when a check of ``result`` misses."""
    if misses(result):
        raise AssertionError("convergence gate missed: "
                             + describe(name, result))
