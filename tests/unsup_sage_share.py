"""The share of unsup_sage runs that clear the convergence gate's floors
(MRR 0.5, community accuracy 0.55), in either package, one run a seed:

    python -m tests.unsup_sage_share jax 100 147
    python -m tests.unsup_sage_share port 42 57
    python -m tests.unsup_sage_share jax_from_port 42 42 24
    python -m tests.unsup_sage_share pair 10 33
    python -m tests.unsup_sage_share init 0 7

``jax`` trains the JAX package's case as the worker of
``tests/test_convergence.py`` does (its model, ``train.train`` at the
seed, its engine client); ``port`` the port's through
``euler_tpu_torch.convergence`` on the CPU; ``jax_from_port`` the JAX
package's training from the port's initial parameters of the seed
(``repeat`` runs a seed, the optional third number); ``pair`` the JAX
step and the port's step side by side from the JAX initial parameters
of the seed on the same host batches, each run scored; ``init`` trains
nothing and prints, for each parameter, the std of both packages'
initial draws over the seeds. Every run scores
the exported embeddings with the port's scorer on the same planted graph
and prints its seed, MRR (the last window's; for ``pair`` the mean of
steps 200-299), accuracy and the embedding rows that are all zero; the
last lines the runs that cleared and that collapsed.
``convergence.JAX_UNSUP_SAGE`` records the JAX shares. Start several
processes over parts of the seed range to use more cores."""

import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

STEPS = 300
LR = 0.05


def _jax_model():
    from euler_tpu import models

    return models.GraphSage(
        node_type=-1, edge_type=[0], max_id=1999, metapath=[[0], [0]],
        fanouts=[5, 5], dim=32, num_negs=5, use_id=True, embedding_dim=32)


def _flax_tree(like, state_dict):
    """The flax parameter tree shaped as ``like`` holding the port's
    ``state_dict``: each leaf's key found by carrying a marker through
    ``convert.params_from_flax`` (Dense kernels come back transposed)."""
    import jax
    import numpy as np

    from euler_tpu_torch import convert

    leaves, treedef = jax.tree_util.tree_flatten(like)
    out = []
    for i in range(len(leaves)):
        mark = [np.zeros(np.shape(x), np.float32) for x in leaves]
        mark[i] = np.arange(1, mark[i].size + 1,
                            dtype=np.float32).reshape(mark[i].shape)
        sd = convert.params_from_flax(jax.tree_util.tree_unflatten(treedef,
                                                                   mark))
        (key, got), = [(k, v.numpy()) for k, v in sd.items() if v.any()]
        value = state_dict[key].numpy()
        out.append(value if np.array_equal(got, mark[i]) else value.T)
    return jax.tree_util.tree_unflatten(
        treedef, [jax.numpy.asarray(np.ascontiguousarray(v)) for v in out])


def _jax_run(graph_dir: str, seed: int, port_init=None) -> tuple:
    import jax
    import numpy as np
    import optax

    import euler_tpu
    from euler_tpu import train as train_lib

    graph = euler_tpu.Graph(directory=graph_dir)
    m = _jax_model()
    state = None
    if port_init is not None:
        state = m.init_state(jax.random.PRNGKey(0), graph,
                             graph.sample_node(128, -1), optax.adam(LR))
        params = _flax_tree(state["params"], port_init)
        state = {"params": params, "opt_state": optax.adam(LR).init(params)}
    state, hist = train_lib.train(
        m, graph, lambda s: graph.sample_node(128, -1), num_steps=STEPS,
        learning_rate=LR, optimizer="adam", log_every=200, seed=seed,
        state=state)
    emb = np.asarray(train_lib.save_embedding(m, graph, 1999, state,
                                              batch_size=400))
    return float(hist[-1]["mrr"]), emb


def _pair(p, seed: int) -> list:
    """The JAX step and the port's from the JAX init of ``seed`` on the
    same host batches: ``[(mrr, emb) of JAX, (mrr, emb) of the port]``."""
    import jax
    import numpy as np
    import optax
    import torch

    from euler_tpu_torch import convergence, convert
    from euler_tpu_torch import train as train_lib

    jm = _jax_model()
    m = convergence.unsupervised_model("unsup_sage")
    first = m.sample(p.graph, p.graph.sample_node(128, -1))
    params = jax.jit(jm.module.init)(jax.random.PRNGKey(seed),
                                     first)["params"]
    js = {"params": params, "opt_state": optax.adam(LR).init(params)}
    jstep = jax.jit(jm.make_train_step(optax.adam(LR)))
    st = m.init_state(p.graph, train_lib.get_optimizer("adam", LR),
                      device="cpu")

    def load(jparams):
        st["module"].load_state_dict(convert.params_from_flax(
            jax.tree_util.tree_map(np.asarray, jparams)))

    load(params)
    step = m.make_train_step()
    mrrs = ([], [])
    for i in range(STEPS):
        b = m.sample(p.graph, p.graph.sample_node(128, -1))
        js, _, jmrr = jstep(js, b)
        _, tmrr = step(st, {k: [{f: torch.from_numpy(np.asarray(a))
                                 for f, a in h.items()} for h in v]
                            for k, v in b.items()})
        if i >= STEPS - 100:
            mrrs[0].append(float(jmrr))
            mrrs[1].append(float(tmrr))

    def export():
        return train_lib.save_embedding(m, 1999, st, batch_size=400,
                                        device="cpu", graph=p.graph)

    port_emb = export()
    load(js["params"])
    return [(float(np.mean(mrrs[0])), export()),
            (float(np.mean(mrrs[1])), port_emb)]


def _init_stds(p, seeds) -> None:
    """Each parameter's std over the initial draws of ``seeds``, the JAX
    package's (carried across by ``convert.params_from_flax``) beside the
    port's."""
    import jax
    import numpy as np

    from euler_tpu_torch import convergence, convert
    from euler_tpu_torch import train as train_lib

    m = convergence.unsupervised_model("unsup_sage")
    first = m.sample(p.graph, p.graph.sample_node(128, -1))
    init = jax.jit(_jax_model().module.init)
    draws = {"jax": {}, "port": {}}
    for seed in seeds:
        sd = {"jax": convert.params_from_flax(jax.tree_util.tree_map(
                  np.asarray, init(jax.random.PRNGKey(seed), first)["params"])),
              "port": m.init_state(p.graph, train_lib.get_optimizer(
                  "adam", LR), device="cpu", seed=seed)["module"].state_dict()}
        for name, params in sd.items():
            for k, v in params.items():
                draws[name].setdefault(k, []).append(v.numpy().ravel())
    for k in sorted(draws["port"]):
        j, t = (np.concatenate(draws[n][k]) for n in ("jax", "port"))
        print(f"{k} std jax {j.std():.5f} port {t.std():.5f} "
              f"({t.size} values)", flush=True)


def main(argv=None) -> int:
    args = (argv or sys.argv[1:])
    mode, first, last = args[:3]
    repeat = int(args[3]) if len(args) > 3 else 1
    import numpy as np
    import torch

    from euler_tpu_torch import convergence
    from euler_tpu_torch import train as train_lib

    torch.set_num_threads(1)
    graph_dir = os.path.join(tempfile.gettempdir(),
                             "unsup_sage_share_planted")
    p = convergence.planted(graph_dir)
    if mode == "init":
        _init_stds(p, range(int(first), int(last) + 1))
        return 0
    floor = convergence.UNSUPERVISED["unsup_sage"]
    names = ["jax", "port"] if mode == "pair" else [mode]
    cleared = dict.fromkeys(names, 0)
    collapsed = dict.fromkeys(names, 0)
    runs = 0

    def score(emb):
        return (convergence.embedding_community_accuracy(
            emb, p.info["communities"]), int((np.abs(emb).sum(1) == 0).sum()))

    for seed in range(int(first), int(last) + 1):
        for _ in range(repeat):
            if mode == "pair":
                results = _pair(p, seed)
            elif mode == "port":
                mrr, acc, zero_rows, _, _ = convergence._unsupervised_run(
                    "unsup_sage", p, "cpu", seed=seed)
                results = None
            else:
                init = None
                if mode == "jax_from_port":
                    init = convergence.unsupervised_model(
                        "unsup_sage").init_state(
                        p.graph, train_lib.get_optimizer("adam", LR),
                        device="cpu", seed=seed)["module"].state_dict()
                results = [_jax_run(graph_dir, seed, init)]
            runs += 1
            for name, r in zip(names, results or [None]):
                if r is not None:
                    mrr, (acc, zero_rows) = r[0], score(r[1])
                cleared[name] += mrr > convergence.MRR_FLOOR and acc > floor
                collapsed[name] += zero_rows >= convergence.COLLAPSED_ROWS
                print(f"{name} seed {seed} mrr {mrr:.4f} acc {acc:.3f} "
                      f"zero_rows {zero_rows}", flush=True)
    for name in names:
        print(f"{name}: {cleared[name]} of {runs} runs cleared mrr "
              f"{convergence.MRR_FLOOR} and acc {floor}, {collapsed[name]} "
              f"collapsed ({convergence.COLLAPSED_ROWS} or more zero rows)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
