#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (nonzero exit, no result line):

1. Environment: torch, CUDA, nvcc, triton, the card's name and power
   limit. TF32 is switched off for matmuls and cuDNN.
2. Build: the port's CUDA kernels from ``euler_tpu_torch/csrc/``.
3. Kernels vs plain, on the full synthetic PPI graph (56,944 nodes), for
   the chained two-hop draw ``sample_fanout2`` (B1) and the single-hop
   draw ``sample_neighbor`` (B2):
   (a) B1 at the ppi shape (512 roots, [10, 10]) equals
   ``sample_fanout2_reference`` exactly, with injected uniforms and with
   Philox, on roots that include a negative id, an id past the slab, the
   default row and zero-weight rows; (b) Philox hop-1 pick frequencies of
   four fixed rows over 10^5 draws each match the ``cum`` probabilities
   within a total variation distance of 0.03, and every pick is a real
   neighbor of its row or the default; (c) B1, its plain version and a
   ``torch.multinomial`` yardstick, timed with CUDA events;
   (d) B2 equals ``sample_neighbor_reference`` exactly at [512, 1] (the
   unsupervised positives) and at [5,120, 10] (a hop-2 shape), with
   injected and Philox uniforms, on the same kinds of odd roots;
   (e) B1 equals two chained B2 launches (hop 0 on the roots, hop 1 on the
   hop-1 picks) bit for bit, so the shared draw routine is shared;
   (f) B2's pick frequencies as in (b); (g) B2, its plain version and a
   ``torch.multinomial`` yardstick at both shapes; (h) B1 equals its plain
   version with Philox uniforms at 2,560 roots (the unsupervised
   negatives' fanout), and is timed there as in (c); (i) both kernels
   equal their plain versions with Philox uniforms on synthetic slabs
   of width 128 and 1,024 (rows of random degree up to the width), each
   timed warm; (j) on the synthetic Reddit graph at ``bench.py``'s shape
   (232,965 nodes, W = 60), B1 at the reddit shape (1,000 roots, [4, 4])
   equals its plain version with injected and Philox uniforms on the same
   kinds of odd roots, and is timed as in (c); (k) the alias draw (plain
   PyTorch, no kernel) on CUDA tensors equals the same draw on CPU
   tensors bit for bit, single hop and a [4, 4] fanout with Philox
   uniforms, on a 9,000-node power-law graph with hub rows, and launches
   no kernel; (l) ``random_walk`` at node2vec's shape (15,360 walkers,
   walk_len 5) over the weighted ppi slab on CUDA tensors equals the same
   walk on CPU tensors bit for bit, on the same kinds of odd roots, with
   exactly five B2 launches, and B2 is timed at [15,360, 1] as in (g);
   (m) the biased walks, plain PyTorch, no kernel: the 2-step joint of
   ``biased_random_walk`` (10^5 walkers from one root of the sorted
   slab) matches the analytic node2vec joint within a TVD of 0.03 for
   (p, q) = (4, 0.25) and (0.25, 4); at 15,360 walkers its CUDA and CPU
   picks are compared (float32 cumsums may round apart: the differing
   picks are counted, every pick must be a legal transition); and
   ``alias_biased_random_walk`` over (k)'s graph's sorted alias tables
   equals the same walk on CPU tensors bit for bit. Each kernel time is
   taken warm (``ms``), with the L2 cache flushed by a 128 MiB write
   before each launch (``ms_cold``), and beside ``floor_ms``, an empty
   kernel at the kernel's grid under the same timer, and ``bound_ms``,
   the least time the card could take for the draws of this run
   (``draw_bound``).
4. Train, each path with the launch counts set to 0 just before it and
   read just after: a small model agrees between CPU (plain draws) and
   CUDA (kernels) step for step; then ``SupervisedGraphSage`` at full ppi
   width (dim 256, batch 512, fanouts [10, 10], Adam 0.01) trains through
   ``train.make_scan_train`` with B1 launched once per step. The same for
   the unsupervised ``GraphSage`` (the JAX package's ``run_loop --model
   graphsage`` defaults: dim 256, fanouts [10, 10], batch 512, 5
   negatives, concat, sigmoid cross-entropy, Adam 0.01): B2 once per step
   (the positives) and B1 three times (the fanouts of roots, positives
   and negatives). Then the GCN family, each after a small CPU/CUDA
   agreement, none launching B1 or B2 (gathers, a sort, cumsums and
   segment sums, as in the JAX package): ``SupervisedGCN`` at ``run_loop
   --model gcn --device_sampling``'s defaults (dim 256, metapath [[0],
   [0]], caps [5,120, 51,200], batch 512, sigmoid loss, Adam 0.01, roots
   drawn on the card each step) with the mean (gcn), gcn (gcn_gcnagg) and
   attention (gcn_attention, 4 heads of 64) aggregators, after one
   batch's expansion is printed hop by hop against its caps and
   ``multi_hop_neighbor`` is timed alone; and ``ScalableGCN`` at
   ``--model scalable_gcn``'s (2 layers, slab rows of 10, store lr 0.001,
   store init 0.05) through ``train.make_scan_train``, printing its
   stores' bytes. Each prints the aggregated (real, masked-in) edges a
   step and their rate. Then ``bench.py``'s reddit recipe (batch 1,000,
   fanouts [4, 4], dim 64, Adam 0.03, 602 features, 41 one-hot labels,
   sigmoid loss): reddit (B1 once per step), reddit_bf16 (the same with a
   bfloat16 feature table) and reddit_heavytail (the power-law graph at
   114.6M edges over alias tables: no kernel launch), each printing its
   build times, its tables' bytes on the card and the peak of allocated
   device memory. Then the walk models (the JAX package's ``run_loop
   --model node2vec --device_sampling`` and ``--model line`` defaults:
   dim 256, id embeddings, combiner add, 5 negatives, sigmoid
   cross-entropy, Adam 0.01), Node2Vec and LINE each after a small
   CPU/CUDA agreement: node2vec (walk_len 5, windows 5/5, 15,360 roots a
   step: B2 five times a step at [15,360, 1]), node2vec_biased (p 4, q
   0.25 over the sorted slab: no kernel), line (order 1, 512 roots: B2
   once a step at [512, 1]) and node2vec_heavytail (node2vec_biased's
   recipe on reddit_heavytail's graph over sorted alias tables: the exact
   rejection walk, no kernel), each printing walk edges and pairs a step
   with their rates and the launches a step.
5. The ``kernels`` line; then the final ``ok`` line. Each phase prints
   its wall time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PPI_BATCH = 512
PPI_FANOUTS = (10, 10)
PPI_DIM = 256
PPI_LR = 0.01
# bench.py's reddit recipe (bench.py:106-130, 608-625)
REDDIT_BATCH = 1000
REDDIT_FANOUTS = (4, 4)
REDDIT_DIM = 64
REDDIT_LR = 0.03
# phase 3 (k)'s power-law graph: hub_degree is max(2048, n // 64) = 2048
# and d_cap n // 4 = 2,250, so the largest rows are hubs
ALIAS_CHECK = dict(num_nodes=9000, num_edges=270_000, feature_dim=8,
                   label_dim=4)
SAGE_NEGS = 5
# run_loop --model node2vec's defaults (run_loop.py:91-102, 141-144,
# 570-584, 725): walk_len 5, windows 5 and 5 (30 pairs a root), and
# --batch_size 512 times those 30 pairs: 15,360 roots a step
N2V_WALK_LEN = 5
N2V_WINDOW = 5
N2V_ROOTS = PPI_BATCH * 30
# the JAX package's biased-walk settings (p, q), both sides of 1
BIASED_PQ = ((4.0, 0.25), (0.25, 4.0))
BIASED_WALKERS = 100_000
CHUNK_STEPS = 20
TIMED_CHUNKS = 4
TVD_BOUND = 0.03
# the single-hop draw's shapes: the unsupervised positives, and a hop-2
# shape of the ppi fanout (512 * 10 rows, 10 draws each)
B2_SHAPES = ((PPI_BATCH, 1), (PPI_BATCH * PPI_FANOUTS[0], PPI_FANOUTS[1]))
# the chained draw's root counts: the ppi batch, and the unsupervised
# negatives' fanout (512 * 5)
B1_ROOTS = (PPI_BATCH, PPI_BATCH * SAGE_NEGS)
# slab widths past the main paths' W = 32 held exact in phase 3 (i): a
# staged draw of 4 slots a lane, and the widest, 32 slots a lane (64 KB
# of shared memory a block, past the default 48 KB)
WIDE_WIDTHS = (128, 1024)
# a write of this many bytes evicts the slab from the H100's 50 MB L2
FLUSH_BYTES = 128 << 20
# NVIDIA H100 SXM data-sheet peaks (700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, runs: int = 100, warmup: int = 10, batch: int = 10,
            before=None) -> float:
    """Median device milliseconds of ``fn()`` over ``runs`` event-timed
    runs. A spin kernel (~20 ms per run) holds the card while the host
    enqueues each batch of runs, so every event pair times the device's
    work and not the host's launch overhead. A batch must stay within
    the card's queue of about a thousand pending launches. ``before()``,
    if given, runs ahead of each event pair, outside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(0, runs, batch):
        torch.cuda._sleep(40_000_000 * batch)
        pairs = []
        for _ in range(batch):
            if before is not None:
                before()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        times += [a.elapsed_time(b) for a, b in pairs]
    return statistics.median(times)


def phase_env() -> str:
    log("== phase 1: environment")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the card only")
    from euler_tpu_torch import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1]}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    smi = smi_line()
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


def phase_build() -> None:
    log("== phase 2: build")
    from euler_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"built {_build.library_path()} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "error")):
            log(f"  ptxas: {line.strip()}")


def weighted_variant(data: dict, zero_rows, seed: int) -> dict:
    """The graph with random edge weights in [0.1, 1) and every edge of
    ``zero_rows`` weighted 0 (neighbors kept, no sampling mass)."""
    rng = np.random.default_rng(seed)
    out = dict(data)
    w = rng.uniform(0.1, 1.0, len(data["indices"])).astype(np.float32)
    for r in zero_rows:
        w[data["indptr"][r]:data["indptr"][r + 1]] = 0.0
    out["weights"] = w
    return out


def check_members(adj: dict, rows, picks) -> None:
    """Every pick is a neighbor of its row (within the row's degree) or
    the default id."""
    n_rows, width = adj["nbr"].shape
    rows = torch.where(rows < 0, n_rows - 1, rows.clamp(max=n_rows - 1)).long()
    nbr = adj["nbr"][rows]                              # [M, W]
    in_deg = torch.arange(width, device=nbr.device) < adj["deg"][rows][:, None]
    hit = ((nbr[:, None, :] == picks[:, :, None]) & in_deg[:, None, :]).any(-1)
    ok = hit | (picks == n_rows - 1)
    if not bool(ok.all()):
        raise AssertionError(
            f"{int((~ok).sum())} picks are not neighbors of their rows")


def phase_kernel(seed: int):
    log("== phase 3: kernel vs plain")
    from euler_tpu_torch.datasets import PPI, build_synthetic
    from euler_tpu_torch.graph import Graph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = build_synthetic(**PPI)
    graph = Graph(**data)
    max_id = graph.max_node_id
    adj = device_graph.tensors(
        device_graph.build_adjacency(graph, [0], max_id), dev)
    log(f"ppi graph {graph.num_nodes} nodes, {len(data['indices'])} edges, "
        f"slab {tuple(adj['nbr'].shape)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    n_rows = adj["nbr"].shape[0]
    default = n_rows - 1
    m, (f1, f2) = PPI_BATCH, PPI_FANOUTS
    gen = torch.Generator(device=dev).manual_seed(seed)
    words = device_graph.seed_words(seed + 12345)

    # (a) exactness on a weighted variant with zero-weight rows
    zero_rows = [5, 77]
    graph_w = Graph(**weighted_variant(data, zero_rows, seed))
    adj_w = device_graph.tensors(
        device_graph.build_adjacency(graph_w, [0], max_id), dev)
    if bool(adj_w["sampleable"][zero_rows].any()):
        raise AssertionError("zero-weight rows must not be sampleable")
    roots = torch.randint(0, max_id + 1, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
    roots[:5] = torch.tensor([-7, n_rows + 100, default, 5, 77],
                             dtype=torch.int32, device=dev)
    # roots that hold the zero-weight rows as neighbors, so hop 2 can
    # reach them
    holders = [
        int(np.searchsorted(data["indptr"], pos[0], side="right") - 1)
        for pos in (np.flatnonzero(data["indices"] == z) for z in zero_rows)
        if len(pos)
    ]
    roots[5:5 + len(holders)] = torch.tensor(holders, dtype=torch.int32,
                                             device=dev)
    max_err = fanout2_exact(adj_w, roots, words, f1, f2, 5, gen, "a")

    # (b) Philox distribution of hop-1 picks for four fixed rows
    deg = adj_w["deg"]
    fixed = [int(deg.argmax()), 11, 1234, 40000]
    per_row = 10_000  # roots per row; x f1 = 10^5 draws per row
    roots_b = torch.tensor(fixed, dtype=torch.int32,
                           device=dev).repeat_interleave(per_row)
    h1, h2 = sampling_kernels.sample_fanout2(
        adj_w, adj_w, roots_b, device_graph.seed_words(seed + 99), f1, 1)
    check_members(adj_w, roots_b, h1)
    check_members(adj_w, h1.reshape(-1), h2)
    h1 = h1.reshape(len(fixed), -1)
    for i, r in enumerate(fixed):
        d = int(deg[r])
        cum = adj_w["cum"][r, :d].double()
        p = torch.diff(cum, prepend=cum.new_zeros(1))
        slot = (h1[i][:, None] == adj_w["nbr"][r, :d][None, :]).double()
        freq = slot.mean(0)
        tvd = 0.5 * float((freq - p).abs().sum())
        log(f"(b) row {r}: degree {d}, {h1.shape[1]} draws, TVD {tvd:.5f} "
            f"(bound {TVD_BOUND})")
        if not tvd < TVD_BOUND:
            raise AssertionError(f"row {r}: TVD {tvd} >= {TVD_BOUND}")

    # (c) timing at the main path's shapes on the main path's slab, and
    # (h) exactness at the negatives' root count
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(graph, -1, max_id), dev)
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    flush = torch.empty(FLUSH_BYTES // 4, device=dev).zero_
    width = adj["nbr"].shape[1]
    timed = []
    for mm in B1_ROOTS:
        if mm != m:
            odd = odd_nodes(mm, max_id, zero_rows, gen)
            max_err = max(max_err, fanout2_exact(
                adj_w, odd, words, f1, f2, 3 + len(zero_rows), None, "h"))
        roots_t = device_graph.sample_node(sampler, mm, generator=gen)
        if mm == m:
            roots_c = roots_t
        kern = lambda: sampling_kernels.sample_fanout2(  # noqa: E731
            adj, adj, roots_t, words, f1, f2)
        plain = lambda: sampling_kernels.sample_fanout2_reference(  # noqa: E731
            adj, adj, roots_t, words, f1, f2)

        def library():  # one torch.multinomial per hop over gathered rows
            r1 = roots_t.long()
            i1 = torch.multinomial(probs[r1], f1, replacement=True)
            hop1 = adj["nbr"][r1].gather(1, i1).reshape(-1).long()
            i2 = torch.multinomial(probs[hop1], f2, replacement=True)
            return adj["nbr"][hop1].gather(1, i2)

        t = time_draw(kern, plain, library, mm * f1, flush)
        h1, h2 = kern()
        b = draw_bound(adj, ((roots_t, h1), (h1, h2)), mm)
        log(f"({'c' if mm == m else 'h'}) sample_fanout2 at [{mm}, {f1}, "
            f"{f2}], W={width}: {describe(t)}, {describe_bound(b)}")
        timed.append(dict(shape=[mm, f1, f2], **t, bound_ms=b["bound_ms"],
                          bound_by=b["bound_by"]))
    b2 = check_single_hop(adj, adj_w, roots, roots_c, zero_rows, seed, flush)
    wide = check_wide(seed)
    reddit, reddit_timed, reddit_err = check_reddit_fanout(seed, flush)
    timed.append(reddit_timed)
    max_err = max(max_err, reddit_err)
    b1 = dict(max_abs_err=max_err, exact_vs_plain=max_err == 0,
              **{k: v for k, v in timed[0].items() if k != "shape"},
              shapes=timed)
    b1["wide"], b2["wide"] = wide
    pl_graph = check_alias(seed)
    b2["shapes"].append(check_walks(adj, adj_w, sampler, zero_rows, seed,
                                    flush))
    check_biased(graph_w, pl_graph, zero_rows, seed)
    return graph, reddit, {"sample_fanout2": b1, "sample_neighbor": b2}


def fanout2_exact(adj_w, roots, words, f1: int, f2: int, n_default: int,
                  gen, tag: str) -> int:
    """B1 equals its plain version bit for bit on ``roots``, with Philox
    uniforms and, when ``gen`` is given, first with uniforms drawn from
    it; the first ``n_default`` roots draw the default id and every pick
    is a neighbor of its row. Returns the max |diff| (0)."""
    from euler_tpu_torch.graph import sampling_kernels

    m = roots.shape[0]
    default = adj_w["nbr"].shape[0] - 1
    modes = [("philox", (None, None))]
    if gen is not None:
        modes.insert(0, ("injected", (
            torch.rand((m, f1), generator=gen, device="cuda"),
            torch.rand((m * f1, f2), generator=gen, device="cuda"))))
    max_err = 0
    for mode, (a, b) in modes:
        k1, k2 = sampling_kernels.sample_fanout2(
            adj_w, adj_w, roots, words, f1, f2, u1=a, u2=b)
        p1, p2 = sampling_kernels.sample_fanout2_reference(
            adj_w, adj_w, roots, words, f1, f2, u1=a, u2=b)
        torch.cuda.synchronize()
        err = max(int((k1 - p1).abs().max()), int((k2 - p2).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(k1, p1) and torch.equal(k2, p2)):
            raise AssertionError(f"kernel != plain at {m} roots ({mode} "
                                 f"uniforms): max |diff| {err}")
        if not bool((k1[:n_default] == default).all()):
            raise AssertionError("unknown, default and zero-weight roots "
                                 "must draw the default id")
        check_members(adj_w, roots, k1)
        check_members(adj_w, k1.reshape(-1), k2)
        log(f"({tag}) {mode} uniforms: kernel == plain at [{m}, {f1}] + "
            f"[{m * f1}, {f2}], W={adj_w['nbr'].shape[1]}, max |diff| {err}")
    return max_err


def check_reddit_fanout(seed: int, flush):
    """Phase 3 (j): builds the synthetic Reddit graph at ``bench.py``'s
    shape (W = 60 after the Poisson(50) clip), holds B1 against its plain
    version at [1,000, 4, 4] on a weighted variant with zero-weight rows,
    with injected and Philox uniforms, and times it on the main path's
    slab. Returns (the graph and its build seconds, the timing record,
    the max |diff|)."""
    from euler_tpu_torch.datasets import REDDIT, build_synthetic
    from euler_tpu_torch.graph import Graph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = build_synthetic(**REDDIT)
    graph = Graph(**data)
    build_s = time.perf_counter() - t0
    max_id = graph.max_node_id
    t0 = time.perf_counter()
    adj = device_graph.tensors(
        device_graph.build_adjacency(graph, [0], max_id), dev)
    width = adj["nbr"].shape[1]
    log(f"(j) reddit graph {graph.num_nodes} nodes, {len(data['indices'])} "
        f"edges built in {build_s:.2f} s; slab {tuple(adj['nbr'].shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    zero_rows = [5, 77]
    adj_w = device_graph.tensors(device_graph.build_adjacency(
        Graph(**weighted_variant(data, zero_rows, seed)), [0], max_id), dev)
    del data
    m, (f1, f2) = REDDIT_BATCH, REDDIT_FANOUTS
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    words = device_graph.seed_words(seed + 6060)
    roots = odd_nodes(m, max_id, zero_rows, gen)
    max_err = fanout2_exact(adj_w, roots, words, f1, f2, 3 + len(zero_rows),
                            gen, "j")
    del adj_w
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(graph, -1, max_id), dev)
    roots_t = device_graph.sample_node(sampler, m, generator=gen)
    n_rows = adj["nbr"].shape[0]
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    kern = lambda: sampling_kernels.sample_fanout2(  # noqa: E731
        adj, adj, roots_t, words, f1, f2)
    plain = lambda: sampling_kernels.sample_fanout2_reference(  # noqa: E731
        adj, adj, roots_t, words, f1, f2)

    def library():  # one torch.multinomial per hop over gathered rows
        r1 = roots_t.long()
        i1 = torch.multinomial(probs[r1], f1, replacement=True)
        hop1 = adj["nbr"][r1].gather(1, i1).reshape(-1).long()
        i2 = torch.multinomial(probs[hop1], f2, replacement=True)
        return adj["nbr"][hop1].gather(1, i2)

    t = time_draw(kern, plain, library, m * f1, flush)
    h1, h2 = kern()
    b = draw_bound(adj, ((roots_t, h1), (h1, h2)), m)
    log(f"(j) sample_fanout2 at [{m}, {f1}, {f2}], W={width}: {describe(t)}, "
        f"{describe_bound(b)}")
    del adj, probs, sampler
    return ((graph, build_s),
            dict(shape=[m, f1, f2], width=width, **t, bound_ms=b["bound_ms"],
                 bound_by=b["bound_by"]), max_err)


def check_alias(seed: int) -> None:
    """Phase 3 (k): the plain alias draw (no kernel) on CUDA tensors
    equals the same draw on CPU tensors bit for bit, Philox uniforms, on
    a power-law graph with hub rows and random weights: single-hop draws
    and a two-hop fanout, on roots led by a negative id, one past the
    end, the default row, zero-weight rows and the hubs. Checks the int64
    Philox ops and the float32 slot arithmetic on the card; no kernel
    may launch."""
    from euler_tpu_torch.datasets import build_powerlaw
    from euler_tpu_torch.graph import Graph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    zero_rows = [5, 77]
    graph = Graph(**weighted_variant(build_powerlaw(**ALIAS_CHECK),
                                     zero_rows, seed))
    max_id = graph.max_node_id
    t0 = time.perf_counter()
    table = device_graph.build_alias_adjacency(graph, [0], max_id)
    hubs = np.argsort(table["deg"])[-4:].tolist()
    if table["deg"].max() < max(2048, graph.num_nodes // 64):
        raise AssertionError("the alias check graph has no hub row")
    log(f"(k) power-law graph {graph.num_nodes} nodes, "
        f"{len(table['nbr'])} edges, max degree {table['deg'].max()}, alias "
        f"tables in {time.perf_counter() - t0:.2f} s")
    cpu = device_graph.tensors(table, "cpu")
    gpu = device_graph.tensors(table, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 70)
    roots = odd_nodes(REDDIT_BATCH, max_id, zero_rows + hubs, gen)
    n_default = 3 + len(zero_rows)
    words = device_graph.seed_words(seed + 7070)
    f1, f2 = REDDIT_FANOUTS
    before = dict(sampling_kernels.launches)
    on_card = [device_graph.sample_neighbor(gpu, roots, f1, words, hop=2)]
    on_card += device_graph.sample_fanout([gpu, gpu], roots, [f1, f2], words)
    on_cpu = [device_graph.sample_neighbor(cpu, roots.cpu(), f1, words, hop=2)]
    on_cpu += device_graph.sample_fanout([cpu, cpu], roots.cpu(), [f1, f2],
                                         words)
    torch.cuda.synchronize()
    if sampling_kernels.launches != before:
        raise AssertionError("an alias draw launched a kernel")
    for name, a, b in zip(("single hop", "roots", "hop 1", "hop 2"),
                          on_card, on_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(
                f"alias draw ({name}) differs between CUDA and CPU: max "
                f"|diff| {int((a.cpu() - b).abs().max())}")
    single = on_card[0]
    if not bool((single[:n_default] == max_id + 1).all()):
        raise AssertionError("unknown, default and zero-weight rows must "
                             "draw the default id")
    if bool((single[n_default:n_default + len(hubs)] == max_id + 1).any()):
        raise AssertionError("a hub row drew the default id")
    log(f"(k) philox uniforms: alias draw on CUDA == on CPU at "
        f"[{REDDIT_BATCH}, {f1}] (hop 2) and the [{f1}, {f2}] fanout "
        f"(hops {[int(h.numel()) for h in on_card[1:]]}), no launch")
    return graph


def check_walks(adj, adj_w, sampler, zero_rows, seed: int, flush) -> dict:
    """Phase 3 (l): ``random_walk`` at node2vec's shape (15,360 walkers,
    walk_len 5) on the weighted ppi slab held as CUDA tensors equals the
    same walk over CPU tensors bit for bit (the kernel against its plain
    version, one Philox stream), from roots led by a negative id, one
    past the slab, the default row and the zero-weight rows, with exactly
    one B2 launch a step; then B2 timed at [15,360, 1] on the main path's
    slab, on step-1 picks of a walk from sampled roots. Returns the
    timing record."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(seed + 80)
    max_id = adj["nbr"].shape[0] - 2
    m, steps = N2V_ROOTS, N2V_WALK_LEN
    words = device_graph.stream_words(seed + 8080, 0)
    roots = odd_nodes(m, max_id, zero_rows, gen)
    before = sampling_kernels.launches["sample_neighbor"]
    on_card = device_graph.random_walk(adj_w, roots, steps, words)
    torch.cuda.synchronize()
    launched = sampling_kernels.launches["sample_neighbor"] - before
    on_cpu = device_graph.random_walk(
        {k: v.cpu() for k, v in adj_w.items()}, roots.cpu(), steps, words)
    if launched != steps:
        raise AssertionError(f"a {steps}-step walk launched B2 {launched} "
                             "times")
    if not torch.equal(on_card.cpu(), on_cpu):
        raise AssertionError(
            f"random_walk differs between CUDA and CPU in "
            f"{int((on_card.cpu() != on_cpu).sum())} picks")
    if not bool((on_card[:3 + len(zero_rows), 1:] == max_id + 1).all()):
        raise AssertionError("unknown, default and zero-weight roots must "
                             "walk the default row")
    for t in range(steps):
        check_members(adj_w, on_card[:, t], on_card[:, t + 1:t + 2])
    log(f"(l) philox uniforms: random_walk on CUDA == on CPU at [{m}, "
        f"{steps + 1}], {launched} B2 launches, every pick a neighbor")

    nodes = device_graph.random_walk(
        adj, device_graph.sample_node(sampler, m, generator=gen), 1,
        words)[:, 1].contiguous()
    n_rows, width = adj["nbr"].shape
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    rows = nodes.long()
    kern = lambda: sampling_kernels.sample_neighbor(  # noqa: E731
        adj, nodes, words, 1, hop=1)
    plain = lambda: sampling_kernels.sample_neighbor_reference(  # noqa: E731
        adj, nodes, words, 1, hop=1)

    def library():  # one torch.multinomial over the gathered rows
        idx = torch.multinomial(probs[rows], 1, replacement=True)
        return adj["nbr"][rows].gather(1, idx)

    t = time_draw(kern, plain, library, m, flush)
    b = draw_bound(adj, ((nodes, kern()),), m)
    log(f"(l) sample_neighbor at [{m}, 1], W={width}: {describe(t)}, "
        f"{describe_bound(b)}")
    return dict(shape=[m, 1], **t, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"])


def analytic_biased_joint(nbr, cum, deg, root: int, p: float, q: float):
    """Exact P(c1, c2) of a 2-step node2vec walk from ``root`` over a
    slab's numpy arrays: step 1 plain weighted, step 2 reweighted by d_tx
    against the parent ``root`` (1 for a neighbor of the root, which wins
    on a root self-loop; 1/p for the root; 1/q otherwise)."""
    def row_probs(v):
        d = deg[v]
        w = np.diff(cum[v][:d].astype(np.float64), prepend=0.0)
        return nbr[v][:d], w / w.sum()

    joint = {}
    root_nbrs = set(nbr[root][:deg[root]].tolist())
    for c1, p1 in zip(*row_probs(root)):
        cands, w2 = row_probs(int(c1))
        scale = np.array([1.0 if c in root_nbrs
                          else (1.0 / p if c == root else 1.0 / q)
                          for c in cands])
        w2 = w2 * scale / (w2 * scale).sum()
        for c2, pr in zip(cands, w2):
            key = (int(c1), int(c2))
            joint[key] = joint.get(key, 0.0) + p1 * pr
    return joint


def check_biased(graph_w, pl_graph, zero_rows, seed: int) -> None:
    """Phase 3 (m): the biased walks, plain PyTorch on the card, no kernel
    launch. ``biased_random_walk`` over the weighted ppi graph's sorted
    slab: the 2-step joint of 10^5 walkers from one root against
    ``analytic_biased_joint`` (TVD bound ``TVD_BOUND``), for each (p, q)
    of ``BIASED_PQ``; then at node2vec's 15,360 walkers and walk_len 5 on
    CUDA against CPU, where float32 cumsums may round apart: the
    differing picks are counted and every pick must be a legal
    transition. ``alias_biased_random_walk`` over the 9,000-node
    power-law graph's sorted alias tables (64 trials) equals the same
    walk on CPU tensors bit for bit."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    before = dict(sampling_kernels.launches)
    max_id = graph_w.max_node_id
    table = device_graph.build_adjacency(graph_w, [0], max_id, sorted=True)
    nbr, cum, deg = table["nbr"], table["cum"], table["deg"]
    # the root: a small joint (few cells for 10^5 draws), every neighbor
    # a live row; a self-loop root where there is one, so the d_tx = 1
    # precedence is in the joint
    live = table["sampleable"] & (deg > 0)
    real = np.arange(nbr.shape[1])[None, :] < deg[:, None]
    cells = deg[nbr].sum(1)  # padding is the default row, of degree 0
    ok = ((deg >= 4) & live & np.where(real, live[nbr], True).all(1)
          & (cells <= 120))
    loops = ok & (real & (nbr == np.arange(len(nbr))[:, None])).any(1)
    pool = np.flatnonzero(loops if loops.any() else ok)
    root = int(pool[np.argmin(cells[pool])])
    gpu = device_graph.tensors(table, "cuda")
    cpu = device_graph.tensors(table, "cpu")
    n = BIASED_WALKERS
    n_rows = max_id + 2
    for i, (p, q) in enumerate(BIASED_PQ):
        walks = device_graph.biased_random_walk(
            gpu, torch.full((n,), root, dtype=torch.int32, device="cuda"), 2,
            p, q, device_graph.seed_words(seed + 90 + i))
        keys, counts = torch.unique(walks[:, 1].long() * n_rows
                                    + walks[:, 2].long(), return_counts=True)
        seen = {(int(k) // n_rows, int(k) % n_rows): int(c) / n
                for k, c in zip(keys.cpu(), counts.cpu())}
        want = analytic_biased_joint(nbr, cum, deg, root, p, q)
        if set(seen) - set(want):
            raise AssertionError(f"illegal 2-step transitions from {root}: "
                                 f"{sorted(set(seen) - set(want))[:5]}")
        tvd = 0.5 * sum(abs(seen.get(k, 0.0) - v) for k, v in want.items())
        log(f"(m) biased_random_walk (p, q) = ({p}, {q}) from root {root} "
            f"(degree {deg[root]}, self-loop "
            f"{bool((nbr[root, :deg[root]] == root).any())}, {len(want)} "
            f"cells): {n} walkers, TVD {tvd:.5f} (bound {TVD_BOUND})")
        if not tvd < TVD_BOUND:
            raise AssertionError(f"biased walk TVD {tvd} >= {TVD_BOUND}")

    gen = torch.Generator(device="cuda").manual_seed(seed + 91)
    roots = odd_nodes(N2V_ROOTS, max_id, zero_rows, gen)
    words = device_graph.stream_words(seed + 9191, 0)
    for p, q in BIASED_PQ:
        a = device_graph.biased_random_walk(gpu, roots, N2V_WALK_LEN, p, q,
                                            words)
        b = device_graph.biased_random_walk(cpu, roots.cpu(), N2V_WALK_LEN,
                                            p, q, words)
        for t in range(N2V_WALK_LEN):
            check_members(gpu, a[:, t], a[:, t + 1:t + 2])
        differ = int((a.cpu() != b).sum())
        log(f"(m) biased_random_walk (p, q) = ({p}, {q}) at "
            f"[{N2V_ROOTS}, {N2V_WALK_LEN + 1}] on CUDA against CPU: "
            f"{differ} of {b.numel()} picks differ (float32 cumsum "
            f"rounding), every CUDA pick a legal transition")

    max_id = pl_graph.max_node_id
    t0 = time.perf_counter()
    table = device_graph.build_alias_adjacency(pl_graph, [0], max_id,
                                               sorted=True)
    gpu = device_graph.tensors(table, "cuda")
    cpu = device_graph.tensors(table, "cpu")
    hubs = np.argsort(table["deg"])[-4:].tolist()
    roots = odd_nodes(4096, max_id, hubs, gen)
    words = device_graph.stream_words(seed + 9292, 0)
    for p, q in BIASED_PQ:
        a = device_graph.alias_biased_random_walk(gpu, roots, N2V_WALK_LEN,
                                                  p, q, seed_words=words)
        b = device_graph.alias_biased_random_walk(
            cpu, roots.cpu(), N2V_WALK_LEN, p, q, seed_words=words)
        if not torch.equal(a.cpu(), b):
            raise AssertionError(
                f"alias_biased_random_walk (p, q) = ({p}, {q}) differs "
                f"between CUDA and CPU in {int((a.cpu() != b).sum())} picks")
        log(f"(m) philox uniforms: alias_biased_random_walk (p, q) = ({p}, "
            f"{q}), {device_graph.DEFAULT_WALK_TRIALS} trials, on CUDA == on "
            f"CPU at [4096, {N2V_WALK_LEN + 1}] over sorted alias tables "
            f"(max degree {table['deg'].max()}, "
            f"{table['bisect_steps'].shape[0]} bisection steps)")
    torch.cuda.synchronize()
    if sampling_kernels.launches != before:
        raise AssertionError("a biased walk launched a kernel")
    log(f"(m) no kernel launched; alias part {time.perf_counter() - t0:.2f} s")


def wide_slab(n_rows: int, width: int, seed: int) -> dict:
    """A [n_rows, width] slab on the card in ``build_adjacency``'s
    layout: row r has a random degree in [1, width] (the widest rows
    full) of random neighbors with weights in [0.1, 1); padding slots
    hold the default id and cum 1; row 1 has zero weight (not
    sampleable); the last row is the default."""
    from euler_tpu_torch.graph import device as device_graph

    rng = np.random.default_rng(seed)
    default = n_rows - 1
    deg = rng.integers(1, width + 1, n_rows)
    deg[:n_rows // 4] = width
    deg[default] = 0
    live = np.arange(width)[None, :] < deg[:, None]
    w = np.where(live, rng.uniform(0.1, 1.0, (n_rows, width)), 0.0)
    cum = np.cumsum(w, 1) / np.maximum(w.sum(1, keepdims=True), 1e-30)
    cum = np.where(live, cum, 1.0).astype(np.float32)
    cum[np.arange(n_rows), np.maximum(deg - 1, 0)] = 1.0
    nbr = np.where(live, rng.integers(0, default, (n_rows, width)), default)
    ok = deg > 0
    ok[1] = False
    cum[1] = 1.0
    return device_graph.tensors(dict(
        nbr=nbr.astype(np.int32), cum=cum, sampleable=ok,
        deg=deg.astype(np.int32)), torch.device("cuda"))


def check_wide(seed: int):
    """Phase 3 (i): the chained and the single-hop kernels equal their
    plain versions, Philox uniforms, on slabs wider than the main paths'
    (``WIDE_WIDTHS``), at the main paths' counts. Returns the warm times,
    by kernel, as lists of {"width", "shape", "ms"}."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    words = device_graph.seed_words(seed + 4321)
    f1, f2 = PPI_FANOUTS
    m1, (m2, count) = PPI_BATCH, B2_SHAPES[1]
    out = ([], [])
    for width in WIDE_WIDTHS:
        adj = wide_slab(8192, width, seed + width)
        max_id = adj["nbr"].shape[0] - 2
        roots = odd_nodes(m1, max_id, [1], gen)
        nodes = odd_nodes(m2, max_id, [1], gen)
        runs = (
            ("sample_fanout2", [m1, f1, f2], lambda: sampling_kernels
             .sample_fanout2(adj, adj, roots, words, f1, f2),
             lambda: sampling_kernels.sample_fanout2_reference(
                 adj, adj, roots, words, f1, f2)),
            ("sample_neighbor", [m2, count], lambda: sampling_kernels
             .sample_neighbor(adj, nodes, words, count, hop=1),
             lambda: sampling_kernels.sample_neighbor_reference(
                 adj, nodes, words, count, hop=1)),
        )
        for (name, shape, kern, plain), times in zip(runs, out):
            k, p = kern(), plain()
            k, p = (k, p) if name == "sample_neighbor" else (
                torch.cat([k[0].reshape(-1), k[1].reshape(-1)]),
                torch.cat([p[0].reshape(-1), p[1].reshape(-1)]))
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(
                    f"{name} != plain at {shape}, W={width} (philox): max "
                    f"|diff| {int((k - p).abs().max())}")
            ms = cuda_ms(kern)
            log(f"(i) philox uniforms: {name} == plain at {shape}, "
                f"W={width}; kernel {ms:.5f} ms warm")
            times.append(dict(width=width, shape=shape, ms=ms))
    return out


def odd_nodes(m: int, max_id: int, zero_rows, gen) -> torch.Tensor:
    """[m] int32 ids on the card: random real ids, led by a negative id,
    one past the slab, the default row and the zero-weight rows."""
    n_rows = max_id + 2
    nodes = torch.randint(0, max_id + 1, (m,), generator=gen, device="cuda",
                          dtype=torch.int32)
    odd = [-7, n_rows + 100, n_rows - 1, *zero_rows]
    nodes[:len(odd)] = torch.tensor(odd, dtype=torch.int32, device="cuda")
    return nodes


def draw_bound(adj, hops, ids: int) -> dict:
    """The least time the card could take for weighted draws over the slab
    ``adj``, from this run's picks; ``hops`` holds one (rows, picks
    [len(rows), count]) pair per hop. Bytes: the ``ids`` roots read, the
    cum row and sampleable flag of each distinct row read once, one 4-byte
    nbr entry per distinct (row, picked id) of a sampleable row (the draw
    counts on cum, then reads only the slot it chose), every pick written.
    Operations: one u >= cum compare per slot and draw."""
    n_rows, width = adj["nbr"].shape
    default = n_rows - 1
    rows = [torch.where(r.reshape(-1) < 0, default,
                        r.reshape(-1).clamp(max=default)).long()
            for r, _ in hops]
    uniq_rows = int(torch.unique(torch.cat(rows)).numel())
    keys = []
    for r, (_, p) in zip(rows, hops):
        key = r[:, None] * n_rows + p.long()
        keys.append(key[adj["sampleable"][r]])
    reads = int(torch.unique(torch.cat(keys)).numel())
    picks = sum(p.numel() for _, p in hops)
    bytes_moved = 4 * ids + uniq_rows * (4 * width + 1) + 4 * reads + 4 * picks
    ops = picks * width
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, compares=ops, rows=uniq_rows, reads=reads)


def describe_bound(b: dict) -> str:
    return (f"bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}: "
            f"{b['bytes']} B over {b['rows']} distinct rows and {b['reads']} "
            f"distinct nbr reads, {b['compares']} compares)")


def floor_launch(warps: int):
    """A callable that launches the empty kernel at the grid a draw
    kernel of ``warps`` warps takes."""
    from euler_tpu_torch import _build

    lib = _build.load_library()

    def launch():
        rc = lib.etpu_launch_floor(warps,
                                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
    return launch


def time_draw(kern, plain, library, warps: int, flush) -> dict:
    """A draw kernel warm (``ms``), with ``flush()`` evicting the L2 cache
    before each launch (``ms_cold``), the empty kernel at its grid
    (``floor_ms``), its plain version and its library yardstick."""
    return dict(
        ms=cuda_ms(kern), ms_cold=cuda_ms(kern, before=flush),
        floor_ms=cuda_ms(floor_launch(warps)),
        plain_ms=cuda_ms(plain, batch=1),  # some 300-600 launches per run
        library_ms=cuda_ms(library))


def describe(t: dict) -> str:
    return (f"kernel {t['ms']:.5f} ms warm, {t['ms_cold']:.5f} ms cold, "
            f"empty launch {t['floor_ms']:.5f} ms, plain {t['plain_ms']:.4f} "
            f"ms, torch.multinomial {t['library_ms']:.4f} ms")


def check_single_hop(adj, adj_w, roots, roots_c, zero_rows, seed, flush):
    """Phase 3 (d)-(g): the single-hop kernel against its plain version,
    against the chained kernel, against the cum probabilities, and timed
    (``flush`` evicts the L2 cache for the cold times). Returns the
    kernel's numbers at the unsupervised positives' shape and, under
    ``shapes``, at both."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    max_id = adj["nbr"].shape[0] - 2
    default = max_id + 1
    words = device_graph.stream_words(seed + 555, 1)

    # (d) exactness at both shapes, injected and Philox uniforms
    max_err = 0
    for hop, (m, count) in enumerate(B2_SHAPES):
        nodes = odd_nodes(m, max_id, zero_rows, gen)
        u = torch.rand((m, count), generator=gen, device="cuda")
        for mode, uu in (("injected", u), ("philox", None)):
            k = sampling_kernels.sample_neighbor(adj_w, nodes, words, count,
                                                 hop=hop, u=uu)
            p = sampling_kernels.sample_neighbor_reference(
                adj_w, nodes, words, count, hop=hop, u=uu)
            torch.cuda.synchronize()
            err = int((k - p).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(k, p):
                raise AssertionError(f"sample_neighbor != plain at [{m}, "
                                     f"{count}] ({mode}): max |diff| {err}")
            if not bool((k[:3 + len(zero_rows)] == default).all()):
                raise AssertionError("unknown, default and zero-weight rows "
                                     "must draw the default id")
            check_members(adj_w, nodes, k)
            log(f"(d) {mode} uniforms: sample_neighbor == plain at [{m}, "
                f"{count}], hop {hop}, max |diff| {err}")

    # (e) the chained kernel is two single-hop launches
    f1, f2 = PPI_FANOUTS
    h1, h2 = sampling_kernels.sample_fanout2(adj_w, adj_w, roots, words, f1,
                                             f2)
    s1 = sampling_kernels.sample_neighbor(adj_w, roots, words, f1, hop=0)
    s2 = sampling_kernels.sample_neighbor(adj_w, s1.reshape(-1), words, f2,
                                          hop=1)
    if not (torch.equal(h1, s1) and torch.equal(h2, s2)):
        raise AssertionError("sample_fanout2 != two chained sample_neighbor "
                             "launches (Philox)")
    log(f"(e) sample_fanout2 == sample_neighbor at hop 0 then hop 1: "
        f"[{roots.shape[0]}, {f1}] + [{h2.shape[0]}, {f2}] bit for bit")

    # (f) Philox pick distribution of four fixed rows, 10^5 draws each
    deg = adj_w["deg"]
    fixed = [int(deg.argmax()), 11, 1234, 40000]
    per_row, count = 10_000, 10
    nodes = torch.tensor(fixed, dtype=torch.int32,
                         device="cuda").repeat_interleave(per_row)
    picks = sampling_kernels.sample_neighbor(
        adj_w, nodes, device_graph.stream_words(seed + 99, 2), count)
    check_members(adj_w, nodes, picks)
    picks = picks.reshape(len(fixed), -1)
    for i, r in enumerate(fixed):
        d = int(deg[r])
        cum = adj_w["cum"][r, :d].double()
        p = torch.diff(cum, prepend=cum.new_zeros(1))
        freq = (picks[i][:, None] == adj_w["nbr"][r, :d][None, :]).double()
        tvd = 0.5 * float((freq.mean(0) - p).abs().sum())
        log(f"(f) row {r}: degree {d}, {picks.shape[1]} draws, TVD "
            f"{tvd:.5f} (bound {TVD_BOUND})")
        if not tvd < TVD_BOUND:
            raise AssertionError(f"row {r}: TVD {tvd} >= {TVD_BOUND}")

    # (g) timing at both shapes on the main path's slab: the positives'
    # roots, and the hop-1 picks of those roots
    n_rows, width = adj["nbr"].shape
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    hop1 = sampling_kernels.sample_neighbor(adj, roots_c, words, f1)
    timed = []
    for hop, ((m, count), nodes) in enumerate(zip(
            B2_SHAPES, (roots_c, hop1.reshape(-1)))):
        kern = lambda: sampling_kernels.sample_neighbor(  # noqa: E731
            adj, nodes, words, count, hop=hop)
        plain = lambda: sampling_kernels.sample_neighbor_reference(  # noqa: E731
            adj, nodes, words, count, hop=hop)
        rows = nodes.long()

        def library():  # one torch.multinomial over the gathered rows
            idx = torch.multinomial(probs[rows], count, replacement=True)
            return adj["nbr"][rows].gather(1, idx)

        t = time_draw(kern, plain, library, m, flush)
        b = draw_bound(adj, ((nodes, kern()),), m)
        log(f"(g) sample_neighbor at [{m}, {count}], W={width}: "
            f"{describe(t)}, {describe_bound(b)}")
        timed.append(dict(shape=[m, count], **t, bound_ms=b["bound_ms"],
                          bound_by=b["bound_by"]))
    return dict(max_abs_err=max_err, exact_vs_plain=max_err == 0,
                **{k: v for k, v in timed[0].items() if k != "shape"},
                shapes=timed)


def agree_cpu_cuda(model, graph, seed: int, name: str,
                   lr: float = PPI_LR) -> None:
    """Three steps of ``model`` from the same init on the CPU (plain
    draws) and on the card (kernels), on the same roots and seeds: first
    loss rtol 1e-5, all losses rtol 1e-3, step-1 gradients within 1e-5 of
    their scale (max |diff| / max(1, max |grad|): the unsupervised loss is
    a sum over the batch, so its gradients run to tens)."""
    from euler_tpu_torch import train

    opt = train.get_optimizer("adam", lr)
    st = {d: model.init_state(graph, opt, device=d, seed=seed)
          for d in ("cpu", "cuda")}
    step = model.make_train_step()
    roots = np.random.default_rng(seed).integers(0, graph.num_nodes, 64)
    losses = {"cpu": [], "cuda": []}
    grads0 = {}
    for i in range(3):
        for d in ("cpu", "cuda"):
            batch = model.device_sample_batch(roots, seed * 10 + i, device=d)
            loss, _ = step(st[d], batch)
            losses[d].append(float(loss))
            if i == 0:
                grads0[d] = [p.grad.cpu()
                             for p in st[d]["module"].parameters()]
    g_err = max(float((a - b).abs().max()) for a, b in
                zip(grads0["cpu"], grads0["cuda"]))
    g_scale = max(1.0, max(float(g.abs().max()) for g in grads0["cpu"]))
    log(f"small {name} losses cpu {losses['cpu']} cuda {losses['cuda']}, "
        f"step-1 max |grad diff| {g_err:.3g} (max |grad| {g_scale:.3g})")
    np.testing.assert_allclose(losses["cuda"][0], losses["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    if not g_err / g_scale < 1e-5:
        raise AssertionError(f"step-1 gradients differ by {g_err} at a "
                             f"scale of {g_scale}")


def table_bytes(consts) -> int:
    """Bytes of every tensor in a (nested) consts dict."""
    if isinstance(consts, dict):
        return sum(table_bytes(v) for v in consts.values())
    return consts.numel() * consts.element_size()


def replay_loss(state, batch: int) -> float:
    """The mean loss of the first chunk's batches under ``state``, without
    a step: ``train.make_scan_train``'s draws for seed 0 (roots from a
    generator seeded 0, step i's draws keyed by i), replayed."""
    from euler_tpu_torch.graph import device as device_graph

    sampler = state["consts"]["roots"]
    gen = torch.Generator(device=sampler["ids"].device).manual_seed(0)
    losses = []
    with torch.no_grad():
        for i in range(CHUNK_STEPS):
            roots = device_graph.sample_node(sampler, batch, generator=gen)
            losses.append(state["module"]({"roots": roots, "seed": i},
                                          state["consts"]).loss)
    return float(torch.stack(losses).mean())


def train_full(model, graph, seed: int, smi: str, name: str,
               edges_per_step, edges_note: str, lr: float = PPI_LR,
               batch: int = PPI_BATCH, pairs_per_step: int = 0,
               fresh_loss_falls: bool = True, scan=None) -> dict:
    """Train ``model`` at full width through ``train.make_scan_train`` (or
    the chunk function ``scan``, for a model whose consts carry no roots
    sampler): a warmup chunk, then TIMED_CHUNKS timed
    chunks. Prints the tables' bytes on the card (and a store model's
    stores'), the peak of allocated device memory, the kernel launches a
    step and, for the walk models, the skip-gram pairs a step and their
    rate. The launch counts are set to 0 just before and read just after;
    returns them and the step ms. Raises unless the losses are finite and
    fall from the first chunk to the last.

    The walk models (``pairs_per_step``) also replay the first chunk's
    batches before and after training (``replay_loss``, outside the
    counted run), and their loss must fall. ``fresh_loss_falls=False``
    keeps only that check: LINE at ``run_loop``'s defaults draws 512 roots
    a step from 56,944 nodes, so in 100 steps a node is a root less than
    once, and the loss of fresh batches need not fall (it rises by about
    0.1% on the CPU, as the JAX package's steps, which the port's
    match)."""
    from euler_tpu_torch import train
    from euler_tpu_torch.graph import sampling_kernels

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = model.init_state(graph, train.get_optimizer("adam", lr),
                             device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"{name} state on card in {time.perf_counter() - t0:.2f} s (its tables "
        f"built and uploaded), tables "
        f"{table_bytes(state['consts'])} B, of which adjacency "
        f"{table_bytes(state['consts']['adj'])} B")
    if "stores" in state:
        log(f"{name} stores {[table_bytes(s) for s in state['stores']]} B, "
            f"grad-stores {[table_bytes(s) for s in state['grad_stores']]} "
            f"B")
    scan = scan or train.make_scan_train(model, CHUNK_STEPS, batch)
    replayed = [replay_loss(state, batch)] if pairs_per_step else []
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    state, first = scan(state, 0)  # warmup chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk_losses = [first]
    for c in range(1, TIMED_CHUNKS + 1):
        state, losses_c = scan(state, c)
        chunk_losses.append(losses_c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(sampling_kernels.launches)
    steps = CHUNK_STEPS * (TIMED_CHUNKS + 1)
    all_losses = torch.stack(chunk_losses).cpu()
    log(f"{name} chunk mean losses "
        f"{[round(float(x), 5) for x in all_losses.mean(1)]}")
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError(f"{name}: non-finite training loss")
    falls = float(all_losses[-1].mean()) < float(all_losses[0].mean())
    if fresh_loss_falls and not falls:
        raise AssertionError(
            f"{name}: loss did not fall from the first chunk to the last")
    if replayed:
        replayed.append(replay_loss(state, batch))
        log(f"{name} first chunk's batches replayed: mean loss "
            f"{replayed[0]:.5f} at init, {replayed[1]:.5f} after "
            f"{steps} steps; fresh batches' loss fell: {falls}")
        if not replayed[1] < replayed[0]:
            raise AssertionError(f"{name}: the loss of the batches it "
                                 "trained on did not fall")
    step_ms = dt / (CHUNK_STEPS * TIMED_CHUNKS) * 1e3
    runs = {"steps": steps, "launches": launches, "step_ms": step_ms}
    pairs = (f", {pairs_per_step} pairs/step, "
             f"{pairs_per_step / step_ms * 1e3:.1f} pairs/s"
             if pairs_per_step else "")
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"{name} train: {steps} steps, launches {launches} ({per_step} a "
        f"step), step {step_ms:.4f} ms, {edges_per_step} edges/step, "
        f"{edges_per_step / step_ms * 1e3:.1f} edges/s{pairs} "
        f"({edges_note}; timed {CHUNK_STEPS * TIMED_CHUNKS} steps after a "
        f"warmup chunk; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; card: {smi})")
    return runs


def phase_train(graph, reddit, seed: int, smi: str) -> dict:
    """The thirteen main paths; returns {path: {"steps", "launches",
    "step_ms"}}."""
    log("== phase 4: train")
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import GraphSage, SupervisedGraphSage

    def sage(max_id, dim):
        return SupervisedGraphSage(
            label_idx=0, label_dim=121, metapath=[[0], [0]],
            fanouts=list(PPI_FANOUTS), dim=dim, feature_idx=1,
            feature_dim=50, max_id=max_id, device_features=True,
            device_sampling=True)

    def unsup(max_id, dim):  # run_loop --model graphsage's defaults
        return GraphSage(
            node_type=0, edge_type=[0], max_id=max_id, metapath=[[0], [0]],
            fanouts=list(PPI_FANOUTS), dim=dim, num_negs=SAGE_NEGS,
            feature_idx=1, feature_dim=50, aggregator="mean", concat=True,
            xent_loss=True, device_features=True, device_sampling=True)

    small = Graph(**build_synthetic(2000, 15, 50, 121, seed=seed + 1))
    f1, f2 = PPI_FANOUTS
    runs = {}
    agree_cpu_cuda(sage(small.max_node_id, 32), small, seed, "ppi")
    runs["ppi"] = train_full(
        sage(graph.max_node_id, PPI_DIM), graph, seed, smi, "ppi",
        PPI_BATCH * (f1 + f1 * f2), "512 * (10 + 10*10) sampled edges/step")
    expect = {"sample_fanout2": runs["ppi"]["steps"], "sample_neighbor": 0}
    if runs["ppi"]["launches"] != expect:
        raise AssertionError(f"ppi launches {runs['ppi']['launches']}, "
                             f"expected {expect}")

    agree_cpu_cuda(unsup(small.max_node_id, 32), small, seed, "graphsage")
    # positives (one edge per root) plus the [10, 10] fanouts of roots,
    # positives and negatives: 512 + (512 + 512 + 2,560) * 110
    towers = PPI_BATCH * (2 + SAGE_NEGS)
    runs["graphsage"] = train_full(
        unsup(graph.max_node_id, PPI_DIM), graph, seed, smi, "graphsage",
        PPI_BATCH + towers * (f1 + f1 * f2),
        f"{PPI_BATCH} + {towers} * {f1 + f1 * f2} sampled edges/step")
    steps = runs["graphsage"]["steps"]
    expect = {"sample_fanout2": 3 * steps, "sample_neighbor": steps}
    if runs["graphsage"]["launches"] != expect:
        raise AssertionError(
            f"graphsage launches {runs['graphsage']['launches']}, expected "
            f"{expect}")
    runs.update(train_gcn(graph, small, seed, smi))
    runs.update(train_walks(graph, small, seed, smi))
    reddit_runs, heavy = train_reddit(reddit, seed, smi)
    runs.update(reddit_runs)
    runs.update(train_walk_heavytail(heavy, seed, smi))
    return runs


def gcn(max_id: int, dim: int, aggregator: str, batch: int = PPI_BATCH):
    """``run_loop --model gcn --device_sampling``'s model
    (run_loop.py:586-602): metapath [[0], [0]], dim ``dim``, the sparse
    aggregator ``aggregator``, 50 features, 121 labels, sigmoid loss, and
    the caps ``batch * cap**h`` unique nodes a hop with cap =
    max(fanouts) = 10: [5,120, 51,200] at batch 512."""
    from euler_tpu_torch.models import SupervisedGCN

    cap = max(PPI_FANOUTS)
    return SupervisedGCN(
        label_idx=0, label_dim=121, metapath=[[0], [0]], dim=dim,
        max_nodes_per_hop=[batch * cap ** h for h in (1, 2)],
        max_edges_per_hop=[batch * cap ** (h + 1) for h in (0, 1)],
        aggregator=aggregator, feature_idx=1, feature_dim=50, max_id=max_id,
        device_features=True, device_sampling=True)


def scalable_gcn(max_id: int, dim: int):
    """``run_loop --model scalable_gcn --device_sampling``'s model
    (run_loop.py:604-625): 2 layers, dim ``dim``, mean aggregator, slab
    rows capped at max_neighbors = fanouts[0] = 10, store lr 0.001, store
    init 0.05, roots of node type 0."""
    from euler_tpu_torch.models import ScalableGCN

    return ScalableGCN(
        label_idx=0, label_dim=121, edge_type=[0], num_layers=2, dim=dim,
        max_id=max_id, max_neighbors=PPI_FANOUTS[0], aggregator="mean",
        feature_idx=1, feature_dim=50, store_learning_rate=0.001,
        store_init_maxval=0.05, device_features=True, device_sampling=True,
        train_node_type=0)


def sampled_roots_scan(model, sampler, batch: int):
    """``make_scan_train``'s chunk function with ``batch`` roots drawn by
    ``sample_node`` over ``sampler`` each step (the JAX package's
    SupervisedGCN builds no roots sampler of its own) and handed to
    ``model.make_train_step()``."""
    from euler_tpu_torch.graph import device as device_graph

    step = model.make_train_step()

    def scan(state, seed: int):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        losses = []
        for i in range(CHUNK_STEPS):
            roots = device_graph.sample_node(sampler, batch, generator=gen)
            losses.append(step(state, {"roots": roots,
                                       "seed": seed * CHUNK_STEPS + i})[0])
        return state, torch.stack(losses)

    return scan


def first_chunk_roots(sampler, batch: int):
    """The roots of the first chunk's steps: ``sample_node`` over
    ``sampler`` from a generator seeded 0, as the chunk loops draw
    them."""
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(0)
    return [device_graph.sample_node(sampler, batch, generator=gen)
            for _ in range(CHUNK_STEPS)]


def expansion_report(adj, caps, sampler) -> float:
    """Prints one batch's full-neighbor expansion hop by hop (parents,
    their real edges, the unique neighbor ids against the cap, the edges
    the cap keeps) and ``multi_hop_neighbor``'s device time alone; returns
    the real edges a step kept (masks summed over the hops), the mean of
    the first chunk's batches."""
    from euler_tpu_torch.graph import device as device_graph

    roots = first_chunk_roots(sampler, PPI_BATCH)
    default = adj["nbr"].shape[0] - 1
    hops = device_graph.multi_hop_neighbor([adj, adj], roots[0], caps)
    parents = roots[0].long()
    for h, (hop, cap) in enumerate(zip(hops, caps)):
        parents = parents[parents != default]
        width = adj["nbr"].shape[1]
        deg = adj["deg"][parents]
        real = adj["nbr"][parents][torch.arange(width, device="cuda")[None, :]
                                   < deg[:, None]]
        uniq = int(torch.unique(real).numel())
        log(f"gcn expansion hop {h + 1}: {parents.numel()} parents, "
            f"{int(deg.sum())} real edges, {uniq} unique neighbors against a "
            f"cap of {cap} ({max(uniq - cap, 0)} dropped), "
            f"{int(hop['mask'].sum())} edges kept")
        parents = hop["nodes"].long()
    ms = cuda_ms(lambda: device_graph.multi_hop_neighbor(
        [adj, adj], roots[0], caps), runs=50, batch=5)
    edges = statistics.mean(
        float(sum(h["mask"].sum() for h in
                  device_graph.multi_hop_neighbor([adj, adj], r, caps)))
        for r in roots)
    log(f"gcn multi_hop_neighbor alone at [{PPI_BATCH}] roots, caps {caps}: "
        f"{ms:.4f} ms (CUDA events, median of 50); {edges:.1f} real edges "
        f"kept a step (mean of the first chunk's {CHUNK_STEPS} batches)")
    return edges


def train_gcn(graph, small, seed: int, smi: str) -> dict:
    """The GCN family on the ppi graph, each after a CPU/CUDA agreement on
    the small graph: gcn (``run_loop --model gcn`` defaults, mean
    aggregator), gcn_gcnagg (``--aggregator gcn``) and gcn_attention
    (``--aggregator attention``, 4 heads of 64), each a step of roots
    drawn on the card and the full-neighbor expansion; then scalable_gcn
    (``--model scalable_gcn``) through ``make_scan_train``. None launches
    a kernel: the paths are gathers, a sort, cumsums and segment sums."""
    from euler_tpu_torch.graph import device as device_graph

    max_id = graph.max_node_id
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(graph, 0, max_id), "cuda")
    adj = device_graph.tensors(
        device_graph.build_adjacency(graph, [0], max_id), "cuda")
    caps = gcn(max_id, PPI_DIM, "mean").max_nodes_per_hop
    edges = expansion_report(adj, caps, sampler)
    # ScalableGCN's slab rows hold min(degree, max_neighbors) real edges
    row_edges = adj["deg"].clamp(max=PPI_FANOUTS[0])
    sc_edges = statistics.mean(
        float(row_edges[r.long()].sum())
        for r in first_chunk_roots(sampler, PPI_BATCH))
    del adj
    note = (f"real edges kept a step, mean of the first chunk's batches; "
            f"caps {caps}")
    runs = {}
    for name, aggregator in (("gcn", "mean"), ("gcn_gcnagg", "gcn"),
                             ("gcn_attention", "attention")):
        t0 = time.perf_counter()
        agree_cpu_cuda(gcn(small.max_node_id, 32, aggregator, 64), small,
                       seed, name)
        model = gcn(max_id, PPI_DIM, aggregator)
        runs[name] = train_full(
            model, graph, seed, smi, name, edges, note,
            scan=sampled_roots_scan(model, sampler, PPI_BATCH))
        log(f"{name} path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    agree_cpu_cuda(scalable_gcn(small.max_node_id, 32), small, seed,
                   "scalable_gcn")
    runs["scalable_gcn"] = train_full(
        scalable_gcn(max_id, PPI_DIM), graph, seed, smi, "scalable_gcn",
        sc_edges, f"real slab-row edges a step (W = {PPI_FANOUTS[0]}), mean "
        f"of the first chunk's batches")
    log(f"scalable_gcn path: {time.perf_counter() - t0:.1f} s")
    for name, run in runs.items():
        expect = {"sample_fanout2": 0, "sample_neighbor": 0}
        if run["launches"] != expect:
            raise AssertionError(f"{name} launches {run['launches']}, "
                                 f"expected {expect}")
    return runs


def node2vec(max_id: int, dim: int, p: float = 1.0, q: float = 1.0,
             alias: bool = False):
    """``run_loop --model node2vec --device_sampling``'s model: all node
    types, the graph's one edge type, dim ``dim``, id embeddings of
    max_id+2 rows (combiner add), walk_len 5, windows 5/5, 5 negatives,
    sigmoid cross-entropy; over sorted alias tables when ``alias``."""
    from euler_tpu_torch.models import Node2Vec

    model = Node2Vec(
        node_type=-1, edge_type=[0], max_id=max_id, dim=dim,
        walk_len=N2V_WALK_LEN, walk_p=p, walk_q=q, left_win_size=N2V_WINDOW,
        right_win_size=N2V_WINDOW, num_negs=SAGE_NEGS, xent_loss=True,
        device_sampling=True)
    if model.batch_size_ratio * PPI_BATCH != N2V_ROOTS:
        raise AssertionError(f"node2vec pairs a root: "
                             f"{model.batch_size_ratio}, expected 30")
    if alias:
        model.set_sampling_options(alias=True)
    return model


def line(max_id: int, dim: int):
    """``run_loop --model line``'s model: order 1, dim ``dim``, 5
    negatives, sigmoid cross-entropy, id embeddings."""
    from euler_tpu_torch.models import LINE

    return LINE(node_type=-1, edge_type=[0], max_id=max_id, dim=dim,
                order=1, num_negs=SAGE_NEGS, xent_loss=True,
                device_sampling=True)


def train_walks(graph, small, seed: int, smi: str) -> dict:
    """The walk models on the ppi graph, each after a CPU/CUDA agreement
    on the small graph where it has one: node2vec (five B2 launches a
    step, at [15,360, 1]), node2vec_biased (the sorted slab, no kernel)
    and line (one B2 launch a step, at [512, 1])."""
    max_id = graph.max_node_id
    edges = N2V_ROOTS * N2V_WALK_LEN
    pairs = N2V_ROOTS * 30
    note = f"{N2V_ROOTS} walks of {N2V_WALK_LEN} edges, 30 pairs a root"
    runs = {}
    agree_cpu_cuda(node2vec(small.max_node_id, 32), small, seed, "node2vec")
    runs["node2vec"] = train_full(
        node2vec(max_id, PPI_DIM), graph, seed, smi, "node2vec", edges, note,
        batch=N2V_ROOTS, pairs_per_step=pairs)
    runs["node2vec_biased"] = train_full(
        node2vec(max_id, PPI_DIM, *BIASED_PQ[0]), graph, seed, smi,
        "node2vec_biased", edges, note, batch=N2V_ROOTS,
        pairs_per_step=pairs)
    agree_cpu_cuda(line(small.max_node_id, 32), small, seed, "line")
    runs["line"] = train_full(
        line(max_id, PPI_DIM), graph, seed, smi, "line", PPI_BATCH,
        f"{PPI_BATCH} positive edges", pairs_per_step=PPI_BATCH,
        fresh_loss_falls=False)
    for name, b2 in (("node2vec", N2V_WALK_LEN), ("node2vec_biased", 0),
                     ("line", 1)):
        steps = runs[name]["steps"]
        expect = {"sample_fanout2": 0, "sample_neighbor": b2 * steps}
        if runs[name]["launches"] != expect:
            raise AssertionError(f"{name} launches {runs[name]['launches']}, "
                                 f"expected {expect}")
    return runs


def train_walk_heavytail(graph, seed: int, smi: str) -> dict:
    """node2vec_biased's recipe on the heavy-tail graph that
    reddit_heavytail trained on (not built again), over its sorted alias
    tables: the exact rejection walk, 64 trials a step and 16-step
    bisection, no kernel."""
    t0 = time.perf_counter()
    run = train_full(
        node2vec(graph.max_node_id, PPI_DIM, *BIASED_PQ[0], alias=True),
        graph, seed, smi, "node2vec_heavytail", N2V_ROOTS * N2V_WALK_LEN,
        f"{N2V_ROOTS} walks of {N2V_WALK_LEN} edges, 30 pairs a root",
        batch=N2V_ROOTS, pairs_per_step=N2V_ROOTS * 30)
    expect = {"sample_fanout2": 0, "sample_neighbor": 0}
    if run["launches"] != expect:
        raise AssertionError(f"node2vec_heavytail launches "
                             f"{run['launches']}, expected {expect}")
    log(f"node2vec_heavytail path: {time.perf_counter() - t0:.1f} s")
    return {"node2vec_heavytail": run}


def reddit_sage(max_id: int, feature_dtype=None, alias: bool = False):
    """``bench.py``'s reddit model (bench.py:608-625): batch 1,000,
    fanouts [4, 4], dim 64, 602 features, 41 one-hot labels, mean
    aggregator, the default sigmoid loss."""
    from euler_tpu_torch.datasets import REDDIT
    from euler_tpu_torch.models import SupervisedGraphSage

    model = SupervisedGraphSage(
        label_idx=0, label_dim=REDDIT["label_dim"], metapath=[[0], [0]],
        fanouts=list(REDDIT_FANOUTS), dim=REDDIT_DIM, feature_idx=1,
        feature_dim=REDDIT["feature_dim"], max_id=max_id,
        device_features=True, device_sampling=True,
        feature_dtype=feature_dtype)
    if alias:
        model.set_sampling_options(alias=True)
    return model


def train_reddit(reddit, seed: int, smi: str):
    """bench.py's reddit, reddit_bf16 and reddit_heavytail configs, each
    after a CPU/CUDA agreement on a small graph: B1 once per step on the
    synthetic graph's slab (float32 and bfloat16 feature tables), no
    kernel on the heavy-tail graph's alias tables. Returns the runs and
    the heavy-tail graph."""
    from euler_tpu_torch.datasets import (REDDIT, REDDIT_HEAVYTAIL,
                                          build_powerlaw, build_synthetic)
    from euler_tpu_torch.graph import Graph

    graph, build_s = reddit
    f1, f2 = REDDIT_FANOUTS
    edges = REDDIT_BATCH * (f1 + f1 * f2)
    note = f"{REDDIT_BATCH} * ({f1} + {f1}*{f2}) sampled edges/step"
    width = dict(feature_dim=REDDIT["feature_dim"],
                 label_dim=REDDIT["label_dim"])
    small = Graph(**build_synthetic(2000, REDDIT["avg_degree"], **width,
                                    multilabel=False, seed=seed + 2))
    small_pl = Graph(**build_powerlaw(3000, 90_000, **width, seed=seed + 3))
    runs = {}
    for name, feature_dtype, alias in (("reddit", None, False),
                                       ("reddit_bf16", "bfloat16", False),
                                       ("reddit_heavytail", None, True)):
        t_path = time.perf_counter()
        if alias:
            t0 = time.perf_counter()
            data = build_powerlaw(**REDDIT_HEAVYTAIL)
            t1 = time.perf_counter()
            graph = Graph(**data)
            t2 = time.perf_counter()
            log(f"{name} graph {graph.num_nodes} nodes, "
                f"{len(data['indices'])} edges (REDDIT_HEAVYTAIL, no cut), "
                f"max degree {np.diff(data['indptr']).max()}, built in "
                f"{t2 - t0:.2f} s ({t1 - t0:.2f} s build_powerlaw, "
                f"{t2 - t1:.2f} s Graph with its sort); its alias tables "
                f"are built in init_state")
            del data
        else:
            log(f"{name} graph: the synthetic reddit graph of phase 3 (j), "
                f"built in {build_s:.2f} s")
        g_small = small_pl if alias else small
        agree_cpu_cuda(reddit_sage(g_small.max_node_id, feature_dtype, alias),
                       g_small, seed, name, REDDIT_LR)
        runs[name] = train_full(
            reddit_sage(graph.max_node_id, feature_dtype, alias), graph,
            seed, smi, name, edges, note, REDDIT_LR, REDDIT_BATCH)
        steps = runs[name]["steps"]
        expect = {"sample_fanout2": 0 if alias else steps,
                  "sample_neighbor": 0}
        if runs[name]["launches"] != expect:
            raise AssertionError(f"{name} launches {runs[name]['launches']}, "
                                 f"expected {expect}")
        log(f"{name} path: {time.perf_counter() - t_path:.1f} s")
    return runs, graph


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    t1 = time.perf_counter()
    log(f"phases 1-2: {t1 - t0:.1f} s")
    graph, reddit, k = phase_kernel(args.seed)
    t2 = time.perf_counter()
    log(f"phase 3: {t2 - t1:.1f} s")
    runs = phase_train(graph, reddit, args.seed, smi)
    log(f"phase 4: {time.perf_counter() - t2:.1f} s")
    log("== phase 5: kernels")
    meta = {
        "sample_fanout2": dict(
            source="euler_tpu_torch/csrc/sample_fanout2.cu",
            replaces="euler_tpu/graph/pallas_sampling.py:481",
            tpu_kernel="_fanout2_kernel"),
        "sample_neighbor": dict(
            source="euler_tpu_torch/csrc/sample_neighbor.cu",
            replaces="euler_tpu/graph/pallas_sampling.py:302",
            tpu_kernel="_kernel"),
    }
    kernels = []
    for name, m in meta.items():
        by_path = {p: r["launches"][name] for p, r in runs.items()}
        kernels.append(dict(
            name=name, route="cuda", **m,
            launches=sum(by_path.values()), launches_by_path=by_path,
            **k[name]))
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
