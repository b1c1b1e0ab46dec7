#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (nonzero exit, no result line):

1. Environment: torch, CUDA, nvcc, triton, the card's name and power
   limit. TF32 is switched off for matmuls and cuDNN.
2. Build: the port's CUDA kernels from ``euler_tpu_torch/csrc/``.
3. Kernel vs plain, on the full synthetic PPI graph (56,944 nodes):
   (a) ``sample_fanout2`` at the ppi shape (512 roots, [10, 10]) equals
   ``sample_fanout2_reference`` exactly, with injected uniforms and with
   Philox, on roots that include a negative id, an id past the slab, the
   default row and zero-weight rows; (b) Philox hop-1 pick frequencies of
   four fixed rows over 10^5 draws each match the ``cum`` probabilities
   within a total variation distance of 0.03, and every pick is a real
   neighbor of its row or the default; (c) kernel, plain version and a
   ``torch.multinomial`` yardstick, timed with CUDA events.
4. Train: a small model agrees between CPU (plain draws) and CUDA
   (kernel) step for step; then ``SupervisedGraphSage`` at full ppi width
   (dim 256, batch 512, fanouts [10, 10], Adam 0.01) trains through
   ``train.make_scan_train``, with the kernel launched once per step.
5. The ``kernels`` line; then the final ``ok`` line.
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
CHUNK_STEPS = 20
TIMED_CHUNKS = 4
TVD_BOUND = 0.03
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


def cuda_ms(fn, runs: int = 100, warmup: int = 10, batch: int = 10) -> float:
    """Median device milliseconds of ``fn()`` over ``runs`` event-timed
    runs. A spin kernel (~20 ms per run) holds the card while the host
    enqueues each batch of runs, so every event pair times the device's
    work and not the host's launch overhead. A batch must stay within
    the card's queue of about a thousand pending launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(0, runs, batch):
        torch.cuda._sleep(40_000_000 * batch)
        pairs = []
        for _ in range(batch):
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
        if "registers" in line or "spill" in line or "error" in line:
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
    adj_w = device_graph.tensors(device_graph.build_adjacency(
        Graph(**weighted_variant(data, zero_rows, seed)), [0], max_id), dev)
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
    u1 = torch.rand((m, f1), generator=gen, device=dev)
    u2 = torch.rand((m * f1, f2), generator=gen, device=dev)
    max_err = 0
    for mode, (a, b) in (("injected", (u1, u2)), ("philox", (None, None))):
        k1, k2 = sampling_kernels.sample_fanout2(
            adj_w, adj_w, roots, words, f1, f2, u1=a, u2=b)
        p1, p2 = sampling_kernels.sample_fanout2_reference(
            adj_w, adj_w, roots, words, f1, f2, u1=a, u2=b)
        torch.cuda.synchronize()
        err = max(int((k1 - p1).abs().max()), int((k2 - p2).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(k1, p1) and torch.equal(k2, p2)):
            raise AssertionError(f"kernel != plain ({mode} uniforms): "
                                 f"max |diff| {err}")
        if not bool((k1[:5] == default).all()):
            raise AssertionError("unknown, default and zero-weight roots "
                                 "must draw the default id")
        check_members(adj_w, roots, k1)
        check_members(adj_w, k1.reshape(-1), k2)
        log(f"(a) {mode} uniforms: kernel == plain at [{m}, {f1}] + "
            f"[{m * f1}, {f2}], max |diff| {err}")

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

    # (c) timing at the main path's shape on the main path's slab
    roots_c = device_graph.sample_node(
        device_graph.tensors(
            device_graph.build_node_sampler(graph, -1, max_id), dev),
        m, generator=gen)
    kern = lambda: sampling_kernels.sample_fanout2(  # noqa: E731
        adj, adj, roots_c, words, f1, f2)
    plain = lambda: sampling_kernels.sample_fanout2_reference(  # noqa: E731
        adj, adj, roots_c, words, f1, f2)
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))

    def library():  # one torch.multinomial per hop over gathered rows
        r1 = roots_c.long()
        i1 = torch.multinomial(probs[r1], f1, replacement=True)
        hop1 = adj["nbr"][r1].gather(1, i1).reshape(-1).long()
        i2 = torch.multinomial(probs[hop1], f2, replacement=True)
        return adj["nbr"][hop1].gather(1, i2)

    kernel_ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, batch=1)  # some 600 launches per run
    library_ms = cuda_ms(library)
    h1, _ = kern()
    uniq1 = int(torch.unique(roots_c).numel())
    uniq2 = int(torch.unique(h1).numel())
    width = adj["nbr"].shape[1]
    row_bytes = width * 8 + 1  # nbr + cum + sampleable
    bytes_moved = (4 * m + (uniq1 + uniq2) * row_bytes
                   + 4 * (m * f1 + m * f1 * f2))
    ops = m * f1 * width + m * f1 * f2 * width  # u >= cum compares
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                >= ops / F32_OPS_PER_S else "operations")
    log(f"(c) sample_fanout2 at [{m}, {f1}, {f2}], W={width}: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.multinomial "
        f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us ({bound_by}: "
        f"{bytes_moved} B over {uniq1}+{uniq2} distinct rows, {ops} compares)")
    return graph, dict(
        max_abs_err=max_err, exact_vs_plain=max_err == 0, ms=kernel_ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by,
    )


def phase_train(graph, seed: int, smi: str) -> int:
    log("== phase 4: train")
    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import Graph, sampling_kernels
    from euler_tpu_torch.models import SupervisedGraphSage

    def sage(max_id, dim):
        return SupervisedGraphSage(
            label_idx=0, label_dim=121, metapath=[[0], [0]],
            fanouts=list(PPI_FANOUTS), dim=dim, feature_idx=1,
            feature_dim=50, max_id=max_id, device_features=True,
            device_sampling=True)

    # small model: CPU (plain draws) and CUDA (kernel) agree step by step
    small = Graph(**build_synthetic(2000, 15, 50, 121, seed=seed + 1))
    model = sage(small.max_node_id, 32)
    opt = train.get_optimizer("adam", PPI_LR)
    st = {d: model.init_state(small, opt, device=d, seed=seed)
          for d in ("cpu", "cuda")}
    step = model.make_train_step()
    roots = np.random.default_rng(seed).integers(0, 2000, 64)
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
    log(f"small model losses cpu {losses['cpu']} cuda {losses['cuda']}, "
        f"step-1 max |grad diff| {g_err:.3g}")
    np.testing.assert_allclose(losses["cuda"][0], losses["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    if not g_err < 1e-5:
        raise AssertionError(f"step-1 gradients differ by {g_err}")

    # full ppi width through the kernel
    model = sage(graph.max_node_id, PPI_DIM)
    t0 = time.perf_counter()
    state = model.init_state(graph, opt, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"ppi state on card in {time.perf_counter() - t0:.2f} s")
    scan = train.make_scan_train(model, CHUNK_STEPS, PPI_BATCH)
    sampling_kernels.launches = 0
    state, first = scan(state, 0)  # warmup chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk_losses = [first]
    for c in range(1, TIMED_CHUNKS + 1):
        state, losses_c = scan(state, c)
        chunk_losses.append(losses_c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = sampling_kernels.launches
    steps = CHUNK_STEPS * (TIMED_CHUNKS + 1)
    all_losses = torch.stack(chunk_losses).cpu()
    log(f"chunk mean losses {[round(float(x), 5) for x in all_losses.mean(1)]}")
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("non-finite training loss")
    if not float(all_losses[-1].mean()) < float(all_losses[0].mean()):
        raise AssertionError("loss did not fall from the first chunk to the last")
    if launches != steps:
        raise AssertionError(f"kernel launched {launches} times in {steps} steps")
    step_ms = dt / (CHUNK_STEPS * TIMED_CHUNKS) * 1e3
    edges = PPI_BATCH * (PPI_FANOUTS[0] + PPI_FANOUTS[0] * PPI_FANOUTS[1])
    log(f"ppi train: {steps} steps, sample_fanout2 launches {launches}, "
        f"step {step_ms:.4f} ms, {edges / step_ms * 1e3:.1f} edges/s "
        f"(timed {CHUNK_STEPS * TIMED_CHUNKS} steps after a warmup chunk; "
        f"card: {smi})")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = phase_env()
    phase_build()
    graph, k = phase_kernel(args.seed)
    launches = phase_train(graph, args.seed, smi)
    log("== phase 5: kernels")
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": [dict(
        name="sample_fanout2",
        route="cuda",
        source="euler_tpu_torch/csrc/sample_fanout2.cu",
        replaces="euler_tpu/graph/pallas_sampling.py:481",
        tpu_kernel="_fanout2_kernel",
        launches=launches,
        max_abs_err=k["max_abs_err"],
        exact_vs_plain=k["exact_vs_plain"],
        ms=k["ms"],
        kernel_ms=k["ms"],
        plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"],
        bound_us=k["bound_ms"] * 1e3,
        bound_by=k["bound_by"],
        library_ms=k["library_ms"],
    )]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
