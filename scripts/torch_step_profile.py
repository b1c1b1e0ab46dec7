#!/usr/bin/env python3
"""Where the time of the port's ppi train step goes, on one NVIDIA GPU.

    python3 scripts/torch_step_profile.py [--steps 20] [--top 15]

Builds the full synthetic PPI graph and SupervisedGraphSage at the flagship
width (dim 256, batch 512, fanouts [10, 10], Adam 0.01), runs one warmup
chunk of ``train.make_scan_train``, times one chunk, then profiles one
chunk with ``torch.profiler`` (CPU + CUDA activities). Prints the card,
the wall time per step with and without the profiler, the device time per
step summed over kernels, the kernel launches per step, the device busy
share (device time / profiled wall time) and the kernels by device time.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_profile: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import PPI, build_synthetic
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import SupervisedGraphSage

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    graph = Graph(**build_synthetic(**PPI))
    model = SupervisedGraphSage(
        label_idx=0, label_dim=121, metapath=[[0], [0]], fanouts=[10, 10],
        dim=256, feature_idx=1, feature_dim=50, max_id=graph.max_node_id,
        device_features=True, device_sampling=True)
    state = model.init_state(graph, train.get_optimizer("adam", 0.01))
    scan = train.make_scan_train(model, args.steps, 512)
    state, _ = scan(state, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = scan(state, 1)
    torch.cuda.synchronize()
    print(f"wall {(time.perf_counter() - t0) / args.steps * 1e3:.4f} "
          "ms/step (not profiled)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, losses = scan(state, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (a CPU op carries its kernels' device time
    # too), and no user annotations (the optimizer's range spans its
    # kernels and the gaps between them)
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            per_kernel[e.name][0] += e.time_range.elapsed_us()
            per_kernel[e.name][1] += 1
    device_us = sum(us for us, _ in per_kernel.values())
    launches = sum(n for _, n in per_kernel.values())
    print(f"wall {wall / args.steps * 1e3:.4f} ms/step (profiled), device "
          f"{device_us / args.steps / 1e3:.4f} ms/step summed over "
          f"{launches / args.steps:.1f} kernel launches/step, busy share "
          f"{device_us / 1e6 / wall:.4f}, final loss {float(losses[-1]):.5f}")
    print(f"{'device us/step':>15} {'calls/step':>10}  kernel")
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    for name, (us, n) in top[:args.top]:
        print(f"{us / args.steps:15.3f} {n / args.steps:10.1f}  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
