"""Hand-written Hopper kernels for the device draws (counterpart of
``euler_tpu/graph/pallas_sampling.py``).

``sample_fanout2`` is the chained two-hop weighted draw: both fanout hops
in one launch of ``csrc/sample_fanout2.cu``, which replaces the TPU kernel
``pallas_sampling._fanout2_kernel``. Beside it, ``sample_fanout2_reference``
is its plain PyTorch version: the two chained plain draws of
``graph/device.py``.

Routing is by where the tensors lie, and nothing else: CPU tensors run
the plain version, CUDA tensors launch the kernel or raise. ``launches``
counts kernel launches, so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch.graph import device as device_graph

launches = 0  # kernel launches of sample_fanout2 in this process


def sample_fanout2_reference(adj1: dict, adj2: dict, roots, seed_words,
                             f1: int, f2: int, u1=None, u2=None):
    """(hop1 [m, f1], hop2 [m*f1, f2]) int32: the plain version of
    ``sample_fanout2``, two chained ``device.sample_neighbor`` draws."""
    hop1 = device_graph.sample_neighbor(adj1, roots.reshape(-1), f1,
                                        seed_words, hop=0, u=u1)
    hop2 = device_graph.sample_neighbor(adj2, hop1.reshape(-1), f2,
                                        seed_words, hop=1, u=u2)
    return hop1, hop2


def _check_slab(adj: dict, n_rows: int, dev: torch.device, name: str):
    nbr, cum, ok = adj["nbr"], adj["cum"], adj["sampleable"]
    for t, dtype in ((nbr, torch.int32), (cum, torch.float32),
                     (ok, torch.bool)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous {dtype} tensors on "
                f"{dev}; got {t.dtype} on {t.device}"
            )
    if nbr.shape != cum.shape or nbr.shape[0] != n_rows or (
        ok.shape != (n_rows,)
    ):
        raise ValueError(
            f"{name}: nbr/cum must be [R, W] and sampleable [R] over one id "
            f"space of {n_rows} rows; got {tuple(nbr.shape)}, "
            f"{tuple(cum.shape)}, {tuple(ok.shape)}"
        )


def _injected(u, shape, dev):
    if u is None:
        return None
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    return u.reshape(shape).contiguous()


def sample_fanout2(adj1: dict, adj2: dict, roots, seed_words, f1: int,
                   f2: int, u1=None, u2=None):
    """(hop1 [m, f1], hop2 [m*f1, f2]) int32 weighted draws with
    replacement, both hops in one kernel launch on CUDA tensors.

    ``adj1``/``adj2`` are slab dicts (``nbr`` int32 [R, W], ``cum``
    float32 [R, W], ``sampleable`` bool [R]) over one id space of R rows;
    the default id is R-1. ``seed_words`` is two 32-bit ints keying the
    Philox uniforms; ``u1`` [m, f1] and ``u2`` [m*f1, f2] float32 replace
    them (inject both or neither)."""
    global launches
    if (u1 is None) != (u2 is None):
        raise ValueError("inject both u1 and u2 or neither")
    roots = roots.reshape(-1)
    if roots.device.type == "cpu":
        return sample_fanout2_reference(adj1, adj2, roots, seed_words, f1,
                                        f2, u1, u2)
    if roots.device.type != "cuda":
        raise ValueError(
            f"sample_fanout2 runs on CPU or CUDA tensors, not {roots.device}"
        )
    dev = roots.device
    n_rows = adj1["nbr"].shape[0]
    _check_slab(adj1, n_rows, dev, "adj1")
    _check_slab(adj2, n_rows, dev, "adj2")
    if roots.dtype != torch.int32:
        raise ValueError(f"roots must be int32, got {roots.dtype}")
    if f1 <= 0 or f2 <= 0:
        raise ValueError(f"fanout counts must be positive, got {f1}, {f2}")
    m = roots.shape[0]
    out1 = torch.empty((m, f1), dtype=torch.int32, device=dev)
    out2 = torch.empty((m * f1, f2), dtype=torch.int32, device=dev)
    if m == 0:
        return out1, out2
    from euler_tpu_torch import _build

    lib = _build.load_library()
    w1, w2 = adj1["nbr"].shape[1], adj2["nbr"].shape[1]
    if max(w1, w2) > lib.etpu_fanout2_max_width():
        raise ValueError(
            f"slab width {max(w1, w2)} exceeds the kernel's register layout "
            f"({lib.etpu_fanout2_max_width()}); cap it with "
            "build_adjacency(max_degree=...)"
        )
    roots = roots.contiguous()
    u1 = _injected(u1, (m, f1), dev)
    u2 = _injected(u2, (m * f1, f2), dev)
    k0, k1 = seed_words
    rc = lib.etpu_sample_fanout2(
        roots.data_ptr(), m,
        adj1["nbr"].data_ptr(), adj1["cum"].data_ptr(),
        adj1["sampleable"].data_ptr(),
        adj2["nbr"].data_ptr(), adj2["cum"].data_ptr(),
        adj2["sampleable"].data_ptr(),
        n_rows, w1, w2, f1, f2, ctypes.c_uint32(k0), ctypes.c_uint32(k1),
        None if u1 is None else u1.data_ptr(),
        None if u2 is None else u2.data_ptr(),
        out1.data_ptr(), out2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sample_fanout2 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out1, out2
