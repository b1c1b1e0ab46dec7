"""Hand-written Hopper kernels for the device draws (counterpart of
``euler_tpu/graph/pallas_sampling.py``).

- ``sample_neighbor`` is the single-hop weighted draw, one launch of
  ``csrc/sample_neighbor.cu``, which replaces the TPU kernel
  ``pallas_sampling._kernel``. Its plain PyTorch version,
  ``sample_neighbor_reference``, is ``graph/device.py``'s slab draw.
- ``sample_fanout2`` is the chained two-hop weighted draw: both fanout
  hops in one launch of ``csrc/sample_fanout2.cu``, which replaces the TPU
  kernel ``pallas_sampling._fanout2_kernel``. Its plain version,
  ``sample_fanout2_reference``, is two chained plain draws.

Both kernels run one draw routine (``csrc/draw.cuh``), as the TPU kernels
share ``_stage_draw``. They take a slab of any width: up to
``etpu_draw_max_width()`` (1,024) slots a warp holds a row in registers,
and a wider slab takes the wide path, a block a row streaming its ``cum``
through shared memory, where the JAX package keeps its XLA chain past the
TPU kernels' ``MAX_W``; the C entry chooses the path. The wide path
counts a row over its first ``deg[row]`` slots, which equals the count
over W on every slab ``device.build_adjacency`` makes (its padding ``cum``
is 1.0, which no uniform reaches), so a slab on the card carries ``deg``.
The kernels' one limit is their C interface's int: rows, width, nodes and
counts up to 2^31 - 1, which is also as many rows as int32 ids can name.
Both take slabs only: an alias table has no kernel, and
``device.sample_fanout`` / ``device.neighbor_draw`` route it to the
plain alias draw before any wrapper here. Routing is by where the tensors lie, and nothing
else: CPU tensors run the plain version, CUDA tensors launch the kernel
or raise. ``launches`` counts each kernel's launches, so a run can show
that its path went through the kernels.

Under a mesh (``parallel.mesh``), ``sample_neighbor_sharded`` and
``sample_fanout2_sharded`` draw one rank's slice of a data-sharded batch
with that rank's folded seed words, through the same kernels;
``sharded_launches`` counts the kernel launches made inside them (each
also counts in ``launches``).
"""

from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch.graph import device as device_graph

# kernel launches in this process, by kernel
launches = {"sample_fanout2": 0, "sample_neighbor": 0}
# the kernel launches made inside the sharded routes (each also counts in
# ``launches``)
sharded_launches = {"sample_fanout2_sharded": 0,
                    "sample_neighbor_sharded": 0}


def sample_neighbor_reference(adj: dict, nodes, seed_words, count: int,
                              hop: int = 0, u=None):
    """[*nodes.shape, count] int32: the plain version of
    ``sample_neighbor``, ``device.sample_neighbor``."""
    return device_graph.sample_neighbor(adj, nodes, count, seed_words,
                                        hop=hop, u=u)


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
    if "deg" not in adj:
        raise ValueError(f"{name}: the kernel reads the slab's deg [R] int32, "
                         "as device.build_adjacency makes it")
    nbr, cum, ok, deg = adj["nbr"], adj["cum"], adj["sampleable"], adj["deg"]
    for key, t, dtype in (("nbr", nbr, torch.int32),
                          ("cum", cum, torch.float32),
                          ("sampleable", ok, torch.bool),
                          ("deg", deg, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes {key} as a contiguous {dtype} "
                f"tensor on {dev}; got {t.dtype} on {t.device}"
            )
    if nbr.shape != cum.shape or nbr.shape[0] != n_rows or (
        ok.shape != (n_rows,) or deg.shape != (n_rows,)
    ):
        raise ValueError(
            f"{name}: nbr/cum must be [R, W] and sampleable/deg [R] over one "
            f"id space of {n_rows} rows; got {tuple(nbr.shape)}, "
            f"{tuple(cum.shape)}, {tuple(ok.shape)}, {tuple(deg.shape)}"
        )


def _injected(u, shape, dev):
    if u is None:
        return None
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    return u.reshape(shape).contiguous()


def _device_of(t, name: str):
    """``t.device`` when it is a CUDA device, None for the CPU (the plain
    version runs), and an error for any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {t.device}")
    return t.device


_INT_MAX = 2**31 - 1


def _library_for(**dims):
    """The kernels' library, after checking that every dimension fits the
    kernels' C interface (int: up to 2^31 - 1)."""
    from euler_tpu_torch import _build

    big = {k: v for k, v in dims.items() if v > _INT_MAX}
    if big:
        raise ValueError(
            f"{big} exceed the kernels' limit of 2^31 - 1 (their C "
            "interface's int) for rows, width, nodes and counts"
        )
    return _build.load_library()


def sample_neighbor(adj: dict, nodes, seed_words, count: int, hop: int = 0,
                    u=None):
    """[*nodes.shape, count] int32 weighted draws with replacement, one
    kernel launch on CUDA tensors.

    ``adj`` is a slab dict (``nbr`` int32 [R, W], ``cum`` float32 [R, W],
    ``sampleable`` bool [R], ``deg`` int32 [R], as
    ``device.build_adjacency`` makes it); the default id is R-1.
    ``seed_words`` is two 32-bit ints keying the Philox uniforms at
    counter (node index, draw, ``hop``, 0); ``u`` [len(nodes), count]
    float32 replaces them."""
    shape = tuple(nodes.shape)
    m = nodes.numel()
    if u is not None:
        u_shape = tuple(torch.as_tensor(u).shape)
        if u_shape not in ((m, count), (*shape, count)):
            raise ValueError(
                f"u must be [{m}, {count}] for {m} nodes and count {count}; "
                f"got {u_shape}"
            )
    dev = _device_of(nodes, "sample_neighbor")
    if dev is None:
        return sample_neighbor_reference(adj, nodes, seed_words, count,
                                         hop, u)
    n_rows = adj["nbr"].shape[0]
    _check_slab(adj, n_rows, dev, "adj")
    if nodes.dtype != torch.int32:
        raise ValueError(f"nodes must be int32, got {nodes.dtype}")
    if count <= 0 or hop < 0:
        raise ValueError(f"need count > 0 and hop >= 0, got {count}, {hop}")
    out = torch.empty((m, count), dtype=torch.int32, device=dev)
    if m == 0:
        return out.reshape(*shape, count)
    width = adj["nbr"].shape[1]
    lib = _library_for(rows=n_rows, width=width, nodes=m, count=count)
    flat = nodes.reshape(-1).contiguous()
    u = _injected(u, (m, count), dev)
    k0, k1 = seed_words
    rc = lib.etpu_sample_neighbor(
        flat.data_ptr(), m,
        adj["nbr"].data_ptr(), adj["cum"].data_ptr(),
        adj["sampleable"].data_ptr(), adj["deg"].data_ptr(),
        n_rows, width, count, hop, ctypes.c_uint32(k0), ctypes.c_uint32(k1),
        None if u is None else u.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"sample_neighbor kernel launch failed: CUDA error {rc}")
    launches["sample_neighbor"] += 1
    return out.reshape(*shape, count)


def sample_fanout2(adj1: dict, adj2: dict, roots, seed_words, f1: int,
                   f2: int, u1=None, u2=None):
    """(hop1 [m, f1], hop2 [m*f1, f2]) int32 weighted draws with
    replacement, both hops in one kernel launch on CUDA tensors.

    ``adj1``/``adj2`` are slab dicts (``nbr`` int32 [R, W], ``cum``
    float32 [R, W], ``sampleable`` bool [R], ``deg`` int32 [R], as
    ``sample_neighbor``'s) over one id space of R rows, of any widths;
    the default id is R-1. ``seed_words`` is two 32-bit ints keying the
    Philox uniforms; ``u1`` [m, f1] and ``u2`` [m*f1, f2] float32 replace
    them (inject both or neither)."""
    if (u1 is None) != (u2 is None):
        raise ValueError("inject both u1 and u2 or neither")
    roots = roots.reshape(-1)
    dev = _device_of(roots, "sample_fanout2")
    if dev is None:
        return sample_fanout2_reference(adj1, adj2, roots, seed_words, f1,
                                        f2, u1, u2)
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
    w1, w2 = adj1["nbr"].shape[1], adj2["nbr"].shape[1]
    lib = _library_for(rows=n_rows, width=max(w1, w2), roots=m, f1=f1,
                       f2=f2)
    roots = roots.contiguous()
    u1 = _injected(u1, (m, f1), dev)
    u2 = _injected(u2, (m * f1, f2), dev)
    k0, k1 = seed_words
    rc = lib.etpu_sample_fanout2(
        roots.data_ptr(), m,
        adj1["nbr"].data_ptr(), adj1["cum"].data_ptr(),
        adj1["sampleable"].data_ptr(), adj1["deg"].data_ptr(),
        adj2["nbr"].data_ptr(), adj2["cum"].data_ptr(),
        adj2["sampleable"].data_ptr(), adj2["deg"].data_ptr(),
        n_rows, w1, w2, f1, f2, ctypes.c_uint32(k0), ctypes.c_uint32(k1),
        None if u1 is None else u1.data_ptr(),
        None if u2 is None else u2.data_ptr(),
        out1.data_ptr(), out2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sample_fanout2 kernel launch failed: CUDA error {rc}")
    launches["sample_fanout2"] += 1
    return out1, out2


# the golden-ratio odd constant the JAX package folds into each shard's
# seed words (pallas_sampling.py, sample_neighbor_sharded)
_FOLD = 0x9E3779B1


def folded_words(seed_words, data_rank: int) -> tuple:
    """The seed words of data shard ``data_rank``: ``(data_rank + 1) *
    0x9E3779B1`` added to both words with 32-bit wraparound, as the JAX
    package's sharded draws fold ``axis_index`` into their int32 words,
    so no two shards replay one Philox stream against different rows."""
    add = ((data_rank + 1) * _FOLD) & 0xFFFFFFFF
    return tuple((int(w) + add) & 0xFFFFFFFF for w in seed_words)


def sample_neighbor_sharded(adj: dict, nodes, seed_words, count: int, mesh,
                            hop: int = 0, draw_fn=None):
    """``sample_neighbor`` on this rank's slice of a batch sharded over
    ``mesh``'s data axis (counterpart of the JAX package's
    ``sample_neighbor_sharded``): ``nodes`` are the rank's own, the
    adjacency is replicated, and the draw runs with the rank's folded
    seed words (``folded_words``). ``draw_fn(adj, nodes, words, count,
    hop=)`` defaults to the kernel's wrapper; the CPU tests pass the plain
    version."""
    if draw_fn is None:
        draw_fn = sample_neighbor
    words = folded_words(seed_words, mesh.data_rank)
    before = launches["sample_neighbor"]
    out = draw_fn(adj, nodes, words, count, hop=hop)
    sharded_launches["sample_neighbor_sharded"] += (
        launches["sample_neighbor"] - before)
    return out


def sample_fanout2_sharded(adj1: dict, adj2: dict, roots, seed_words,
                           f1: int, f2: int, mesh, draw_fn=None):
    """``sample_fanout2`` on this rank's slice of a batch sharded over
    ``mesh``'s data axis (counterpart of the JAX package's
    ``sample_fanout2_sharded``), with the rank's folded seed words, as
    ``sample_neighbor_sharded``. ``draw_fn(adj1, adj2, roots, words, f1,
    f2)`` defaults to the kernel's wrapper."""
    if draw_fn is None:
        draw_fn = sample_fanout2
    words = folded_words(seed_words, mesh.data_rank)
    before = launches["sample_fanout2"]
    out = draw_fn(adj1, adj2, roots, words, f1, f2)
    sharded_launches["sample_fanout2_sharded"] += (
        launches["sample_fanout2"] - before)
    return out
