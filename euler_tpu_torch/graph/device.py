"""Device-resident graph sampling: adjacency on the card, fanout inside
the train step (counterpart of ``euler_tpu/graph/device.py``).

The table builders are numpy copies of the JAX package's and return the
same dicts; ``tensors`` moves one onto a device. The draws are plain
PyTorch on those tensors, with the JAX package's semantics:

- ``build_adjacency`` exports a padded slab per edge-type set:
  ``nbr [N+2, W] int32`` neighbor ids, ``cum [N+2, W] float32``
  normalized cumulative weights (last real slot pinned to exactly 1.0),
  ``deg`` and ``sampleable``. Row ``max_id+1`` is the default node.
- ``sample_neighbor`` draws with replacement: ``idx = #(u >= cum[row])``
  clipped to W-1; unknown ids draw from the default row, rows of zero
  total weight yield the default node.
- ``build_node_sampler`` / ``sample_node`` draw roots weight-
  proportionally through the two-level (segment, then within-segment)
  cumulative that stays exact beyond float32's resolution (see ``SEG``).
- ``sample_fanout`` chains the hops; a two-hop fanout runs as ONE call of
  ``sampling_kernels.sample_fanout2``, the hand-written Hopper kernel on
  CUDA tensors.

Randomness: every draw takes injected uniforms (``u=``) so tests can
replay the JAX package's threefry uniforms bit for bit. Without them the
neighbor draws use ``philox_uniform``, a Philox4x32-10 stream keyed by two
32-bit seed words and countered by (row, column, hop), which the CUDA
kernel computes identically; roots come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def _fetch_flat_csr(graph, edge_types, max_id: int, chunk: int):
    """Chunked full-neighbor export: (counts [N+2] int64, nbr_flat int64,
    w_flat float32 contiguous, offsets [N+3] int64 with offsets[-1] ==
    len(nbr_flat)). Row max_id+1 (the default row) is always empty."""
    n_rows = max_id + 2
    et = list(edge_types)
    counts_all = np.zeros(n_rows, dtype=np.int64)
    nbr_parts: list[np.ndarray] = []
    w_parts: list[np.ndarray] = []
    for lo in range(0, max_id + 1, chunk):
        ids = np.arange(lo, min(lo + chunk, max_id + 1), dtype=np.int64)
        nbr, w, _, counts = graph.get_full_neighbor(ids, et)
        counts_all[lo:lo + len(ids)] = counts
        nbr_parts.append(nbr)
        w_parts.append(w)
    nbr_flat = (
        np.concatenate(nbr_parts) if nbr_parts else np.zeros(0, np.int64)
    )
    w_flat = np.ascontiguousarray(
        np.concatenate(w_parts) if w_parts else np.zeros(0), np.float32
    )
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts_all, out=offsets[1:])
    return counts_all, nbr_flat, w_flat, offsets


def build_adjacency(
    graph,
    edge_types,
    max_id: int,
    max_degree: int | None = None,
    chunk: int = 65536,
) -> dict:
    """Export the adjacency restricted to ``edge_types`` as slabs.

    Returns {"nbr": [N+2, W] int32, "cum": [N+2, W] float32, "deg": [N+2]
    int32, "sampleable": [N+2] bool} with N = max_id + 1; W = observed max
    degree, or the ``max_degree`` cap (rows beyond it keep their W
    heaviest neighbors, renormalized, with a warning). Rows whose weights
    sum to 0 keep their neighbors but are not ``sampleable``."""
    n_rows = max_id + 2
    default = max_id + 1
    counts_all, nbr_flat, w_flat, offsets = _fetch_flat_csr(
        graph, edge_types, max_id, chunk
    )

    W = int(counts_all.max()) if len(counts_all) else 0
    truncated = np.zeros(0, dtype=np.int64)
    if max_degree is not None and W > max_degree:
        W = max_degree
        truncated = np.flatnonzero(counts_all > W)
    W = max(W, 1)

    rows = np.repeat(np.arange(n_rows), counts_all)
    cols = np.arange(len(nbr_flat)) - np.repeat(offsets[:-1], counts_all)
    keep = cols < W  # drop overflow entries; truncated rows redone below
    nbr_out = np.full((n_rows, W), default, dtype=np.int32)
    cum_out = np.ones((n_rows, W), dtype=np.float32)
    nbr_out[rows[keep], cols[keep]] = nbr_flat[keep]
    # per-row normalized cumulative weights from one flat float64 cumsum
    csum = np.cumsum(w_flat, dtype=np.float64)
    csum_z = np.concatenate([[0.0], csum])
    row_base = csum_z[np.repeat(offsets[:-1], counts_all)]
    row_total = (csum_z[offsets[1:]] - csum_z[offsets[:-1]])[rows]
    with np.errstate(invalid="ignore", divide="ignore"):
        cum_flat = (csum_z[1:] - row_base) / row_total
    cum_out[rows[keep], cols[keep]] = cum_flat[keep]
    # the last real slot is exactly 1 so u < 1 always lands in-row
    has = counts_all > 0
    cum_out[np.flatnonzero(has), np.minimum(counts_all[has], W) - 1] = 1.0
    # zero-total rows: neighbors exist, sampling mass does not
    zero_w = np.flatnonzero(
        has & (csum_z[offsets[1:]] - csum_z[offsets[:-1]] <= 0)
    )
    sampleable = np.ones(n_rows, dtype=bool)
    if len(zero_w):
        cum_out[zero_w] = 1.0
        sampleable[zero_w] = False

    for i in truncated:  # keep the heaviest W neighbors, exactly
        nb = nbr_flat[offsets[i]:offsets[i + 1]]
        wt = w_flat[offsets[i]:offsets[i + 1]]
        sel = np.argsort(wt)[::-1][:W]
        nb, wt = nb[sel], wt[sel]
        total = wt.sum()
        if total <= 0:
            continue
        nbr_out[i, :W] = nb
        c = np.cumsum(wt) / total
        c[-1] = 1.0
        cum_out[i, :W] = c
    if len(truncated):
        warnings.warn(
            f"build_adjacency: {len(truncated)} rows exceeded "
            f"max_degree={W}; truncated to their heaviest neighbors "
            "(renormalized)"
        )
    return {
        "nbr": nbr_out,
        "cum": cum_out,
        "deg": np.minimum(counts_all, W).astype(np.int32),
        "sampleable": sampleable,
    }


SEG = 1 << 16  # two-level draw segment size: a single float32 cumulative
# over ~16M comparably-weighted nodes collides at float32 resolution
# (spacing near 1.0 is 2^-24) and tail nodes get probability 0.
# Normalizing WITHIN 2^16-node segments keeps adjacent steps >= ~2^-16,
# and the segment-level cumulative holds to ~2^36 nodes.


def _segment_cum(weights: np.ndarray, seg: int | None = None):
    """(seg_cum [S] f32, within [M] f32): float64 host cumsum split into
    ceil(M/seg) segments, the last entry of every segment pinned to 1.0.
    All weights must be > 0 (the callers filter), so every segment total
    is positive."""
    if seg is None:
        seg = SEG
    w = weights.astype(np.float64)
    m = len(w)
    starts = np.arange(0, m, seg)
    seg_tot = np.add.reduceat(w, starts)
    seg_cum = np.cumsum(seg_tot)
    seg_cum /= seg_cum[-1]
    seg_cum[-1] = 1.0
    cum = np.cumsum(w)
    base = np.concatenate([[0.0], np.cumsum(seg_tot)])
    seg_idx = np.arange(m) // seg
    within = (cum - base[seg_idx]) / seg_tot[seg_idx]
    within[np.minimum(starts + seg, m) - 1] = 1.0  # pin segment ends
    return seg_cum.astype(np.float32), within.astype(np.float32)


def build_node_sampler(graph, node_type: int = -1, max_id: int = 0) -> dict:
    """Weighted root sampler for one node type (-1 = all types): the
    two-level layout {"ids": [M] int32, "cum": [M] float32 (normalized
    within SEG-node segments), "seg_cum": [S] float32} over the nodes of
    positive weight, sorted by id."""
    ids = np.arange(max_id + 1, dtype=np.int64)
    weights = graph.node_weights(ids)
    if node_type != -1:
        mask = graph.node_types(ids) == node_type
        ids, weights = ids[mask], weights[mask]
    keep = weights > 0
    ids, weights = ids[keep], weights[keep]
    if len(ids) == 0:
        raise ValueError(f"no nodes of type {node_type} with weight > 0")
    seg_cum, within = _segment_cum(weights)
    return {
        "ids": ids.astype(np.int32),
        "cum": within,
        "seg_cum": seg_cum,
    }


def tensors(arrays: dict, device) -> dict:
    """The numpy arrays of a table dict as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


# ---- draws ----


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def seed_words(seed: int) -> tuple[int, int]:
    """The two 32-bit Philox key words of a host integer seed."""
    return seed & _U32, (seed >> 32) & _U32


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    int64 tensors ``b`` holding 32-bit values, without int64 overflow:
    the product is split at 16 bits of ``b``."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    32-bit words: ``counter`` is four broadcastable int64 tensors on one
    device, ``key`` two ints; returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def philox_uniform(seed_words, hop: int, rows: int, cols: int,
                   device=None) -> torch.Tensor:
    """[rows, cols] float32 uniforms in [0, 1): Philox4x32-10 keyed by
    ``seed_words`` at counter (row, column, hop, 0), first output word,
    top 24 bits scaled by 2^-24 (exact in float32). The CUDA kernel
    computes the same numbers, so kernel and plain version agree bit for
    bit without injected uniforms."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = torch.full((1, 1), hop, dtype=torch.int64, device=device)
    x0 = philox4x32((r, c, h, torch.zeros_like(h)), seed_words)[0]
    return (x0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _bisect_first_ge(cum, lo, hi, u, steps: int):
    """Vectorized first index in [lo, hi) with cum[idx] >= u (fixed-depth
    binary search)."""
    M = max(int(cum.shape[0]), 1)
    for _ in range(steps):
        active = lo < hi
        # lo + (hi - lo)//2, NOT (lo + hi)//2: lo+hi can wrap in int32
        mid = lo + (hi - lo) // 2
        go_right = cum[mid.clamp(0, M - 1)] < u
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.clamp(0, M - 1)


def sample_node(sampler: dict, count: int, generator=None, u=None):
    """[count] int32 roots drawn weight-proportionally: u1 picks a
    SEG-node segment from seg_cum, u2 bisects that segment's cumulative.
    ``u`` = (u1, u2), each [count] float32, replaces the generator's
    uniforms."""
    ids = sampler["ids"]
    if u is None:
        u1 = torch.rand(count, generator=generator, device=ids.device)
        u2 = torch.rand(count, generator=generator, device=ids.device)
    else:
        u1, u2 = (
            torch.as_tensor(x, dtype=torch.float32, device=ids.device)
            for x in u
        )
    m = int(ids.shape[0])
    seg_cum = sampler["seg_cum"]
    s = torch.searchsorted(seg_cum, u1).clamp(0, seg_cum.shape[0] - 1)
    lo = s * SEG
    hi = (lo + SEG).clamp(max=m)
    steps = max(min(m, SEG).bit_length(), 1)
    idx = _bisect_first_ge(sampler["cum"], lo, hi, u2, steps)
    return ids[idx]


def sample_neighbor(adj: dict, nodes, count: int, seed_words=None,
                    hop: int = 0, u=None):
    """[*nodes.shape, count] int32 weighted neighbor draws (replacement),
    the plain slab draw: per draw the first slot whose cumulative weight
    exceeds u. Negative and past-the-slab ids draw from the default row;
    rows of zero total weight yield the default node. ``u`` ([len(nodes),
    count] float32) replaces the Philox uniforms of ``seed_words`` at
    ``hop``."""
    nbr, cum = adj["nbr"], adj["cum"]
    n_rows, width = nbr.shape
    flat = nodes.reshape(-1)
    flat = torch.where(flat < 0, n_rows - 1, flat.clamp(max=n_rows - 1))
    m = flat.shape[0]
    if u is None:
        u = philox_uniform(seed_words, hop, m, count, device=nbr.device)
    u = torch.as_tensor(u, dtype=torch.float32, device=nbr.device)
    u = u.reshape(m, count)
    # index = #thresholds at or below u  (u < cum[0] -> 0, ...)
    idx = (u[:, :, None] >= cum.index_select(0, flat)[:, None, :]).sum(-1)
    idx = idx.clamp(max=width - 1)
    out = nbr.index_select(0, flat).gather(1, idx)
    ok = adj["sampleable"].index_select(0, flat)[:, None]
    out = torch.where(ok, out, n_rows - 1)
    return out.reshape(*nodes.shape, count)


def sample_fanout(adjs, roots, counts, seed_words=None, u=None):
    """Multi-hop fanout: [roots, hop1, hop2, ...] flat int32 tensors, hop
    h sized len(roots) * prod(counts[:h+1]). ``adjs`` holds one adjacency
    per hop; ``u`` one injected [rows, count] uniform tensor per hop.

    Two hops over slabs of one id space run as one call of the chained
    draw ``sampling_kernels.sample_fanout2`` (the Hopper kernel on CUDA
    tensors). Other fanouts run hop by hop with the plain draw, on the
    CPU only until the single-hop kernel is ported."""
    from euler_tpu_torch.graph import sampling_kernels

    if len(adjs) != len(counts):
        raise ValueError(
            f"sample_fanout needs one adjacency per hop: got {len(adjs)} "
            f"adjacencies for {len(counts)} fanout counts"
        )
    roots = roots.reshape(-1)
    u = [None] * len(counts) if u is None else list(u)
    if len(counts) == 2 and adjs[0]["nbr"].shape[0] == adjs[1]["nbr"].shape[0]:
        h1, h2 = sampling_kernels.sample_fanout2(
            adjs[0], adjs[1], roots, seed_words, counts[0], counts[1],
            u1=u[0], u2=u[1],
        )
        return [roots, h1.reshape(-1), h2.reshape(-1)]
    if roots.is_cuda:
        raise NotImplementedError(
            f"a {len(counts)}-hop fanout on CUDA needs the single-hop draw "
            "kernel, which is not ported yet; only two-hop fanouts run on "
            "the card"
        )
    out = [roots]
    cur = roots
    for h, (adj, c) in enumerate(zip(adjs, counts)):
        cur = sample_neighbor(adj, cur, c, seed_words, hop=h, u=u[h])
        cur = cur.reshape(-1)
        out.append(cur)
    return out
