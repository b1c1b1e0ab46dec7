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
- ``build_alias_adjacency`` exports the exact form for heavy-tailed
  graphs instead: flat-CSR Walker alias tables (``off``, ``deg``, ``nbr``,
  ``alias``, ``prob``, ``sampleable``), O(E) memory and no width cap.
  ``sample_neighbor`` dispatches on its ``"off"`` key to the O(1) alias
  draw, which has no kernel: it is plain PyTorch on every device.
- ``build_node_sampler`` / ``sample_node`` draw roots weight-
  proportionally through the two-level (segment, then within-segment)
  cumulative that stays exact beyond float32's resolution (see ``SEG``).
- ``sample_fanout`` chains the hops; a two-hop fanout over two slabs runs
  as ONE call of ``sampling_kernels.sample_fanout2``, other fanouts hop by
  hop through ``neighbor_draw``: ``sampling_kernels.sample_neighbor`` for
  a slab (the hand-written Hopper kernels on CUDA tensors), the alias
  draw for an alias table.
- ``multi_hop_neighbor`` expands the full neighborhoods of roots hop by
  hop over slabs, deduplicated up to static node caps: deterministic,
  plain PyTorch on every device, no kernel (the GCN models' expansion).
- ``random_walk`` chains ``neighbor_draw`` one step at a time (over a
  slab on CUDA tensors, one single-hop kernel launch a step);
  ``biased_random_walk`` (node2vec's p/q over id-sorted slabs,
  ``sorted=True``) and ``alias_biased_random_walk`` (the exact rejection
  walk over id-sorted alias tables) are plain PyTorch on every device,
  as the JAX package runs them outside any kernel.

Randomness: every draw takes injected uniforms (``u=``) so tests can
replay the JAX package's threefry uniforms bit for bit. Without them the
neighbor draws use ``philox_uniform``, a Philox4x32-10 stream keyed by two
32-bit seed words and countered by (row, column, hop), which the CUDA
kernels compute identically; ``stream_words`` gives the independent
streams of one step. Roots come from an explicit ``torch.Generator`` or,
for draws that must agree between CPU and CUDA (negatives), from
``philox_uniform`` too.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def _fetch_flat_csr(graph, edge_types, max_id: int, chunk: int,
                    sorted: bool = False):
    """Chunked full-neighbor export: (counts [N+2] int64, nbr_flat int64,
    w_flat float32 contiguous, offsets [N+3] int64 with offsets[-1] ==
    len(nbr_flat)). Row max_id+1 (the default row) is always empty.
    ``sorted`` merges each row's edge types by id."""
    n_rows = max_id + 2
    et = list(edge_types)
    counts_all = np.zeros(n_rows, dtype=np.int64)
    nbr_parts: list[np.ndarray] = []
    w_parts: list[np.ndarray] = []
    for lo in range(0, max_id + 1, chunk):
        ids = np.arange(lo, min(lo + chunk, max_id + 1), dtype=np.int64)
        nbr, w, _, counts = graph.get_full_neighbor(ids, et, sorted=sorted)
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
    sorted: bool = False,
    _prefetched=None,
) -> dict:
    """Export the adjacency restricted to ``edge_types`` as slabs.

    Returns {"nbr": [N+2, W] int32, "cum": [N+2, W] float32, "deg": [N+2]
    int32, "sampleable": [N+2] bool} with N = max_id + 1; W = observed max
    degree, or the ``max_degree`` cap (rows beyond it keep their W
    heaviest neighbors, renormalized, with a warning). Rows whose weights
    sum to 0 keep their neighbors but are not ``sampleable``.

    ``sorted=True`` exports id-ordered rows, the precondition of
    ``biased_random_walk``'s membership search: a truncated row keeps its
    heaviest W neighbors in id order, and padding is the default id, the
    largest, so whole rows ascend. ``_prefetched`` is a
    ``_fetch_flat_csr`` result to build from (the truncation guard in
    ``Model.add_sampling_consts`` fetches once for both builders)."""
    n_rows = max_id + 2
    default = max_id + 1
    counts_all, nbr_flat, w_flat, offsets = (
        _prefetched if _prefetched is not None
        else _fetch_flat_csr(graph, edge_types, max_id, chunk, sorted=sorted)
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
        if sorted:  # the heaviest W, in id order
            sel = np.sort(sel)
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


def _build_alias_rows(offsets: np.ndarray, weights: np.ndarray):
    """(prob [E] float32, alias [E] int32 row-local slots): Vose's alias
    table of every CSR row, bit for bit the native engine's
    ``eg::BuildAliasRows``. Per row: the float64 sum of its weights in
    order, ``scale = n / total``, ``scaled = w * scale``; slots below 1.0
    go to ``small`` and the rest to ``large``, both in index order and
    popped from the back; each small slot keeps ``prob = scaled`` (stored
    as float32) and aliases the large one, whose ``scaled`` loses
    ``1 - scaled[s]``. Slots left over, and rows of zero total, keep
    ``prob = 1`` and alias themselves.

    A row whose weights are all equal scales every slot alike, so either
    no slot is small or none is large: the loop pairs nothing and the row
    keeps the defaults. Only the other rows run the loop, in Python (every
    row of an unweighted graph skips it)."""
    e = len(weights)
    counts = np.diff(offsets)
    base = np.repeat(offsets[:-1], counts)  # each slot's row start
    prob = np.ones(e, np.float32)
    alias = (np.arange(e, dtype=np.int64) - base).astype(np.int32)
    differs = np.flatnonzero(weights != weights[base])  # NaN differs too
    mixed = np.unique(np.searchsorted(offsets, differs, side="right") - 1)
    for r in mixed.tolist():
        lo, n = int(offsets[r]), int(counts[r])
        w = weights[lo:lo + n].tolist()
        total = 0.0
        for x in w:
            total += x
        if total <= 0.0:
            continue
        scale = n / total
        scaled = [x * scale for x in w]
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if not scaled[i] < 1.0]
        row_prob = [1.0] * n
        row_alias = list(range(n))
        while small and large:
            sm = small.pop()
            lg = large.pop()
            row_prob[sm] = scaled[sm]
            row_alias[sm] = lg
            scaled[lg] -= 1.0 - scaled[sm]
            (small if scaled[lg] < 1.0 else large).append(lg)
        prob[lo:lo + n] = np.asarray(row_prob, np.float64)  # float32 cast
        alias[lo:lo + n] = row_alias
    return prob, alias


def build_alias_adjacency(graph, edge_types, max_id: int,
                          chunk: int = 65536, sorted: bool = False,
                          _prefetched=None) -> dict:
    """Export the adjacency restricted to ``edge_types`` as exact
    flat-CSR alias tables: every neighbor kept, no ``max_degree`` cap, 12
    bytes an edge (1.38 GB at Reddit's 114.6M edges).

    Returns {"off": [N+2] int32 row starts, "deg": [N+2] int32, "nbr":
    [E] int32, "alias": [E] int32 (global ids, so a draw needs no second
    hop through the row), "prob": [E] float32, "sampleable": [N+2] bool,
    "bisect_steps": [max(bit_length(max degree), 1)] int8 zeros, kept for
    the rejection walk's bisection depth} with N = max_id + 1. Unknown
    ids, the default row and rows of zero total weight draw the default
    node. ``sorted=True`` exports id-sorted rows, the precondition of
    ``alias_biased_random_walk``'s membership bisection (the alias draw
    itself does not care about order); with one edge type the rows are
    sorted either way. ``_prefetched`` as in ``build_adjacency``."""
    n_rows = max_id + 2
    default = max_id + 1
    counts_all, nbr_flat, w_flat, offsets = (
        _prefetched if _prefetched is not None
        else _fetch_flat_csr(graph, edge_types, max_id, chunk, sorted=sorted)
    )
    e = len(nbr_flat)
    if e >= 1 << 31:
        raise ValueError(
            f"alias adjacency needs int32 slots: {e} edges; shard the "
            "graph first"
        )
    prob, alias_local = _build_alias_rows(offsets, w_flat)
    row_base = np.repeat(offsets[:-1], counts_all)
    alias_ids = nbr_flat[row_base + alias_local].astype(np.int32)
    csum_z = np.concatenate([[0.0], np.cumsum(w_flat, dtype=np.float64)])
    sums = csum_z[offsets[1:]] - csum_z[offsets[:-1]]
    sampleable = (counts_all > 0) & (sums > 0)
    sampleable[default] = False
    max_deg = int(counts_all.max()) if len(counts_all) else 0
    return {
        "off": offsets[:-1].astype(np.int32),
        "deg": counts_all.astype(np.int32),
        "nbr": nbr_flat.astype(np.int32),
        "alias": alias_ids,
        "prob": prob,
        "sampleable": sampleable,
        "bisect_steps": np.zeros(max(max_deg.bit_length(), 1), np.int8),
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


def stream_words(seed: int, stream: int) -> tuple[int, int]:
    """The seed words of Philox stream ``stream`` of a step's integer
    ``seed``: ``seed_words(seed)`` for stream 0, and for stream s the high
    word xor s * 0x9E3779B9 (odd, so a bijection of s mod 2^32). For
    seeds below 2^32, as the trainer's step seeds are, distinct (seed,
    stream) pairs get distinct key words, so no two streams of any steps
    share a (key, counter) pair."""
    k0, k1 = seed_words(seed)
    return k0, k1 ^ ((stream * _PHILOX_W[0]) & _U32)


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


def _philox_grid(seed_words, hop: int, rows: int, cols: int, device):
    """The four Philox4x32-10 words at counter (row, column, hop, 0) for
    every cell of a [rows, cols] grid."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = torch.full((1, 1), hop, dtype=torch.int64, device=device)
    return philox4x32((r, c, h, torch.zeros_like(h)), seed_words)


def _top24(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit word's top 24 bits scaled by 2^-24: a float32 uniform in
    [0, 1), exact."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def philox_uniform(seed_words, hop: int, rows: int, cols: int,
                   device=None) -> torch.Tensor:
    """[rows, cols] float32 uniforms in [0, 1): Philox4x32-10 keyed by
    ``seed_words`` at counter (row, column, hop, 0), first output word,
    top 24 bits scaled by 2^-24 (exact in float32). The CUDA kernel
    computes the same numbers, so kernel and plain version agree bit for
    bit without injected uniforms."""
    return _top24(_philox_grid(seed_words, hop, rows, cols, device)[0])


def philox_uniforms(seed_words, hop: int, rows: int, cols: int, n: int,
                    device=None):
    """``n`` (up to four) [rows, cols] float32 uniforms from one Philox
    call: words 0..n-1 at the same counter (row, column, hop, 0), each cut
    as in ``philox_uniform`` (whose numbers are the first). The alias
    draw takes two (slot and coin), the rejection walk three (slot, coin
    and accept)."""
    x = _philox_grid(seed_words, hop, rows, cols, device)
    return tuple(_top24(w) for w in x[:n])


def _default_clamped(nodes, default: int):
    """Negative and past-the-table ids sent to the default row."""
    return torch.where(nodes < 0, default, nodes.clamp(max=default))


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


def sample_node(sampler: dict, count: int, generator=None, u=None,
                seed_words=None):
    """[count] int32 roots drawn weight-proportionally: u1 picks a
    SEG-node segment from seg_cum, u2 bisects that segment's cumulative.
    The uniforms are ``u`` = (u1, u2), each [count] float32, when given;
    else columns 0 and 1 of ``philox_uniform(seed_words, 0, count, 2)``
    when ``seed_words`` is given (the same on every device); else the
    generator's."""
    ids = sampler["ids"]
    if u is None and seed_words is not None:
        u1, u2 = philox_uniform(seed_words, 0, count, 2,
                                device=ids.device).t().contiguous()
    elif u is None:
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


def _alias_sample_neighbor(adj: dict, nodes, count: int, seed_words=None,
                           hop: int = 0, u=None):
    """[*nodes.shape, count] int32 exact draws from alias tables: slot j =
    min(int32(u1 * deg), deg - 1), computed in float32 as the JAX package
    does; keep ``nbr`` at the slot when u2 < ``prob``, else ``alias``.
    Negative and unknown ids draw from the default row; unsampleable and
    empty rows, and every draw of a table with no edges, yield the default
    node. ``u`` = (u1, u2), each [len(nodes), count] float32, replaces
    ``philox_uniforms(seed_words, hop, ..., 2)``."""
    off = adj["off"]
    dev = off.device
    n_rows = off.shape[0]
    default = n_rows - 1
    flat = nodes.reshape(-1)
    flat = _default_clamped(flat, default).long()
    m = flat.shape[0]
    e = adj["prob"].shape[0]
    if e == 0:  # no edges of these types at all: everything defaults
        return torch.full((*nodes.shape, count), default, dtype=torch.int32,
                          device=dev)
    if u is None:
        u1, u2 = philox_uniforms(seed_words, hop, m, count, 2, device=dev)
    else:
        u1, u2 = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                  .reshape(m, count) for x in u)
    deg = adj["deg"].index_select(0, flat)[:, None]          # int32 [m, 1]
    j = torch.minimum((u1 * deg).to(torch.int32), (deg - 1).clamp(min=0))
    # empty rows at the CSR's end start at off == E; their draws are
    # masked below, so the clamp only keeps the gather in bounds
    slot = (off.index_select(0, flat)[:, None].long() + j).clamp(max=e - 1)
    pick = torch.where(u2 < adj["prob"][slot], adj["nbr"][slot],
                       adj["alias"][slot])
    ok = adj["sampleable"].index_select(0, flat) & (deg[:, 0] > 0)
    out = torch.where(ok[:, None], pick, default)
    return out.reshape(*nodes.shape, count)


def sample_neighbor(adj: dict, nodes, count: int, seed_words=None,
                    hop: int = 0, u=None):
    """[*nodes.shape, count] int32 weighted neighbor draws (replacement),
    the plain draw. An alias table (``"off"`` key) takes
    ``_alias_sample_neighbor``. A slab takes per draw the first slot whose
    cumulative weight exceeds u. Negative and past-the-slab ids draw from
    the default row; rows of zero total weight yield the default node.
    ``u`` ([len(nodes), count] float32) replaces the Philox uniforms of
    ``seed_words`` at ``hop``."""
    if "off" in adj:
        return _alias_sample_neighbor(adj, nodes, count, seed_words, hop, u)
    nbr, cum = adj["nbr"], adj["cum"]
    n_rows, width = nbr.shape
    flat = nodes.reshape(-1)
    flat = _default_clamped(flat, n_rows - 1)
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


def neighbor_draw(adj: dict, nodes, count: int, seed_words=None,
                  hop: int = 0, u=None):
    """One hop's draw as a model makes it: a slab (``"cum"``) takes
    ``sampling_kernels.sample_neighbor`` (the Hopper kernel on CUDA
    tensors), an alias table the plain ``sample_neighbor`` (its draw has
    no kernel). Arguments as ``sample_neighbor``'s; ``u`` is (u1, u2) for
    an alias table."""
    if "cum" not in adj:
        return sample_neighbor(adj, nodes, count, seed_words, hop, u)
    from euler_tpu_torch.graph import sampling_kernels

    return sampling_kernels.sample_neighbor(adj, nodes, seed_words, count,
                                            hop=hop, u=u)


def sample_fanout(adjs, roots, counts, seed_words=None, u=None):
    """Multi-hop fanout: [roots, hop1, hop2, ...] flat int32 tensors, hop
    h sized len(roots) * prod(counts[:h+1]). ``adjs`` holds one adjacency
    per hop; ``u`` one injected uniform per hop ([rows, count], or the
    pair (u1, u2) for an alias table).

    Two hops over two slabs (``"cum"``) of one id space run as one call of
    the chained draw ``sampling_kernels.sample_fanout2``; other fanouts
    run hop by hop through ``neighbor_draw`` at hop h (the single-hop
    kernel for a slab, with the same Philox counters as the chained one,
    so both routes draw the same picks; the alias draw for an alias
    table, which never reaches a kernel)."""
    from euler_tpu_torch.graph import sampling_kernels

    if len(adjs) != len(counts):
        raise ValueError(
            f"sample_fanout needs one adjacency per hop: got {len(adjs)} "
            f"adjacencies for {len(counts)} fanout counts"
        )
    roots = roots.reshape(-1)
    u = [None] * len(counts) if u is None else list(u)
    if (len(counts) == 2 and all("cum" in a for a in adjs)
            and adjs[0]["nbr"].shape[0] == adjs[1]["nbr"].shape[0]):
        h1, h2 = sampling_kernels.sample_fanout2(
            adjs[0], adjs[1], roots, seed_words, counts[0], counts[1],
            u1=u[0], u2=u[1],
        )
        return [roots, h1.reshape(-1), h2.reshape(-1)]
    out = [roots]
    cur = roots
    for h, (adj, c) in enumerate(zip(adjs, counts)):
        cur = neighbor_draw(adj, cur, c, seed_words, hop=h, u=u[h])
        cur = cur.reshape(-1)
        out.append(cur)
    return out


def multi_hop_neighbor(adjs, roots, node_caps):
    """Full-neighbor multi-hop expansion with per-hop dedup over slabs:
    deterministic, no draw and no kernel (plain PyTorch on every device,
    as the JAX package computes it in XLA ops).

    Per hop: gather each current node's slab row, mask the columns at or
    past its degree to the default id, dense-rank the flat ``[C*W]`` ids
    by a stable sort, and emit ``{"nodes": [cap] int32 (the unique ids in
    ascending order, default-padded), "src"/"dst": [C*W] int32 indices
    into the current/next hop's nodes, "mask": [C*W] float32 1.0 on real
    edges, "w": the same tensor as "mask"}``. The default id is the
    largest, so padding sorts last. A hop with more than ``node_caps[h]``
    unique ids drops the largest ones: their edges are masked out and
    their ``dst`` clipped to cap-1. Hop h+1 expands hop h's default-padded
    ``nodes``; the default row has degree 0 and gives no edges.

    Ids past the slab read the default row, as in the JAX function;
    negative ids do too, where the JAX function wraps them (no model
    passes one: roots come clipped)."""
    cur = roots.reshape(-1).to(torch.int32)
    hops = []
    for adj, cap in zip(adjs, node_caps):
        nbr, deg = adj["nbr"], adj["deg"]
        default = nbr.shape[0] - 1
        width = nbr.shape[1]
        rows = _default_clamped(cur, default).long()
        c = rows.shape[0]
        valid = (torch.arange(width, device=nbr.device)[None, :]
                 < deg.index_select(0, rows)[:, None])
        flat = torch.where(valid, nbr.index_select(0, rows),
                           default).reshape(-1)                # [C*W]
        order = torch.argsort(flat, stable=True)
        s = flat[order]
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        rank_sorted = torch.cumsum(first, 0) - 1               # int64
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted
        # ranks past the cap land in a spare slot that is cut off
        nodes = torch.full((cap + 1,), default, dtype=torch.int32,
                           device=nbr.device)
        nodes[rank_sorted.clamp(max=cap)] = s
        mask = (valid.reshape(-1) & (rank < cap)
                & (flat != default)).to(torch.float32)
        hops.append({
            "nodes": nodes[:cap],
            "src": torch.arange(c, dtype=torch.int32,
                                device=nbr.device).repeat_interleave(width),
            "dst": rank.clamp(0, cap - 1).to(torch.int32),
            "mask": mask,
            "w": mask,
        })
        cur = hops[-1]["nodes"]
    return hops


# ---- walks ----


def random_walk(adj, roots, walk_len: int, seed_words=None, u=None):
    """[len(roots), walk_len+1] int32 walks (column 0 = the roots as
    given). Step i is one ``neighbor_draw(adj_i, cur, 1, seed_words,
    hop=i)``: over a slab held as CUDA tensors one launch of the
    single-hop kernel at [M, 1], over an alias table the plain alias draw.
    Dead ends (and unknown ids) chain into the default row and stay there.

    ``adj`` is one table, or a list of ``walk_len`` tables (the metapath
    form). ``u`` holds one injected uniform per step ([M, 1], or the pair
    (u1, u2) for an alias table) in place of the Philox stream."""
    adjs = list(adj) if isinstance(adj, (list, tuple)) else [adj] * walk_len
    if len(adjs) != walk_len:
        raise ValueError(f"metapath walk needs {walk_len} per-step "
                         f"adjacencies, got {len(adjs)}")
    u = [None] * walk_len if u is None else list(u)
    cur = roots.reshape(-1).to(torch.int32)
    cols = [cur]
    for i in range(walk_len):
        cur = neighbor_draw(adjs[i], cur, 1, seed_words, hop=i,
                            u=u[i]).reshape(-1)
        cols.append(cur)
    return torch.stack(cols, dim=1)


def biased_random_walk(adj, roots, walk_len: int, p: float, q: float,
                       seed_words=None, u=None):
    """[len(roots), walk_len+1] int32 node2vec-biased walks over an
    id-sorted slab (``build_adjacency(..., sorted=True)``), plain PyTorch
    on every device: the reference's ``BuildWeights`` scales a candidate's
    weight by 1 when it is a neighbor of the parent (d_tx = 1), else by
    1/p when it is the parent (d_tx = 0), else by 1/q, then draws over
    the rescaled row. On a parent self-loop d_tx = 1 wins, as the
    reference merge's branch order has it.

    The membership test searches each candidate in the parent's sorted
    row (``torch.searchsorted``, left side, row by row). Step 0 has no
    parent and takes the plain weighted draw over the row, here (not the
    single-hop kernel, as the JAX function does not take
    ``sample_neighbor`` there). Dead ends and unknown ids chain into the
    default row. Step i's uniforms are ``philox_uniform(seed_words, i,
    M, 1)``, or ``u[i]`` ([M, 1]) when injected."""
    nbr, cum = adj["nbr"], adj["cum"]
    deg, sampleable = adj["deg"], adj["sampleable"]
    n_rows, width = nbr.shape
    default = n_rows - 1
    roots = roots.reshape(-1).to(torch.int32)
    m = roots.shape[0]
    cur = _default_clamped(roots, default).long()
    parent = torch.full_like(cur, default)
    prow = None  # the parent's row: the previous step's candidates
    slot = torch.arange(width, device=nbr.device)
    # 1/p and 1/q rounded to float32, as the JAX package's scales are
    scales = (float(np.float32(1.0 / p)), float(np.float32(1.0 / q)))
    cols = [roots]
    for step in range(walk_len):
        cand = nbr.index_select(0, cur)                      # [M, W]
        c = cum.index_select(0, cur)
        w = torch.cat([c[:, :1], c[:, 1:] - c[:, :-1]], dim=1)
        w = w * (slot[None, :] < deg.index_select(0, cur)[:, None])
        w = w * sampleable.index_select(0, cur)[:, None]
        if prow is not None:
            pos = torch.searchsorted(prow, cand)
            hit = prow.gather(1, pos.clamp(max=width - 1)) == cand
            in_parent = hit & (pos < deg.index_select(0, parent)[:, None])
            is_parent = cand == parent[:, None]
            w = w * torch.where(
                in_parent, 1.0, torch.where(is_parent, *scales))
        cw = torch.cumsum(w, dim=1)
        total = cw[:, -1:]
        cw = cw / total.clamp(min=1e-30)
        us = (philox_uniform(seed_words, step, m, 1, device=nbr.device)
              if u is None else torch.as_tensor(
                  u[step], dtype=torch.float32,
                  device=nbr.device).reshape(m, 1))
        idx = (us >= cw).sum(1).clamp(max=width - 1)
        nxt = cand.gather(1, idx[:, None])[:, 0]
        nxt = torch.where(total[:, 0] > 0, nxt, default)
        parent, cur, prow = cur, nxt.long(), cand
        cols.append(nxt)
    return torch.stack(cols, dim=1)


DEFAULT_WALK_TRIALS = 64  # the rejection walk's proposals a step: at the
# worst realistic node2vec point (p or q = 1/4, envelope 4) acceptance is
# at least 1/16, so (1 - 1/16)^64, about 1.6% of steps, fall back to the
# first (unbiased) proposal; p and q near 1 accept at once.


def _alias_biased_step(adj, cur, parent, p: float, q: float, trials: int,
                       u):
    """One exact node2vec-biased transition over full neighbor lists:
    ``trials`` proposals from the current node's alias row (u1 the slot,
    u2 the alias coin), each accepted with probability s/M (u3), where s
    is the reference's d_tx scale (1 for a neighbor of the parent, which
    wins on a parent self-loop; 1/p for the parent; 1/q otherwise) and
    M = max(1/p, 1, 1/q). Accepted proposals are distributed as w * s
    exactly; when every trial is rejected, the walker takes its first
    proposal. Membership bisects the parent's id-sorted CSR row
    (``build_alias_adjacency(..., sorted=True)``) to the table's
    ``bisect_steps`` depth. ``u`` = (u1, u2, u3), each [len(cur),
    trials] float32. Returns [len(cur)] int32 next nodes."""
    off, deg_t, prob = adj["off"], adj["deg"], adj["prob"]
    nbrs, alias = adj["nbr"], adj["alias"]
    default = off.shape[0] - 1
    e = prob.shape[0]
    b = cur.shape[0]
    if e == 0:
        return torch.full((b,), default, dtype=torch.int32, device=off.device)
    u1, u2, u3 = (torch.as_tensor(x, dtype=torch.float32, device=off.device)
                  .reshape(b, trials) for x in u)
    deg = deg_t.index_select(0, cur)[:, None]                 # int32 [b, 1]
    j = torch.minimum((u1 * deg).to(torch.int32), (deg - 1).clamp(min=0))
    slot = (off.index_select(0, cur)[:, None].long() + j).clamp(max=e - 1)
    cand = torch.where(u2 < prob[slot], nbrs[slot], alias[slot])
    # first flat index in [plo, phi) of the parent's row with nbr >= cand
    plo = off.index_select(0, parent).long()
    phi = plo + deg_t.index_select(0, parent).long()
    plo, phi = (x[:, None].expand(b, trials) for x in (plo, phi))
    pos = _bisect_first_ge(nbrs, plo, phi, cand,
                           int(adj["bisect_steps"].shape[0]))
    hit = (nbrs[pos.clamp(0, e - 1)] == cand) & (pos < phi)
    is_parent = cand == parent[:, None]
    # s/M divided in float32, as the JAX package divides its float32 s
    m = np.float32(max(1.0 / p, 1.0, 1.0 / q))
    t_hit, t_parent, t_other = (float(np.float32(s) / m)
                                for s in (1.0, 1.0 / p, 1.0 / q))
    accept = u3 < torch.where(hit, t_hit,
                              torch.where(is_parent, t_parent, t_other))
    # the first accepted trial; none accepted -> argmax 0, the first
    first = accept.to(torch.uint8).argmax(dim=1)
    pick = cand.gather(1, first[:, None])[:, 0]
    ok = adj["sampleable"].index_select(0, cur) & (deg[:, 0] > 0)
    return torch.where(ok, pick, default)


def alias_biased_random_walk(adj, roots, walk_len: int, p: float, q: float,
                             trials: int | None = None, seed_words=None,
                             u=None):
    """[len(roots), walk_len+1] int32 node2vec-biased walks drawn exactly
    over full neighbor lists, the heavy-tail form of
    ``biased_random_walk``: proposals from id-sorted alias tables
    (``build_alias_adjacency(..., sorted=True)``), rejection-corrected to
    the d_tx-scaled distribution (``_alias_biased_step``). Plain PyTorch
    on every device; no kernel.

    Unknown ids walk from the default row (column 0 holds them clamped,
    as in the JAX function). Step 0 has no parent and is the plain alias
    draw at hop 0; dead ends chain into the default row. ``trials``
    bounds a step's proposals (default ``DEFAULT_WALK_TRIALS``). Step i
    >= 1 takes ``philox_uniforms(seed_words, i, M, trials, 3)``: words 0, 1
    and 2 at counter (walker, trial, i, 0). ``u`` injects one entry a
    step instead: (u1, u2) [M, 1] for step 0, (u1, u2, u3) [M, trials]
    after it."""
    if trials is None:
        trials = DEFAULT_WALK_TRIALS
    default = adj["off"].shape[0] - 1
    dev = adj["off"].device
    cur = _default_clamped(roots.reshape(-1).to(torch.int32), default)
    m = cur.shape[0]
    parent = torch.full_like(cur, default)
    u = [None] * walk_len if u is None else list(u)
    cols = [cur]
    for step in range(walk_len):
        if step == 0:
            nxt = _alias_sample_neighbor(adj, cur, 1, seed_words, hop=0,
                                         u=u[0])[:, 0]
        else:
            us = (u[step] if u[step] is not None else
                  philox_uniforms(seed_words, step, m, trials, 3,
                                  device=dev))
            nxt = _alias_biased_step(adj, cur.long(), parent.long(), p, q,
                                     trials, us)
        parent, cur = cur, nxt
        cols.append(cur)
    return torch.stack(cols, dim=1)
