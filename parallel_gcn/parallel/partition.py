"""Graph partitioning for multi-chip aggregation.

The reference is single-GPU (SURVEY.md §2.4: no DP/TP/PP anywhere); the scaling
dimension of this workload is graph size, and its scale-out is
**node partitioning**: contiguous row blocks of the CSR per device, the
device's edges (all edges whose destination row it owns) kept local, and the
remote source features fetched between devices during aggregation.

Host-side preprocessing produces equal-shaped per-device COO slabs (shard_map
needs identical static shapes on every device); per-device edge counts are padded to
the max across devices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from parallel_gcn.data.graph import HostCSR, pad_to_multiple


@dataclass(frozen=True)
class ShardedGraph:
    """Per-device COO slabs, stacked on a leading device axis.

    Flat layout (``ring=False``): row_local[d, e] is the destination row
    *within device d's shard* (shard rows are the global rows
    [d·n_local, (d+1)·n_local)); col[d, e] is the *global* source node id
    (resolved against the all-gathered features). Padding entries carry val 0
    and in-bounds indices.

    Ring layout (``ring=True``): arrays gain a ring-step axis —
    row_local/col/val are [n_dev, n_dev, e_slab], where slab ``s`` on device
    ``d`` holds exactly the edges whose source node lives in the block owned by
    device ``(d - s) mod n_dev`` — the block device ``d`` is holding at ring
    step ``s`` of the ``ppermute`` rotation. ``col`` is then the source index
    *within that block* (source node id mod n_local).

    Boundary layout (``send_idx is not None``): ``col`` indexes the COMPACT
    per-device halo buffer ``[x_local ; all_to_all-received rows]`` instead of
    the all-gathered matrix — device d fetches ONLY the remote rows its edges
    reference (train_parallel._halo_buffer). ``send_idx[d]`` lists, in
    ``n_dev`` chunks of ``halo_size``, the local row ids device d sends to
    each peer. Peak per-device feature memory drops from O(N·F) to
    O((n_local + n_dev·halo_size)·F).
    """

    row_local: np.ndarray  # int32 [n_dev, e_local] | [n_dev, n_dev, e_slab]
    col: np.ndarray  # int32, same shape as row_local
    val: np.ndarray  # float32, same shape as row_local
    n_dev: int
    n_local: int  # rows per device
    n_real_nodes: int
    n_real_edges: int
    ring: bool = False
    send_idx: np.ndarray | None = None  # int32 [n_dev, n_dev*halo_size]
    halo_size: int = 0  # rows per (src-device, dst-device) exchange slab
    # Adaptive (push/pull) halo — partition_graph(adaptive=True): for each
    # off-diagonal device pair (s=col owner, d=row owner) the exchange runs in
    # whichever direction moves fewer rows. PULL pairs (unique source rows ≤
    # unique dest rows) stay in row_local/col/val against the compact halo
    # buffer as in the boundary layout. PUSH pairs move their edges to the
    # SOURCE owner: device s computes partial sums over its local features
    # (push_col: LOCAL source row; push_row: slot d·push_slab+k of the compact
    # partial buffer), one all_to_all ships the partial ROWS, and the receiver
    # scatter-adds them at push_recv[s·push_slab+k] (n_local = padding slot).
    # Hub-heavy graphs (power-law degrees) pull enormous neighborhoods but
    # push few rows — the per-pair choice bounds the slab by min(pull, push).
    push_row: np.ndarray | None = None  # int32 [n_dev, e_push]
    push_col: np.ndarray | None = None  # int32 [n_dev, e_push]
    push_val: np.ndarray | None = None  # float32 [n_dev, e_push]
    push_recv: np.ndarray | None = None  # int32 [n_dev, n_dev*push_slab]
    push_slab: int = 0

    @property
    def n_nodes_pad(self) -> int:
        return self.n_dev * self.n_local

    @property
    def n_buf(self) -> int:
        """Rows of the per-device source-feature buffer the column indices
        resolve against: the full gathered matrix (all_gather halo) or the
        compact local+halo buffer (boundary halo)."""
        if self.send_idx is not None:
            return self.n_local + self.n_dev * self.halo_size
        return self.n_nodes_pad


def _slice_coo_by_dest(rows, cols, vals, n_dev, n_local, n_pad):
    """Cut row-sorted COO triplets into per-dest-device slabs of equal static
    shape (padding: val 0, row n_local-1, col n_pad-1)."""
    rows = np.asarray(rows, dtype=np.int64)
    bounds = np.searchsorted(rows, np.arange(1, n_dev) * n_local)
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(rows)]])
    e_local = pad_to_multiple(max(int((ends - starts).max()), 1), 128)
    row_s = np.full((n_dev, e_local), n_local - 1, dtype=np.int32)
    col_s = np.full((n_dev, e_local), n_pad - 1, dtype=np.int32)
    val_s = np.zeros((n_dev, e_local), dtype=np.float32)
    for d in range(n_dev):
        s, e = int(starts[d]), int(ends[d])
        cnt = e - s
        row_s[d, :cnt] = (rows[s:e] - d * n_local).astype(np.int32)
        col_s[d, :cnt] = cols[s:e]
        val_s[d, :cnt] = vals[s:e]
    return row_s, col_s, val_s


def _build_boundary_exchange(needed, n_dev, n_local, block: int = 1):
    """Build the all_to_all send schedule for a boundary halo.

    ``needed[d][b]``: int64 array of GLOBAL row ids (owned by device b, b≠d)
    that device d must fetch, in the order they will occupy d's halo slab for
    b (callers that mix block- and row-granular requests put the blocks first
    so block starts stay ``block``-aligned). Returns ``(send_idx, H)`` where
    ``H`` is the per-(src,dst) slab size (max request length, rounded up to a
    multiple of ``block``) and ``send_idx[b]`` holds, in ``n_dev`` chunks of
    ``H``, the LOCAL row ids device b sends to each destination d (chunk d).
    Padding slots send local row 0 — receivers never index padded positions.
    """
    H = 1
    for d in range(n_dev):
        for b in range(n_dev):
            H = max(H, len(needed[d][b]))
    H = pad_to_multiple(H, block)
    send_idx = np.zeros((n_dev, n_dev * H), np.int32)
    for b in range(n_dev):
        for d in range(n_dev):
            req = np.asarray(needed[d][b], dtype=np.int64)
            if len(req):
                send_idx[b, d * H : d * H + len(req)] = req - b * n_local
    return send_idx, H


def _remap_cols_boundary(col_s, val_s, n_dev, n_local):
    """Row-granular boundary remap for flat COO slabs: compute each device's
    remote boundary set from its live columns, and rewrite ``col`` to index
    the compact ``[local ; halo]`` buffer. Returns (col_new, send_idx, H)."""
    needed = [[np.empty(0, np.int64)] * n_dev for _ in range(n_dev)]
    for d in range(n_dev):
        g = col_s[d].astype(np.int64)[val_s[d] != 0]
        owner = g // n_local
        for b in range(n_dev):
            if b != d:
                needed[d][b] = np.unique(g[owner == b])
    send_idx, H = _build_boundary_exchange(needed, n_dev, n_local)
    col_new = np.zeros_like(col_s)
    for d in range(n_dev):
        g = col_s[d].astype(np.int64)
        owner = g // n_local
        res = np.zeros(len(g), np.int64)
        local = owner == d
        res[local] = g[local] - d * n_local
        for b in range(n_dev):
            m = (~local) & (owner == b)
            if m.any():
                res[m] = n_local + b * H + np.searchsorted(needed[d][b], g[m])
        res[val_s[d] == 0] = 0  # padding edges: val 0, point at local row 0
        col_new[d] = res.astype(np.int32)
    return col_new, send_idx, H


def _adaptive_pair_modes(rows, cols, n_dev, n_local):
    """Per-pair push/pull classification for the adaptive halo.

    For each off-diagonal (src-device s, dst-device d) pair, counts the
    unique SOURCE rows the pull exchange would ship (raw feature rows s→d)
    against the unique DEST rows the push exchange would ship (partial-sum
    rows s→d) and picks the smaller. Returns ``mode_push`` [n_dev, n_dev]
    (True where push wins — strictly smaller, so ties keep the simpler pull).
    """
    n_pad = n_dev * n_local
    dev_r = rows // n_local
    dev_c = cols // n_local
    off = dev_r != dev_c
    pair = (dev_c[off] * n_dev + dev_r[off]).astype(np.int64)
    pull_cnt = np.bincount(
        np.unique(pair * n_pad + cols[off]) // n_pad, minlength=n_dev * n_dev
    )
    push_cnt = np.bincount(
        np.unique(pair * n_pad + rows[off]) // n_pad, minlength=n_dev * n_dev
    )
    mode_push = (push_cnt < pull_cnt) & (push_cnt > 0)
    # the all_to_all slabs pad every pair to the max of its category, so the
    # exchange footprint is max(pull-chosen) + max(push-chosen) rows — only
    # split the traffic when that actually beats the pure-pull max (dense
    # graphs with near-uniform pair sizes would otherwise pay BOTH maxes)
    mixed = (
        int(pull_cnt[~mode_push].max(initial=0))
        + int(push_cnt[mode_push].max(initial=0))
    )
    if mixed >= int(pull_cnt.max(initial=0)):
        mode_push[:] = False
    return mode_push.reshape(n_dev, n_dev)


def _build_push_slabs(rows, cols, vals, n_dev, n_local):
    """Per-SOURCE-device slabs for the push edges (see ShardedGraph docstring).

    Edges are laid out sorted by (src device, dst device, dst row) so
    ``push_row`` ascends within each device slab (segment_sum keeps its
    sorted-ids fast path). Returns
    (push_row, push_col, push_val, push_recv, push_slab)."""
    n_pad = n_dev * n_local
    dev_r = (rows // n_local).astype(np.int64)
    dev_c = (cols // n_local).astype(np.int64)
    pair = dev_c * n_dev + dev_r
    key = pair * n_pad + rows  # sorts by (src dev, dst dev, dst row)
    uniq, inv = np.unique(key, return_inverse=True)
    upair = uniq // n_pad
    pair_start = np.searchsorted(upair, np.arange(n_dev * n_dev))
    slot = np.arange(len(uniq)) - pair_start[upair]
    per_pair = np.bincount(upair, minlength=n_dev * n_dev)
    push_slab = pad_to_multiple(max(int(per_pair.max()), 1), 8)

    order = np.argsort(key, kind="stable")
    src_dev = dev_c[order]
    e_cnt = np.bincount(src_dev, minlength=n_dev)
    e_push = pad_to_multiple(max(int(e_cnt.max()), 1), 128)
    starts = np.zeros(n_dev, np.int64)
    np.cumsum(e_cnt[:-1], out=starts[1:])
    pos = np.arange(len(order)) - starts[src_dev]

    # padding: val 0 into the LAST slot (keeps push_row ascending per device
    # for segment_sum's sorted-ids fast path) — a zero contribution to a
    # (possibly real) partial row, like the COO slabs' val-0 padding edges
    push_row = np.full((n_dev, e_push), n_dev * push_slab - 1, np.int32)
    push_col = np.zeros((n_dev, e_push), np.int32)
    push_val = np.zeros((n_dev, e_push), np.float32)
    push_row[src_dev, pos] = (
        dev_r[order] * push_slab + slot[inv[order]]
    ).astype(np.int32)
    push_col[src_dev, pos] = (cols[order] - src_dev * n_local).astype(np.int32)
    push_val[src_dev, pos] = vals[order]

    # receiver map: slot k of the slab from device s lands at local dst row
    # push_recv[d, s*push_slab + k]; unused slots point at the n_local dump
    # row (scatter mode='drop')
    push_recv = np.full((n_dev, n_dev * push_slab), n_local, np.int32)
    s_u, d_u = upair // n_dev, upair % n_dev
    push_recv[d_u, s_u * push_slab + slot] = (
        uniq % n_pad - d_u * n_local
    ).astype(np.int32)
    return push_row, push_col, push_val, push_recv, int(push_slab)


def _boundary_pays_off(n_local, n_dev, halo, n_pad, kind: str,
                       fallback: bool) -> bool:
    """Guard against a compact halo buffer that is NOT smaller than the full
    all_gathered matrix (possible because the all_to_all pads every
    (src, dst) slab to the max pair — a single skewed pair inflates all
    n_dev² slabs; one tiled all_to_all cannot carry ragged per-pair sizes).
    A user choosing boundary/adaptive to SAVE memory would get the opposite,
    silently. Returns True when the buffer is strictly smaller; otherwise
    warns and returns False (callers with ``fallback`` drop to all_gather)."""
    n_buf = n_local + n_dev * halo
    if n_buf < n_pad:
        return True
    import warnings

    warnings.warn(
        f"{kind} halo buffer ({n_buf} rows = {n_local} local + {n_dev} peers "
        f"x {halo}-row slabs) is not smaller than the all_gathered matrix "
        f"({n_pad} rows); the per-pair boundary sets are too uniform for the "
        "max-padded all_to_all slabs to pay off"
        + (" — falling back to the all_gather halo" if fallback else ""),
        stacklevel=3,
    )
    return False


def partition_graph(
    csr: HostCSR, n_dev: int, node_pad: int = 8, boundary: bool = False,
    adaptive: bool = False, boundary_fallback: bool = False,
) -> ShardedGraph:
    """Split a host CSR into ``n_dev`` contiguous row blocks.

    Rows are padded so every device owns the same number (a multiple of
    ``node_pad``); edge slabs are padded to the max per-device count rounded
    to 128. ``boundary=True`` precomputes the per-device boundary index sets
    and rewrites columns against the compact local+halo buffer (SURVEY.md
    §7.7's halo design; pairs with train_parallel's all_to_all exchange).
    ``adaptive=True`` (implies boundary) additionally re-routes each device
    PAIR's edges in whichever direction ships fewer rows — pull raw feature
    rows or push partial sums (see the ShardedGraph docstring); on hub-heavy
    graphs this bounds the exchange slab by min(pull, push) per pair.

    ``boundary_fallback=True``: when the compact buffer would not be smaller
    than the all_gathered matrix, warn and return the plain all_gather
    partition instead (see _boundary_pays_off) — fit_parallel sets this so a
    user choosing halo=boundary to save memory never gets the opposite.
    Default ``False`` keeps the requested layout (structural tests/dryruns),
    warning only.
    """
    n_local = pad_to_multiple(-(-csr.n_rows // n_dev), node_pad)
    n_pad = n_local * n_dev

    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    vals = csr.values

    push = (None, None, None, None, 0)
    if adaptive:
        boundary = True
        mode_push = _adaptive_pair_modes(rows, cols, n_dev, n_local)
        is_push = mode_push[cols // n_local, rows // n_local]
        if is_push.any():
            push = _build_push_slabs(
                rows[is_push], cols[is_push], vals[is_push], n_dev, n_local
            )
            # pull part keeps row-sorted order (sorted-subset)
            rows, cols, vals = rows[~is_push], cols[~is_push], vals[~is_push]

    # CSR expansion is row-sorted already
    row_local, col, val = _slice_coo_by_dest(
        rows, cols, vals, n_dev, n_local, n_pad
    )

    send_idx, halo = None, 0
    if boundary:
        col_b, send_idx, halo = _remap_cols_boundary(col, val, n_dev, n_local)
        if _boundary_pays_off(n_local, n_dev, halo,
                              n_pad, "adaptive" if adaptive else "boundary",
                              boundary_fallback):
            col = col_b
        elif boundary_fallback:
            if adaptive:
                # the push split already peeled edges out of rows/cols/vals;
                # rebuild the plain partition from the CSR
                return partition_graph(csr, n_dev, node_pad=node_pad)
            send_idx, halo = None, 0
        else:
            col = col_b

    return ShardedGraph(
        row_local=row_local,
        col=col,
        val=val,
        n_dev=n_dev,
        n_local=n_local,
        n_real_nodes=csr.n_rows,
        n_real_edges=csr.nnz,
        send_idx=send_idx,
        halo_size=halo,
        push_row=push[0], push_col=push[1], push_val=push[2],
        push_recv=push[3], push_slab=push[4],
    )


def partition_graph_ring(csr: HostCSR, n_dev: int, node_pad: int = 8) -> ShardedGraph:
    """Partition for the ``ppermute`` ring halo exchange (SURVEY.md §7.7).

    Each device's edges are additionally bucketed by *source block* and laid
    out in ring order: slab ``s`` of device ``d`` contains the edges whose
    source node belongs to device ``(d - s) mod n_dev`` — exactly the block
    that arrives at device ``d`` after ``s`` ring rotations. Slabs are padded
    to the max (device, step) edge count (rounded to 128) so every scan step
    has identical static shapes; per-slab rows stay sorted (padding rows are
    ``n_local - 1``, appended last) so ``segment_sum`` keeps its sorted-ids
    fast path.
    """
    n_local = pad_to_multiple(-(-csr.n_rows // n_dev), node_pad)

    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    vals = csr.values
    d = rows // n_local
    b = cols // n_local
    s = (d - b) % n_dev

    order = np.lexsort((rows, s, d))  # group by (d, s); row-sorted within
    group = (d[order] * n_dev + s[order]).astype(np.int64)
    counts = np.bincount(group, minlength=n_dev * n_dev)
    e_slab = pad_to_multiple(max(int(counts.max()), 1), 128)

    starts = np.zeros(n_dev * n_dev, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(len(order), dtype=np.int64) - starts[group]

    row_s = np.full((n_dev * n_dev, e_slab), n_local - 1, dtype=np.int32)
    col_s = np.zeros((n_dev * n_dev, e_slab), dtype=np.int32)
    val_s = np.zeros((n_dev * n_dev, e_slab), dtype=np.float32)
    row_s[group, pos] = (rows[order] - d[order] * n_local).astype(np.int32)
    col_s[group, pos] = (cols[order] % n_local).astype(np.int32)
    val_s[group, pos] = vals[order]

    shape = (n_dev, n_dev, e_slab)
    return ShardedGraph(
        row_local=row_s.reshape(shape),
        col=col_s.reshape(shape),
        val=val_s.reshape(shape),
        n_dev=n_dev,
        n_local=n_local,
        n_real_nodes=csr.n_rows,
        n_real_edges=csr.nnz,
        ring=True,
    )


@dataclass(frozen=True)
class HybridShardedGraph:
    """Row-block hybrid partition: per-device BCSR tile slabs (local tile-rows
    × GLOBAL tile-cols) + per-device COO residual (local dest rows × global
    source cols). Used with the all_gather halo: each device aggregates its
    own rows with dense tiles against the gathered features
    (train_parallel.graphsum_dist_hybrid). All per-device arrays are padded to
    identical static shapes.
    """

    tiles: np.ndarray  # [n_dev, T, tile_r, tile_c] (f32, bf16 or int8 pattern)
    trow: np.ndarray  # int32 [n_dev, T] — LOCAL tile-row ids, ascending
    tcol: np.ndarray  # int32 [n_dev, T] — GLOBAL tile-col ids
    res_row: np.ndarray  # int32 [n_dev, e_local] — local dest rows
    res_col: np.ndarray  # int32 [n_dev, e_local] — global source cols
    res_val: np.ndarray  # float32 [n_dev, e_local] (int8 mode: 1.0 / 0.0 pad)
    n_dev: int
    n_local: int
    n_real_nodes: int
    n_real_edges: int
    # int8 pattern mode: row-sharded d (= deg^{-1/2}) [n_dev, n_local]; the
    # aggregation becomes d_local ⊙ (slab(ag(d_local ⊙ x)) + residual) with
    # residual values 1 — scale-before-gather keeps ONE collective. None for
    # value (f32/bf16) packs.
    sym_scale: np.ndarray | None = None
    # boundary halo (see ShardedGraph): when set, tcol/res_col index the
    # compact [local ; halo] buffer; halo slabs are tile_c-aligned so fetched
    # tile-column blocks stay whole and the Pallas kernel addresses them
    # directly.
    send_idx: np.ndarray | None = None  # int32 [n_dev, n_dev*halo_size]
    halo_size: int = 0
    # slab-balancing node permutation (new_global_row -> old_global_row),
    # applied in whole tile_c blocks so tile contents move intact; None when
    # the natural order was already balanced. Callers must permute node-keyed
    # arrays (features/labels/split) the same way — shard_dataset does.
    node_perm: np.ndarray | None = None
    # Adaptive (push/pull) halo — partition_graph_hybrid(adaptive=True):
    # off-diagonal device pairs where PUSHING partial sums ships fewer rows
    # than pulling source rows/blocks move their tiles AND residual edges to
    # the SOURCE device. Push tiles form a per-source-device rect pack over
    # LOCAL columns with a COMPACT output row space (ptrow = ascending compact
    # block ids, every block covered); pt_dst scatters the compact partial
    # rows into the per-pair all_to_all slab (slots ≥ n_dev·push_slab drop).
    # Push residual edges segment-sum straight into slab slots (prow). The
    # receiver scatter-adds the exchanged rows at push_recv. None/0 when the
    # partition has no push pairs.
    ptiles: np.ndarray | None = None  # [n_dev, Tp, tile_r, tile_c]
    ptrow: np.ndarray | None = None   # int32 [n_dev, Tp] compact block ids
    ptcol: np.ndarray | None = None   # int32 [n_dev, Tp] LOCAL col blocks
    pt_dst: np.ndarray | None = None  # int32 [n_dev, Bp·tile_r] slab slots
    prow: np.ndarray | None = None    # int32 [n_dev, e_push] slab slots
    pcol: np.ndarray | None = None    # int32 [n_dev, e_push] local src rows
    pval: np.ndarray | None = None    # float32 [n_dev, e_push]
    push_recv: np.ndarray | None = None  # int32 [n_dev, n_dev·push_slab]
    push_slab: int = 0

    @property
    def n_nodes_pad(self) -> int:
        return self.n_dev * self.n_local

    @property
    def n_buf(self) -> int:
        if self.send_idx is not None:
            return self.n_local + self.n_dev * self.halo_size
        return self.n_nodes_pad


def _balance_block_perm(g_trow, n_blocks, blocks_per_dev, n_dev, rpt,
                        threshold: float = 1.2):
    """Greedy LPT assignment of tile_c-sized NODE blocks to devices so the
    per-device tile counts flatten (every device pads its slab to the max —
    imbalance is redundant zero-tile compute AND memory on every chip).

    ``g_trow``: global tile-row ids of the pack (tile_r granularity); ``rpt``
    = tile-rows per node block (tile_c // tile_r). Each device receives
    exactly ``blocks_per_dev`` blocks (static shapes), chosen to minimize the
    max summed tile weight. Returns block_perm (new_block -> old_block) or
    None when the natural contiguous order is already within ``threshold``.
    """
    w = np.bincount(g_trow // rpt, minlength=n_blocks).astype(np.int64)
    cur = w.reshape(n_dev, blocks_per_dev).sum(axis=1)
    if cur.max() <= threshold * max(cur.mean(), 1.0):
        return None
    order = np.argsort(-w, kind="stable")
    loads = np.zeros(n_dev, np.int64)
    caps = np.full(n_dev, blocks_per_dev, np.int64)
    assign = np.empty(n_blocks, np.int64)
    for blk in order:
        open_devs = np.flatnonzero(caps > 0)
        d = open_devs[np.argmin(loads[open_devs])]
        assign[blk] = d
        loads[d] += w[blk]
        caps[d] -= 1
    # device-major layout; within a device keep ascending old block ids (the
    # community/RCM locality inside each slab survives)
    return np.concatenate([np.flatnonzero(assign == d) for d in range(n_dev)])


def _hybrid_boundary(tiles, trow, tcol, res_col, res_val, n_dev, n_local,
                     tile_c):
    """Boundary exchange for hybrid slabs: device d fetches only the remote
    tile-column BLOCKS its tiles touch (whole, tile_c-aligned — the Pallas
    kernel addresses x by block id) plus the remote residual source ROWS not
    already inside a fetched block. Rewrites ``tcol``/``res_col`` in place to
    buffer coordinates; returns (send_idx, halo_size)."""
    Bl = n_local // tile_c
    blocks_req = [[None] * n_dev for _ in range(n_dev)]
    rows_req = [[None] * n_dev for _ in range(n_dev)]
    needed = [[np.empty(0, np.int64)] * n_dev for _ in range(n_dev)]
    for d in range(n_dev):
        # zero tiles (slab padding + coverage tiles) contribute nothing: point
        # them at the device's own first block so they never inflate the halo
        zero = ~tiles[d].reshape(tiles[d].shape[0], -1).any(axis=1)
        tcol[d][zero] = d * Bl
        blk = np.unique(tcol[d].astype(np.int64))
        g = res_col[d].astype(np.int64)[res_val[d] != 0]
        for b in range(n_dev):
            if b == d:
                continue
            bb = blk[blk // Bl == b]
            rr = np.unique(g[g // n_local == b])
            rr = rr[~np.isin(rr // tile_c, bb)]
            blocks_req[d][b] = bb
            rows_req[d][b] = rr
            needed[d][b] = np.concatenate([
                (bb[:, None] * tile_c + np.arange(tile_c)).reshape(-1), rr,
            ])
    send_idx, H = _build_boundary_exchange(needed, n_dev, n_local, block=tile_c)
    for d in range(n_dev):
        t = tcol[d].astype(np.int64)
        owner = t // Bl
        local = owner == d
        new_t = np.zeros_like(t)
        new_t[local] = t[local] - d * Bl
        for b in range(n_dev):
            m = (~local) & (owner == b)
            if m.any():
                new_t[m] = (n_local + b * H) // tile_c + np.searchsorted(
                    blocks_req[d][b], t[m]
                )
        tcol[d] = new_t.astype(np.int32)

        g = res_col[d].astype(np.int64)
        owner = g // n_local
        local = owner == d
        new_g = np.zeros_like(g)
        new_g[local] = g[local] - d * n_local
        for b in range(n_dev):
            m = (~local) & (owner == b)
            if not m.any():
                continue
            bb, rr = blocks_req[d][b], rows_req[d][b]
            gm = g[m]
            in_blk = np.isin(gm // tile_c, bb)
            base = n_local + b * H
            res = np.empty(len(gm), np.int64)
            res[in_blk] = (
                base
                + np.searchsorted(bb, gm[in_blk] // tile_c) * tile_c
                + gm[in_blk] % tile_c
            )
            res[~in_blk] = (
                base + len(bb) * tile_c + np.searchsorted(rr, gm[~in_blk])
            )
            new_g[m] = res
        new_g[res_val[d] == 0] = 0  # padding edges point at local row 0
        res_col[d] = new_g.astype(np.int32)
    return send_idx, H


def _hybrid_adaptive_split(g_trow, g_tcol, g_tiles, r_rows, r_cols, r_vals,
                           n_dev, n_local, tile_r, tile_c):
    """Per-pair push/pull classification for the hybrid (tile) partition.

    For each off-diagonal (src device s, dst device d) pair: PULL ships the
    unique source col-BLOCKS the pair's tiles touch (whole, tile_c rows each)
    plus the residual source rows outside them (what _hybrid_boundary would
    fetch); PUSH ships one partial-sum row per unique DEST row — tile_r rows
    per touched dest tile-row block plus residual dest rows outside them.
    Pairs where push is strictly cheaper move their tiles and residual edges
    to the source device (hub-heavy layouts: the hub block's neighborhoods
    pull everything, but push only the hub rows).

    Returns (keep_tiles mask, keep_res mask, push_pack, push_res, push_recv,
    push_slab) with push_pack = (ptiles, ptrow, ptcol, pt_dst) per-source-
    device slabs (compact ascending output blocks, LOCAL col blocks) and
    push_res = (prow, pcol, pval) slot-sorted per-source COO; all padded to
    identical static shapes. Everything None/0 when no pair chooses push.
    """
    rows_per_dev = n_local // tile_r
    Bl = n_local // tile_c
    nz = g_tiles.reshape(g_tiles.shape[0], -1).any(axis=1)
    t_dst = (g_trow // rows_per_dev).astype(np.int64)
    t_src = (g_tcol // Bl).astype(np.int64)
    live_r = r_vals != 0
    r_dst = (r_rows // n_local).astype(np.int64)
    r_src = (r_cols // n_local).astype(np.int64)

    pull = np.zeros((n_dev, n_dev), np.int64)
    push = np.zeros((n_dev, n_dev), np.int64)
    pair_tiles = {}
    pair_res = {}
    for s in range(n_dev):
        for d in range(n_dev):
            if s == d:
                continue
            tm = np.flatnonzero(nz & (t_dst == d) & (t_src == s))
            rm = np.flatnonzero(live_r & (r_dst == d) & (r_src == s))
            pair_tiles[s, d] = tm
            pair_res[s, d] = rm
            blk = np.unique(g_tcol[tm].astype(np.int64))
            rr = np.unique(r_cols[rm].astype(np.int64))
            rr = rr[~np.isin(rr // tile_c, blk)]
            pull[s, d] = tile_c * len(blk) + len(rr)
            rb = np.unique(g_trow[tm].astype(np.int64))
            rd = np.unique(r_rows[rm].astype(np.int64))
            rd = rd[~np.isin(rd // tile_r, rb)]
            push[s, d] = tile_r * len(rb) + len(rd)
    mode_push = (push < pull) & (push > 0)
    # the all_to_all slabs pad every pair to the max of its category (cf.
    # _adaptive_pair_modes): only mix when that beats the pure-pull max
    mixed = (
        int(pull[~mode_push].max(initial=0))
        + int(push[mode_push].max(initial=0))
    )
    if not mode_push.any() or mixed >= int(pull.max(initial=0)):
        return None

    # --- slot spaces: per pair, tile-row blocks first (tile_r rows each,
    # shared by tiles AND residual edges landing inside them), then the
    # stray residual dest rows ---
    H = 1
    pair_blocks = {}
    pair_extra = {}
    for (s, d), tm in pair_tiles.items():
        if not mode_push[s, d]:
            continue
        rb = np.unique(g_trow[tm].astype(np.int64))
        rd = np.unique(r_rows[pair_res[s, d]].astype(np.int64))
        extra = rd[~np.isin(rd // tile_r, rb)]
        pair_blocks[s, d] = rb
        pair_extra[s, d] = extra
        H = max(H, tile_r * len(rb) + len(extra))
    H = pad_to_multiple(H, 8)

    keep_t = np.ones(len(g_trow), bool)
    keep_r = np.ones(len(r_rows), bool)
    push_recv = np.full((n_dev, n_dev * H), n_local, np.int32)
    dev_blocks = [[] for _ in range(n_dev)]  # (compact slot base, tile idxs)
    dev_res = [[] for _ in range(n_dev)]     # (slot, local col, val)
    dev_nblocks = np.zeros(n_dev, np.int64)
    for s in range(n_dev):
        for d in range(n_dev):
            if (s, d) not in pair_blocks:
                continue
            tm, rm = pair_tiles[s, d], pair_res[s, d]
            keep_t[tm] = False
            keep_r[rm] = False
            rb, extra = pair_blocks[s, d], pair_extra[s, d]
            blk_pos = {int(b): i for i, b in enumerate(rb)}
            # receiver map: slot -> local dest row on device d
            for i, b in enumerate(rb):
                rows_g = b * tile_r + np.arange(tile_r)
                push_recv[d, s * H + i * tile_r : s * H + (i + 1) * tile_r] = (
                    rows_g - d * n_local
                ).astype(np.int32)
            base_extra = tile_r * len(rb)
            push_recv[d, s * H + base_extra : s * H + base_extra + len(extra)] = (
                extra - d * n_local
            ).astype(np.int32)
            # tiles: compact block ids continue ascending across pairs
            for tix in tm:
                b = int(g_trow[tix])
                dev_blocks[s].append((dev_nblocks[s] + blk_pos[b], int(tix)))
            # residual: slot per dest row (inside blocks: shared slot)
            rrow_pair = r_rows[rm].astype(np.int64)
            rcol_pair = r_cols[rm].astype(np.int64)
            rval_pair = r_vals[rm]
            in_blk = np.isin(rrow_pair // tile_r, rb)
            slot = np.empty(len(rrow_pair), np.int64)
            bp = np.searchsorted(rb, rrow_pair[in_blk] // tile_r)
            slot[in_blk] = bp * tile_r + rrow_pair[in_blk] % tile_r
            slot[~in_blk] = base_extra + np.searchsorted(
                extra, rrow_pair[~in_blk]
            )
            dev_res[s].append(
                (d * H + slot, rcol_pair - s * n_local, rval_pair)
            )
            dev_nblocks[s] += len(rb)

    # --- per-device static packing ---
    tile_shape = g_tiles.shape[1:]
    Bp = max(int(dev_nblocks.max()), 1)
    Tp = 1
    for s in range(n_dev):
        Tp = max(Tp, len(dev_blocks[s]))
    ptiles = np.zeros((n_dev, Tp) + tile_shape, dtype=g_tiles.dtype)
    ptrow = np.full((n_dev, Tp), Bp - 1, np.int32)
    ptcol = np.zeros((n_dev, Tp), np.int32)
    pt_dst = np.full((n_dev, Bp * tile_r), n_dev * H, np.int32)  # pad: drop
    e_push = 1
    for s in range(n_dev):
        e_push = max(e_push, sum(len(x[0]) for x in dev_res[s]))
    e_push = pad_to_multiple(e_push, 128)
    prow = np.full((n_dev, e_push), n_dev * H, np.int32)  # pad slot: dropped
    pcol = np.zeros((n_dev, e_push), np.int32)
    pval = np.zeros((n_dev, e_push), np.float32)

    for s in range(n_dev):
        # tiles, sorted by compact block id (ascending d, then block order)
        entries = sorted(dev_blocks[s], key=lambda x: x[0])
        for k, (cblk, tix) in enumerate(entries):
            ptiles[s, k] = g_tiles[tix]
            ptrow[s, k] = cblk
            ptcol[s, k] = int(g_tcol[tix]) - s * Bl
        # compact row -> slab slot map
        base = 0
        for d in range(n_dev):
            if (s, d) not in pair_blocks:
                continue
            nb = len(pair_blocks[s, d])
            rows = np.arange(nb * tile_r)
            pt_dst[s, base * tile_r : (base + nb) * tile_r] = (
                d * H + rows
            ).astype(np.int32)
            base += nb
        # residual edges, sorted by slot (segment_sum fast path)
        if dev_res[s]:
            slots = np.concatenate([x[0] for x in dev_res[s]])
            cols_l = np.concatenate([x[1] for x in dev_res[s]])
            vals_l = np.concatenate([x[2] for x in dev_res[s]])
            o = np.argsort(slots, kind="stable")
            k = len(slots)
            prow[s, :k] = slots[o].astype(np.int32)
            pcol[s, :k] = cols_l[o].astype(np.int32)
            pval[s, :k] = vals_l[o]

    # coverage: ptrow must cover every compact block 0..Bp-1 on every device
    # or the rect kernel leaves garbage rows (pt_dst drops padding blocks,
    # but blocks BELOW dev_nblocks[s] are real) — real blocks are covered by
    # construction (a block exists because a tile touches it); padding
    # devices (fewer blocks) point their zero tiles at Bp-1, and blocks in
    # [dev_nblocks[s], Bp) scatter to the drop slot via pt_dst's padding.
    # Blocks in that range still need >=1 tile for a defined (ignored) value:
    for s in range(n_dev):
        covered = set(ptrow[s, : len(dev_blocks[s])].tolist())
        missing = [b for b in range(Bp) if b not in covered]
        free = len(dev_blocks[s])
        need = len(missing)
        if need > Tp - free:
            pad_t = need - (Tp - free)
            ptiles = np.concatenate(
                [ptiles, np.zeros((n_dev, pad_t) + tile_shape,
                                  dtype=g_tiles.dtype)], axis=1)
            ptrow = np.concatenate(
                [ptrow, np.full((n_dev, pad_t), Bp - 1, np.int32)], axis=1)
            ptcol = np.concatenate(
                [ptcol, np.zeros((n_dev, pad_t), np.int32)], axis=1)
            Tp += pad_t
        ptrow[s, free : free + need] = np.asarray(missing, np.int32)
        # re-sort this device's slab by block id (kernel needs ascending)
        o = np.argsort(ptrow[s], kind="stable")
        ptiles[s] = ptiles[s][o]
        ptrow[s] = ptrow[s][o]
        ptcol[s] = ptcol[s][o]

    return (keep_t, keep_r, (ptiles, ptrow, ptcol, pt_dst),
            (prow, pcol, pval), push_recv, int(H))


def partition_graph_hybrid(
    csr: HostCSR,
    n_dev: int,
    node_pad: int = 8,
    tile_r: int = 128,
    tile_c: int = 0,
    tile_dtype=np.float32,
    tile_budget_bytes: int = 3 * 1024 * 1024 * 1024,
    min_tile_nnz: int | None = None,
    boundary: bool = False,
    adaptive: bool = False,
    balance: bool = True,
    boundary_fallback: bool = False,
) -> HybridShardedGraph:
    """Tile-accelerated row-block partition.

    The GLOBAL symmetric edge split (data.graph.split_dense_tiles) is packed
    once (data sorted by tile-row), then cut into per-device slabs at
    tile-row-block boundaries; every device gets the same static tile count
    (zero tiles pad the shorter slabs). The residual COO is sliced per dest
    device like ``partition_graph``.

    ``balance=True`` (default) applies a symmetric whole-block node
    permutation (tile_c granularity — tile contents move intact, Â stays
    symmetric) when the natural order concentrates tiles on few devices
    (e.g. the community order's hubs-first leading block); the permutation is
    returned as ``node_perm`` and shard_dataset applies it to node-keyed
    arrays. ``boundary=True`` additionally precomputes the boundary exchange
    so the aggregation fetches only referenced remote blocks/rows instead of
    all-gathering the full feature matrix. ``adaptive=True`` (implies
    boundary) re-routes each device PAIR's tiles and residual edges in
    whichever direction ships fewer rows — pull source blocks/rows, or push
    one partial-sum row per destination row (_hybrid_adaptive_split) — the
    tile-slab counterpart of partition_graph(adaptive=True).
    """
    from parallel_gcn.data.graph import split_dense_tiles
    from parallel_gcn.ops.bcsr import build_bcsr

    import math

    tile_c = tile_c or tile_r
    assert tile_c % tile_r == 0, (tile_r, tile_c)
    # rows per device must be a whole number of tile rows AND honor node_pad
    n_local = pad_to_multiple(
        -(-csr.n_rows // n_dev), math.lcm(node_pad, tile_c)
    )
    n_pad = n_local * n_dev
    assert n_local % tile_r == 0 and n_pad % tile_c == 0

    rows = csr.row_ids()
    cols = csr.indices
    vals = csr.values
    sym_scale = None
    if np.dtype(tile_dtype) == np.int8:
        from parallel_gcn.data.graph import sym_scale_for

        sym_scale = sym_scale_for(csr, rows, cols, vals, n_pad)
    in_tiles = split_dense_tiles(
        rows, cols, n_pad, min_tile_nnz, tile_budget_bytes,
        tile=tile_r, bytes_per_elem=np.dtype(tile_dtype).itemsize, tile_c=tile_c,
    )
    pack = build_bcsr(
        rows[in_tiles], cols[in_tiles], vals[in_tiles], n_pad,
        dtype=tile_dtype, tile=tile_r, tile_c=tile_c, sym_scale=sym_scale,
    )
    g_trow = np.asarray(pack.tile_rows)
    g_tcol = np.asarray(pack.tile_cols)
    g_tiles = np.asarray(pack.tiles)
    r_rows = rows[~in_tiles].astype(np.int64)
    r_cols = cols[~in_tiles].astype(np.int64)
    r_vals = vals[~in_tiles]
    if sym_scale is not None:
        # int8 mode: residual values become the edge multiplicity k (1, or
        # the coalesced duplicate count) — the residual rides the same
        # d-scaled features as the tile slabs (one gather); k·d_i·d_j == v
        d = np.asarray(sym_scale, np.float64)
        r_vals = np.where(
            r_vals != 0,
            np.rint(r_vals / np.maximum(d[r_rows] * d[r_cols], 1e-30)),
            0.0,
        ).astype(np.float32)

    node_perm = None
    rpt = tile_c // tile_r  # tile-rows per node block
    if balance and n_dev > 1:
        block_perm = _balance_block_perm(
            g_trow, n_pad // tile_c, n_local // tile_c, n_dev, rpt
        )
        if block_perm is not None:
            inv = np.empty_like(block_perm)
            inv[block_perm] = np.arange(len(block_perm))
            g_trow = (inv[g_trow // rpt] * rpt + g_trow % rpt).astype(np.int32)
            g_tcol = inv[g_tcol].astype(np.int32)
            o = np.argsort(g_trow, kind="stable")
            g_trow, g_tcol, g_tiles = g_trow[o], g_tcol[o], g_tiles[o]
            remap = lambda g: inv[g // tile_c] * tile_c + g % tile_c
            r_rows, r_cols = remap(r_rows), remap(r_cols)
            o = np.argsort(r_rows, kind="stable")
            r_rows, r_cols, r_vals = r_rows[o], r_cols[o], r_vals[o]
            node_perm = (
                block_perm[:, None] * tile_c + np.arange(tile_c)
            ).reshape(-1)
            if sym_scale is not None:
                sym_scale = np.asarray(sym_scale)[node_perm]

    push = None
    if adaptive and n_dev > 1:
        boundary = True
        split = _hybrid_adaptive_split(
            g_trow, g_tcol, g_tiles, r_rows, r_cols, r_vals,
            n_dev, n_local, tile_r, tile_c,
        )
        if split is not None:
            keep_t, keep_r, push_pack, push_res, push_recv, push_slab = split
            g_trow, g_tcol, g_tiles = (
                g_trow[keep_t], g_tcol[keep_t], g_tiles[keep_t]
            )
            r_rows, r_cols, r_vals = (
                r_rows[keep_r], r_cols[keep_r], r_vals[keep_r]
            )
            # re-ensure global tile-row coverage (a row whose tiles ALL moved
            # to push would leave garbage in the rect kernel's output): zero
            # tiles pointed at the owner's own first block (halo-neutral)
            n_trows = n_pad // tile_r
            missing = np.setdiff1d(
                np.arange(n_trows, dtype=np.int64),
                np.unique(g_trow.astype(np.int64)),
            )
            if len(missing):
                Bl = n_local // tile_c
                own_blk = (missing * tile_r) // n_local * Bl
                g_trow = np.concatenate([g_trow, missing]).astype(np.int32)
                g_tcol = np.concatenate([g_tcol, own_blk]).astype(np.int32)
                g_tiles = np.concatenate([
                    g_tiles,
                    np.zeros((len(missing), tile_r, tile_c), g_tiles.dtype),
                ])
                o = np.argsort(g_trow, kind="stable")
                g_trow, g_tcol, g_tiles = g_trow[o], g_tcol[o], g_tiles[o]
            push = (push_pack, push_res, push_recv, push_slab)

    rows_per_dev = n_local // tile_r
    dev_of_tile = g_trow // rows_per_dev
    counts = np.bincount(dev_of_tile, minlength=n_dev)
    T = int(counts.max())
    mean_t = max(counts.mean(), 1.0)
    if T > 1.5 * mean_t:
        # every device is padded to the max slab (SPMD static shapes), so a
        # hot row block turns imbalance into redundant zero-tile work AND
        # memory on every chip. With balance=True this fires only when even
        # the LPT block assignment cannot flatten the load (single huge block)
        import warnings

        warnings.warn(
            f"hybrid partition tile imbalance: max {T} vs mean {mean_t:.0f} "
            f"tiles/device — all devices pad to {T}."
            + ("" if balance else " Set balance=True to spread hot blocks."),
            stacklevel=2,
        )
    tiles = np.zeros((n_dev, T, tile_r, tile_c), dtype=g_tiles.dtype)
    trow = np.full((n_dev, T), rows_per_dev - 1, dtype=np.int32)
    tcol = np.zeros((n_dev, T), dtype=np.int32)
    for d in range(n_dev):
        sel = dev_of_tile == d
        k = int(sel.sum())
        tiles[d, :k] = g_tiles[sel]
        trow[d, :k] = g_trow[sel] - d * rows_per_dev  # sorted ascending; pads
        tcol[d, :k] = g_tcol[sel]                      # (= last row) keep order

    # residual: per-dest-device slabs, global source cols (row-sorted subset)
    res_row, res_col, res_val = _slice_coo_by_dest(
        r_rows, r_cols, r_vals, n_dev, n_local, n_pad
    )

    send_idx, halo = None, 0
    if boundary:
        tcol0, res_col0 = tcol.copy(), res_col.copy()
        send_idx, halo = _hybrid_boundary(
            tiles, trow, tcol, res_col, res_val, n_dev, n_local, tile_c
        )
        kind = "hybrid-adaptive" if push is not None else "hybrid-boundary"
        if not _boundary_pays_off(n_local, n_dev, halo, n_pad, kind,
                                  boundary_fallback and push is None):
            if boundary_fallback and push is None:
                # restore the global-coordinate layout (= all_gather halo);
                # _hybrid_boundary rewrote tcol/res_col in place. (With push
                # pairs in play the pull buffer alone is not the whole
                # story — warn only.)
                tcol, res_col = tcol0, res_col0
                send_idx, halo = None, 0

    push_fields = {}
    if push is not None:
        (ptiles, ptrow, ptcol, pt_dst), (prow, pcol, pval), precv, pslab = push
        push_fields = dict(
            ptiles=ptiles, ptrow=ptrow, ptcol=ptcol, pt_dst=pt_dst,
            prow=prow, pcol=pcol, pval=pval, push_recv=precv,
            push_slab=pslab,
        )

    return HybridShardedGraph(
        tiles=tiles, trow=trow, tcol=tcol,
        res_row=res_row, res_col=res_col, res_val=res_val,
        n_dev=n_dev, n_local=n_local,
        n_real_nodes=csr.n_rows, n_real_edges=csr.nnz,
        sym_scale=None if sym_scale is None else
        np.asarray(sym_scale)[: n_pad].reshape(n_dev, n_local),
        send_idx=send_idx, halo_size=halo, node_perm=node_perm,
        **push_fields,
    )
