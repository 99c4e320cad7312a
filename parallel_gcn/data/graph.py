"""Graph containers for static-shaped aggregation.

The reference keeps the graph as host/device CSR (indptr+indices, values in a
separate array; reference: include/sparse.cuh:11-29) and aggregates with ragged
per-row loops (src/module.cu:172-186). XLA needs static shapes, so the
on-device layout here is a **row-sorted, padded COO** (row/col/val arrays padded
to a fixed edge count) plus an optional dense Â for small graphs where one
matmul beats gather/scatter outright.

The normalization matches the reference exactly: degrees include the implicit
self-loop (it is the first CSR entry of every row, src/parser.cpp:29-31) and
``val(src,dst) = 1/sqrt(deg(src)*deg(dst))`` (src/parser.cpp:164-181).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Graph:
    """Device-side graph for `ops.graphsum`.

    row/col/val are COO triplets sorted by ``row``; padding entries carry
    ``val == 0`` and point at the last padded node so scatters stay in-bounds.
    ``adj`` is the optional dense normalized adjacency (n_nodes × n_nodes),
    present only when the dense backend is selected.

    The adjacency is symmetric (undirected graph + symmetric normalization), so
    Âᵀ = Â and the backward of aggregation reuses the same triplets — the same
    shortcut the reference exploits by reusing one kernel for forward and
    backward (src/module.cu:188-208).
    """

    row: jnp.ndarray  # int32 [n_edges_pad] (hybrid: COO residual only)
    col: jnp.ndarray  # int32 [n_edges_pad]
    val: jnp.ndarray  # float32 [n_edges_pad]
    adj: jnp.ndarray | None  # float32 [n_nodes, n_nodes] or None
    bcsr: "object | None"  # ops.bcsr.BCSR tile pack or None
    n_nodes: int = dataclasses.field(metadata=dict(static=True))  # padded
    n_real_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_real_edges: int = dataclasses.field(metadata=dict(static=True))
    # True when bcsr holds only the dense tiles and row/col/val the residual
    is_hybrid: bool = dataclasses.field(metadata=dict(static=True), default=False)
    # False when row/col/val do NOT contain the whole edge set (hybrid builds,
    # including ones demoted to pure-BCSR because the residual came out empty)
    coo_complete: bool = dataclasses.field(metadata=dict(static=True), default=True)
    # sqrt(deg), self-loop-inclusive, [n_nodes] f32, 1.0 on padding rows.
    # Lets aggregation-variant models reuse the symmetric-Â machinery through
    # exact diagonal rewrites: (A+I)·h = s ⊙ Â·(s ⊙ h) with s = sqrt(deg)
    # (models/sage.py SUM and MEAN aggregators) — every backend (dense, tile
    # pack, int8 pattern, segment) and the backward-equals-forward shortcut
    # come along for free.
    sqrt_deg: jnp.ndarray | None = None
    # adj_dtype=int8: d (= deg^{-1/2}, [n_nodes] f32) factoring the dense
    # adjacency as adj_ij = adj8_ij · d_i · d_j — the int8 tile-pattern trick
    # applied to the dense path (ops.graphsum wraps out = d ⊙ (A₈ @ (d ⊙ x)))
    adj_scale: jnp.ndarray | None = None

    @property
    def n_edges_pad(self) -> int:
        return self.row.shape[0]


@dataclass(frozen=True)
class HostCSR:
    """Host-side CSR with values — the direct analog of the reference's
    SparseIndex + value array (include/sparse.cuh:11-29)."""

    indptr: np.ndarray  # int32/int64 [n_rows+1]
    indices: np.ndarray  # int32 [nnz]
    values: np.ndarray  # float32 [nnz]
    n_rows: int
    n_cols: int
    # d = deg^{-1/2} with DUPLICATE-INCLUSIVE degrees ([n_rows] f32), the
    # exact factor of the symmetric normalization v_ij = k_ij·d_i·d_j. Set
    # by the adjacency builders (add_self_loops_csr, the native loader)
    # where the pre-coalesce degrees are known; coalescing and permutation
    # preserve it. None for feature CSRs and hand-built fixtures — int8
    # packs then fall back to recover_sym_scale (see sym_scale_for).
    sym_scale: np.ndarray | None = None

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_ids(self) -> np.ndarray:
        """Expand indptr to a per-nnz row-id array (COO rows)."""
        return np.repeat(
            np.arange(self.n_rows, dtype=np.int32),
            np.diff(self.indptr).astype(np.int64),
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.float32)
        out[self.row_ids(), self.indices] = self.values
        return out


def normalized_adjacency_values(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Â edge weights: 1/sqrt(deg(src)·deg(dst)), degrees self-loop-inclusive.

    Equivalent to reference src/parser.cpp:164-181 (calculateGraphValues),
    vectorized. Computed in float32 to match the reference's `sqrtf`.
    """
    deg = np.diff(indptr).astype(np.float32)
    src_deg = np.repeat(deg, np.diff(indptr).astype(np.int64))
    dst_deg = deg[indices]
    return (1.0 / np.sqrt(src_deg * dst_deg)).astype(np.float32)


def coalesce_duplicate_edges(csr: HostCSR) -> HostCSR:
    """Merge duplicate (row, col) entries, SUMMING their values.

    The reference datasets list some neighbors twice (cora: 302 entries,
    citeseer: 236) and the reference parser keeps them (src/parser.cpp:35-44),
    so its CSR-walking aggregation counts each copy — degrees included. A
    duplicated entry with value v is therefore exactly ONE edge of weight k·v
    in the reference's Â. Matrix-shaped backends (dense Â, BCSR tiles) can
    store a position only once, so without coalescing they would silently
    DROP the extra copies while the segment backend counts them — coalescing
    after the degree-inclusive value computation makes every backend apply
    the identical reference operator. Within-row entries come out col-sorted
    (the self-loop is no longer guaranteed first; nothing downstream needs
    that). No-op (same object) when the CSR is already duplicate-free."""
    rows = csr.row_ids().astype(np.int64)
    key = rows * csr.n_cols + csr.indices
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) == len(key):
        return csr
    values = np.zeros(len(uniq), np.float32)
    np.add.at(values, inv, csr.values)
    new_rows = (uniq // csr.n_cols).astype(np.int64)
    indptr = np.zeros(csr.n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rows, minlength=csr.n_rows), out=indptr[1:])
    return HostCSR(
        indptr=indptr,
        indices=(uniq % csr.n_cols).astype(np.int32),
        values=values,
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        sym_scale=csr.sym_scale,  # node-indexed: coalescing edges keeps it
    )


def add_self_loops_csr(neighbor_lists: list[np.ndarray]) -> HostCSR:
    """Build the graph CSR with the implicit self-loop as first neighbor of
    every row, exactly like the reference parser (src/parser.cpp:29-31);
    duplicate neighbor entries are then coalesced into single weighted edges
    (see coalesce_duplicate_edges — degrees, and hence the Â values, still
    count every copy like the reference's)."""
    n = len(neighbor_lists)
    counts = np.fromiter((1 + len(nb) for nb in neighbor_lists), dtype=np.int64, count=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int32)
    for i, nb in enumerate(neighbor_lists):
        start = indptr[i]
        indices[start] = i
        if len(nb):
            indices[start + 1 : indptr[i + 1]] = nb
    values = normalized_adjacency_values(indptr, indices)
    # the duplicate-inclusive degrees are only known HERE (coalescing merges
    # the copies); carry d = deg^{-1/2} so int8 packs factor exactly even
    # when the raw data duplicates a self-loop (citeseer: 3 self-citing
    # papers ⇒ v_ii = k_ii/deg with k_ii up to 3)
    sym = (1.0 / np.sqrt(counts.astype(np.float64))).astype(np.float32)
    return coalesce_duplicate_edges(
        HostCSR(indptr=indptr, indices=indices, values=values, n_rows=n,
                n_cols=n, sym_scale=sym)
    )


def local_clustering_coefficient(csr: HostCSR) -> np.ndarray:
    """Per-node local clustering coefficient.

    Mirrors the reference parser's (unused) experiment
    (src/parser.cpp:135-162): triangles through each node divided by
    deg·(deg−1), degrees EXCLUDING the self-loop. Host-side preprocessing,
    O(Σ deg²) like the reference's nested neighbor scan.
    """
    n = csr.n_rows
    # strip self-loops: neighbor sets per node, sorted
    nbrs = []
    for i in range(n):
        row = csr.indices[csr.indptr[i] : csr.indptr[i + 1]]
        nbrs.append(np.asarray(sorted(int(c) for c in row if c != i), dtype=np.int64))
    out = np.zeros(n, dtype=np.float32)
    for i in range(n):
        d = len(nbrs[i])
        if d < 2:
            continue
        links = sum(np.isin(nbrs[j], nbrs[i], assume_unique=True).sum()
                    for j in nbrs[i])
        out[i] = np.float32(links) / np.float32(d * (d - 1))
    return out


def split_dense_tiles(
    rows: np.ndarray,
    cols: np.ndarray,
    n_pad: int,
    min_tile_nnz: int | None = None,
    tile_budget_bytes: int = 3 * 1024 * 1024 * 1024,
    tile: int = 128,
    bytes_per_elem: int = 4,
    tile_c: int | None = None,
) -> np.ndarray:
    """Boolean mask of edges living in "dense-enough" tile_r×tile_c blocks.

    A tile qualifies when its nnz ≥ threshold, where the threshold is the
    smallest value ≥ ``min_tile_nnz`` whose qualified tiles fit the byte
    budget. An edge enters the tile part only if BOTH its tile and its
    mirror edge's tile qualify — this keeps the tile-part matrix symmetric
    (Â is symmetric) for ANY tile geometry, which the backward-equals-forward
    shortcut relies on for both the tile part and the COO residual. (For
    square tiles the mirror tile has identical nnz, so the AND is a no-op.)
    """
    tile_r = tile
    tile_c = tile_c or tile_r
    ntc = n_pad // tile_c
    r64 = rows.astype(np.int64)
    c64 = cols.astype(np.int64)
    tid = (r64 // tile_r) * ntc + c64 // tile_c
    uniq, inverse = np.unique(tid, return_inverse=True)
    counts = np.bincount(inverse)

    tile_bytes = tile_r * tile_c * bytes_per_elem
    if min_tile_nnz is None:
        # default break-even vs the COO gather path: about one edge per
        # 12 KiB of tile bytes (a prior from an earlier platform; the
        # configured datasets set min_tile_nnz explicitly)
        min_tile_nnz = max(8, tile_bytes // 12288)
    thresh = min_tile_nnz
    max_tiles = max(tile_budget_bytes // tile_bytes, 1)
    # raise the threshold until the qualified tile count fits the budget
    cs = np.sort(counts)[::-1]
    if (cs >= thresh).sum() > max_tiles:
        thresh = int(cs[max_tiles - 1]) + 1

    qualified = counts >= thresh
    mask = qualified[inverse]
    if tile_r != tile_c:
        # symmetrize the edge split: the mirror edge (c, r) lives in a
        # differently-shaped grid cell — require its tile to qualify too
        qual_tids = uniq[qualified]
        mirror_tid = (c64 // tile_r) * ntc + r64 // tile_c
        pos = np.searchsorted(qual_tids, mirror_tid)
        pos = np.clip(pos, 0, max(len(qual_tids) - 1, 0))
        mirror_ok = (
            (qual_tids[pos] == mirror_tid) if len(qual_tids) else
            np.zeros(len(mirror_tid), dtype=bool)
        )
        mask = mask & mirror_ok
    return mask


def recover_sym_scale(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int, n_pad: int
) -> np.ndarray:
    """Recover d (= deg^{-1/2}) such that v_ij = k_ij·d_i·d_j with small
    integer multiplicities k (coalesced duplicate edges sum to k copies; the
    reference data carries some — see coalesce_duplicate_edges), for int8
    pattern packs. Under the k_ii=1 hypothesis the self-loop value gives
    v_ii = d_i² = 1/deg_i directly (self-loop guaranteed present by the
    parser, src/parser.cpp:29-31), so d_i = sqrt(v_ii); every edge is then
    verified to factor as an integer multiple k_ij ≥ 1 of d_i·d_j. The
    factorization is exact for any symmetrically-normalized adjacency,
    which is the only thing the reference's calculateGraphValues produces
    (src/parser.cpp:164-181). Raises ValueError when the k_ii=1 hypothesis
    fails — e.g. citeseer lists 3 papers citing themselves, so the implicit
    self-loop coalesces with the listed copy and 502 edges stop factoring.
    Such graphs must carry the parser-computed duplicate-inclusive
    ``HostCSR.sym_scale`` instead (see sym_scale_for), which is exact with
    no recovery step."""
    selfloops = rows == cols
    d = np.zeros(n_pad, dtype=np.float64)
    d[rows[selfloops]] = np.sqrt(vals[selfloops].astype(np.float64))
    if not (d[:n_rows] > 0).all():
        raise ValueError(
            "tile_dtype=int8 needs a self-loop on every node to recover d"
        )
    unit = d[rows] * d[cols]
    k = np.rint(vals / np.maximum(unit, 1e-30))
    if not ((k >= 1).all() and np.allclose(vals, k * unit, rtol=1e-4,
                                           atol=1e-7)):
        raise ValueError(
            "tile_dtype=int8 requires values of the form k/sqrt(deg·deg) "
            "(symmetric normalization, integer edge multiplicity); got "
            "values that do not factor (duplicate self-loops in the raw "
            "data break the v_ii = d_i² assumption — load through the "
            "parser so HostCSR.sym_scale carries the exact degrees)"
        )
    return d.astype(np.float32)


def sym_scale_for(
    csr: "HostCSR", rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    n_pad: int,
) -> np.ndarray:
    """Padded d with v_ij = k_ij·d_i·d_j (integer multiplicities k) for the
    int8 pattern packs: exact from the parser-carried duplicate-inclusive
    degrees when the CSR has them (add_self_loops_csr / the native loader
    attach ``sym_scale``; permutations and coalescing preserve it), else
    recovered from the self-loop values. Either way the factorization is
    VERIFIED against every edge value — an int8 pack is exact or it is
    refused."""
    if csr.sym_scale is None:
        return recover_sym_scale(rows, cols, vals, csr.n_rows, n_pad)
    d = np.zeros(n_pad, dtype=np.float32)
    d[: csr.n_rows] = csr.sym_scale
    unit = d[rows].astype(np.float64) * d[cols]
    k = np.rint(vals / np.maximum(unit, 1e-30))
    if not ((k >= 1).all() and (k <= 127).all()
            and np.allclose(vals, k * unit, rtol=1e-4, atol=1e-7)):
        raise ValueError(
            "HostCSR.sym_scale does not factor the edge values as "
            "k·d_i·d_j with int8 multiplicities — refusing an inexact "
            "int8 pattern pack"
        )
    return d


def build_graph(
    csr: HostCSR,
    *,
    node_pad: int = 8,
    edge_pad: int = 512,
    dense: bool = False,
    bcsr: bool = False,
    hybrid: bool = False,
    n_nodes_pad: int | None = None,
    min_tile_nnz: int | None = None,
    tile_budget_bytes: int = 3 * 1024 * 1024 * 1024,
    tile_dtype=np.float32,
    tile_size: int = 128,
    tile_cols: int = 0,
    adj_dtype=np.float32,
) -> Graph:
    """Pad a host CSR into the static-shaped device Graph.

    Padding edges get val=0 and row=col=n_nodes_pad-1 (in-bounds, harmless).
    ``bcsr=True`` additionally packs Â into 128×128 dense tiles (nodes are then
    padded to a multiple of 128). ``hybrid=True`` packs only the dense-enough
    tiles (see ``split_dense_tiles``) and keeps the remaining edges as the COO
    residual in row/col/val — the layout for ops.graphsum's "hybrid" backend.
    """
    tile_cols = tile_cols or tile_size
    if bcsr or hybrid:
        node_pad = max(node_pad, tile_cols)
    n_pad = n_nodes_pad or pad_to_multiple(max(csr.n_rows, 1), node_pad)

    all_rows = csr.row_ids()  # O(nnz) expansion — computed once, reused below
    rows_np = all_rows
    cols_np = csr.indices
    vals_np = csr.values

    sym_scale = None
    if np.dtype(tile_dtype) == np.int8:
        sym_scale = sym_scale_for(csr, rows_np, cols_np, vals_np, n_pad)

    coo_complete = True
    bcsr_pack = None
    if hybrid:
        coo_complete = False
        from parallel_gcn.ops.bcsr import build_bcsr

        in_tiles = split_dense_tiles(
            rows_np, cols_np, n_pad, min_tile_nnz, tile_budget_bytes,
            tile=tile_size, bytes_per_elem=np.dtype(tile_dtype).itemsize,
            tile_c=tile_cols,
        )
        bcsr_pack = build_bcsr(
            rows_np[in_tiles], cols_np[in_tiles], vals_np[in_tiles], n_pad,
            dtype=tile_dtype, tile=tile_size, tile_c=tile_cols,
            sym_scale=sym_scale,
        )
        rows_np = rows_np[~in_tiles]
        cols_np = cols_np[~in_tiles]
        vals_np = vals_np[~in_tiles]
        if len(rows_np) == 0:
            # every edge landed in a tile: the graph is pure BCSR — drop the
            # hybrid flag so aggregation skips the empty residual pass
            hybrid = False

    nnz = len(rows_np)
    e_pad = pad_to_multiple(max(nnz, 1), edge_pad)
    row = np.full(e_pad, n_pad - 1, dtype=np.int32)
    col = np.full(e_pad, n_pad - 1, dtype=np.int32)
    val = np.zeros(e_pad, dtype=np.float32)
    row[:nnz] = rows_np
    col[:nnz] = cols_np
    val[:nnz] = vals_np

    adj = None
    adj_scale = None
    if dense:
        if np.dtype(adj_dtype) == np.int8:
            # the int8 tile-pattern trick on the dense path: Â factors as
            # k_ij·d_i·d_j (sym_scale_for verifies), so store the integer
            # multiplicity matrix and scale outside the matmul — EXACT, and
            # half the bytes of bf16 on the epoch-dominating Â reads
            d = (sym_scale if sym_scale is not None else
                 sym_scale_for(csr, all_rows, csr.indices, csr.values, n_pad))
            unit = d[all_rows].astype(np.float64) * d[csr.indices]
            k = np.rint(csr.values / np.maximum(unit, 1e-30))
            assert (1 <= k).all() and (k <= 127).all(), "multiplicity range"
            adj_np = np.zeros((n_pad, n_pad), dtype=np.int8)
            adj_np[all_rows, csr.indices] = k.astype(np.int8)
            adj_scale = jnp.asarray(d.astype(np.float32))
        else:
            adj_np = np.zeros((n_pad, n_pad), dtype=np.float32)
            adj_np[all_rows, csr.indices] = csr.values
            # dense-backend Â in bf16 when fast-matmul is requested
            # (adj_dtype follows matmul_precision, NOT tile_dtype — an
            # explicit int8/bf16 tile pack under precision=highest must not
            # silently degrade the dense path): at citation scale the epoch
            # is dominated by the 2 adjacency reads per epoch (cora: 2×29 MB
            # of a 115 µs epoch), and default-precision matmuls round the
            # operands to bf16 on the fly anyway — storing bf16 halves the
            # read without changing the compute class.
            if np.dtype(adj_dtype) != np.float32:
                adj_np = adj_np.astype(jnp.dtype(adj_dtype))
        adj = jnp.asarray(adj_np)

    if bcsr:
        from parallel_gcn.ops.bcsr import build_bcsr

        bcsr_pack = build_bcsr(
            all_rows, csr.indices, csr.values, n_pad,
            dtype=tile_dtype, tile=tile_size, tile_c=tile_cols,
            sym_scale=sym_scale,
        )
        assert bcsr_pack.n_nodes == n_pad

    sqrt_deg_np = np.ones(n_pad, dtype=np.float32)
    sqrt_deg_np[: csr.n_rows] = np.sqrt(
        np.diff(csr.indptr).astype(np.float32)
    )

    return Graph(
        row=jnp.asarray(row),
        col=jnp.asarray(col),
        val=jnp.asarray(val),
        adj=adj,
        bcsr=bcsr_pack,
        n_nodes=n_pad,
        n_real_nodes=csr.n_rows,
        n_real_edges=csr.nnz,
        is_hybrid=hybrid,
        coo_complete=coo_complete,
        sqrt_deg=jnp.asarray(sqrt_deg_np),
        adj_scale=adj_scale,
    )


def random_graph(
    n_nodes: int, avg_degree: int, seed: int = 0
) -> tuple[HostCSR, list[np.ndarray]]:
    """Synthetic undirected graph fixture for tests (reference uses the real
    datasets as fixtures; small synthetic graphs stand in for unit tests)."""
    rng = np.random.default_rng(seed)
    half: dict[int, set[int]] = {i: set() for i in range(n_nodes)}
    n_edges = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    for s, d in zip(src, dst):
        if s == d:
            continue
        half[int(s)].add(int(d))
        half[int(d)].add(int(s))
    neighbor_lists = [np.array(sorted(half[i]), dtype=np.int32) for i in range(n_nodes)]
    return add_self_loops_csr(neighbor_lists), neighbor_lists
