"""Block-sparse (BCSR) SpMM — ``out = Â · x`` over dense tiles of Â.

The sparse matrix is packed into dense ``tile_r × tile_c`` blocks (only the
nonempty ones, sorted by tile-row). On the GPU the product is the Pallas
Triton kernel of ops/bcsr_triton.py; elsewhere (the CPU tests) it is
``tile_product``, plain XLA, which is also the kernel's reference:

* gather the column blocks of ``x`` that the tiles touch,
* one batched ``dot_general`` per chunk of tiles, accumulating in f32,
* ``segment_sum`` of the per-tile products by tile-row.

int8 pattern packs upconvert to the compute dtype and apply the D·B·D degree
scaling as elementwise ops around the product. The tile loop is chunked by a
byte budget so the gathered operands and per-tile products stay bounded at
any graph size.

Combined with a locality-preserving reorder (data/reorder.py) the tiles hold
the graph's dense community blocks; the COO residual covers the rest
(ops/graphsum.py ``hybrid``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from parallel_gcn.ops.bcsr_triton import tile_product_triton

TILE = 128  # default tile edge

# bytes of per-chunk temporaries (upconverted tiles + gathered x blocks +
# f32 per-tile products) one batched product may hold
_CHUNK_BYTES = 512 * 1024 * 1024


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BCSR:
    """Sorted-by-row pack of nonempty tile_r×tile_c blocks of Â.

    Rectangular tiles matter: after a bandwidth-reducing reorder a tile-row's
    occupied columns are contiguous, so wide tiles (tile_c ≫ tile_r) cover the
    same edges with fewer tiles.

    NOTE (symmetry): the VJP reuses the UNtransposed pack, which is valid iff
    the packed matrix itself is symmetric. For square tiles of symmetric Â
    that is automatic; for rectangular tiles the caller must pack a symmetric
    EDGE SET — data/graph.py split_dense_tiles enforces this by qualifying an
    edge only if its mirror's tile also qualifies. Do not feed an asymmetric
    matrix through bcsr_matmul's autodiff.
    """

    tiles: jnp.ndarray  # [T, tile_r, tile_c] — dense tile data (f32/bf16/int8)
    tile_rows: jnp.ndarray  # int32 [T] — tile-row index, ascending
    tile_cols: jnp.ndarray  # int32 [T]
    n_nodes: int = dataclasses.field(metadata=dict(static=True))  # padded cols
    n_tiles_real: int = dataclasses.field(metadata=dict(static=True))
    # output row count; 0 means square (= n_nodes). A row-block slab of a
    # sharded matrix sets this to its local row count.
    n_rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    # int8 "binary" packs: Â's values factor as v_ij = d_i·d_j with
    # d = deg^{-1/2} (symmetric normalization), so tiles store the EXACT 0/1
    # adjacency pattern in int8 (half the bf16 stream, no quantization error)
    # and the product is wrapped as out = d ⊙ K(d ⊙ x). ``sym_scale`` holds d
    # ([n_nodes] f32); None for f32/bf16 value packs.
    sym_scale: jnp.ndarray | None = None

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def tile(self) -> int:
        return self.tiles.shape[1]

    @property
    def tile_r(self) -> int:
        return self.tiles.shape[1]

    @property
    def tile_c(self) -> int:
        return self.tiles.shape[2]


def build_bcsr(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_nodes: int,
    dtype=np.float32,
    tile: int = TILE,
    tile_c: int | None = None,
    sym_scale: np.ndarray | None = None,
) -> BCSR:
    """Pack COO triplets into BCSR. ``n_nodes`` is rounded up to a tile-column
    multiple; padding tiles (val 0) keep the tile count static-friendly.
    ``dtype=bfloat16`` halves tile bytes (the product accumulates in f32);
    ``tile`` (rows) and ``tile_c`` (columns, default square, must be a
    multiple of ``tile``) set the tile shape.

    ``dtype=int8`` stores the EXACT edge-multiplicity pattern (0/1, or k for
    coalesced duplicate edges; quarter the f32 stream) and requires
    ``sym_scale`` = the d vector ([n_nodes] f32) factoring the values as
    v_ij = k_ij·d_i·d_j — valid for any symmetrically-normalized adjacency
    (Â = D^{-1/2}(A+I)D^{-1/2}). The matmul then computes
    d ⊙ (pattern · (d ⊙ x)), which is algebraically identical."""
    tile_r = tile
    tile_c = tile_c or tile_r
    if tile_r <= 0 or tile_c % tile_r:
        raise ValueError(f"bad tile shape {tile_r}x{tile_c}")
    binary = np.dtype(dtype) == np.int8
    if binary and (sym_scale is None or len(sym_scale) < n_nodes):
        raise ValueError("int8 pattern pack needs sym_scale (d) for every node")
    n_pad = ((n_nodes + tile_c - 1) // tile_c) * tile_c
    live = vals != 0
    rows, cols, vals = rows[live], cols[live], vals[live]
    trow = rows // tile_r
    tcol = cols // tile_c
    n_tile_cols = n_pad // tile_c
    tile_id = trow.astype(np.int64) * n_tile_cols + tcol
    uniq, inverse = np.unique(tile_id, return_inverse=True)
    T = len(uniq)
    # allocate the FINAL dtype and scatter converted values directly — a
    # float32 intermediate for a reddit-scale pack is a 4.8 GB alloc+convert
    # (int8 packs: 4× the bytes of the result)
    out_dtype = np.int8 if binary else jnp.dtype(dtype)
    tiles = np.zeros((T, tile_r, tile_c), dtype=out_dtype)
    if binary:
        # edge multiplicity k (coalesced duplicates; 1 otherwise) — exact:
        # the value factors as k·d_i·d_j (verified by recover_sym_scale)
        d = np.asarray(sym_scale, np.float64)
        counts = np.rint(
            vals / np.maximum(d[rows] * d[cols], 1e-30)
        ).astype(np.int8)
        tiles[inverse, rows % tile_r, cols % tile_c] = counts
    else:
        tiles[inverse, rows % tile_r, cols % tile_c] = vals.astype(out_dtype)
    # np.unique sorts the row-major tile ids, so tiles are already row-sorted
    tile_rows = (uniq // n_tile_cols).astype(np.int32)
    tile_cols = (uniq % n_tile_cols).astype(np.int32)
    return BCSR(
        tiles=jnp.asarray(tiles),
        tile_rows=jnp.asarray(tile_rows),
        tile_cols=jnp.asarray(tile_cols),
        n_nodes=n_pad,
        n_tiles_real=T,
        sym_scale=(
            None
            if not binary
            else jnp.asarray(
                np.pad(
                    np.asarray(sym_scale, np.float32)[:n_nodes],
                    (0, n_pad - n_nodes),
                )
            )
        ),
    )


def _chunk_len(tile_r: int, tile_c: int, n_feat: int, itemsize: int) -> int:
    per_tile = tile_r * tile_c * itemsize + tile_c * n_feat * itemsize
    per_tile += tile_r * n_feat * 4
    return max(1, _CHUNK_BYTES // per_tile)


def tile_product(tiles, tile_rows, tile_cols, x, n_rows, scale=None,
                 precision=None):
    """``out[n_rows, F] (f32) = Σ_t tile_t · x[block tile_cols[t]]``, each
    product landing in row block ``tile_rows[t]``. With ``scale`` (d, the
    int8 pattern's degree factor) computes d ⊙ (B · (d ⊙ x)).

    The plain-XLA block-sparse product: gather, batched dot, segment_sum,
    chunked over tiles so the per-chunk temporaries stay under
    ``_CHUNK_BYTES``."""
    T, tile_r, tile_c = tiles.shape
    n_feat = x.shape[1]
    # int8 patterns contract at x's dtype; value tiles at their own dtype
    cdt = x.dtype if tiles.dtype == jnp.int8 else tiles.dtype
    if scale is not None:
        x = scale[:, None] * x.astype(jnp.float32)
    x = x.astype(cdt)
    xb = x.reshape(-1, tile_c, n_feat)
    n_row_blocks = n_rows // tile_r
    chunk = _chunk_len(tile_r, tile_c, n_feat, jnp.dtype(cdt).itemsize)
    out = jnp.zeros((n_row_blocks, tile_r, n_feat), jnp.float32)
    for s in range(0, T, chunk):
        a = tiles[s:s + chunk].astype(cdt)
        prod = jnp.einsum(
            "tij,tjf->tif", a, xb[tile_cols[s:s + chunk]],
            preferred_element_type=jnp.float32, precision=precision,
        )
        out = out + jax.ops.segment_sum(
            prod, tile_rows[s:s + chunk], num_segments=n_row_blocks,
            indices_are_sorted=True,
        )
    out = out.reshape(n_rows, n_feat)
    if scale is not None:
        out = scale[:n_rows, None] * out
    return out


def _product(tiles, tile_rows, tile_cols, x, n_rows, scale=None,
             precision=None):
    """The tile product on this platform: the Triton kernel on the GPU
    (measured faster end to end, PERF.md), plain XLA elsewhere."""
    impl = tile_product_triton if jax.default_backend() == "gpu" else tile_product
    return impl(tiles, tile_rows, tile_cols, x, n_rows, scale, precision)


@partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def _bcsr_matmul(tiles, tile_rows, tile_cols, scale, x, n_nodes, precision):
    return _product(tiles, tile_rows, tile_cols, x, n_nodes, scale, precision)


def _fwd(tiles, tile_rows, tile_cols, scale, x, n_nodes, precision):
    out = _product(tiles, tile_rows, tile_cols, x, n_nodes, scale, precision)
    return out, (tiles, tile_rows, tile_cols, scale)


def _bwd(n_nodes, precision, res, g):
    tiles, tile_rows, tile_cols, scale = res
    # The tile-part MATRIX is symmetric (Â symmetric + symmetric edge split,
    # data/graph.py split_dense_tiles; diag(d)·B·diag(d) stays symmetric) ⇒
    # Tᵀg = Tg: reuse the same pack (src/module.cu:188-208 uses one kernel for
    # both directions likewise). This holds for rectangular tiles too —
    # symmetry is enforced on the EDGE SET, not the tile grid.
    dx = _product(tiles, tile_rows, tile_cols, g, n_nodes, scale, precision)
    return None, None, None, None, dx.astype(g.dtype)


_bcsr_matmul.defvjp(_fwd, _bwd)


def bcsr_matmul(bcsr: BCSR, x: jnp.ndarray, precision=None) -> jnp.ndarray:
    """out = Â·x (f32) with Â in BCSR form. x: [n_nodes, F]
    (n_nodes = bcsr.n_nodes).

    Square packs only (the custom VJP reuses the forward, valid iff the packed
    matrix is symmetric); rectangular slabs use ``bcsr_matmul_rect``."""
    if x.shape[0] != bcsr.n_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, pack has {bcsr.n_nodes}")
    if bcsr.n_rows and bcsr.n_rows != bcsr.n_nodes:
        raise ValueError("rectangular pack: use bcsr_matmul_rect")
    return _bcsr_matmul(
        bcsr.tiles, bcsr.tile_rows, bcsr.tile_cols, bcsr.sym_scale, x,
        bcsr.n_nodes, precision,
    )


def bcsr_matmul_rect(bcsr: BCSR, x: jnp.ndarray) -> jnp.ndarray:
    """out[n_rows, F] = slab · x for a rectangular (row-block) pack.

    NO custom VJP — callers embed this in their own adjoint (e.g. the sharded
    aggregation is self-adjoint at the collective level because the GLOBAL
    matrix is symmetric; see parallel/train_parallel.graphsum_dist_hybrid)."""
    if x.shape[0] != bcsr.n_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, slab has {bcsr.n_nodes}")
    if bcsr.sym_scale is not None:
        raise ValueError(
            "int8 pattern packs are single-device; build slab packs with values"
        )
    return _product(bcsr.tiles, bcsr.tile_rows, bcsr.tile_cols, x, bcsr.n_rows)
