"""Block-sparse SpMM as a Pallas kernel through Triton — the GPU's tile
product (ops/bcsr.py dispatches to it on the GPU).

One program per (``block_m`` output rows, ``block_f`` feature columns). The
program loops over its tile-row's tiles through row pointers, and over each
tile's columns in ``block_k`` steps: the int8 (or bf16/f32) sub-tile is
upconverted and degree-scaled in registers, the matching rows of ``x`` are
loaded by the tile's column index, and ``pl.dot`` accumulates into an f32
block that is written once. Nothing is carried between programs, so the
grid runs in any order, and no temporaries leave the SM: the plain-XLA
product (``ops.bcsr.tile_product``) materializes upconverted tiles, gathered
``x`` blocks and per-tile products instead.

Same contract as ``ops.bcsr.tile_product``, which is its reference;
``interpret=True`` runs it on the CPU, for tests only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def _kernel(row_ptr_ref, cols_ref, tiles_ref, d_ref, x_ref, o_ref, *,
            block_m, block_k, block_f, tile_r, tile_c, cdt, precision):
    i = pl.program_id(0)
    j = pl.program_id(1)
    row0 = i * block_m
    trow = row0 // tile_r
    r_off = row0 % tile_r
    f_sl = pl.ds(j * block_f, block_f)

    def tile_body(t, acc):
        c0 = cols_ref[t] * tile_c

        def k_body(k, acc):
            c = c0 + k * block_k
            a = tiles_ref[t, pl.ds(r_off, block_m), pl.ds(k * block_k, block_k)]
            dc = d_ref[pl.ds(c, block_k)]
            a = (a.astype(jnp.float32) * dc[None, :]).astype(cdt)
            xb = x_ref[pl.ds(c, block_k), f_sl].astype(cdt)
            return acc + pl.dot(a, xb, precision=precision)

        return lax.fori_loop(0, tile_c // block_k, k_body, acc)

    acc = jnp.zeros((block_m, block_f), jnp.float32)
    acc = lax.fori_loop(row_ptr_ref[trow], row_ptr_ref[trow + 1], tile_body,
                        acc)
    dr = d_ref[pl.ds(row0, block_m)]
    o_ref[...] = acc * dr[:, None]


def tile_product_triton(tiles, tile_rows, tile_cols, x, n_rows, scale=None,
                        precision=None, *, block_m=64, block_k=128,
                        num_warps=4, num_stages=3, interpret=False):
    """``out[n_rows, F] (f32)`` = the block-sparse product, one Triton
    program per (row block, feature block). ``scale`` and ``precision`` as
    in ``ops.bcsr.tile_product`` (f32 operands contract in TF32 unless
    ``precision="highest"``)."""
    _, tile_r, tile_c = tiles.shape
    n_nodes, n_feat = x.shape
    block_m, block_k = min(block_m, tile_r), min(block_k, tile_c)
    if tile_r % block_m or tile_c % block_k:
        raise ValueError(f"tile {tile_r}x{tile_c} not a multiple of the "
                         f"{block_m}x{block_k} program block")
    cdt = x.dtype if tiles.dtype == jnp.int8 else tiles.dtype
    block_f = min(128, max(16, pl.next_power_of_2(n_feat)))
    f_pad = pl.cdiv(n_feat, block_f) * block_f
    if f_pad != n_feat:
        x = jnp.pad(x, ((0, 0), (0, f_pad - n_feat)))
    d = jnp.ones((max(n_nodes, n_rows),), jnp.float32) if scale is None else scale
    n_row_blocks = n_rows // tile_r
    row_ptr = jnp.searchsorted(
        tile_rows, jnp.arange(n_row_blocks + 1, dtype=tile_rows.dtype)
    ).astype(jnp.int32)
    kernel = functools.partial(
        _kernel, block_m=block_m, block_k=block_k, block_f=block_f,
        tile_r=tile_r, tile_c=tile_c, cdt=cdt,
        precision=(lax.Precision.HIGHEST
                   if precision in ("highest", lax.Precision.HIGHEST) else None),
    )
    out = pl.pallas_call(
        kernel,
        grid=(n_rows // block_m, f_pad // block_f),
        in_specs=[pl.no_block_spec] * 5,
        out_specs=pl.BlockSpec((block_m, block_f), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n_rows, f_pad), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        interpret=interpret,
        name="bcsr_tile_spmm",
    )(row_ptr, tile_cols, tiles, d, x)
    return out[:, :n_feat]
