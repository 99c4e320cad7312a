"""graphsum — neighborhood aggregation ``out = Â · x``.

This is the message-passing op of the framework, the counterpart of the
reference's GraphSum CUDA kernel (src/module.cu:165-210: CSR traversal with
precomputed Â values, one thread per output element).

Backends, all plain XLA with static shapes:

* ``dense``    — materialize Â once (small graphs): a single ``adj @ x``
                 matmul.
* ``segment``  — row-sorted COO: gather ``x[col]``, scale by ``val``, and
                 ``segment_sum`` by ``row`` — the reference's row-ordered walk
                 over the edges. Edge-chunked with ``lax.scan`` when the
                 gathered intermediate would blow the memory budget
                 (E × F floats — e.g. reddit at hidden 600).
* ``bcsr``     — block-sparse product over dense tiles of Â (ops/bcsr.py).
* ``hybrid``   — the tiles for the graph's dense blocks + ``segment`` over
                 the residual edges.

Backward: Â is symmetric (undirected graph, symmetric normalization), so
``∂/∂x (Âx)ᵀg = Âᵀg = Âg`` — the custom VJP re-runs the forward on the
cotangent, the same shortcut the reference uses by calling one kernel for both
directions (src/module.cu:188-208). This also keeps the backward's segment ids
row-sorted.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parallel_gcn.data.graph import Graph

# Gathered-intermediate budget for the segment backend, in float32 elements.
# 256Mi elements = 1 GiB; above this the edge loop is chunked with lax.scan.
_DEFAULT_EDGE_ELEM_BUDGET = 256 * 1024 * 1024


def _segment_once(x, row, col, val, n_nodes):
    gathered = val[:, None].astype(x.dtype) * x[col]
    return jax.ops.segment_sum(
        gathered, row, num_segments=n_nodes, indices_are_sorted=True
    )


def _segment_chunked(x, row, col, val, n_nodes, n_chunks):
    """lax.scan over edge chunks; keeps the gathered intermediate at
    chunk_size × F instead of E × F."""
    e_pad = row.shape[0]
    chunk = e_pad // n_chunks
    rows = row[: n_chunks * chunk].reshape(n_chunks, chunk)
    cols = col[: n_chunks * chunk].reshape(n_chunks, chunk)
    vals = val[: n_chunks * chunk].reshape(n_chunks, chunk)

    def body(acc, inputs):
        r, c, v = inputs
        acc = acc + jax.ops.segment_sum(
            v[:, None].astype(x.dtype) * x[c],
            r,
            num_segments=n_nodes,
            indices_are_sorted=True,
        )
        return acc, None

    init = jnp.zeros((n_nodes, x.shape[1]), dtype=x.dtype)
    out, _ = jax.lax.scan(body, init, (rows, cols, vals))
    rem = e_pad - n_chunks * chunk
    if rem:
        out = out + _segment_once(x, row[-rem:], col[-rem:], val[-rem:], n_nodes)
    return out


def _pick_n_chunks(n_edges_pad: int, n_feat: int, edge_chunk: int) -> int:
    if edge_chunk > 0:
        return max(1, n_edges_pad // edge_chunk)
    total = n_edges_pad * max(n_feat, 1)
    n_chunks = max(1, total // _DEFAULT_EDGE_ELEM_BUDGET)
    while n_edges_pad % n_chunks != 0 and n_chunks > 1:
        n_chunks -= 1
    return n_chunks


@partial(jax.custom_vjp, nondiff_argnums=(6, 7))
def _graphsum(x, row, col, val, adj, bcsr, n_nodes, spec):
    return _graphsum_impl(x, row, col, val, adj, bcsr, n_nodes, spec)


def _graphsum_impl(x, row, col, val, adj, bcsr, n_nodes, spec):
    backend, n_chunks, precision = spec
    if backend == "dense":
        prec = None if precision in (None, "default") else precision
        out_dtype = x.dtype
        if adj.dtype == jnp.int8:
            # int8 pattern matrix (graphsum wrapped the d-scaling outside):
            # upcast to x's compute dtype — XLA folds the convert into the
            # matmul's operand read, so HBM still moves 1 byte/entry
            adj = adj.astype(x.dtype)
        elif adj.dtype != x.dtype:
            # never upcast a bf16-stored Â back to f32 (that would materialize
            # the full matrix wide again) — narrow x instead; the result keeps
            # x's original dtype
            if jnp.dtype(adj.dtype).itemsize < jnp.dtype(x.dtype).itemsize:
                x = x.astype(adj.dtype)
            else:
                adj = adj.astype(x.dtype)
        return jnp.dot(
            adj, x, preferred_element_type=out_dtype, precision=prec
        )
    if backend in ("bcsr", "hybrid"):
        from parallel_gcn.ops.bcsr import bcsr_matmul

        prec = None if precision in (None, "default") else precision
        out = bcsr_matmul(bcsr, x, precision=prec).astype(x.dtype)
        if backend == "bcsr":
            return out
        # hybrid: dense tiles + COO residual through segment_sum
        if n_chunks > 1:
            return out + _segment_chunked(x, row, col, val, n_nodes, n_chunks)
        return out + _segment_once(x, row, col, val, n_nodes)
    if n_chunks > 1:
        return _segment_chunked(x, row, col, val, n_nodes, n_chunks)
    return _segment_once(x, row, col, val, n_nodes)


def _graphsum_fwd(x, row, col, val, adj, bcsr, n_nodes, spec):
    out = _graphsum_impl(x, row, col, val, adj, bcsr, n_nodes, spec)
    return out, (row, col, val, adj, bcsr)


def _graphsum_bwd(n_nodes, spec, res, g):
    row, col, val, adj, bcsr = res
    # Â symmetric: backward is the same aggregation applied to the cotangent.
    dx = _graphsum_impl(g, row, col, val, adj, bcsr, n_nodes, spec)
    return dx, None, None, None, None, None


_graphsum.defvjp(_graphsum_fwd, _graphsum_bwd)


def resolve_backend(graph: Graph, backend: str, dense_threshold: int = 8192) -> str:
    if backend == "auto":
        if graph.is_hybrid:
            backend = "hybrid"
        elif graph.bcsr is not None:
            backend = "bcsr"
        elif graph.adj is not None and graph.n_nodes <= dense_threshold:
            backend = "dense"
        else:
            backend = "segment"
    if backend in ("bcsr", "segment") and graph.is_hybrid:
        # a hybrid-built graph keeps only the dense tiles in bcsr and only the
        # residual edges in row/col/val — serving either alone would silently
        # compute a wrong aggregation. The coercion preserves correctness, but
        # surface the configuration mismatch instead of hiding it.
        import warnings

        warnings.warn(
            f"backend={backend!r} requested on a hybrid-built graph; serving "
            "tiles or residual alone would drop edges — using 'hybrid'",
            stacklevel=2,
        )
        backend = "hybrid"
    if not graph.is_hybrid and not graph.coo_complete:
        # hybrid build demoted to pure tiles (empty residual): the COO arrays
        # are padding-only, so ANY request must be served by the tile pack
        if graph.bcsr is None:
            raise ValueError("graph has neither a complete COO nor a tile pack")
        if backend in ("dense", "segment"):
            raise ValueError(
                f"backend={backend!r} requested but this graph carries only a "
                "tile pack (hybrid build with empty residual; its COO/adj "
                "arrays are padding-only) — use backend=bcsr/hybrid/auto"
            )
        backend = "bcsr"
    elif backend == "hybrid" and not graph.is_hybrid and graph.bcsr is not None:
        backend = "bcsr"
    return backend


def graphsum(
    x: jnp.ndarray,
    graph: Graph,
    *,
    backend: str = "auto",
    edge_chunk: int = 0,
    dense_threshold: int = 8192,
    precision: str | None = "highest",
) -> jnp.ndarray:
    """Aggregate node features over the normalized adjacency: ``Â @ x``.

    x: [n_nodes, F] node features (n_nodes = padded node count of ``graph``).
    ``precision`` applies to the dense and tile products (f32 matmuls at
    default precision may run in TF32 on the GPU; "highest" forces true f32).
    Returns [n_nodes, F].
    """
    resolved = resolve_backend(graph, backend, dense_threshold)
    if resolved == "dense" and graph.adj is None:
        raise ValueError("dense backend requested but graph was built without adj")
    if resolved == "bcsr" and graph.bcsr is None:
        raise ValueError("bcsr backend requested but graph was built without bcsr")
    if resolved == "hybrid" and graph.bcsr is None:
        raise ValueError(
            "hybrid backend requested but graph was built without tiles "
            "(build with hybrid=True / backend=hybrid)"
        )
    n_chunks = (
        _pick_n_chunks(graph.n_edges_pad, x.shape[-1], edge_chunk)
        if resolved in ("segment", "hybrid")
        else 1
    )
    if resolved == "dense" and graph.adj.dtype == jnp.int8:
        # adj_dtype=int8: Â = D·A₈·D with D = diag(d) (data.graph build
        # verified the factorization) — scale outside the pattern matmul.
        # D·A₈·D is symmetric like Â, so the inner op's reuse-the-forward
        # VJP and the outer autodiff compose exactly
        d = graph.adj_scale.astype(x.dtype)[:, None]
        out = _graphsum(
            x * d, graph.row, graph.col, graph.val, graph.adj, graph.bcsr,
            graph.n_nodes, (resolved, n_chunks, precision),
        )
        return out * d
    return _graphsum(
        x,
        graph.row,
        graph.col,
        graph.val,
        graph.adj,
        graph.bcsr,
        graph.n_nodes,
        (resolved, n_chunks, precision),
    )
