"""BCSR block-sparse SpMM tests + RCM reordering tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import parallel_gcn.ops.bcsr as pb
from parallel_gcn.data.graph import build_graph, random_graph
from parallel_gcn.data.reorder import permute_csr, rcm_permutation
from parallel_gcn.golden import csr_matvec_dense
from parallel_gcn.ops.graphsum import graphsum


@pytest.mark.parametrize("n,f", [(200, 64), (300, 130)])
def test_bcsr_matmul_matches_golden(n, f):
    csr, _ = random_graph(n, 6, seed=1)
    graph = build_graph(csr, bcsr=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((graph.n_nodes, f)).astype(np.float32)
    out = np.asarray(pb.bcsr_matmul(graph.bcsr, jnp.asarray(x)))
    expected = csr_matvec_dense(csr, x[: csr.n_rows])
    np.testing.assert_allclose(out[: csr.n_rows], expected, rtol=2e-5, atol=2e-5)
    # padded rows produce zeros (rows no tile touches sum to zero)
    np.testing.assert_allclose(out[csr.n_rows :], 0.0, atol=1e-7)


def test_bcsr_through_graphsum_and_vjp():
    csr, _ = random_graph(150, 5, seed=2)
    graph = build_graph(csr, bcsr=True)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((graph.n_nodes, 32)).astype(np.float32))
    g = jnp.asarray(rng.standard_normal((graph.n_nodes, 32)).astype(np.float32))

    out = graphsum(x, graph, backend="bcsr")
    expected = graphsum(x, graph, backend="segment")
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=2e-5, atol=2e-5)

    _, vjp = jax.vjp(lambda x: graphsum(x, graph, backend="bcsr"), x)
    (dx,) = vjp(g)
    expected_dx = graphsum(g, graph, backend="segment")
    np.testing.assert_allclose(
        np.asarray(dx), np.asarray(expected_dx), rtol=2e-5, atol=2e-5
    )


def test_bcsr_tile_rows_sorted_and_covering():
    csr, _ = random_graph(500, 4, seed=3)
    graph = build_graph(csr, bcsr=True)
    rows = np.asarray(graph.bcsr.tile_rows)
    assert (np.diff(rows) >= 0).all()
    assert set(range(graph.n_nodes // 128)) <= set(rows.tolist())


def test_rcm_reduces_bandwidth():
    csr, _ = random_graph(400, 6, seed=4)
    perm = rcm_permutation(csr)
    assert sorted(perm.tolist()) == list(range(400))
    permuted = permute_csr(csr, perm)

    def bandwidth(c):
        rows = c.row_ids().astype(np.int64)
        return int(np.abs(rows - c.indices).max())

    assert bandwidth(permuted) <= bandwidth(csr)
    # permuted graph is the same graph: aggregation commutes with permutation
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    inv = np.empty(400, dtype=np.int64)
    inv[perm] = np.arange(400)
    out_orig = csr_matvec_dense(csr, x)
    out_perm = csr_matvec_dense(permuted, x[perm])
    np.testing.assert_allclose(out_perm, out_orig[perm], rtol=1e-5, atol=1e-5)


def test_rcm_tile_reduction_on_real_graph():
    """RCM should cut the BCSR tile count on a citation graph."""
    try:
        from parallel_gcn.data.parser import load_dataset

        ds = load_dataset("cora", use_native=False)
    except FileNotFoundError:
        pytest.skip("cora not available")
    csr = ds.graph
    perm = rcm_permutation(csr)
    permuted = permute_csr(csr, perm)
    g_orig = build_graph(csr, bcsr=True)
    g_perm = build_graph(permuted, bcsr=True)
    assert g_perm.bcsr.n_tiles < g_orig.bcsr.n_tiles


@pytest.mark.parametrize("hybrid", [False, True])
def test_int8_pattern_pack_matches_golden(hybrid):
    """int8 tiles store the exact 0/1 pattern; out = d ⊙ B(d ⊙ x) must equal
    the value-tile result to f32 tolerance (factorization, not quantization)."""
    csr, _ = random_graph(300, 6, seed=4)
    kw = dict(hybrid=True, min_tile_nnz=2) if hybrid else dict(bcsr=True)
    graph = build_graph(csr, tile_dtype=np.int8, **kw)
    b = graph.bcsr
    assert b.tiles.dtype == jnp.int8
    assert b.sym_scale is not None and b.sym_scale.shape[0] == b.n_nodes
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((graph.n_nodes, 32)).astype(np.float32))
    backend = "hybrid" if graph.is_hybrid else "bcsr"
    out = graphsum(x, graph, backend=backend)
    ref_graph = build_graph(csr, **kw)
    expected = graphsum(x, ref_graph, backend=backend)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(expected), rtol=2e-5, atol=2e-5
    )
    # VJP: diag(d)·B·diag(d) is symmetric -> backward equals forward
    g = jnp.asarray(rng.standard_normal((graph.n_nodes, 32)).astype(np.float32))
    _, vjp = jax.vjp(lambda x: graphsum(x, graph, backend=backend), x)
    (dx,) = vjp(g)
    expected_dx = graphsum(g, ref_graph, backend=backend)
    np.testing.assert_allclose(
        np.asarray(dx), np.asarray(expected_dx), rtol=2e-5, atol=2e-5
    )


def test_int8_pack_rejects_nonfactoring_values():
    csr, _ = random_graph(100, 4, seed=5)
    bad = csr.values.copy()
    # break v_ij = k·d_i·d_j with a NON-integer factor (an integer one is a
    # legitimate duplicate-edge multiplicity under the exact sym_scale)
    bad[0] *= 1.7
    import dataclasses as dc

    broken = dc.replace(csr, values=bad)
    with pytest.raises(ValueError):
        build_graph(broken, bcsr=True, tile_dtype=np.int8)
    # without the carried scale the recovery must also refuse
    broken2 = dc.replace(csr, values=bad, sym_scale=None)
    with pytest.raises(ValueError):
        build_graph(broken2, bcsr=True, tile_dtype=np.int8)


# --- the XLA block-sparse product against the golden oracle ---------------

def _tile_case(tile_r, tile_c, dtype, slab):
    import dataclasses

    from parallel_gcn.data.graph import sym_scale_for

    csr, _ = random_graph(300, 6, seed=5)
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    vals = csr.values
    if slab == "rect":  # a row slab: the first tile-row of Â
        keep = rows < tile_r
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    scale = None
    if dtype == "int8":
        n_pad = -(-csr.n_rows // tile_c) * tile_c
        scale = sym_scale_for(csr, rows, cols, vals, n_pad)
    pack = pb.build_bcsr(rows, cols, vals, csr.n_rows, dtype=np.dtype(dtype),
                         tile=tile_r, tile_c=tile_c, sym_scale=scale)
    if slab == "rect":
        pack = dataclasses.replace(pack, n_rows=tile_r)
    dense = np.zeros((pack.n_nodes, pack.n_nodes), np.float64)
    dense[csr.row_ids(), csr.indices] = csr.values
    return pack, dense[: pack.n_rows or pack.n_nodes], pack.n_rows or pack.n_nodes


@pytest.mark.parametrize("direction", ["forward", "vjp"])
@pytest.mark.parametrize("dtype,slab", [
    ("float32", "square"), ("bfloat16", "square"), ("int8", "square"),
    ("float32", "rect"), ("bfloat16", "rect"),
])
@pytest.mark.parametrize("tile_r,tile_c", [(128, 128), (128, 256), (256, 256)])
def test_tile_product_matches_golden(tile_r, tile_c, dtype, slab, direction):
    """bcsr_matmul (square, custom VJP reusing the forward) and
    bcsr_matmul_rect (row slab, plain autodiff) against the dense f64
    product — forward Â·x and the VJP Âᵀ·g. bf16 tiles contract at bf16, so
    their tolerance is bf16's; f32 values and the exact int8 pattern with
    f32 scaling hold f32 accuracy."""
    pack, dense, n_rows = _tile_case(tile_r, tile_c, dtype, slab)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((pack.n_nodes, 24)).astype(np.float32)
    g = rng.standard_normal((dense.shape[0], 24)).astype(np.float32)

    def fn(h):
        if slab == "rect":
            return pb.bcsr_matmul_rect(pack, h)
        return pb.bcsr_matmul(pack, h, precision="highest")

    if direction == "forward":
        out = np.asarray(fn(jnp.asarray(x)))
        want = dense @ x
    else:
        _, vjp = jax.vjp(fn, jnp.asarray(x))
        out = np.asarray(vjp(jnp.asarray(g))[0])
        want = dense.T @ g
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol)


def test_tile_product_rect_rejects_int8_pattern():
    pack, _, _ = _tile_case(128, 128, "int8", "square")
    with pytest.raises(ValueError, match="int8"):
        pb.bcsr_matmul_rect(pack, jnp.zeros((pack.n_nodes, 4)))


def test_tile_product_chunking_is_exact(monkeypatch):
    """Any tile chunk length gives the same sum (the byte budget only
    bounds temporaries)."""
    pack, dense, _ = _tile_case(128, 128, "float32", "square")
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (pack.n_nodes, 8)).astype(np.float32))
    full = np.asarray(pb.bcsr_matmul(pack, x, precision="highest"))
    monkeypatch.setattr(pb, "_CHUNK_BYTES", 1)  # one tile per chunk
    one = np.asarray(pb.bcsr_matmul(pack, x, precision="highest"))
    np.testing.assert_allclose(one, full, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(full, dense @ np.asarray(x), rtol=2e-5,
                               atol=2e-5)


# --- the GPU tile kernel (Pallas Triton) in interpret mode ----------------


@pytest.mark.parametrize("dtype,slab", [
    ("float32", "square"), ("bfloat16", "square"), ("int8", "square"),
    ("float32", "rect"),
])
@pytest.mark.parametrize("tile_r,tile_c", [(128, 128), (128, 256)])
def test_triton_tile_kernel_matches_xla_product(tile_r, tile_c, dtype, slab):
    """The Triton kernel (run by the Pallas interpreter) computes the same
    product as the plain-XLA tile product it replaces on the GPU."""
    from parallel_gcn.ops.bcsr_triton import tile_product_triton

    pack, dense, n_rows = _tile_case(tile_r, tile_c, dtype, slab)
    x = jnp.asarray(np.random.default_rng(6).standard_normal(
        (pack.n_nodes, 41)).astype(np.float32))
    args = (pack.tiles, pack.tile_rows, pack.tile_cols, x, n_rows,
            pack.sym_scale, "highest")
    want = np.asarray(pb.tile_product(*args))
    got = np.asarray(tile_product_triton(*args, interpret=True))
    assert got.shape == want.shape == (n_rows, 41)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, dense @ np.asarray(x), rtol=tol, atol=tol)


def test_triton_tile_kernel_rejects_unaligned_blocks():
    from parallel_gcn.ops.bcsr_triton import tile_product_triton

    pack, _, _ = _tile_case(128, 128, "float32", "square")
    x = jnp.zeros((pack.n_nodes, 8))
    with pytest.raises(ValueError, match="program block"):
        tile_product_triton(pack.tiles, pack.tile_rows, pack.tile_cols, x,
                            pack.n_nodes, block_m=96, interpret=True)


def test_tile_product_dispatch_follows_the_platform(monkeypatch):
    """bcsr_matmul takes the Triton kernel on the GPU and the XLA product
    elsewhere — chosen from the backend, never by falling back."""
    calls = []
    monkeypatch.setattr(pb, "tile_product_triton",
                        lambda *a, **k: calls.append("triton") or pb.tile_product(*a))
    pack, _, _ = _tile_case(128, 128, "float32", "square")
    x = jnp.ones((pack.n_nodes, 4))
    pb.bcsr_matmul(pack, x)
    assert calls == []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    pb.bcsr_matmul(pack, x)
    assert calls == ["triton"]
