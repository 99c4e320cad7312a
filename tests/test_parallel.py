"""Multi-chip tests on the 8-device virtual CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gcn.config import AdamConfig, Config, GCNConfig, ExecConfig, TrainConfig
from parallel_gcn.data.graph import build_graph, random_graph
from parallel_gcn.data.parser import Dataset, DeviceDataset
from parallel_gcn.models.gcn import init_params
from parallel_gcn.optim import init_adam
from parallel_gcn.parallel.partition import partition_graph, partition_graph_ring
from parallel_gcn.parallel.train_parallel import (
    AXIS,
    device_put_sharded_inputs,
    graphsum_dist,
    graphsum_ring,
    make_mesh,
    make_parallel_epoch_step,
    shard_dataset,
)
from parallel_gcn.train import make_epoch_step, build_model
from jax.sharding import PartitionSpec as P


def _dataset(n=200, f=12, c=3, seed=0):
    rng = np.random.default_rng(seed)
    csr, _ = random_graph(n, 6, seed=seed)
    labels = rng.integers(0, c, n).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    feats[np.arange(n), labels] += 2.0
    split = rng.choice([1, 2, 3], size=n, p=[0.5, 0.25, 0.25]).astype(np.int32)
    return Dataset(
        name="synthetic", graph=csr, feature_csr=None, features=feats,
        labels=labels, split=split, n_nodes=n, input_dim=f, output_dim=c,
    )


def test_partition_covers_all_edges():
    csr, _ = random_graph(100, 5, seed=2)
    sg = partition_graph(csr, 4)
    assert sg.n_nodes_pad >= csr.n_rows
    assert (sg.val != 0).sum() == csr.nnz
    # reconstruct global COO and compare against the CSR expansion
    rows_g, cols_g, vals_g = [], [], []
    for d in range(4):
        live = sg.val[d] != 0
        rows_g.append(sg.row_local[d][live] + d * sg.n_local)
        cols_g.append(sg.col[d][live])
        vals_g.append(sg.val[d][live])
    rows_g = np.concatenate(rows_g)
    order = np.argsort(rows_g, kind="stable")
    np.testing.assert_array_equal(rows_g[order], csr.row_ids())
    np.testing.assert_array_equal(np.concatenate(cols_g)[order], csr.indices)
    np.testing.assert_allclose(np.concatenate(vals_g)[order], csr.values)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_graphsum_dist_matches_single_device(n_dev):
    csr, _ = random_graph(96, 6, seed=1)
    sg = partition_graph(csr, n_dev)
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sg.n_nodes_pad, 16)).astype(np.float32)

    # single-device expected
    g1 = build_graph(csr, n_nodes_pad=sg.n_nodes_pad)
    from parallel_gcn.ops.graphsum import graphsum

    expected = np.asarray(graphsum(jnp.asarray(x), g1, backend="segment"))

    fn = jax.jit(
        jax.shard_map(
            lambda x, r, c, v: graphsum_dist(x, r[0], c[0], v[0], sg.n_local),
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None)),
            out_specs=P(AXIS, None),
            check_vma=False,
        )
    )
    out = np.asarray(fn(x, sg.row_local, sg.col, sg.val))
    np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5)


def test_ring_partition_covers_all_edges():
    csr, _ = random_graph(100, 5, seed=2)
    sg = partition_graph_ring(csr, 4)
    assert sg.ring and sg.row_local.shape[:2] == (4, 4)
    assert (sg.val != 0).sum() == csr.nnz
    rows_g, cols_g, vals_g = [], [], []
    for d in range(4):
        for s in range(4):
            live = sg.val[d, s] != 0
            src_block = (d - s) % 4
            rows_g.append(sg.row_local[d, s][live] + d * sg.n_local)
            cols_g.append(sg.col[d, s][live] + src_block * sg.n_local)
            vals_g.append(sg.val[d, s][live])
    rows_g = np.concatenate(rows_g)
    cols_g = np.concatenate(cols_g)
    key = rows_g.astype(np.int64) * sg.n_nodes_pad + cols_g
    order = np.argsort(key)
    ref = csr.row_ids().astype(np.int64) * sg.n_nodes_pad + csr.indices
    ref_order = np.argsort(ref)
    np.testing.assert_array_equal(key[order], ref[ref_order])
    np.testing.assert_allclose(
        np.concatenate(vals_g)[order], csr.values[ref_order]
    )


@pytest.mark.parametrize("n_dev", [2, 8])
def test_graphsum_ring_matches_single_device(n_dev):
    csr, _ = random_graph(96, 6, seed=1)
    sg = partition_graph_ring(csr, n_dev)
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sg.n_nodes_pad, 16)).astype(np.float32)

    g1 = build_graph(csr, n_nodes_pad=sg.n_nodes_pad)
    from parallel_gcn.ops.graphsum import graphsum

    expected = np.asarray(graphsum(jnp.asarray(x), g1, backend="segment"))

    fn = jax.jit(
        jax.shard_map(
            lambda x, r, c, v: graphsum_ring(
                x, r[0], c[0], v[0], sg.n_local, n_dev
            ),
            mesh=mesh,
            in_specs=(
                P(AXIS, None),
                P(AXIS, None, None), P(AXIS, None, None), P(AXIS, None, None),
            ),
            out_specs=P(AXIS, None),
            check_vma=False,
        )
    )
    out = np.asarray(fn(x, sg.row_local, sg.col, sg.val))
    np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5)


def test_graphsum_ring_gradient_matches_dense():
    """d/dx of the ring aggregation must equal Âᵀ·g = Â·g (symmetric Â)."""
    n_dev = 4
    csr, _ = random_graph(64, 5, seed=3)
    sg = partition_graph_ring(csr, n_dev)
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((sg.n_nodes_pad, 8)).astype(np.float32)

    adj = np.zeros((sg.n_nodes_pad, sg.n_nodes_pad), np.float32)
    adj[csr.row_ids(), csr.indices] = csr.values
    expected_grad = adj.T @ np.ones_like(x)  # cotangent of sum(Âx) is Âᵀ1

    def loss(x):
        def inner(x, r, c, v):
            return graphsum_ring(x, r[0], c[0], v[0], sg.n_local, n_dev)

        y = jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(
                P(AXIS, None),
                P(AXIS, None, None), P(AXIS, None, None), P(AXIS, None, None),
            ),
            out_specs=P(AXIS, None),
            check_vma=False,
        )(x, sg.row_local, sg.col, sg.val)
        return jnp.sum(y)

    grad = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))
    np.testing.assert_allclose(grad, expected_grad, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tile_r,tile_c,dtype,tol", [
    (128, 128, np.float32, 2e-5),
    (128, 256, np.float32, 2e-5),   # rectangular: exercises the mirror split
    (128, 256, "bfloat16", 3e-2),   # production tile dtype
    (128, 256, "int8", 2e-5),       # pattern slabs + scale-before-gather (exact)
])
def test_hybrid_sharded_matches_single_device(tile_r, tile_c, dtype, tol):
    """Per-device tile slabs + residual (HybridShardedGraph) must reproduce
    the single-device aggregation, forward AND gradient (the sharded operator
    is self-adjoint because the global Â is symmetric) — across square,
    rectangular, and bf16 slab geometries."""
    from parallel_gcn.parallel.partition import partition_graph_hybrid
    from parallel_gcn.parallel.train_parallel import graphsum_dist_hybrid

    n_dev = 4
    csr, _ = random_graph(520, 7, seed=11)
    sg = partition_graph_hybrid(
        csr, n_dev, tile_r=tile_r, tile_c=tile_c,
        tile_dtype=np.dtype(dtype), min_tile_nnz=8,
        balance=False,  # expected is computed on the natural node order
    )
    assert sg.n_nodes_pad % n_dev == 0
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sg.n_nodes_pad, 16)).astype(np.float32)

    g1 = build_graph(csr, n_nodes_pad=sg.n_nodes_pad)
    from parallel_gcn.ops.graphsum import graphsum

    expected = np.asarray(graphsum(jnp.asarray(x), g1, backend="segment"))

    if sg.sym_scale is not None:
        from parallel_gcn.parallel.train_parallel import (
            graphsum_dist_hybrid_scaled,
        )

        def agg(x, tiles, trow, tcol, rr, rc, rv, d):
            return graphsum_dist_hybrid_scaled(
                x, d[0], None, tiles[0], trow[0], tcol[0], rr[0], rc[0],
                rv[0], sg.n_local, sg.n_buf,
            )

        extra_specs = (P(AXIS, None),)
        extra_args = (sg.sym_scale,)
    else:

        def agg(x, tiles, trow, tcol, rr, rc, rv):
            return graphsum_dist_hybrid(
                x, None, tiles[0], trow[0], tcol[0], rr[0], rc[0], rv[0],
                sg.n_local, sg.n_buf,
            )

        extra_specs = ()
        extra_args = ()

    specs = (
        P(AXIS, None),
        P(AXIS, None, None, None), P(AXIS, None), P(AXIS, None),
        P(AXIS, None), P(AXIS, None), P(AXIS, None),
    ) + extra_specs
    fn = jax.jit(jax.shard_map(
        agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
        check_vma=False,
    ))
    args = (x, sg.tiles, sg.trow, sg.tcol, sg.res_row, sg.res_col,
            sg.res_val) + extra_args
    out = np.asarray(fn(*args))
    np.testing.assert_allclose(out, expected, rtol=tol, atol=tol)

    # gradient: d sum(Âx)/dx = Â^T 1 = Â 1
    adj = np.zeros((sg.n_nodes_pad, sg.n_nodes_pad), np.float32)
    adj[csr.row_ids(), csr.indices] = csr.values
    expected_grad = adj.T @ np.ones_like(x)
    grad = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax.shard_map(
            agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
            check_vma=False,
        )(x, *args[1:]))
    ))(jnp.asarray(x)))
    np.testing.assert_allclose(grad, expected_grad, rtol=tol,
                               atol=tol * 10)


def test_fit_parallel_hybrid_end_to_end():
    """fit_parallel with backend=hybrid (tile-accelerated sharded aggregation):
    value slabs train end-to-end, and int8 pattern slabs reproduce their LOSS
    trajectory exactly (the d ⊙ B(d ⊙ x) factorization is exact; accuracies
    can flip on this fixture's exact truth==max ties under 1e-7 noise, so the
    loss columns are the robust invariant)."""
    from parallel_gcn.parallel.train_parallel import fit_parallel

    results = {}
    for tile_dtype in ("auto", "int8"):
        ds = _dataset()
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.0, 0.0),
                          epochs=40, early_stopping=0),
            exec=ExecConfig(backend="hybrid", seed=7, n_devices=4,
                          min_tile_nnz=4, matmul_precision="highest",
                          tile_dtype=tile_dtype),
            train=TrainConfig(verbose=False),
        )
        results[tile_dtype] = fit_parallel(cfg, ds)
    res = results["auto"]
    assert res.history[-1, 0] < res.history[0, 0]
    assert res.test_acc > 0.5
    assert np.isfinite(res.history).all()
    np.testing.assert_allclose(
        results["int8"].history[:, [0, 2]], res.history[:, [0, 2]],
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("n_dev", [2, 8])
def test_graphsum_dist_boundary_matches_single_device(n_dev):
    """Boundary halo (all_to_all of only the referenced remote rows) must
    reproduce the all_gather aggregation exactly — forward and gradient (the
    cotangent is row-sharded like x and Â is symmetric)."""
    csr, _ = random_graph(96, 6, seed=1)
    sg = partition_graph(csr, n_dev, boundary=True)
    assert sg.send_idx is not None and sg.halo_size > 0
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sg.n_nodes_pad, 16)).astype(np.float32)

    g1 = build_graph(csr, n_nodes_pad=sg.n_nodes_pad)
    from parallel_gcn.ops.graphsum import graphsum

    expected = np.asarray(graphsum(jnp.asarray(x), g1, backend="segment"))

    specs = (P(AXIS, None),) * 5

    def agg(x, r, c, v, s):
        return graphsum_dist(x, r[0], c[0], v[0], sg.n_local, send_idx=s[0])

    fn = jax.jit(jax.shard_map(
        agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
        check_vma=False,
    ))
    args = (sg.row_local, sg.col, sg.val, sg.send_idx)
    out = np.asarray(fn(x, *args))
    np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5)

    adj = np.zeros((sg.n_nodes_pad, sg.n_nodes_pad), np.float32)
    adj[csr.row_ids(), csr.indices] = csr.values
    expected_grad = adj.T @ np.ones_like(x)
    grad = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax.shard_map(
            agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
            check_vma=False,
        )(x, *args))
    ))(jnp.asarray(x)))
    np.testing.assert_allclose(grad, expected_grad, rtol=2e-5, atol=2e-4)


def _hub_csr(n=240, w=2, n_hubs=3):
    """Power-law fixture: a banded graph plus ``n_hubs`` nodes adjacent to
    everything. The hub owner's PULL halo is every remote neighborhood (≈ the
    whole graph); its PUSH slab is just the hub rows — exactly the asymmetry
    the adaptive halo exists for."""
    from parallel_gcn.data.graph import add_self_loops_csr

    lists = []
    for i in range(n):
        nb = {j for j in range(max(0, i - w), min(n, i + w + 1)) if j != i}
        nb |= set(range(n_hubs)) if i >= n_hubs else set(range(n)) - {i}
        lists.append(np.array(sorted(nb), dtype=np.int32))
    return add_self_loops_csr(lists)


def test_adaptive_partition_mixes_modes_and_covers_edges():
    """adaptive=True must (a) classify hub-dominated pairs as push, (b) keep
    every edge exactly once across the pull+push slabs, and (c) shrink the
    exchange footprint vs the pure-pull boundary layout."""
    csr = _hub_csr()
    n_dev = 4
    sg = partition_graph(csr, n_dev, boundary=True, adaptive=True)
    sgb = partition_graph(csr, n_dev, boundary=True)
    assert sg.push_slab > 0 and sg.push_row is not None
    # exchange slabs shrink: pulled rows + pushed partial rows < pure pull
    assert sg.halo_size + sg.push_slab < sgb.halo_size

    # edge coverage: reconstruct global (row, col, val) from both slab kinds
    rows_g, cols_g, vals_g = [], [], []
    for d in range(n_dev):
        live = sg.val[d] != 0
        rows_g.append(sg.row_local[d][live] + d * sg.n_local)
        # pull cols index the compact buffer — invert via send_idx
        c = sg.col[d][live].astype(np.int64)
        H = sg.halo_size
        local = c < sg.n_local
        src_dev = np.where(local, d, (c - sg.n_local) // H)
        slot = np.where(local, c, (c - sg.n_local) % H)
        sent = sg.send_idx[src_dev, d * H + np.where(local, 0, slot)]
        cols_g.append(
            np.where(local, c + d * sg.n_local, sent + src_dev * sg.n_local)
        )
        vals_g.append(sg.val[d][live])
    for s in range(n_dev):
        live = sg.push_val[s] != 0
        pr = sg.push_row[s][live].astype(np.int64)
        dst_dev, slot = pr // sg.push_slab, pr % sg.push_slab
        loc = sg.push_recv[dst_dev, s * sg.push_slab + slot]
        assert (loc < sg.n_local).all()  # live edges never hit the dump slot
        rows_g.append(loc + dst_dev * sg.n_local)
        cols_g.append(sg.push_col[s][live] + s * sg.n_local)
        vals_g.append(sg.push_val[s][live])
    rows_g = np.concatenate(rows_g).astype(np.int64)
    cols_g = np.concatenate(cols_g).astype(np.int64)
    key = rows_g * sg.n_nodes_pad + cols_g
    order = np.argsort(key)
    ref = csr.row_ids().astype(np.int64) * sg.n_nodes_pad + csr.indices
    ref_order = np.argsort(ref)
    np.testing.assert_array_equal(key[order], ref[ref_order])
    np.testing.assert_allclose(
        np.concatenate(vals_g)[order], csr.values[ref_order]
    )


@pytest.mark.parametrize("n_dev", [2, 8])
def test_graphsum_dist_adaptive_matches_single_device(n_dev):
    """Push/pull halo must reproduce the aggregation exactly — forward and
    gradient (autodiff transposes both all_to_alls and the scatter-add)."""
    from parallel_gcn.parallel.train_parallel import graphsum_dist_adaptive

    csr = _hub_csr()
    sg = partition_graph(csr, n_dev, adaptive=True)
    assert sg.push_slab > 0
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sg.n_nodes_pad, 16)).astype(np.float32)

    g1 = build_graph(csr, n_nodes_pad=sg.n_nodes_pad)
    from parallel_gcn.ops.graphsum import graphsum

    expected = np.asarray(graphsum(jnp.asarray(x), g1, backend="segment"))

    specs = (P(AXIS, None),) * 9

    def agg(x, r, c, v, pr, pc, pv, precv, s):
        return graphsum_dist_adaptive(
            x, r[0], c[0], v[0], pr[0], pc[0], pv[0], precv[0],
            sg.n_local, send_idx=s[0],
        )

    fn = jax.jit(jax.shard_map(
        agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
        check_vma=False,
    ))
    args = (sg.row_local, sg.col, sg.val, sg.push_row, sg.push_col,
            sg.push_val, sg.push_recv, sg.send_idx)
    out = np.asarray(fn(x, *args))
    np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5)

    adj = np.zeros((sg.n_nodes_pad, sg.n_nodes_pad), np.float32)
    adj[csr.row_ids(), csr.indices] = csr.values
    cot = rng.standard_normal(x.shape).astype(np.float32)
    expected_grad = adj.T @ cot
    grad = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax.shard_map(
            agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
            check_vma=False,
        )(x, *args) * cot)
    ))(jnp.asarray(x)))
    np.testing.assert_allclose(grad, expected_grad, rtol=2e-5, atol=2e-4)


def _banded_csr(n, w):
    """Locality fixture: node i ~ nodes i±1..w (no wraparound) — tiny
    boundary sets between contiguous row blocks."""
    from parallel_gcn.data.graph import add_self_loops_csr

    lists = [
        np.array(
            [j for j in range(max(0, i - w), min(n, i + w + 1)) if j != i],
            dtype=np.int32,
        )
        for i in range(n)
    ]
    return add_self_loops_csr(lists)


def test_boundary_halo_buffer_is_compact():
    """VERDICT item 1's memory criterion: with the boundary halo the
    per-device source buffer is O(n_local + |halo|), NOT O(N) — on a graph
    with locality the buffer stays near n_local while the all_gather layout
    would always hold all n_nodes_pad rows."""
    csr = _banded_csr(1024, 3)
    n_dev = 8
    sg = partition_graph(csr, n_dev, boundary=True)
    # each device needs only w=3 rows from each contiguous neighbor block
    assert sg.n_buf < sg.n_local + 8 * n_dev  # vs n_nodes_pad = 8*n_local
    assert sg.n_buf < sg.n_nodes_pad // 4

    from parallel_gcn.parallel.partition import partition_graph_hybrid

    # hybrid: halo granularity is whole tile_c blocks for tile columns; a
    # banded graph touches one remote block per side, so the buffer stays
    # n_local + O(n_dev · tile_c) ≪ n_nodes_pad
    sgh = partition_graph_hybrid(
        _banded_csr(8192, 3), n_dev, tile_r=128, tile_c=128, min_tile_nnz=4,
        boundary=True,
    )
    assert sgh.send_idx is not None
    assert sgh.n_buf < sgh.n_nodes_pad // 3


def test_boundary_cost_guard_warns_and_falls_back():
    """VERDICT round-2 weak item 5: the all_to_all pads every (src, dst) slab
    to the max pair, so on a uniform random graph the 'compact' buffer can
    EXCEED the all_gathered matrix. The partition must warn; with
    boundary_fallback it must return the all_gather layout instead — a
    memory-saving option silently costing more memory is the bug."""
    from parallel_gcn.parallel.partition import partition_graph_hybrid

    csr, _ = random_graph(200, 6, seed=0)  # near-complete boundary sets

    # warn-only default (structural tests/dryruns keep the layout under test)
    with pytest.warns(UserWarning, match="not smaller than the all_gathered"):
        sg = partition_graph(csr, 4, boundary=True)
    assert sg.send_idx is not None
    assert sg.n_buf >= sg.n_nodes_pad  # the fixture premise

    # fallback: plain all_gather partition, bit-identical to boundary=False
    with pytest.warns(UserWarning, match="falling back to the all_gather"):
        sg_fb = partition_graph(csr, 4, boundary=True, boundary_fallback=True)
    assert sg_fb.send_idx is None and sg_fb.halo_size == 0
    plain = partition_graph(csr, 4)
    np.testing.assert_array_equal(sg_fb.col, plain.col)
    np.testing.assert_array_equal(sg_fb.val, plain.val)

    # adaptive: the push split must be discarded too (pure all_gather layout)
    with pytest.warns(UserWarning, match="falling back to the all_gather"):
        sg_ad = partition_graph(csr, 4, adaptive=True, boundary_fallback=True)
    assert sg_ad.send_idx is None and sg_ad.push_slab == 0
    np.testing.assert_array_equal(sg_ad.col, plain.col)

    # hybrid slabs: tcol/res_col must be restored to global coordinates
    with pytest.warns(UserWarning, match="falling back to the all_gather"):
        sgh_fb = partition_graph_hybrid(
            csr, 4, tile_r=128, tile_c=128, min_tile_nnz=4, boundary=True,
            boundary_fallback=True,
        )
    assert sgh_fb.send_idx is None
    sgh_plain = partition_graph_hybrid(csr, 4, tile_r=128, tile_c=128,
                                       min_tile_nnz=4)
    np.testing.assert_array_equal(sgh_fb.res_col, sgh_plain.res_col)

    # a LOCAL graph must not warn: small boundary sets genuinely pay off
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        sg_ok = partition_graph(_banded_csr(1024, 3), 8, boundary=True,
                                boundary_fallback=True)
    assert sg_ok.send_idx is not None


def test_fit_parallel_boundary_fallback_end_to_end():
    """halo=boundary on a graph where the compact buffer loses must still
    train (on the all_gather layout) and warn — never hand the user a layout
    that inflates memory."""
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()  # random fixture: boundary never pays off here
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.0, 0.0),
                      epochs=5, early_stopping=0),
        exec=ExecConfig(backend="segment", seed=7, n_devices=4,
                      halo="boundary"),  # halo_fallback defaults True
        train=TrainConfig(verbose=False, mode="scan"),
    )
    with pytest.warns(UserWarning, match="falling back to the all_gather"):
        res = fit_parallel(cfg, ds)
    assert np.isfinite(res.history).all()
    assert res.history[-1, 0] < res.history[0, 0]


@pytest.mark.parametrize("tile_r,tile_c,dtype,balance,tol", [
    (128, 128, np.float32, False, 2e-5),
    (128, 256, np.float32, False, 2e-5),   # rectangular blocks in the halo
    (128, 128, np.float32, True, 2e-5),    # + slab-balancing node perm
    (128, 128, "int8", False, 2e-5),       # pattern slabs: scaled halo exchange
])
def test_hybrid_boundary_matches_single_device(tile_r, tile_c, dtype, balance,
                                               tol):
    """Hybrid tile slabs + COO residual against the BOUNDARY halo (compact
    local+halo buffer, tile_c-aligned blocks) must reproduce the single-device
    aggregation, forward AND gradient — the memory-scaling config keeps the
    fast kernels (VERDICT round-1 weak item 1)."""
    from parallel_gcn.parallel.partition import partition_graph_hybrid
    from parallel_gcn.parallel.train_parallel import (
        graphsum_dist_hybrid,
        graphsum_dist_hybrid_scaled,
    )

    n_dev = 4
    csr, _ = random_graph(520, 7, seed=11)
    sg = partition_graph_hybrid(
        csr, n_dev, tile_r=tile_r, tile_c=tile_c,
        tile_dtype=np.dtype(dtype), min_tile_nnz=8,
        boundary=True, balance=balance,
    )
    assert sg.send_idx is not None
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sg.n_nodes_pad, 16)).astype(np.float32)

    g1 = build_graph(csr, n_nodes_pad=sg.n_nodes_pad)
    from parallel_gcn.ops.graphsum import graphsum

    expected = np.asarray(graphsum(jnp.asarray(x), g1, backend="segment"))
    perm = sg.node_perm
    if perm is not None:
        # the partition relabeled nodes (whole tile_c blocks); sharded row
        # i is global row perm[i] of the natural order
        x = x[perm]
        expected = expected[perm]

    if sg.sym_scale is not None:
        def agg(x, tiles, trow, tcol, rr, rc, rv, s, d):
            return graphsum_dist_hybrid_scaled(
                x, d[0], s[0], tiles[0], trow[0], tcol[0], rr[0], rc[0],
                rv[0], sg.n_local, sg.n_buf,
            )

        extra_specs = (P(AXIS, None),)
        extra_args = (sg.sym_scale,)
    else:
        def agg(x, tiles, trow, tcol, rr, rc, rv, s):
            return graphsum_dist_hybrid(
                x, s[0], tiles[0], trow[0], tcol[0], rr[0], rc[0], rv[0],
                sg.n_local, sg.n_buf,
            )

        extra_specs = ()
        extra_args = ()

    specs = (
        P(AXIS, None),
        P(AXIS, None, None, None), P(AXIS, None), P(AXIS, None),
        P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
    ) + extra_specs
    fn = jax.jit(jax.shard_map(
        agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
        check_vma=False,
    ))
    args = (x, sg.tiles, sg.trow, sg.tcol, sg.res_row, sg.res_col,
            sg.res_val, sg.send_idx) + extra_args
    out = np.asarray(fn(*args))
    np.testing.assert_allclose(out, expected, rtol=tol, atol=tol)

    # gradient: d sum(Âx)/dx = Âᵀ1 = Â1, in the permuted labeling
    adj = np.zeros((sg.n_nodes_pad, sg.n_nodes_pad), np.float32)
    adj[csr.row_ids(), csr.indices] = csr.values
    expected_grad = adj.T @ np.ones_like(x)
    if perm is not None:
        expected_grad = expected_grad[perm]
    grad = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax.shard_map(
            agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
            check_vma=False,
        )(x, *args[1:]))
    ))(jnp.asarray(x)))
    np.testing.assert_allclose(grad, expected_grad, rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("tile_c,dtype,tol", [
    (128, np.float32, 2e-5),
    (256, np.float32, 2e-5),   # rectangular blocks: separate push slab shapes
    (128, "int8", 2e-5),       # pattern slabs: d-scaled push partials
])
def test_hybrid_adaptive_matches_single_device(tile_c, dtype, tol):
    """VERDICT round-2 item 3: the fast tile backend composed with the best
    memory-scaling halo. On a hub-heavy layout the per-pair push/pull split
    must (a) actually choose push pairs, (b) keep the compact buffer below
    the gathered matrix, and (c) reproduce the single-device aggregation —
    forward AND gradient (the self-adjoint collective shortcut must hold
    however the edges were routed)."""
    from parallel_gcn.parallel.partition import partition_graph_hybrid
    from parallel_gcn.parallel.train_parallel import (
        graphsum_dist_hybrid_adaptive,
        graphsum_dist_hybrid_adaptive_scaled,
    )

    n_dev = 4
    csr = _hub_csr(n=1040, n_hubs=3)
    sg = partition_graph_hybrid(
        csr, n_dev, tile_r=128, tile_c=tile_c,
        tile_dtype=np.dtype(dtype), min_tile_nnz=8, adaptive=True,
    )
    assert sg.push_slab > 0 and sg.ptiles is not None
    assert sg.send_idx is not None
    assert sg.n_buf < sg.n_nodes_pad  # the halo actually scales memory
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sg.n_nodes_pad, 16)).astype(np.float32)

    g1 = build_graph(csr, n_nodes_pad=sg.n_nodes_pad)
    from parallel_gcn.ops.graphsum import graphsum

    expected = np.asarray(graphsum(jnp.asarray(x), g1, backend="segment"))
    perm = sg.node_perm
    if perm is not None:
        x = x[perm]
        expected = expected[perm]

    push_arrays = (sg.ptiles, sg.ptrow, sg.ptcol, sg.pt_dst,
                   sg.prow, sg.pcol, sg.pval, sg.push_recv)
    push_specs = (P(AXIS, None, None, None),) + (P(AXIS, None),) * 7

    if sg.sym_scale is not None:
        def agg(x, tiles, trow, tcol, rr, rc, rv, s, d, *push):
            return graphsum_dist_hybrid_adaptive_scaled(
                x, d[0], s[0], tiles[0], trow[0], tcol[0], rr[0], rc[0],
                rv[0], *(p[0] for p in push), sg.n_local, sg.n_buf,
            )

        extra_specs = (P(AXIS, None),)
        extra_args = (sg.sym_scale,)
    else:
        def agg(x, tiles, trow, tcol, rr, rc, rv, s, *push):
            return graphsum_dist_hybrid_adaptive(
                x, s[0], tiles[0], trow[0], tcol[0], rr[0], rc[0], rv[0],
                *(p[0] for p in push), sg.n_local, sg.n_buf,
            )

        extra_specs = ()
        extra_args = ()

    specs = (
        P(AXIS, None),
        P(AXIS, None, None, None), P(AXIS, None), P(AXIS, None),
        P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
    ) + extra_specs + push_specs
    fn = jax.jit(jax.shard_map(
        agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
        check_vma=False,
    ))
    args = (x, sg.tiles, sg.trow, sg.tcol, sg.res_row, sg.res_col,
            sg.res_val, sg.send_idx) + extra_args + push_arrays
    out = np.asarray(fn(*args))
    np.testing.assert_allclose(out, expected, rtol=tol, atol=tol)

    # gradient: d sum(Âx)/dx = Âᵀ1 = Â1, in the permuted labeling
    adj = np.zeros((sg.n_nodes_pad, sg.n_nodes_pad), np.float32)
    adj[csr.row_ids(), csr.indices] = csr.values
    expected_grad = adj.T @ np.ones_like(x)
    if perm is not None:
        expected_grad = expected_grad[perm]
    grad = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax.shard_map(
            agg, mesh=mesh, in_specs=specs, out_specs=P(AXIS, None),
            check_vma=False,
        )(x, *args[1:]))
    ))(jnp.asarray(x)))
    np.testing.assert_allclose(grad, expected_grad, rtol=tol,
                               atol=tol * 10)


def test_fit_parallel_hybrid_adaptive_matches_single_chip():
    """End-to-end: backend=hybrid halo=adaptive trains with single-chip
    metric parity on the hub fixture (VERDICT round-2 item 3's Done bar) —
    the fused scan program, int8 pattern slabs, push pairs active."""
    from parallel_gcn.data.parser import Dataset, to_device
    from parallel_gcn.parallel.train_parallel import fit_parallel
    from parallel_gcn.train import fit

    csr = _hub_csr(n=1040, n_hubs=3)
    rng = np.random.default_rng(0)
    n = csr.n_rows
    labels = rng.integers(0, 4, n).astype(np.int32)
    feats = rng.standard_normal((n, 16)).astype(np.float32)
    feats[np.arange(n), labels] += 2.0
    split = rng.choice([1, 2, 3], size=n,
                       p=[0.5, 0.25, 0.25]).astype(np.int32)
    ds = Dataset(
        name="hub", graph=csr, feature_csr=None, features=feats,
        labels=labels, split=split, n_nodes=n, input_dim=16, output_dim=4,
    )
    gcn = GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.0, 0.0),
                    epochs=12, early_stopping=0)
    cfg = Config(
        gcn=gcn,
        exec=ExecConfig(backend="hybrid", seed=7, n_devices=4,
                      halo="adaptive", min_tile_nnz=8, tile_size=128,
                      tile_cols=128, tile_dtype="int8",
                      matmul_precision="highest", halo_fallback=False),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    # the fixture must actually exercise the push path under the exact
    # partition fit_parallel builds (int8, balanced)
    from parallel_gcn.parallel.partition import partition_graph_hybrid

    probe = partition_graph_hybrid(
        csr, 4, tile_r=128, tile_c=128, tile_dtype=np.dtype("int8"),
        min_tile_nnz=8, adaptive=True, balance=True,
    )
    assert probe.push_slab > 0
    res_par = fit_parallel(cfg, ds)

    single_cfg = Config(
        gcn=gcn,
        exec=ExecConfig(backend="segment", seed=7,
                      matmul_precision="highest"),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    res_one = fit(single_cfg, to_device(ds))

    assert res_par.epochs_run == res_one.epochs_run
    np.testing.assert_allclose(
        res_par.history[:, [0, 2]], res_one.history[:, [0, 2]],
        rtol=2e-3, atol=2e-3,
    )
    np.testing.assert_allclose(
        res_par.history[:, [1, 3]], res_one.history[:, [1, 3]], atol=0.02
    )
    assert abs(res_par.test_acc - res_one.test_acc) < 0.03


def _hub_community_csr():
    """Balance fixture: blocks 0–3 (128 nodes each) form an inter-connected
    hub community (4 live tiles per block-row); blocks 4–7 carry only
    self-loops (1 diagonal tile each). Natural contiguous assignment over 4
    devices gives 8/8/2/2 tiles — LPT block placement flattens it to 5 each."""
    from parallel_gcn.data.graph import add_self_loops_csr

    n = 1024
    lists = []
    for i in range(n):
        if i < 512:
            lists.append(np.array(
                sorted((i + 128 * k) % 512 for k in (1, 2, 3)), np.int32
            ))
        else:
            lists.append(np.empty(0, np.int32))
    return add_self_loops_csr(lists)


def test_balance_flattens_hub_slabs():
    """VERDICT round-1 weak item 3: the hub block must not concentrate tiles
    on one device while everyone pads to its slab size. With balance=True the
    LPT block permutation flattens tiles/device to max/mean ≤ 1.2 and the
    imbalance warning never fires; balance=False on the same fixture warns."""
    import warnings

    from parallel_gcn.parallel.partition import partition_graph_hybrid

    csr = _hub_community_csr()
    n_dev = 4

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any imbalance warning -> failure
        sg = partition_graph_hybrid(
            csr, n_dev, tile_r=128, tile_c=128, min_tile_nnz=8, balance=True,
        )
    assert sg.node_perm is not None
    live = sg.tiles.reshape(n_dev, sg.tiles.shape[1], -1).any(-1).sum(-1)
    assert live.max() <= 1.2 * live.mean(), live
    # the permutation is a bijection over the padded nodes, applied in whole
    # tile_c blocks (tile contents move intact)
    perm = np.asarray(sg.node_perm)
    assert sorted(perm) == list(range(sg.n_nodes_pad))
    assert (perm.reshape(-1, 128) // 128 == perm.reshape(-1, 128)[:, :1] // 128).all()

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sg0 = partition_graph_hybrid(
            csr, n_dev, tile_r=128, tile_c=128, min_tile_nnz=8, balance=False,
        )
    assert sg0.node_perm is None
    assert any("imbalance" in str(w.message) for w in rec)
    live0 = sg0.tiles.reshape(n_dev, sg0.tiles.shape[1], -1).any(-1).sum(-1)
    assert live0.max() > 1.5 * live0.mean()


@pytest.mark.parametrize("backend,halo,es,tile_dtype,preagg", [
    ("segment", "all_gather", 0, "auto", False),
    ("segment", "boundary", 8, "auto", False),   # while_loop early stopping
    ("segment", "adaptive", 0, "auto", False),   # push/pull exchange
    ("hybrid", "boundary", 0, "auto", False),    # fused deferred eval
    ("hybrid", "boundary", 0, "int8", True),     # + input preagg hoist
])
def test_fit_parallel_scan_matches_single_chip(backend, halo, es, tile_dtype,
                                               preagg):
    """VERDICT round-1 weak item 2: the fused multi-chip whole-run program
    (make_parallel_run — lax.scan/while_loop inside ONE shard_map, on-device
    early stopping, deferred-eval stacking, preagg) must reproduce the
    single-chip scan run's metric trajectory epoch for epoch."""
    from parallel_gcn.data.parser import to_device
    from parallel_gcn.parallel.train_parallel import fit_parallel
    from parallel_gcn.train import fit

    ds = _dataset()
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.0, 0.0),
                      epochs=12, early_stopping=es),
        exec=ExecConfig(backend=backend, seed=7, n_devices=4, halo=halo,
                      min_tile_nnz=4, matmul_precision="highest",
                      tile_dtype=tile_dtype, input_preagg=preagg,
                      halo_fallback=False),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    res_par = fit_parallel(cfg, ds)

    single_cfg = Config(
        gcn=cfg.gcn,
        exec=ExecConfig(backend="segment", seed=7,
                      matmul_precision="highest", input_preagg=preagg),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    dds = to_device(ds)
    res_one = fit(single_cfg, dds)

    assert res_par.epochs_run == res_one.epochs_run
    np.testing.assert_allclose(
        res_par.history[:, [0, 2]], res_one.history[:, [0, 2]],
        rtol=2e-3, atol=2e-3,
    )
    np.testing.assert_allclose(
        res_par.history[:, [1, 3]], res_one.history[:, [1, 3]], atol=0.02
    )
    assert abs(res_par.test_acc - res_one.test_acc) < 0.03


def test_fit_parallel_scan_checkpoint_and_resume(tmp_path):
    """Multi-chip scan-mode checkpointing: chunked fused runs (checkpoint_every)
    must reproduce the uninterrupted run exactly (the inter-chunk _advance_key
    replays the per-epoch key splits — dropout on to expose drift), and
    resuming from an intermediate chunk must continue the run's tail."""
    import os

    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()

    def cfg(ckpt_dir="", every=0):
        return Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.4, 0.3),
                          epochs=12, early_stopping=0),
            exec=ExecConfig(backend="segment", seed=7, n_devices=4,
                          halo="boundary", halo_fallback=False),
            train=TrainConfig(verbose=False, mode="scan",
                              checkpoint_dir=ckpt_dir,
                              checkpoint_every=every),
        )

    plain = fit_parallel(cfg(), ds)
    ck = str(tmp_path / "ck")
    chunked = fit_parallel(cfg(ck, 5), ds)
    np.testing.assert_allclose(chunked.history, plain.history,
                               rtol=1e-5, atol=1e-6)
    assert sorted(os.listdir(ck)) == [
        "ckpt_000005.npz", "ckpt_000010.npz", "ckpt_final.npz"
    ]

    resumed = fit_parallel(
        cfg(), ds, resume_from=os.path.join(ck, "ckpt_000005.npz")
    )
    assert resumed.epochs_run == 7
    np.testing.assert_allclose(resumed.history, plain.history[5:],
                               rtol=1e-5, atol=1e-6)
    assert resumed.test_acc == pytest.approx(plain.test_acc, abs=1e-6)


@pytest.mark.parametrize("halo", ["all_gather", "boundary", "adaptive", "ring"])
def test_fit_parallel_end_to_end(halo):
    """The complete multi-chip driver: trains, evaluates test, early-stops."""
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.0, 0.0),
                      epochs=40, early_stopping=8),
        exec=ExecConfig(backend="segment", seed=7, n_devices=8, halo=halo,
                      halo_fallback=False),
        train=TrainConfig(verbose=False),
    )
    res = fit_parallel(cfg, ds)
    assert res.history[-1, 0] < res.history[0, 0]  # train loss decreased
    assert res.test_acc > 0.5  # separable synthetic problem
    assert 1 <= res.epochs_run <= 40
    assert np.isfinite(res.history).all()


@pytest.mark.parametrize("halo", ["all_gather", "ring"])
def test_parallel_training_learns_and_matches_metrics(halo):
    """8-way node-parallel training must produce the same metrics trajectory as
    single-device training (identical weights, no dropout)."""
    ds = _dataset()
    n_dev = 8
    part = partition_graph_ring if halo == "ring" else partition_graph
    sg = part(ds.graph, n_dev)
    mesh = make_mesh(n_dev)
    x, labels, split = shard_dataset(ds, sg)
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.0, 0.0),
                      epochs=10, early_stopping=0),
        adam=AdamConfig(),
        exec=ExecConfig(backend="segment", seed=5),
        train=TrainConfig(verbose=False),
    )
    step = make_parallel_epoch_step(cfg, mesh, sg, {1: int((ds.split == 1).sum()),
                                                    2: int((ds.split == 2).sum()),
                                                    3: int((ds.split == 3).sum())})
    inputs = device_put_sharded_inputs(mesh, sg, x, labels, split)

    key = jax.random.PRNGKey(0)
    w = init_params(jax.random.PRNGKey(42), ds.input_dim, (16,), ds.output_dim)
    w_single = [jnp.array(v) for v in w]
    opt = init_adam(w)

    par_metrics = []
    for _ in range(10):
        w, opt, key, m = step(w, opt, key, *inputs)
        par_metrics.append(np.asarray(m))
    par_metrics = np.stack(par_metrics)

    # single-device run with identical init (same graph padded to same size)
    g1 = build_graph(ds.graph, n_nodes_pad=sg.n_nodes_pad)
    xp = np.zeros((sg.n_nodes_pad, ds.input_dim), np.float32)
    xp[: ds.n_nodes] = ds.features
    lp = np.full(sg.n_nodes_pad, -1, np.int32)
    lp[: ds.n_nodes] = ds.labels
    sp = np.zeros(sg.n_nodes_pad, np.int32)
    sp[: ds.n_nodes] = ds.split
    dds = DeviceDataset(
        graph=g1, x=jnp.asarray(xp), labels=jnp.asarray(lp), split=jnp.asarray(sp),
        n_real_nodes=ds.n_nodes, input_dim=ds.input_dim, output_dim=ds.output_dim,
        split_counts={s: int((ds.split == s).sum()) for s in (1, 2, 3)},
    )
    model = build_model(cfg, dds)
    sstep = make_epoch_step(model, cfg, dds)
    opt1 = init_adam(w_single)
    key1 = jax.random.PRNGKey(0)
    single_metrics = []
    for _ in range(10):
        w_single, opt1, key1, m = sstep(w_single, opt1, key1)
        single_metrics.append(np.asarray(m))
    single_metrics = np.stack(single_metrics)

    # losses track tightly; accuracies may flip a borderline sample
    np.testing.assert_allclose(
        par_metrics[:, [0, 2]], single_metrics[:, [0, 2]], rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        par_metrics[:, [1, 3]], single_metrics[:, [1, 3]], atol=0.02
    )
    assert par_metrics[-1, 0] < par_metrics[0, 0]  # learning


def test_parallel_residual_matches_single_chip():
    """The multi-chip forward honors gcn.residual: a 3-layer residual model's
    metric trajectory matches single-device training (no dropout, same init)."""
    ds = _dataset()
    n_dev = 4
    sg = partition_graph(ds.graph, n_dev)
    mesh = make_mesh(n_dev)
    x, labels, split = shard_dataset(ds, sg)
    cfg = Config(
        gcn=GCNConfig(n_layers=3, hidden_dims=(16, 16), dropouts=(0.0,) * 3,
                      epochs=8, early_stopping=0, residual=True),
        adam=AdamConfig(),
        exec=ExecConfig(backend="segment", seed=5),
        train=TrainConfig(verbose=False),
    )
    counts = {s: int((ds.split == s).sum()) for s in (1, 2, 3)}
    step = make_parallel_epoch_step(cfg, mesh, sg, counts)
    inputs = device_put_sharded_inputs(mesh, sg, x, labels, split)

    key = jax.random.PRNGKey(0)
    w = init_params(jax.random.PRNGKey(42), ds.input_dim, (16, 16), ds.output_dim)
    w_single = [jnp.array(v) for v in w]
    opt = init_adam(w)
    par = []
    for _ in range(8):
        w, opt, key, m = step(w, opt, key, *inputs)
        par.append(np.asarray(m))
    par = np.stack(par)

    g1 = build_graph(ds.graph, n_nodes_pad=sg.n_nodes_pad)
    xp = np.zeros((sg.n_nodes_pad, ds.input_dim), np.float32)
    xp[: ds.n_nodes] = ds.features
    lp = np.full(sg.n_nodes_pad, -1, np.int32)
    lp[: ds.n_nodes] = ds.labels
    sp = np.zeros(sg.n_nodes_pad, np.int32)
    sp[: ds.n_nodes] = ds.split
    dds = DeviceDataset(
        graph=g1, x=jnp.asarray(xp), labels=jnp.asarray(lp), split=jnp.asarray(sp),
        n_real_nodes=ds.n_nodes, input_dim=ds.input_dim, output_dim=ds.output_dim,
        split_counts=counts,
    )
    sstep = make_epoch_step(build_model(cfg, dds), cfg, dds)
    opt1 = init_adam(w_single)
    key1 = jax.random.PRNGKey(0)
    single = []
    for _ in range(8):
        w_single, opt1, key1, m = sstep(w_single, opt1, key1)
        single.append(np.asarray(m))
    single = np.stack(single)
    np.testing.assert_allclose(par[:, [0, 2]], single[:, [0, 2]], rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# tensor parallelism (SURVEY.md §2.4 TP row, VERDICT round-1 missing item 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "backend,halo,es,n_layers,residual,n_dev,tp,mode",
    [
        ("segment", "all_gather", 0, 2, False, 4, 2, "scan"),
        ("segment", "all_gather", 5, 3, True, 2, 4, "scan"),
        ("hybrid", "boundary", 0, 2, False, 4, 2, "scan"),
        ("segment", "boundary", 0, 2, False, 4, 2, "eager"),
        # adaptive push/pull halo composed with feat sharding (the hub
        # fixture guarantees push-mode pairs actually exist)
        ("segment", "adaptive", 0, 2, False, 4, 2, "scan"),
    ],
)
def test_fit_parallel_tp_matches_single_chip(backend, halo, es, n_layers,
                                             residual, n_dev, tp, mode):
    """Tensor parallelism (cfg.exec.tp > 1, Megatron-style col/row weight
    sharding over the 'feat' mesh axis) composed with the node partition must
    reproduce the single-chip metric trajectory on an n_dev×tp mesh. Covers
    the alternating schedule (even L), the odd-L slice/reduce_scatter path
    with residual, and composition with the hybrid tiles + boundary halo."""
    from parallel_gcn.data.parser import to_device
    from parallel_gcn.parallel.train_parallel import fit_parallel
    from parallel_gcn.train import fit

    if halo == "adaptive":
        csr = _hub_csr()
        rng = np.random.default_rng(0)
        n = csr.n_rows
        labels = rng.integers(0, 4, n).astype(np.int32)
        feats = rng.standard_normal((n, 16)).astype(np.float32)
        feats[np.arange(n), labels] += 2.0
        split = rng.choice([1, 2, 3], size=n,
                           p=[0.5, 0.25, 0.25]).astype(np.int32)
        ds = Dataset(
            name="hub", graph=csr, feature_csr=None, features=feats,
            labels=labels, split=split, n_nodes=n, input_dim=16,
            output_dim=4,
        )
    else:
        ds = _dataset()
    gcn = GCNConfig(
        n_layers=n_layers, hidden_dims=(16,) * (n_layers - 1),
        dropouts=(0.0,) * n_layers, epochs=10, early_stopping=es,
        residual=residual,
    )
    cfg = Config(
        gcn=gcn,
        exec=ExecConfig(backend=backend, seed=7, n_devices=n_dev, tp=tp,
                      halo=halo, min_tile_nnz=4,
                      matmul_precision="highest", halo_fallback=False),
        train=TrainConfig(verbose=False, mode=mode),
    )
    res_par = fit_parallel(cfg, ds)

    single_cfg = Config(
        gcn=gcn,
        exec=ExecConfig(backend="segment", seed=7,
                      matmul_precision="highest"),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    res_one = fit(single_cfg, to_device(ds))

    assert res_par.epochs_run == res_one.epochs_run
    np.testing.assert_allclose(
        res_par.history[:, [0, 2]], res_one.history[:, [0, 2]],
        rtol=2e-3, atol=2e-3,
    )
    np.testing.assert_allclose(
        res_par.history[:, [1, 3]], res_one.history[:, [1, 3]], atol=0.02
    )
    assert abs(res_par.test_acc - res_one.test_acc) < 0.03


def test_tp_weights_are_feature_sharded():
    """The point of TP is memory scaling: each device must hold only a
    1/tp-wide shard of every weight (col layers shard the output dim, row
    layers the input dim)."""
    from parallel_gcn.parallel.train_parallel import (
        _tp_schedule,
        make_mesh,
        shard_weights,
    )

    mesh = make_mesh(2, tp=4)
    w = init_params(jax.random.PRNGKey(0), 12, (16, 16, 16), 4)
    sharded = shard_weights(w, mesh, 4)
    sched = _tp_schedule(4)
    assert sched == ["col", "row", "col", "row"]
    for full, s, kind in zip(w, sharded, sched):
        local = s.addressable_shards[0].data.shape
        if kind == "col":
            assert local == (full.shape[0], full.shape[1] // 4)
        else:
            assert local == (full.shape[0] // 4, full.shape[1])


def test_tp_validates_indivisible_dims():
    from parallel_gcn.parallel.train_parallel import validate_tp_dims

    with pytest.raises(ValueError, match="divisible by tp"):
        validate_tp_dims(12, (17,), 4, tp=4)  # hidden 17 % 4 != 0
    validate_tp_dims(12, (16,), 4, tp=4)  # fine


def test_fit_parallel_tp_learns_with_dropout():
    """Dropout under TP: feat-replicated inputs mask identically across the
    feat axis, feat-sharded inputs mask independently — training must still
    learn the separable synthetic problem."""
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.3, 0.3),
                      epochs=40, early_stopping=0),
        exec=ExecConfig(backend="segment", seed=7, n_devices=2, tp=4),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    res = fit_parallel(cfg, ds)
    assert res.history[-1, 0] < res.history[0, 0]
    assert res.test_acc > 0.5
    assert np.isfinite(res.history).all()


@pytest.mark.parametrize("n_layers,mode", [(2, "scan"), (3, "eager")])
def test_fit_parallel_tp_remat_matches_plain(n_layers, mode):
    """remat × tp (VERDICT round-2 item 6): per-layer jax.checkpoint with the
    save-the-tp-collectives policy must reproduce the plain TP trajectory
    exactly — the recompute regenerates dropout masks from the same keys and
    the tagged psum/psum_scatter outputs are saved, so no value changes.
    Covers the even-L alternating schedule and the odd-L replicated-slice
    path (where the inter-layer all_gather feeds a col layer)."""
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()

    def run(remat):
        cfg = Config(
            gcn=GCNConfig(n_layers=n_layers, hidden_dims=(16,) * (n_layers - 1),
                          dropouts=(0.3,) * n_layers, epochs=8,
                          early_stopping=0, remat=remat),
            exec=ExecConfig(backend="segment", seed=7, n_devices=4, tp=2,
                          matmul_precision="highest"),
            train=TrainConfig(verbose=False, mode=mode),
        )
        return fit_parallel(cfg, ds)

    res_plain = run(False)
    res_remat = run(True)
    np.testing.assert_allclose(res_remat.history, res_plain.history,
                               rtol=1e-5, atol=1e-6)
    assert res_remat.test_acc == pytest.approx(res_plain.test_acc, abs=1e-6)


# ---------------------------------------------------------------------------
# compiled collective structure (VERDICT round-1 weak item 6 / next item 7):
# pin the collective count/type per halo mode so a halo regression (e.g. an
# accidental full gather sneaking back into the boundary path) is caught
# without multi-chip hardware.
# ---------------------------------------------------------------------------


def _collective_counts(halo, tp=1, backend="segment", model="gcn"):
    import re
    from parallel_gcn.parallel.partition import partition_graph_hybrid
    from parallel_gcn.parallel.train_parallel import shard_weights

    return _collective_counts_inner(
        re, partition_graph_hybrid, shard_weights, halo, tp, backend,
        model,
    )


def _collective_counts_inner(re, partition_graph_hybrid, shard_weights, halo,
                             tp, backend, model="gcn"):
    # hybrid needs >= 2 tile-row blocks per device (8 dev × 128-row tiles)
    # or slab balancing has no freedom and the imbalance warning fires
    ds = _dataset(n=2048) if backend == "hybrid" else _dataset()
    if halo == "adaptive":
        # the uniform random graph can classify every pair as pull (pulling
        # nothing through the push path) — the hub fixture guarantees both
        # directions appear, which is the structure this count pins
        csr = _hub_csr()
        rng = np.random.default_rng(0)
        n, c = csr.n_rows, 3
        labels = rng.integers(0, c, n).astype(np.int32)
        feats = rng.standard_normal((n, 12)).astype(np.float32)
        split = rng.choice([1, 2, 3], size=n, p=[0.5, 0.25, 0.25]).astype(np.int32)
        ds = Dataset(
            name="hub", graph=csr, feature_csr=None, features=feats,
            labels=labels, split=split, n_nodes=n, input_dim=12, output_dim=c,
        )
    counts_split = {s: int((ds.split == s).sum()) for s in (1, 2, 3)}
    nd = 4 if tp > 1 else 8
    mesh = make_mesh(nd, tp=tp)
    if backend == "hybrid":
        sg = partition_graph_hybrid(
            ds.graph, nd, min_tile_nnz=4, boundary=halo == "boundary",
            balance=True,
        )
    elif halo == "ring":
        sg = partition_graph_ring(ds.graph, nd)
    else:
        sg = partition_graph(ds.graph, nd, boundary=halo == "boundary",
                             adaptive=halo == "adaptive")
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.0, 0.0),
                      epochs=1, early_stopping=0, model=model,
                      heads=2 if model == "gat" else 8),
        exec=ExecConfig(backend=backend, n_devices=nd, tp=tp, halo=halo,
                      min_tile_nnz=4),
        train=TrainConfig(verbose=False),
    )
    x, l, s = shard_dataset(ds, sg)
    inputs = device_put_sharded_inputs(mesh, sg, x, l, s)
    step = make_parallel_epoch_step(cfg, mesh, sg, counts_split)
    if model == "gat":
        from parallel_gcn.models.gat import init_gat_params

        w = init_gat_params(jax.random.PRNGKey(0), ds.input_dim, (16,),
                            ds.output_dim, 2)
    else:
        w = init_params(jax.random.PRNGKey(0), ds.input_dim, (16,),
                        ds.output_dim)
    if tp > 1:
        w = shard_weights(w, mesh, tp)
    opt = init_adam(w)
    hlo = step.lower(w, opt, jax.random.PRNGKey(1), *inputs).compile().as_text()
    return {
        op: len(re.findall(rf"{op}(?:-start)?\(", hlo))
        for op in ("all-gather", "reduce-scatter", "all-reduce",
                   "collective-permute", "all-to-all")
    }


@pytest.mark.skipif(jax.default_backend() != "cpu", reason="CPU-mesh test")
@pytest.mark.parametrize(
    "halo,tp,backend,expect",
    [
        # 2-layer epoch step = 2 train-fwd aggs + 2 bwd transposes +
        # 2 val-fwd aggs; grad/loss psums become combined all-reduces.
        # all_gather halo: one AG per fwd agg, the bwd transpose of AG is a
        # reduce-scatter.
        ("all_gather", 1, "segment",
         {"all-gather": 4, "reduce-scatter": 2, "collective-permute": 0,
          "all-to-all": 0}),
        # boundary halo: NO full gather anywhere (the memory-scaling
        # invariant) — each agg is one all-to-all; its transpose is another.
        ("boundary", 1, "segment",
         {"all-gather": 0, "reduce-scatter": 0, "collective-permute": 0,
          "all-to-all": 6}),
        ("boundary", 1, "hybrid",
         {"all-gather": 0, "reduce-scatter": 0, "collective-permute": 0,
          "all-to-all": 6}),
        # ring halo: one collective-permute inside each agg's rotation loop
        # (6 agg sites), and never a full gather.
        ("ring", 1, "segment",
         {"all-gather": 0, "reduce-scatter": 0, "collective-permute": 6,
          "all-to-all": 0}),
        # adaptive halo: each agg site = pull all_to_all + push all_to_all
        # (and their transposes are all_to_alls too) — still no full gather.
        ("adaptive", 1, "segment",
         {"all-gather": 0, "reduce-scatter": 0, "collective-permute": 0,
          "all-to-all": 12}),
        # TP on a 4x2 mesh: node-axis structure unchanged; the feat-axis
        # last-layer psums + sharded-W0 L2 psums add all-reduces only.
        ("all_gather", 2, "segment",
         {"all-gather": 4, "reduce-scatter": 2, "collective-permute": 0,
          "all-to-all": 0}),
    ],
)
def test_epoch_step_collective_structure(halo, tp, backend, expect):
    got = _collective_counts(halo, tp=tp, backend=backend)
    for op, n in expect.items():
        assert got[op] == n, f"{halo}/tp={tp}/{backend}: {op}={got[op]} != {n} ({got})"
    # grad psum + loss/acc psums must exist; exact count depends on XLA's
    # all-reduce combiner, so only pin a sane band
    assert 1 <= got["all-reduce"] <= 8, got


@pytest.mark.skipif(jax.default_backend() != "cpu", reason="CPU-mesh test")
@pytest.mark.parametrize(
    "halo,expect",
    [
        # mesh GAT over the flat COO partition: ONE buffer exchange per
        # layer carrying the concatenated [W·h | t] (fwd), its autodiff
        # transpose in the bwd, eval fwd again — and with the boundary halo
        # NEVER a full gather (the memory-scaling invariant extends to the
        # attention path).
        ("boundary",
         {"all-gather": 0, "reduce-scatter": 0, "collective-permute": 0,
          "all-to-all": 6}),
        ("all_gather",
         {"all-gather": 4, "reduce-scatter": 2, "collective-permute": 0,
          "all-to-all": 0}),
    ],
)
def test_gat_epoch_step_collective_structure(halo, expect):
    got = _collective_counts(halo, backend="segment", model="gat")
    for op, n in expect.items():
        assert got[op] == n, f"gat/{halo}: {op}={got[op]} != {n} ({got})"
    assert 1 <= got["all-reduce"] <= 8, got
