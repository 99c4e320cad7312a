"""Hybrid (dense tiles + COO residual) backend and reordering pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gcn.config import Config, GCNConfig, ExecConfig, TrainConfig
from parallel_gcn.data.graph import build_graph, random_graph, split_dense_tiles
from parallel_gcn.data.parser import Dataset, to_device
from parallel_gcn.data.reorder import community_order, permute_dataset
from parallel_gcn.data.synthetic import synthetic_csr
from parallel_gcn.ops.graphsum import graphsum, resolve_backend
from parallel_gcn.train import fit


def test_split_dense_tiles_symmetric_and_budgeted():
    csr = synthetic_csr(2000, 30000, seed=3, structure="community", n_communities=16)
    n_pad = ((csr.n_rows + 127) // 128) * 128
    rows, cols = csr.row_ids(), csr.indices
    mask = split_dense_tiles(rows, cols, n_pad, min_tile_nnz=8)
    # symmetry: edge (r,c) is in a dense tile iff (c,r) is
    keys = rows.astype(np.int64) * n_pad + cols
    dense_keys = set(keys[mask].tolist())
    for r, c in zip(rows[mask][:2000], cols[mask][:2000]):
        assert int(c) * n_pad + int(r) in dense_keys
    # budget honored
    budget = 64 * 65536  # 64 tiles worth of bytes
    mask_b = split_dense_tiles(rows, cols, n_pad, min_tile_nnz=1,
                               tile_budget_bytes=budget)
    ntc = n_pad // 128
    tid = (rows[mask_b].astype(np.int64) // 128) * ntc + cols[mask_b] // 128
    assert len(np.unique(tid)) <= 64


@pytest.mark.parametrize("min_nnz", [1, 16, 10**9])
def test_hybrid_matches_segment(min_nnz):
    """Any tile/residual split must produce the same aggregation (min_nnz=1:
    everything tiled; 1e9: everything residual)."""
    csr, _ = random_graph(300, 8, seed=4)
    g_seg = build_graph(csr, n_nodes_pad=384)
    g_hyb = build_graph(csr, hybrid=True, min_tile_nnz=min_nnz)
    assert g_hyb.n_nodes == 384
    rng = np.random.default_rng(0)
    x = rng.standard_normal((384, 16)).astype(np.float32)
    a = np.asarray(graphsum(jnp.asarray(x), g_hyb, backend="hybrid"))
    b = np.asarray(graphsum(jnp.asarray(x), g_seg, backend="segment"))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_hybrid_tile256_matches_segment():
    csr, _ = random_graph(300, 8, seed=4)
    g_seg = build_graph(csr, n_nodes_pad=512)
    g_hyb = build_graph(csr, hybrid=True, min_tile_nnz=4, tile_size=256)
    assert g_hyb.n_nodes == 512 and g_hyb.bcsr.tile == 256
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    a = np.asarray(graphsum(jnp.asarray(x), g_hyb, backend="hybrid"))
    b = np.asarray(graphsum(jnp.asarray(x), g_seg, backend="segment"))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tile_cols", [256, 512])
def test_hybrid_rect_tiles_match_segment(tile_cols):
    """Rectangular tiles (wide): forward AND gradient must match segment —
    the gradient check exercises the symmetric edge-split requirement."""
    csr, _ = random_graph(300, 8, seed=4)
    g_hyb = build_graph(csr, hybrid=True, min_tile_nnz=2, tile_size=128,
                        tile_cols=tile_cols)
    n_pad = g_hyb.n_nodes
    g_seg = build_graph(csr, n_nodes_pad=n_pad)
    assert g_hyb.bcsr.tile_r == 128 and g_hyb.bcsr.tile_c == tile_cols
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n_pad, 16)).astype(np.float32))
    a = np.asarray(graphsum(x, g_hyb, backend="hybrid"))
    b = np.asarray(graphsum(x, g_seg, backend="segment"))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)

    cot = jnp.asarray(rng.standard_normal((n_pad, 16)).astype(np.float32))
    ga = np.asarray(jax.grad(
        lambda x: jnp.vdot(graphsum(x, g_hyb, backend="hybrid"), cot))(x))
    gb = np.asarray(jax.grad(
        lambda x: jnp.vdot(graphsum(x, g_seg, backend="segment"), cot))(x))
    np.testing.assert_allclose(ga, gb, rtol=2e-5, atol=2e-5)


def test_hybrid_gradient_matches_segment():
    csr, _ = random_graph(256, 6, seed=9)
    g_seg = build_graph(csr, n_nodes_pad=256)
    g_hyb = build_graph(csr, hybrid=True, min_tile_nnz=4)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((256, 8)).astype(np.float32))
    cot = jnp.asarray(rng.standard_normal((256, 8)).astype(np.float32))

    def loss(g, backend):
        return lambda x: jnp.vdot(graphsum(x, g, backend=backend), cot)

    ga = np.asarray(jax.grad(loss(g_hyb, "hybrid"))(x))
    gb = np.asarray(jax.grad(loss(g_seg, "segment"))(x))
    np.testing.assert_allclose(ga, gb, rtol=2e-5, atol=2e-5)


def test_resolve_backend_protects_hybrid():
    csr, _ = random_graph(400, 6, seed=0)  # 4x4 tile grid, uneven counts
    # median-ish threshold -> some tiles qualify, some edges stay residual
    for thresh in (180, 160, 140, 200, 120):
        g = build_graph(csr, hybrid=True, min_tile_nnz=thresh)
        if g.is_hybrid and (np.asarray(g.val) != 0).any() and g.bcsr.n_tiles_real:
            break
    assert g.is_hybrid and (np.asarray(g.val) != 0).any()
    assert resolve_backend(g, "auto") == "hybrid"
    # explicit bcsr/segment on a hybrid graph is coerced (correctness) but
    # surfaces the config mismatch as a warning
    with pytest.warns(UserWarning, match="hybrid"):
        assert resolve_backend(g, "bcsr") == "hybrid"  # residual must not be dropped
    with pytest.warns(UserWarning, match="hybrid"):
        assert resolve_backend(g, "segment") == "hybrid"  # tiles must not be dropped

    # low threshold -> every edge tiled: the empty residual pass is skipped
    g2 = build_graph(csr, hybrid=True, min_tile_nnz=1)
    assert not g2.is_hybrid and g2.bcsr is not None
    assert not g2.coo_complete  # COO arrays are padding-only
    assert resolve_backend(g2, "auto") == "bcsr"
    assert resolve_backend(g2, "hybrid") == "bcsr"
    # a 'segment' request on the demoted graph must NOT run over the
    # padding-only COO (it would silently return zeros) — explicit requests
    # for structures the graph does not carry are hard errors
    with pytest.raises(ValueError, match="tile pack"):
        resolve_backend(g2, "segment")
    with pytest.raises(ValueError, match="tile pack"):
        resolve_backend(g2, "dense")
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (g2.n_nodes, 8)).astype(np.float32))
    a = np.asarray(graphsum(x, g2))
    g_seg = build_graph(csr, n_nodes_pad=g2.n_nodes)
    b = np.asarray(graphsum(x, g_seg, backend="segment"))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_community_order_is_permutation_and_improves_tiling():
    # sparse enough that a shuffled order leaves most tiles under-filled
    csr = synthetic_csr(20000, 100000, seed=5, structure="community",
                        n_communities=24)
    perm = community_order(csr)
    assert sorted(perm.tolist()) == list(range(20000))
    n_pad = ((csr.n_rows + 127) // 128) * 128
    before = split_dense_tiles(csr.row_ids(), csr.indices, n_pad, 16).mean()
    from parallel_gcn.data.reorder import permute_csr

    csrp = permute_csr(csr, perm)
    after = split_dense_tiles(csrp.row_ids(), csrp.indices, n_pad, 16).mean()
    assert after > before + 0.2, (before, after)


def test_reordered_hybrid_training_matches_plain():
    """reorder=community + backend=hybrid must reproduce plain segment
    training exactly (GCN is permutation-equivariant; weights are node-free;
    dropout off)."""
    csr = synthetic_csr(600, 7000, seed=6, structure="community", n_communities=6)
    rng = np.random.default_rng(2)
    n, f, c = 600, 12, 4
    labels = rng.integers(0, c, n).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    feats[np.arange(n), labels] += 2.0
    split = rng.choice([1, 2, 3], size=n, p=[.5, .25, .25]).astype(np.int32)
    ds = Dataset(name="t", graph=csr, feature_csr=None, features=feats,
                 labels=labels, split=split, n_nodes=n, input_dim=f, output_dim=c)

    def run(ds_run, backend):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                          epochs=8, early_stopping=0),
            exec=ExecConfig(backend=backend, input_preagg=False),
            train=TrainConfig(verbose=False, mode="scan"),
        )
        dds = to_device(ds_run, hybrid=backend == "hybrid")
        return fit(cfg, dds)

    plain = run(ds, "segment")
    reordered = run(permute_dataset(ds, community_order(csr)), "hybrid")
    np.testing.assert_allclose(
        plain.history, reordered.history, rtol=2e-4, atol=2e-4
    )
