"""Data-layer tests: CSR build, Â normalization, padding, real-dataset stats
(validated against report p.10 Table 2 / SURVEY.md §6)."""

import numpy as np
import pytest

from parallel_gcn.data.graph import (
    add_self_loops_csr,
    build_graph,
    normalized_adjacency_values,
    pad_to_multiple,
    random_graph,
)
from parallel_gcn.data.parser import load_dataset
from tests.conftest import has_dataset, requires_cora


def test_self_loop_first_and_degrees():
    # 3-node path graph: 0-1, 1-2
    csr = add_self_loops_csr([
        np.array([1], dtype=np.int32),
        np.array([0, 2], dtype=np.int32),
        np.array([1], dtype=np.int32),
    ])
    assert csr.indptr.tolist() == [0, 2, 5, 7]
    # self-loop is the first entry of each row (src/parser.cpp:29-31)
    assert csr.indices[0] == 0 and csr.indices[2] == 1 and csr.indices[5] == 2
    # degrees incl self-loop: 2, 3, 2
    deg = np.diff(csr.indptr)
    assert deg.tolist() == [2, 3, 2]
    # Â value for edge (0,1): 1/sqrt(2*3)
    np.testing.assert_allclose(csr.values[1], 1 / np.sqrt(6), rtol=1e-6)
    np.testing.assert_allclose(csr.values[0], 1 / 2, rtol=1e-6)


def test_normalization_symmetric():
    csr, _ = random_graph(64, 8, seed=3)
    dense = csr.to_dense()
    np.testing.assert_allclose(dense, dense.T, atol=1e-7)


def test_row_stochasticity_of_unnormalized():
    # sanity: values recomputed from indptr/indices match stored ones
    csr, _ = random_graph(40, 5, seed=1)
    vals = normalized_adjacency_values(csr.indptr, csr.indices)
    np.testing.assert_allclose(vals, csr.values, rtol=1e-7)


def test_padding_shapes():
    csr, _ = random_graph(50, 6, seed=0)
    g = build_graph(csr, node_pad=8, edge_pad=512, dense=True)
    assert g.n_nodes == pad_to_multiple(50, 8) == 56
    assert g.row.shape[0] % 512 == 0
    # padding entries are zero-valued and in-bounds
    assert g.val[csr.nnz :].max() == 0.0
    assert int(g.row.max()) < g.n_nodes and int(g.col.max()) < g.n_nodes
    # dense adj agrees with CSR expansion
    np.testing.assert_allclose(
        np.asarray(g.adj)[:50, :50], csr.to_dense(), atol=1e-7
    )


@pytest.mark.parametrize(
    "name,nodes,edges,classes,features",
    [
        ("cora", 2708, 5429, 7, 1433),
        ("citeseer", 3327, 4732, 6, 3703),
        ("pubmed", 19717, 44338, 3, 500),
    ],
)
def test_real_dataset_stats(name, nodes, edges, classes, features):
    """Counts from report p.10 Table 2. The .graph files store each undirected
    edge in both rows, plus one self-loop per node."""
    if not has_dataset(name):
        pytest.skip(f"{name} dataset not available")
    ds = load_dataset(name, use_native=False)
    assert ds.n_nodes == nodes
    assert ds.output_dim == classes
    assert ds.input_dim == features
    # nnz = 2*edges + n self-loops; the raw files carry some duplicate and
    # directed entries (cora: 302 duplicates) which the loader COALESCES into
    # single weighted edges (data.graph.coalesce_duplicate_edges), so nnz
    # lands a little under the raw count — allow 3% either way
    expected = 2 * edges + nodes
    assert abs(ds.graph.nnz - expected) <= 0.03 * expected
    assert ds.train_dim > 0 and ds.val_dim > 0 and ds.test_dim > 0
    assert ds.features.shape == (nodes, features)


@requires_cora
def test_binarize_features():
    ds = load_dataset("cora", binarize_features=True, use_native=False)
    vals = ds.feature_csr.values
    assert (vals == 1.0).all()


def test_native_loader_matches_python():
    """The C++ loader (csrc/loader.cpp) must be bit-identical to the Python
    parser on a real dataset."""
    import pytest as _pytest

    if not has_dataset("citeseer"):
        _pytest.skip("citeseer not available")
    try:
        from parallel_gcn.data import native

        result = native.load_dataset_native(
            __import__("parallel_gcn.data.parser", fromlist=["find_data_dir"]).find_data_dir("citeseer"),
            "citeseer",
            False,
        )
    except Exception:
        _pytest.skip("native loader unavailable (no compiler?)")
    graph, feats, labels, split, input_dim, output_dim = result
    ds = load_dataset("citeseer", use_native=False)
    np.testing.assert_array_equal(graph.indptr, ds.graph.indptr)
    np.testing.assert_array_equal(graph.indices, ds.graph.indices)
    np.testing.assert_allclose(graph.values, ds.graph.values, rtol=1e-7)
    np.testing.assert_array_equal(labels, ds.labels)
    np.testing.assert_array_equal(split, ds.split)
    np.testing.assert_array_equal(feats.indices, ds.feature_csr.indices)
    np.testing.assert_allclose(feats.values, ds.feature_csr.values, rtol=1e-6)
    assert (input_dim, output_dim) == (ds.input_dim, ds.output_dim)


def test_native_loader_rejects_overflowing_ids(tmp_path):
    """A corrupt neighbor id > 2^63 must fail the load (status -7), not wrap
    through parse_int's accumulator and slip past the range check."""
    import pytest as _pytest

    try:
        from parallel_gcn.data import native

        native._get_lib()
    except Exception:
        _pytest.skip("native loader unavailable (no compiler?)")
    (tmp_path / "corrupt.graph").write_text("1\n99999999999999999999999\n")
    (tmp_path / "corrupt.svmlight").write_text("0 0:1.0\n1 0:1.0\n")
    (tmp_path / "corrupt.split").write_text("1\n2\n")
    with _pytest.raises(Exception, match="status -7"):
        native.load_dataset_native(str(tmp_path), "corrupt", False)


def test_local_clustering_coefficient():
    """Triangle graph + pendant: verify against hand-computed values
    (reference parser experiment, src/parser.cpp:135-162)."""
    from parallel_gcn.data.graph import (
        add_self_loops_csr,
        local_clustering_coefficient,
    )

    # nodes 0,1,2 form a triangle; node 3 hangs off node 0
    nb = [
        np.array([1, 2, 3], dtype=np.int32),
        np.array([0, 2], dtype=np.int32),
        np.array([0, 1], dtype=np.int32),
        np.array([0], dtype=np.int32),
    ]
    csr = add_self_loops_csr(nb)
    c = local_clustering_coefficient(csr)
    # node 0: neighbors {1,2,3}, links among them = (1,2),(2,1) -> 2/(3*2)
    np.testing.assert_allclose(c, [2 / 6, 1.0, 1.0, 0.0], rtol=1e-6)


def test_native_label_propagation_matches_numpy():
    """csrc/loader.cpp pgcn_community_labels vs the NumPy spec — identical
    labels (including the ties-toward-larger-label rule and isolated rows)."""
    try:
        from parallel_gcn.data.native import community_labels_native
    except Exception:
        pytest.skip("native lib unavailable")
    from parallel_gcn.data.graph import random_graph
    from parallel_gcn.data.reorder import _propagate_labels_numpy

    csr, _ = random_graph(400, 5, seed=9)
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    # drop some edges so a few rows have no surviving edges (keep row-sorted)
    keep = (rows * 131 + cols * 17) % 7 != 0
    rows, cols = rows[keep], cols[keep]
    for iters in (1, 4, 8):
        try:
            native = community_labels_native(rows, cols, 400, iters)
        except RuntimeError:  # _get_lib build/load unavailability only —
            pytest.skip("native lib unavailable")  # real failures must FAIL
        ref = _propagate_labels_numpy(rows, cols, 400, iters)
        np.testing.assert_array_equal(native, ref)


def test_local_clustering_coefficient_matches_reference_semantics():
    """Mirror of the reference's unused graph-analysis experiment
    (src/parser.cpp:135-162) — verified against a literal transcription of
    its triple loop on a small fixture (self-loop quirks included)."""
    from parallel_gcn.data.graph import add_self_loops_csr
    from parallel_gcn.data.parser import local_clustering_coefficient

    rng = np.random.default_rng(3)
    n = 24
    nb = {i: set() for i in range(n)}
    for _ in range(70):
        a, b = rng.integers(0, n, 2)
        if a != b:
            nb[a].add(int(b))
            nb[b].add(int(a))
    csr = add_self_loops_csr(
        [np.array(sorted(nb[i]), dtype=np.int32) for i in range(n)]
    )

    def reference_loops(node):  # src/parser.cpp:135-162, line for line
        start, end = int(csr.indptr[node]), int(csr.indptr[node + 1])
        edges = end - start
        if edges <= 1:
            return 0.0
        triangles = 0
        for i in range(start, end):
            neighbor = int(csr.indices[i])
            for j in range(int(csr.indptr[neighbor]),
                           int(csr.indptr[neighbor + 1])):
                non = int(csr.indices[j])
                if non == node:
                    continue
                for k in range(start, end):
                    if int(csr.indices[k]) == non:
                        triangles += 1
                        break
        return 2.0 * triangles / (edges * (edges - 1))

    for node in range(n):
        assert local_clustering_coefficient(csr, node) == pytest.approx(
            reference_loops(node)
        )


def test_duplicate_edges_coalesce_and_backends_agree():
    """The reference data lists some neighbors twice and its CSR-walking
    aggregation counts each copy (src/parser.cpp:35-44); matrix-shaped
    backends can store a position only once. coalesce_duplicate_edges merges
    copies into single weighted edges AFTER the degree-inclusive value
    computation, so dense/tiles/segment all apply the identical reference
    operator on duplicated inputs."""
    import jax.numpy as jnp

    from parallel_gcn.data.graph import (
        add_self_loops_csr,
        build_graph,
        coalesce_duplicate_edges,
    )
    from parallel_gcn.ops.graphsum import graphsum

    # node 0 lists node 1 twice (like cora's raw lines); symmetric mirror
    lists = [
        np.array([1, 1, 2], dtype=np.int32),
        np.array([0, 0], dtype=np.int32),
        np.array([0], dtype=np.int32),
        np.array([], dtype=np.int32),
    ]
    csr = add_self_loops_csr(lists)
    # degrees count every copy (reference indptr semantics): deg0 = 4
    key = csr.row_ids().astype(np.int64) * csr.n_cols + csr.indices
    assert len(np.unique(key)) == len(key)  # coalesced: no duplicates left
    # the merged (0,1) edge carries k=2 times the unit value
    v01 = csr.values[(csr.row_ids() == 0) & (csr.indices == 1)]
    assert v01 == pytest.approx(2.0 / np.sqrt(4.0 * 3.0))
    assert coalesce_duplicate_edges(csr) is csr  # idempotent fast path

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    g_seg = build_graph(csr, n_nodes_pad=8)
    g_dense = build_graph(csr, dense=True, n_nodes_pad=8)
    a = np.asarray(graphsum(jnp.asarray(x), g_seg, backend="segment"))
    b = np.asarray(graphsum(jnp.asarray(x), g_dense, backend="dense"))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # the double edge genuinely contributes twice: out[0] includes 2·v·x[1]
    vals = {int(c): float(v) for c, v in zip(csr.indices[:3], csr.values[:3])}
    expected0 = sum(vals[c] * x[c] for c in vals)
    np.testing.assert_allclose(a[0], expected0, rtol=1e-5)


def test_duplicate_self_loop_int8_exact():
    """citeseer's raw data lists 3 papers citing themselves, so the implicit
    self-loop coalesces with the listed copy: v_ii = k_ii/deg with k_ii > 1.
    The naive d_i = sqrt(v_ii) recovery cannot factor that — the parser must
    carry the duplicate-inclusive degrees (HostCSR.sym_scale) so int8
    pattern packs stay EXACT (reference degree semantics:
    src/parser.cpp:35-44)."""
    import jax.numpy as jnp

    from parallel_gcn.data.graph import add_self_loops_csr, build_graph
    from parallel_gcn.ops.graphsum import graphsum

    # node 0 lists itself (self-citation) → coalesced self-loop k=2;
    # node 1 lists itself twice → k=3
    lists = [
        np.array([0, 1, 2], dtype=np.int32),
        np.array([1, 1, 0], dtype=np.int32),
        np.array([0], dtype=np.int32),
    ]
    csr = add_self_loops_csr(lists)
    assert csr.sym_scale is not None
    # degrees count every copy: deg = [4, 4, 2]
    np.testing.assert_allclose(csr.sym_scale, 1 / np.sqrt([4.0, 4.0, 2.0]))
    v00 = csr.values[(csr.row_ids() == 0) & (csr.indices == 0)]
    assert v00 == pytest.approx(2.0 / 4.0)

    g8 = build_graph(csr, dense=True, adj_dtype=np.int8, n_nodes_pad=8)
    gf = build_graph(csr, dense=True, n_nodes_pad=8)
    adj8 = np.asarray(g8.adj)
    assert adj8[0, 0] == 2 and adj8[1, 1] == 3 and adj8[2, 2] == 1
    x = np.random.default_rng(3).standard_normal((8, 5)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(graphsum(jnp.asarray(x), g8, backend="dense")),
        np.asarray(graphsum(jnp.asarray(x), gf, backend="dense")),
        rtol=1e-6, atol=1e-6,
    )

    # a hand-built CSR without sym_scale must REFUSE the inexact pack
    # rather than recover a wrong d (unreachable-exactness guard)
    from dataclasses import replace

    with pytest.raises(ValueError):
        build_graph(replace(csr, sym_scale=None), dense=True,
                    adj_dtype=np.int8, n_nodes_pad=8)
    # and an inconsistent sym_scale is caught by verification
    with pytest.raises(ValueError):
        build_graph(replace(csr, sym_scale=csr.sym_scale * 1.1), dense=True,
                    adj_dtype=np.int8, n_nodes_pad=8)


def test_permute_csr_is_exact_similarity():
    """Reordering must be an exact reassociation: P·Â·Pᵀ with values moving
    with their edges. Recomputing values from the coalesced CSR's degrees
    would change the operator on duplicate-carrying graphs (the coalesced
    row length undercounts the reference's duplicate-inclusive degree)."""
    from parallel_gcn.data.graph import add_self_loops_csr
    from parallel_gcn.data.reorder import permute_csr

    lists = [
        np.array([0, 1, 2], dtype=np.int32),  # duplicate self-loop on 0
        np.array([1, 1, 0], dtype=np.int32),  # k_ii=3 on 1
        np.array([0, 3], dtype=np.int32),
        np.array([2], dtype=np.int32),
    ]
    csr = add_self_loops_csr(lists)
    perm = np.array([2, 0, 3, 1])
    out = permute_csr(csr, perm)
    dense = csr.to_dense()
    np.testing.assert_allclose(out.to_dense(), dense[np.ix_(perm, perm)],
                               rtol=0, atol=0)
    np.testing.assert_allclose(out.sym_scale, csr.sym_scale[perm])
