"""Synthetic dataset generator (data/synthetic.py) — structure invariants."""

import numpy as np

from parallel_gcn.data.graph import normalized_adjacency_values
from parallel_gcn.data.synthetic import (
    make_synthetic_dataset,
    synthetic_csr,
)


def test_synthetic_csr_structure():
    n, e = 500, 4000
    csr = synthetic_csr(n, e, seed=7)
    # self-loop is the first neighbor of every row (reference src/parser.cpp:29-31)
    first = csr.indices[csr.indptr[:-1]]
    np.testing.assert_array_equal(first, np.arange(n))
    # undirected: every (r,c) has (c,r)
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    keys = set((rows * n + cols).tolist())
    assert all((c * n + r) in keys for r, c in zip(rows[:500], cols[:500]))
    # edge count close to requested (±2% after dedupe), excluding self-loops
    real = csr.nnz - n
    assert abs(real - e) / e < 0.02, (real, e)
    # normalization matches the shared helper exactly
    np.testing.assert_allclose(
        csr.values, normalized_adjacency_values(csr.indptr, csr.indices)
    )


def test_synthetic_dataset_splits_and_features():
    ds = make_synthetic_dataset(
        "tiny", n_nodes=400, n_edges=3000, input_dim=32, n_classes=5,
        n_train=200, n_val=80, feature_nnz_per_row=8,
    )
    assert ds.train_dim == 200 and ds.val_dim == 80 and ds.test_dim == 120
    assert ds.features.shape == (400, 32)
    assert (np.count_nonzero(ds.features, axis=1) <= 8).all()
    # sparse CSR and dense features agree
    np.testing.assert_allclose(ds.feature_csr.to_dense(), ds.features)
    assert ds.labels.min() >= 0 and ds.labels.max() < 5


def test_synthetic_registered_name_loads():
    from parallel_gcn.data.parser import load_dataset

    ds = load_dataset("synth-medium")
    assert ds.n_nodes == 25_000
    assert ds.input_dim == 300 and ds.output_dim == 16
    assert abs((ds.graph.nnz - ds.n_nodes) - 1_200_000) / 1_200_000 < 0.02


def test_structure_labels_balanced_and_graph_correlated():
    """Labels must (a) spread over all classes roughly evenly (greedy bin
    packing) and (b) correlate with graph structure — same-label edge fraction
    far above the 1/n_classes balanced-random baseline — or aggregation
    carries no class signal (VERDICT round-1 weak item 5)."""
    from parallel_gcn.data.synthetic import structure_labels

    n, n_classes = 4000, 10
    csr = synthetic_csr(n, 40_000, seed=3, n_communities=80)
    rng = np.random.default_rng(0)
    labels = structure_labels(csr, n_classes, rng, label_noise=0.0)

    counts = np.bincount(labels, minlength=n_classes)
    assert counts.min() > 0
    assert counts.max() / counts.mean() < 1.5, counts

    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    off = rows != cols  # self-loops trivially agree
    same = (labels[rows[off]] == labels[cols[off]]).mean()
    assert same > 3.0 / n_classes, same

    # noise flips roughly the requested fraction
    noisy = structure_labels(csr, n_classes, np.random.default_rng(0), label_noise=0.3)
    flipped = (noisy != labels).mean()
    assert 0.15 < flipped < 0.35, flipped


def test_feature_centroid_signal():
    """With feature_signal > 0, per-class mean features separate: a node's
    nearest class centroid (in the empirical per-class means) is its own."""
    from parallel_gcn.data.synthetic import synthetic_features

    n, d, k, c = 3000, 64, 16, 6
    rng = np.random.default_rng(1)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    _, x = synthetic_features(
        n, d, k, rng, labels=labels, n_classes=c, feature_signal=1.0
    )
    means = np.stack([x[labels == ci].mean(axis=0) for ci in range(c)])
    # cosine similarity of each node's features to each class mean
    sim = (x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)) @ (
        means / (np.linalg.norm(means, axis=1, keepdims=True) + 1e-9)
    ).T
    top1 = (sim.argmax(axis=1) == labels).mean()
    assert top1 > 0.5, top1  # 1/6 by chance


def test_synthetic_dataset_is_learnable():
    """End-to-end learning-health check: a 2-layer GCN on a small synthetic
    dataset must clear chance by a wide margin — the property that makes the
    bench's test_acc a regression signal (PERF.md)."""
    from parallel_gcn.config import Config
    from parallel_gcn.data.parser import prepare_device_dataset
    from parallel_gcn.train import fit

    cfg = Config()
    cfg.gcn.n_layers = 2
    cfg.gcn.hidden_dims = (32,)
    cfg.gcn.dropouts = (0.1, 0.1)
    cfg.gcn.epochs = 60
    cfg.gcn.early_stopping = 0
    cfg.train.verbose = False

    import parallel_gcn.data.parser as parser_mod

    ds = make_synthetic_dataset(
        "tiny-learn", n_nodes=3000, n_edges=30_000, input_dim=64, n_classes=8,
        n_train=2000, n_val=400, feature_nnz_per_row=16, n_communities=60,
    )
    dds = parser_mod.to_device(ds)
    res = fit(cfg, dds, verbose=False)
    assert res.test_acc > 0.45, res.test_acc  # chance = 0.125
