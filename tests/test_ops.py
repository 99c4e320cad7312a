"""Op-level allclose tests against the NumPy golden oracle (SURVEY.md §4:
per-op allclose against a CPU mirror is the formalization of the reference's
golden-sequential-model strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gcn.golden import csr_matvec_dense, golden_loss_acc
from parallel_gcn.ops.dropout import dropout
from parallel_gcn.ops.graphsum import graphsum
from parallel_gcn.ops.loss import l2_penalty, masked_softmax_xent
from parallel_gcn.ops.sparse_matmul import (
    feature_transform,
    sparse_feature_transform,
)


@pytest.mark.parametrize("backend", ["dense", "segment"])
def test_graphsum_matches_golden(small_graph, rng, backend):
    csr, graph = small_graph
    x = rng.standard_normal((graph.n_nodes, 32), dtype=np.float32)
    expected = csr_matvec_dense(csr, x[: csr.n_rows])
    out = np.asarray(graphsum(jnp.asarray(x), graph, backend=backend))
    np.testing.assert_allclose(out[: csr.n_rows], expected, rtol=2e-5, atol=2e-5)
    # padded rows receive nothing
    np.testing.assert_allclose(out[csr.n_rows :], 0.0, atol=1e-7)


def test_graphsum_chunked_matches_unchunked(small_graph, rng):
    _, graph = small_graph
    x = jnp.asarray(rng.standard_normal((graph.n_nodes, 16), dtype=np.float32))
    full = graphsum(x, graph, backend="segment")
    chunked = graphsum(x, graph, backend="segment", edge_chunk=128)
    np.testing.assert_allclose(np.asarray(full), np.asarray(chunked), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["dense", "segment"])
def test_graphsum_vjp_is_symmetric_aggregation(small_graph, rng, backend):
    """∂(Âx)/∂x applied to g must equal Âg (symmetric Â shortcut)."""
    csr, graph = small_graph
    x = jnp.asarray(rng.standard_normal((graph.n_nodes, 8), dtype=np.float32))
    g = jnp.asarray(rng.standard_normal((graph.n_nodes, 8), dtype=np.float32))
    _, vjp = jax.vjp(lambda x: graphsum(x, graph, backend=backend), x)
    (dx,) = vjp(g)
    expected = graphsum(g, graph, backend=backend)
    np.testing.assert_allclose(np.asarray(dx), np.asarray(expected), rtol=2e-5, atol=2e-5)


def test_feature_transform_sparse_equals_dense(rng):
    n, f, h = 40, 64, 16
    dense = (rng.random((n, f)) < 0.1).astype(np.float32) * rng.standard_normal(
        (n, f)
    ).astype(np.float32)
    w = rng.standard_normal((f, h)).astype(np.float32)
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]
    out_sparse = sparse_feature_transform(
        jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(cols.astype(np.int32)),
        jnp.asarray(vals),
        jnp.asarray(w),
        n,
    )
    out_dense = feature_transform(jnp.asarray(dense), jnp.asarray(w))
    np.testing.assert_allclose(
        np.asarray(out_sparse), np.asarray(out_dense), rtol=2e-5, atol=2e-5
    )


def test_sparse_feature_transform_weight_grad(rng):
    n, f, h = 20, 30, 8
    dense = (rng.random((n, f)) < 0.2).astype(np.float32)
    w = rng.standard_normal((f, h)).astype(np.float32)
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]

    def loss(w):
        out = sparse_feature_transform(
            jnp.asarray(rows.astype(np.int32)),
            jnp.asarray(cols.astype(np.int32)),
            jnp.asarray(vals),
            w,
            n,
        )
        return jnp.sum(out**2)

    gw = jax.grad(loss)(jnp.asarray(w))
    # golden: d/dW ||XW||² = 2 Xᵀ X W
    expected = 2 * dense.T @ dense @ w
    np.testing.assert_allclose(np.asarray(gw), expected, rtol=1e-4, atol=1e-4)


def test_masked_xent_matches_golden(rng):
    n, c = 64, 7
    logits = rng.standard_normal((n, c)).astype(np.float32) * 3
    labels = rng.integers(0, c, size=n).astype(np.int32)
    mask = rng.random(n) < 0.4
    labels_masked = np.where(mask, labels, -1).astype(np.int32)
    num = int(mask.sum())
    w0 = rng.standard_normal((5, 5)).astype(np.float32)
    wd = 5e-4

    loss, acc = masked_softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels_masked), jnp.asarray(mask), num
    )
    loss = float(loss) + wd * float(l2_penalty(jnp.asarray(w0))) / 2

    g_loss, g_acc, _ = golden_loss_acc(logits, labels_masked, mask, w0, wd)
    np.testing.assert_allclose(loss, g_loss, rtol=1e-5)
    np.testing.assert_allclose(float(acc), g_acc, rtol=1e-6)


def test_masked_xent_grad_is_softmax_minus_onehot(rng):
    """Autograd must reproduce the reference's fused gradient
    (prob − onehot)·mask/num_samples (src/module.cu:505-519)."""
    n, c = 32, 5
    logits = rng.standard_normal((n, c)).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    mask = rng.random(n) < 0.5
    num = int(mask.sum())

    def f(lg):
        loss, _ = masked_softmax_xent(lg, jnp.asarray(labels), jnp.asarray(mask), num)
        return loss

    g = np.asarray(jax.grad(f)(jnp.asarray(logits)))
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    prob = e / e.sum(axis=1, keepdims=True)
    onehot = np.eye(c, dtype=np.float32)[labels]
    expected = mask[:, None] * (prob - onehot) / num
    np.testing.assert_allclose(g, expected, rtol=1e-5, atol=1e-6)


def test_dropout_inverted_scaling():
    key = jax.random.PRNGKey(0)
    x = jnp.ones((1000, 64))
    out = dropout(x, 0.4, key, training=True)
    vals = np.unique(np.asarray(out))
    assert len(vals) == 2
    np.testing.assert_allclose(vals, [0.0, 1 / 0.6], rtol=1e-6)
    # expectation preserved within sampling noise
    assert abs(float(out.mean()) - 1.0) < 0.02
    # eval mode is identity (src/module.cu:67-68)
    np.testing.assert_array_equal(np.asarray(dropout(x, 0.4, key, training=False)), 1.0)
    # rate 0 is identity
    np.testing.assert_array_equal(np.asarray(dropout(x, 0.0, key, training=True)), 1.0)


def _int8_adj_graph(n=50, deg=6, seed=0):
    from parallel_gcn.data.graph import build_graph, random_graph

    csr, _ = random_graph(n, avg_degree=deg, seed=seed)
    g8 = build_graph(csr, dense=True, adj_dtype=np.int8)
    gf = build_graph(csr, dense=True)
    return csr, g8, gf


def test_graphsum_dense_int8_matches_f32():
    """adj_dtype=int8 (the tile-pattern trick on the dense path): the 0/1·k
    pattern matmul with out = d ⊙ (A₈ @ (d ⊙ x)) must reproduce the f32
    dense aggregation — an exact factorization, not quantization — in both
    the forward and the (symmetric) VJP."""
    csr, g8, gf = _int8_adj_graph()
    assert g8.adj.dtype == jnp.int8 and g8.adj_scale is not None
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((g8.n_nodes, 24), dtype=np.float32))
    g = jnp.asarray(rng.standard_normal((g8.n_nodes, 24), dtype=np.float32))

    out8 = graphsum(x, g8, backend="dense")
    outf = graphsum(x, gf, backend="dense")
    np.testing.assert_allclose(np.asarray(out8), np.asarray(outf),
                               rtol=2e-5, atol=2e-5)

    _, vjp = jax.vjp(lambda x: graphsum(x, g8, backend="dense"), x)
    (dx,) = vjp(g)
    np.testing.assert_allclose(
        np.asarray(dx), np.asarray(graphsum(g, gf, backend="dense")),
        rtol=2e-5, atol=2e-5,
    )


def test_graphsum_dense_int8_multiplicity():
    """Duplicate (coalesced) edges carry integer multiplicities k>1 in the
    reference data — the int8 pattern must store k, not saturate at 1."""
    from parallel_gcn.data.graph import (
        HostCSR, build_graph, normalized_adjacency_values,
    )

    # 3-node graph, self-loops everywhere, the (0,1)/(1,0) pair coalesced
    # from a duplicate listing: k=2 on that pair
    indptr = np.array([0, 2, 4, 5], np.int64)
    indices = np.array([0, 1, 0, 1, 2], np.int32)
    deg = np.array([3.0, 3.0, 1.0])  # duplicates count toward degree
    vals = []
    rows = np.repeat(np.arange(3), np.diff(indptr))
    for r, c in zip(rows, indices):
        k = 2.0 if (r, c) in ((0, 1), (1, 0)) else 1.0
        vals.append(k / np.sqrt(deg[r] * deg[c]))
    csr = HostCSR(indptr=indptr, indices=indices,
                  values=np.asarray(vals, np.float32), n_rows=3, n_cols=3)
    g8 = build_graph(csr, dense=True, adj_dtype=np.int8, node_pad=8)
    adj8 = np.asarray(g8.adj)
    assert adj8[0, 1] == 2 and adj8[1, 0] == 2 and adj8[0, 0] == 1
    x = jnp.asarray(np.eye(8, 4, dtype=np.float32))
    out = np.asarray(graphsum(x, g8, backend="dense"))
    gf = build_graph(csr, dense=True, node_pad=8)
    np.testing.assert_allclose(out, np.asarray(
        graphsum(x, gf, backend="dense")), rtol=1e-6, atol=1e-6)
