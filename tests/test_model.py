"""Model + optimizer + end-to-end training tests against the golden oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gcn.config import AdamConfig, Config, GCNConfig, ExecConfig, TrainConfig
from parallel_gcn.data.graph import build_graph, random_graph
from parallel_gcn.data.parser import DeviceDataset
from parallel_gcn.golden import (
    GoldenAdamState,
    glorot_range,
    golden_adam_step,
    golden_forward,
    golden_grads,
)
from parallel_gcn.models.gcn import GCNModel, glorot, init_params
from parallel_gcn.ops.loss import masked_softmax_xent
from parallel_gcn.optim import adam_step, init_adam
from parallel_gcn.train import fit


def _weights_np(key, dims):
    ws = init_params(key, dims[0], dims[1:-1], dims[-1])
    return ws, [np.asarray(w) for w in ws]


def _synthetic(n=150, f=12, c=3, seed=0):
    """A separable synthetic node-classification problem: labels form graph
    communities (edges are mostly intra-class), features leak the label — so
    both the aggregation and the transform carry signal."""
    from parallel_gcn.data.graph import add_self_loops_csr

    rng = np.random.default_rng(seed)
    labels = (np.arange(n) * c // n).astype(np.int32)  # contiguous communities
    nb = {i: set() for i in range(n)}
    for _ in range(n * 3):
        a = int(rng.integers(0, n))
        # 90% intra-community edges
        pool = np.where(labels == labels[a])[0] if rng.random() < 0.9 else np.arange(n)
        b = int(pool[rng.integers(0, len(pool))])
        if a != b:
            nb[a].add(b)
            nb[b].add(a)
    csr = add_self_loops_csr(
        [np.array(sorted(nb[i]), dtype=np.int32) for i in range(n)]
    )
    x = rng.standard_normal((n, f)).astype(np.float32) * 0.2
    x[np.arange(n), labels] += 2.0  # leak the label into the features
    split = rng.choice([1, 2, 3], size=n, p=[0.5, 0.25, 0.25]).astype(np.int32)
    return csr, x, labels, split


@pytest.mark.parametrize("n_layers", [2, 3, 6])
def test_forward_matches_golden(n_layers, small_graph, rng):
    csr, graph = small_graph
    dims = [12] + [16] * (n_layers - 1) + [4]
    ws, ws_np = _weights_np(jax.random.PRNGKey(0), dims)
    x = rng.standard_normal((graph.n_nodes, dims[0])).astype(np.float32)

    model = GCNModel(n_layers=n_layers, dropouts=(0.0,) * n_layers, backend="segment")
    logits = np.asarray(model.apply(ws, jnp.asarray(x), graph, training=False))
    expected, _ = golden_forward(ws_np, x[: csr.n_rows], csr)
    np.testing.assert_allclose(logits[: csr.n_rows], expected, rtol=5e-5, atol=5e-5)


def test_grads_match_golden(small_graph, rng):
    csr, graph = small_graph
    n = csr.n_rows
    dims = [10, 16, 4]
    ws, ws_np = _weights_np(jax.random.PRNGKey(1), dims)
    x = rng.standard_normal((graph.n_nodes, dims[0])).astype(np.float32)
    x[n:] = 0
    labels = rng.integers(0, 4, size=graph.n_nodes).astype(np.int32)
    mask_np = np.zeros(graph.n_nodes, dtype=bool)
    mask_np[: n // 2] = True
    num = int(mask_np.sum())

    model = GCNModel(n_layers=2, dropouts=(0.0, 0.0), backend="segment")

    def loss_fn(ws):
        logits = model.apply(ws, jnp.asarray(x), graph, training=False)
        loss, _ = masked_softmax_xent(
            logits, jnp.asarray(labels), jnp.asarray(mask_np), num
        )
        return loss

    grads = jax.grad(loss_fn)(ws)
    g_golden, _ = golden_grads(
        ws_np, x[:n], csr, labels[:n], mask_np[:n]
    )
    for g, gg in zip(grads, g_golden):
        np.testing.assert_allclose(np.asarray(g), gg, rtol=1e-4, atol=1e-5)


def test_adam_matches_golden(rng):
    ws_np = [rng.standard_normal((8, 6)).astype(np.float32) for _ in range(2)]
    gs_np = [rng.standard_normal((8, 6)).astype(np.float32) for _ in range(2)]
    ws = [jnp.asarray(w) for w in ws_np]
    state = init_adam(ws)
    gstate = GoldenAdamState(
        m=[np.zeros_like(w) for w in ws_np], v=[np.zeros_like(w) for w in ws_np]
    )
    hp = dict(lr=0.01, wd=5e-4, b1=0.9, b2=0.999, eps=1e-8)
    cur, gcur = ws, ws_np
    for _ in range(3):
        cur, state = adam_step(
            cur, [jnp.asarray(g) for g in gs_np], state,
            learning_rate=hp["lr"], weight_decay=hp["wd"],
            beta1=hp["b1"], beta2=hp["b2"], eps=hp["eps"],
        )
        gcur = golden_adam_step(
            gcur, gs_np, gstate, hp["lr"], hp["wd"], hp["b1"], hp["b2"], hp["eps"],
            decay_flags=[True, False],
        )
    for w, gw in zip(cur, gcur):
        np.testing.assert_allclose(np.asarray(w), gw, rtol=1e-5, atol=1e-6)


def test_glorot_range_and_distribution():
    key = jax.random.PRNGKey(0)
    w = np.asarray(glorot(key, 100, 50))
    r = glorot_range(100, 50)
    assert np.abs(w).max() <= r
    assert np.abs(w).max() > 0.9 * r  # actually fills the range
    assert abs(w.mean()) < 0.01


def _fit_synthetic(mode, backend="segment", epochs=60, n_layers=2,
                   hidden_dims=(16,), dropouts=(0.2, 0.2), **gcn_kw):
    csr, x, labels, split = _synthetic()
    graph = build_graph(csr, dense=(backend == "dense"))
    n_pad = graph.n_nodes
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[: csr.n_rows] = x
    lp = np.full(n_pad, -1, np.int32)
    lp[: csr.n_rows] = labels
    sp = np.zeros(n_pad, np.int32)
    sp[: csr.n_rows] = split
    dds = DeviceDataset(
        graph=graph, x=jnp.asarray(xp), labels=jnp.asarray(lp), split=jnp.asarray(sp),
        n_real_nodes=csr.n_rows, input_dim=x.shape[1], output_dim=3,
        split_counts={s: int((split == s).sum()) for s in (1, 2, 3)},
    )
    cfg = Config(
        gcn=GCNConfig(n_layers=n_layers, hidden_dims=hidden_dims,
                      dropouts=dropouts, epochs=epochs, early_stopping=0,
                      **gcn_kw),
        adam=AdamConfig(),
        exec=ExecConfig(backend=backend, seed=7),
        train=TrainConfig(verbose=False, mode=mode),
    )
    return fit(cfg, dds)


@pytest.mark.parametrize("mode", ["eager", "scan"])
def test_end_to_end_learns(mode):
    result = _fit_synthetic(mode)
    assert result.history[0, 0] > result.history[-1, 0]  # train loss fell
    assert result.test_acc > 0.8  # separable task
    assert result.epochs_run == 60


def test_scan_and_eager_agree():
    r_scan = _fit_synthetic("scan", epochs=20)
    r_eager = _fit_synthetic("eager", epochs=20)
    np.testing.assert_allclose(r_scan.history, r_eager.history, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(r_scan.test_acc, r_eager.test_acc, atol=1e-6)


def test_residual_runs():
    result = _fit_synthetic("scan", epochs=10, n_layers=3,
                            hidden_dims=(16, 16), dropouts=(0.1, 0.1, 0.1),
                            residual=True)
    assert np.isfinite(result.history).all()


def test_residual_forward_matches_golden(small_graph, rng):
    """3-layer residual forward vs the golden oracle (reference
    -DRESIDUAL_CONNECTIONS, src/module.cu:566-593)."""
    csr, graph = small_graph
    dims = [12, 16, 16, 4]
    ws, ws_np = _weights_np(jax.random.PRNGKey(3), dims)
    x = rng.standard_normal((graph.n_nodes, dims[0])).astype(np.float32)

    model = GCNModel(n_layers=3, dropouts=(0.0,) * 3, backend="segment",
                     residual=True)
    logits = np.asarray(model.apply(ws, jnp.asarray(x), graph, training=False))
    expected, _ = golden_forward(ws_np, x[: csr.n_rows], csr, residual=True)
    np.testing.assert_allclose(logits[: csr.n_rows], expected, rtol=5e-5,
                               atol=5e-5)


def test_early_stopping_triggers():
    csr, x, labels, split = _synthetic()
    graph = build_graph(csr)
    n_pad = graph.n_nodes
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[: csr.n_rows] = x
    lp = np.full(n_pad, -1, np.int32)
    lp[: csr.n_rows] = labels
    sp = np.zeros(n_pad, np.int32)
    sp[: csr.n_rows] = split
    dds = DeviceDataset(
        graph=graph, x=jnp.asarray(xp), labels=jnp.asarray(lp), split=jnp.asarray(sp),
        n_real_nodes=csr.n_rows, input_dim=x.shape[1], output_dim=3,
        split_counts={s: int((split == s).sum()) for s in (1, 2, 3)},
    )
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.5, 0.5),
                      epochs=500, early_stopping=5),
        exec=ExecConfig(backend="segment", seed=3),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    result = fit(cfg, dds)
    assert result.epochs_run < 500  # early stopping fired
    # the early-stop rule: last val loss > mean of last k (incl current)
    k = 5
    hist = result.history[:, 2]
    assert hist[-1] > hist[-k:].mean() - 1e-6


def test_input_preagg_is_exact():
    """(Â·X)·W0 == Â·(X·W0): pre-aggregating the input (train.preaggregate_input)
    must reproduce the metric trajectory of the unhoisted model exactly."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)

    def run(preagg):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                          epochs=15, early_stopping=0),
            exec=ExecConfig(backend="segment", input_preagg=preagg),
            train=TrainConfig(verbose=False, mode="scan"),
        )
        return fit(cfg, dds)

    a, b = run(False), run(True)
    np.testing.assert_allclose(a.history, b.history, rtol=1e-4, atol=1e-5)
    assert a.test_acc == pytest.approx(b.test_acc, abs=1e-6)


def test_input_preagg_with_dropout_hoists_eval_only():
    """Nonzero input dropout: the train path must keep per-epoch aggregation
    (model unchanged), but Â·X is stored for the eval forwards (x_agg), and
    the metric trajectory must match the unhoisted run exactly (same dropout
    key sequence; eval has no dropout so the hoist is pure reassociation)."""
    from parallel_gcn.models.gcn import GCNModel
    from parallel_gcn.data.parser import Dataset, to_device
    from parallel_gcn.train import preaggregate_input

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)
    model = GCNModel(n_layers=2, dropouts=(0.5, 0.5), backend="segment")
    model2, dds2 = preaggregate_input(model, dds)
    assert model2.input_preagg is False
    assert dds2.x_agg is not None

    def run(preagg):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.4, 0.3),
                          epochs=12, early_stopping=0),
            exec=ExecConfig(backend="segment", input_preagg=preagg, seed=3),
            train=TrainConfig(verbose=False, mode="scan"),
        )
        return fit(cfg, dds)

    a, b = run(False), run(True)
    np.testing.assert_allclose(a.history, b.history, rtol=1e-4, atol=1e-5)
    assert a.test_acc == pytest.approx(b.test_acc, abs=1e-6)


def test_resume_scan_trains_remaining_epochs(tmp_path):
    """fit(resume_from=...) in scan mode must train epochs - start_epoch more
    epochs (the eager loop already did; the fused program's count is derived)."""
    from parallel_gcn.data.parser import Dataset, to_device
    from parallel_gcn.utils.checkpoint import save_checkpoint
    from parallel_gcn.models.gcn import init_params
    from parallel_gcn.optim import init_adam
    import jax

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)
    w = init_params(jax.random.PRNGKey(0), dds.input_dim, (8,), dds.output_dim)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, w, init_adam(w), epoch=7, key=jax.random.PRNGKey(1))

    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                      epochs=10, early_stopping=0),
        exec=ExecConfig(backend="segment"),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    res = fit(cfg, dds, resume_from=path)
    assert res.epochs_run == 3  # 10 total - 7 already done
    assert res.history.shape == (3, 4)


def test_scan_chunked_checkpoint_matches_unchunked(tmp_path):
    """Scan mode with checkpoint_every splits the fused run into chunks; with
    a static schedule (early_stopping=0) the chunking must be numerically
    exact — same metric history and test acc as one unchunked fused run —
    because _advance_key replays the per-epoch key splits between chunks.
    Nonzero dropout makes any key-stream drift visible."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)

    def run(ckpt_dir, every):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.4, 0.3),
                          epochs=12, early_stopping=0),
            exec=ExecConfig(backend="segment", seed=5),
            train=TrainConfig(verbose=False, mode="scan",
                              checkpoint_dir=ckpt_dir,
                              checkpoint_every=every),
        )
        return fit(cfg, dds)

    import os

    plain = run("", 0)
    ck = str(tmp_path / "ck")
    chunked = run(ck, 5)
    np.testing.assert_allclose(chunked.history, plain.history,
                               rtol=1e-5, atol=1e-6)
    assert chunked.test_acc == pytest.approx(plain.test_acc, abs=1e-6)
    # chunks at 5 and 10; the 12-epoch tail is ckpt_final
    names = sorted(os.listdir(ck))
    assert names == ["ckpt_000005.npz", "ckpt_000010.npz", "ckpt_final.npz"]


def test_scan_resume_from_chunk_continues_key_stream(tmp_path):
    """Resuming a scan run from an intermediate chunk checkpoint must CONTINUE
    the dropout-key stream (not replay the first epochs): the resumed tail's
    metrics must equal rows [5:] of the single uninterrupted run."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)

    def cfg(ckpt_dir="", every=0):
        return Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.4, 0.3),
                          epochs=12, early_stopping=0),
            exec=ExecConfig(backend="segment", seed=5),
            train=TrainConfig(verbose=False, mode="scan",
                              checkpoint_dir=ckpt_dir,
                              checkpoint_every=every),
        )

    plain = fit(cfg(), dds)
    ck = str(tmp_path / "ck")
    fit(cfg(ck, 5), dds)
    import os

    resumed = fit(cfg(), dds, resume_from=os.path.join(ck, "ckpt_000005.npz"))
    assert resumed.epochs_run == 7
    np.testing.assert_allclose(resumed.history, plain.history[5:],
                               rtol=1e-5, atol=1e-6)
    assert resumed.test_acc == pytest.approx(plain.test_acc, abs=1e-6)


def test_checkpoint_resume(tmp_path):
    """Resume must continue training from the saved state."""
    from parallel_gcn.utils.checkpoint import load_checkpoint, save_checkpoint
    from parallel_gcn.optim import init_adam
    from parallel_gcn.models.gcn import init_params
    import jax

    w = init_params(jax.random.PRNGKey(0), 10, (8,), 3)
    opt = init_adam(w)
    key = jax.random.PRNGKey(7)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, w, opt, epoch=5, key=key)
    w2, opt2, epoch2, key2 = load_checkpoint(path)
    assert epoch2 == 5
    for a, b in zip(w, w2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(key)), np.asarray(jax.random.key_data(key2))
    )
    assert int(opt2.step) == int(opt.step)


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_layers=3, hidden_dims=(16, 16), dropouts=(0.2, 0.1, 0.2),
             residual=True),
        dict(dropouts=(0.0, 0.3)),  # zero input dropout -> shared prefix
        dict(dropouts=(0.0, 0.0)),
    ],
)
def test_fused_deferred_eval_matches_eager(kw):
    """The stacked deferred-eval scan (train._fused_deferred_forward) must
    reproduce the eager per-epoch schedule's metrics exactly across layer
    counts, residuals, and dropout patterns."""
    r_scan = _fit_synthetic("scan", epochs=25, **kw)
    r_eager = _fit_synthetic("eager", epochs=25, **kw)
    np.testing.assert_allclose(r_scan.history, r_eager.history, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(r_scan.test_acc, r_eager.test_acc, atol=1e-6)


def test_one_layer_preagg_scan_matches_eager():
    """A 1-layer model with input_preagg has NO aggregation left in the loop;
    the deferred-eval fusion must not apply (it would aggregate Â²XW0) and
    the scan path must still match eager exactly."""
    kw = dict(n_layers=1, hidden_dims=(), dropouts=(0.0,))
    r_scan = _fit_synthetic("scan", epochs=15, **kw)
    r_eager = _fit_synthetic("eager", epochs=15, **kw)
    np.testing.assert_allclose(r_scan.history, r_eager.history, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(r_scan.test_acc, r_eager.test_acc, atol=1e-6)


def test_fused_deferred_eval_single_epoch():
    """epochs=1: the scan emits one row whose val metrics come entirely from
    the post-scan standalone eval (the in-body deferred eval evaluated the
    init weights and is dropped)."""
    r_scan = _fit_synthetic("scan", epochs=1)
    r_eager = _fit_synthetic("eager", epochs=1)
    assert r_scan.history.shape == (1, 4)
    np.testing.assert_allclose(r_scan.history, r_eager.history, rtol=2e-4, atol=2e-4)


def test_residual_grads_match_golden(small_graph, rng):
    """Residual gradients vs the oracle, incl. the hidden==output-dim case
    where the last layer must NOT get a residual (src/gcn.cu:116-142 places
    ResidualConnection only on inner layers)."""
    csr, graph = small_graph
    n = csr.n_rows
    dims = [10, 16, 16, 16]  # hidden == output dim: exercises the boundary
    ws, ws_np = _weights_np(jax.random.PRNGKey(2), dims)
    x = rng.standard_normal((graph.n_nodes, dims[0])).astype(np.float32)
    x[n:] = 0
    labels = rng.integers(0, dims[-1], size=graph.n_nodes).astype(np.int32)
    mask_np = np.zeros(graph.n_nodes, dtype=bool)
    mask_np[: n // 2] = True
    num = int(mask_np.sum())

    model = GCNModel(n_layers=3, dropouts=(0.0,) * 3, backend="segment",
                     residual=True)

    logits = np.asarray(model.apply(ws, jnp.asarray(x), graph, training=False))
    expected, _ = golden_forward(ws_np, x[:n], csr, residual=True)
    np.testing.assert_allclose(logits[:n], expected, rtol=5e-5, atol=5e-5)

    def loss_fn(ws):
        logits = model.apply(ws, jnp.asarray(x), graph, training=False)
        loss, _ = masked_softmax_xent(
            logits, jnp.asarray(labels), jnp.asarray(mask_np), num
        )
        return loss

    grads = jax.grad(loss_fn)(ws)
    g_golden, _ = golden_grads(
        ws_np, x[:n], csr, labels[:n], mask_np[:n], residual=True
    )
    for g, gg in zip(grads, g_golden):
        np.testing.assert_allclose(np.asarray(g), gg, rtol=1e-4, atol=1e-5)


def test_deep_residual_gcn_trains():
    """Deep configuration from BASELINE.json ("n_layers 4-8, wider hidden"):
    a 6-layer residual GCN must train stably in the fused scan path."""
    result = _fit_synthetic(
        "scan", epochs=40, n_layers=6, hidden_dims=(32,) * 5,
        dropouts=(0.1,) * 6, residual=True,
    )
    assert np.isfinite(result.history).all()
    assert result.history[-1, 0] < result.history[0, 0]
    assert result.test_acc > 0.6


def test_same_seed_reproduces_exactly():
    """Fixed seed ⇒ bitwise-identical metric history across runs (the
    reference's reproducibility contract via its fixed Philox seed,
    include/utils.cuh:22; ours via threefry)."""
    a = _fit_synthetic("scan", epochs=15)
    b = _fit_synthetic("scan", epochs=15)
    np.testing.assert_array_equal(a.history, b.history)
    assert a.test_acc == b.test_acc


def test_fit_dense_int8_adj_matches_f32_trajectory():
    """adj_dtype=int8 end to end: the dense backend with the 0/1·k pattern
    matrix + outside d-scaling must reproduce the f32-adjacency trajectory
    under matmul_precision=highest (the factorization is exact; only f32
    reassociation rounding differs)."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(name="t", graph=csr, feature_csr=None, features=x,
                 labels=labels, split=split, n_nodes=csr.n_rows,
                 input_dim=x.shape[1], output_dim=int(labels.max()) + 1)

    def run(adj_dtype):
        dds = to_device(ds, dense=True, adj_dtype=adj_dtype)
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(16,), dropouts=(0.2, 0.2),
                          epochs=40, early_stopping=0),
            adam=AdamConfig(),
            exec=ExecConfig(backend="dense", seed=7,
                          matmul_precision="highest", adj_dtype=adj_dtype),
            train=TrainConfig(verbose=False, mode="scan"),
        )
        return fit(cfg, dds)

    a = run("int8")
    b = run("float32")
    np.testing.assert_allclose(a.history, b.history, rtol=2e-4, atol=2e-4)
    assert a.test_acc == pytest.approx(b.test_acc, abs=2e-3)
