"""GAT model family (models/gat.py) — golden-oracle, backend-parity, and
end-to-end training tests (paper arXiv:1710.10903; the reference framework is
GCN-only, so the oracle here is golden.golden_gat_forward, an independent
NumPy re-expression, not a reference port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gcn.config import AdamConfig, Config, GCNConfig, ExecConfig, TrainConfig
from parallel_gcn.data.graph import build_graph, random_graph
from parallel_gcn.golden import golden_gat_forward
from parallel_gcn.models.gat import GATModel, init_gat_params
from parallel_gcn.train import fit

from tests.test_model import _synthetic


def _graph_pair(n=60, deg=5, seed=3):
    csr, _ = random_graph(n, deg, seed=seed)
    g = build_graph(csr, dense=True, node_pad=1, edge_pad=1)
    assert g.adj is not None and g.n_nodes == csr.n_rows
    return csr, g


@pytest.mark.parametrize("n_layers,heads", [(2, 1), (2, 4), (3, 2)])
def test_gat_forward_matches_golden(n_layers, heads):
    csr, g = _graph_pair()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((csr.n_rows, 10)).astype(np.float32)
    hidden = [6] * (n_layers - 1)
    params = init_gat_params(jax.random.PRNGKey(1), 10, hidden, 4, heads)
    params_np = jax.tree.map(np.asarray, params)

    expected = golden_gat_forward(params_np, x, csr, heads)
    for backend in ("dense", "segment"):
        model = GATModel(
            n_layers=n_layers, dropouts=(0.0,) * n_layers, heads=heads,
            backend=backend, precision="highest",
        )
        out = np.asarray(
            model.apply(params, jnp.asarray(x), g, training=False)
        )
        np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5,
                                   err_msg=backend)


def test_gat_chunked_attention_matches_unchunked():
    """The streaming (edge_chunk) segment attention must reproduce the
    unchunked edge softmax exactly — forward and gradients (same math,
    two-pass max/exp-accumulate formulation)."""
    csr, g = _graph_pair(n=80, deg=6)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((csr.n_rows, 9)).astype(np.float32))
    params = init_gat_params(jax.random.PRNGKey(3), 9, [5], 4, heads=3)

    def loss(params, chunk):
        model = GATModel(n_layers=2, dropouts=(0.0, 0.0), heads=3,
                         backend="segment", precision="highest",
                         edge_chunk=chunk)
        logits = model.apply(params, x, g, training=False)
        return jnp.sum(logits * jnp.cos(logits)), logits

    (l0, out0), g0 = jax.value_and_grad(loss, has_aux=True)(params, 0)
    # 100 does not divide the padded edge count — exercises the pad tail
    (l1, out1), g1 = jax.value_and_grad(loss, has_aux=True)(params, 100)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out0),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


def test_gat_chunked_attn_dropout_deterministic_and_trains():
    """The chunked path's attention dropout (fold_in-per-chunk key stream,
    numerator-only masking == dropping normalized α) must be deterministic
    under remat recompute (same seed → bit-identical loss/grads twice) and
    must keep an unbiased mean (loss within noise of the undropped run's
    scale — pinned loosely via finiteness + determinism + the e2e learning
    test below)."""
    csr, g = _graph_pair(n=80, deg=6)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((csr.n_rows, 9)).astype(np.float32))
    params = init_gat_params(jax.random.PRNGKey(6), 9, [5], 4, heads=3)

    def loss(params):
        model = GATModel(n_layers=2, dropouts=(0.2, 0.2), heads=3,
                         backend="segment", precision="highest",
                         edge_chunk=100, attn_dropout=0.3, remat=True)
        logits = model.apply(params, x, g, training=True,
                             key=jax.random.PRNGKey(11))
        return jnp.sum(logits * logits)

    l0, g0 = jax.value_and_grad(loss)(params)
    l1, g1 = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(l0))
    assert float(l0) == float(l1)  # remat recompute must reuse the SAME masks
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode,es", [
    ("scan", 0),    # fused deferred-eval path (_fused_deferred_forward)
    ("scan", 4),    # while_loop path (GCNModel.apply)
    ("eager", 0),
])
def test_gcn_remat_matches_plain(mode, es, monkeypatch):
    """remat on the GCN must not change the math on ANY schedule — same
    metric trajectory as the plain run — and must actually FIRE (a prior
    version of the knob silently no-op'd on the default fused path)."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)

    calls = {"n": 0}
    real_ckpt = jax.checkpoint

    def counting(fn, **kw):
        calls["n"] += 1
        return real_ckpt(fn, **kw)

    monkeypatch.setattr(jax, "checkpoint", counting)

    def run(remat):
        cfg = Config(
            gcn=GCNConfig(n_layers=4, hidden_dims=(8, 8, 8),
                          dropouts=(0.3,) * 4, epochs=8, early_stopping=es,
                          residual=True, remat=remat),
            exec=ExecConfig(backend="segment", seed=3,
                          matmul_precision="highest"),
            train=TrainConfig(verbose=False, mode=mode),
        )
        return fit(cfg, dds)

    a = run(False)
    before = calls["n"]
    b = run(True)
    assert calls["n"] > before, "remat=True never reached jax.checkpoint"
    np.testing.assert_allclose(a.history, b.history, rtol=1e-5, atol=1e-6)
    assert a.test_acc == pytest.approx(b.test_acc, abs=1e-6)


def test_gat_remat_matches_plain():
    """jax.checkpoint'd layers must not change the math — same logits and
    gradients, just recomputed in backward."""
    csr, g = _graph_pair(n=60, deg=5)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((csr.n_rows, 8)).astype(np.float32))
    params = init_gat_params(jax.random.PRNGKey(5), 8, [6], 3, heads=2)

    def loss(params, remat):
        model = GATModel(n_layers=2, dropouts=(0.2, 0.2), heads=2,
                         backend="segment", precision="highest", remat=remat)
        logits = model.apply(params, x, g, training=True,
                             key=jax.random.PRNGKey(9))
        return jnp.sum(logits * logits)

    l0, g0 = jax.value_and_grad(loss)(params, False)
    l1, g1 = jax.value_and_grad(loss)(params, True)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_gat_backend_gradient_parity():
    """dense (masked matmul softmax) and segment (edge softmax) are independent
    implementations of the same math — their gradients must agree."""
    csr, g = _graph_pair()
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((csr.n_rows, 8)).astype(np.float32))
    params = init_gat_params(jax.random.PRNGKey(2), 8, [5], 3, heads=2)

    def loss(params, backend):
        model = GATModel(n_layers=2, dropouts=(0.0, 0.0), heads=2,
                         backend=backend, precision="highest")
        logits = model.apply(params, x, g, training=False)
        return jnp.sum(logits * logits)

    gd = jax.grad(lambda p: loss(p, "dense"))(params)
    gs = jax.grad(lambda p: loss(p, "segment"))(params)
    for a, b in zip(jax.tree.leaves(gd), jax.tree.leaves(gs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("attn_dropout", [0.0, 0.6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 2, 8])
def test_gat_segment_matches_dense(heads, dtype, attn_dropout, remat):
    """The segment (edge softmax over the COO) and dense (masked [heads,N,N]
    softmax) attention routes agree — logits and gradients — across head
    counts, compute dtypes and remat. With attention dropout the two draw
    masks over differently shaped arrays, so parity is checked on the
    dropout-free eval forward and the training forward must stay finite."""
    csr, g = _graph_pair()
    rng = np.random.default_rng(heads)
    x = jnp.asarray(rng.standard_normal((csr.n_rows, 8)).astype(np.float32))
    params = init_gat_params(jax.random.PRNGKey(2), 8, [4], 3, heads=heads)

    def model(backend):
        return GATModel(n_layers=2, dropouts=(0.0, 0.0), heads=heads,
                        attn_dropout=attn_dropout, backend=backend,
                        compute_dtype=dtype, precision="highest", remat=remat)

    def loss(params, backend):
        logits = model(backend).apply(params, x, g, training=False)
        return jnp.sum(logits * logits), logits

    (ld, od), gd = jax.value_and_grad(loss, has_aux=True)(params, "dense")
    (ls, os_), gs = jax.value_and_grad(loss, has_aux=True)(params, "segment")
    def relerr(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)

    if dtype == "float32":
        assert relerr(os_, od) < 2e-4
        for a, b in zip(jax.tree.leaves(gd), jax.tree.leaves(gs)):
            assert relerr(b, a) < 2e-4
    else:
        # bf16 rounds every intermediate to 8 mantissa bits, and the softmax
        # gradient w.r.t. the small attention vectors is a cancelling sum —
        # so compare the whole gradient normwise, not leaf by leaf
        flat = lambda g: np.concatenate(
            [np.ravel(np.asarray(x, np.float64)) for x in jax.tree.leaves(g)])
        assert relerr(os_, od) < 5e-2
        assert relerr(flat(gs), flat(gd)) < 5e-2
    if attn_dropout:
        for backend in ("dense", "segment"):
            train = model(backend).apply(params, x, g, training=True,
                                         key=jax.random.PRNGKey(3))
            assert np.isfinite(np.asarray(train)).all()
            assert not np.allclose(np.asarray(train), np.asarray(od))


@pytest.mark.parametrize("mode,backend", [
    ("eager", "dense"),
    ("scan", "dense"),     # plain scan path (no deferred-eval for GAT)
    ("scan", "segment"),
    ("eager", "segment"),
])
def test_gat_trains_end_to_end(mode, backend):
    """model=gat through the SAME trainer as the GCN: learns the separable
    synthetic problem in both modes and both attention backends."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds, dense=backend == "dense")
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.1, 0.1),
                      epochs=40, early_stopping=0, model="gat", heads=2,
                      attn_dropout=0.1),
        adam=AdamConfig(learning_rate=0.02, weight_decay=5e-4),
        exec=ExecConfig(backend=backend, dense_threshold=0 if backend != "dense"
                      else 8192, matmul_precision="highest", seed=4),
        train=TrainConfig(verbose=False, mode=mode),
    )
    res = fit(cfg, dds)
    assert res.history[-1, 0] < res.history[0, 0]  # train loss decreased
    assert res.test_acc > 0.6, res.test_acc
    assert np.isfinite(res.history).all()


def test_gat_scan_matches_eager():
    """The fused scan run must reproduce the eager loop's trajectory for the
    GAT exactly (same key schedule; deferred-eval stacking correctly gated
    OFF — attention differs per lane, stacking would be wrong)."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)

    def run(mode):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.3, 0.3),
                          epochs=12, early_stopping=0, model="gat", heads=2),
            exec=ExecConfig(backend="segment", dense_threshold=0,
                          matmul_precision="highest", seed=7),
            train=TrainConfig(verbose=False, mode=mode),
        )
        return fit(cfg, dds)

    a, b = run("eager"), run("scan")
    np.testing.assert_allclose(a.history, b.history, rtol=1e-4, atol=1e-5)
    assert a.test_acc == pytest.approx(b.test_acc, abs=1e-6)


def test_gat_scan_chunked_falls_back_to_eager(monkeypatch):
    """A fused scan + edge_chunk attention program can exhaust device memory
    at reddit scale — above the check threshold,
    fit() AOT-compiles the program and asks XLA's memory analysis whether it
    fits the device (train._gat_scan_fits_hbm); a does-not-fit (or
    can't-tell) verdict takes the eager per-epoch path with a warning, never
    handing the user a worker crash. The fallback trains the identical
    model: trajectories match an explicit eager run exactly; a fits verdict
    proceeds with the unchanged scan trajectory."""
    import parallel_gcn.train as train_mod
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)

    def run(mode):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.3, 0.3),
                          epochs=6, early_stopping=0, model="gat", heads=2,
                          remat=True),
            exec=ExecConfig(backend="segment", dense_threshold=0,
                          matmul_precision="highest", seed=7, edge_chunk=64),
            train=TrainConfig(verbose=False, mode=mode),
        )
        return fit(cfg, dds)

    # below the threshold: scan mode proceeds (no warning)
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        res_scan = run("scan")

    # shrink the threshold so this fixture counts as "reddit scale": the AOT
    # check runs, and on CPU (no reported bytes_limit) it passes — scan
    # proceeds with the identical trajectory, no warning
    monkeypatch.setattr(train_mod, "_GAT_SCAN_CHECK_EDGES", 10)
    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        res_checked = run("scan")
    np.testing.assert_allclose(res_checked.history, res_scan.history,
                               rtol=1e-6, atol=1e-7)

    # force a does-not-fit verdict (what the real device reports at 11.8M
    # edges): the eager fallback must engage with a warning
    monkeypatch.setattr(
        train_mod, "_gat_scan_fits_hbm",
        lambda run, w, o, k: (False, "forced by test", None),
    )
    with pytest.warns(UserWarning, match="falling back to mode=eager"):
        res_fb = run("scan")
    res_eager = run("eager")
    np.testing.assert_allclose(res_fb.history, res_eager.history,
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(res_fb.history).all()
    # and the fallback matches the (structurally sound) scan trajectory too
    np.testing.assert_allclose(res_fb.history, res_scan.history,
                               rtol=1e-4, atol=1e-5)


def test_gat_scan_guard_no_limit_accelerator_is_conservative(monkeypatch):
    """An accelerator that does NOT report bytes_limit must get the
    conservative verdict: XLA's memory analysis alone cannot clear the
    program against an unknown limit. CPU keeps fits=True so the
    virtual-mesh tests run scan mode."""
    import parallel_gcn.train as train_mod

    class FakeDev:
        platform = "gpu"

        def memory_stats(self):
            return {}  # no bytes_limit

    class FakeCompiled:
        def memory_analysis(self):
            class MA:
                temp_size_in_bytes = 5_600_000_000
                argument_size_in_bytes = 100
                output_size_in_bytes = 100
                alias_size_in_bytes = 0
            return MA()

    class FakeRun:
        def lower(self, *a):
            class L:
                def compile(self):
                    return FakeCompiled()
            return L()

    import jax as _real_jax

    # _gat_scan_fits_hbm does `import jax as _jax` internally — patch the
    # real module's devices() for the duration of this test
    monkeypatch.setattr(_real_jax, "devices", lambda: [FakeDev()])
    fits, detail, compiled = train_mod._gat_scan_fits_hbm(
        FakeRun(), None, None, None
    )
    assert not fits and compiled is None
    assert "no memory limit" in detail

    # a missing size attribute (jax API drift) must also land conservative,
    # not silently read as need=0 (ADVICE r4 medium finding)
    class BadMA:
        pass

    class BadCompiled(FakeCompiled):
        def memory_analysis(self):
            return BadMA()

    class BadRun(FakeRun):
        def lower(self, *a):
            class L:
                def compile(self):
                    return BadCompiled()
            return L()

    fits, detail, compiled = train_mod._gat_scan_fits_hbm(
        BadRun(), None, None, None
    )
    assert not fits and compiled is None

    # and memory_analysis() returning None likewise
    class NoneCompiled(FakeCompiled):
        def memory_analysis(self):
            return None

    class NoneRun(FakeRun):
        def lower(self, *a):
            class L:
                def compile(self):
                    return NoneCompiled()
            return L()

    fits, detail, compiled = train_mod._gat_scan_fits_hbm(
        NoneRun(), None, None, None
    )
    assert not fits and "None" in detail


@pytest.mark.parametrize("halo,mode", [
    ("all_gather", "scan"),
    ("boundary", "scan"),
    ("boundary", "eager"),
])
def test_gat_fit_parallel_matches_single_chip(halo, mode):
    """Multi-chip GAT (per-destination edge softmax stays device-local; one
    halo exchange per layer ships [W·h | t]) must reproduce the single-chip
    trajectory on the 4-device mesh."""
    from parallel_gcn.data.parser import Dataset, to_device
    from parallel_gcn.parallel.train_parallel import fit_parallel

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    gcn_cfg = GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                        epochs=12, early_stopping=0, model="gat", heads=2)
    cfg = Config(
        gcn=gcn_cfg,
        exec=ExecConfig(backend="segment", seed=7, n_devices=4, halo=halo,
                      matmul_precision="highest", halo_fallback=False),
        train=TrainConfig(verbose=False, mode=mode),
    )
    res_par = fit_parallel(cfg, ds)

    single_cfg = Config(
        gcn=gcn_cfg,
        exec=ExecConfig(backend="segment", dense_threshold=0, seed=7,
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


def test_gat_fit_parallel_learns_with_dropout():
    """Mesh GAT with feature + attention dropout (per-device folded keys)
    must still learn the separable synthetic problem."""
    from parallel_gcn.data.parser import Dataset
    from parallel_gcn.parallel.train_parallel import fit_parallel

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.2, 0.2),
                      epochs=40, early_stopping=0, model="gat", heads=2,
                      attn_dropout=0.2, remat=True),  # mesh remat path too
        adam=AdamConfig(learning_rate=0.02, weight_decay=5e-4),
        exec=ExecConfig(backend="segment", seed=4, n_devices=4,
                      halo="boundary", halo_fallback=False),
        train=TrainConfig(verbose=False, mode="scan"),
    )
    res = fit_parallel(cfg, ds)
    assert res.history[-1, 0] < res.history[0, 0]
    assert res.test_acc > 0.6, res.test_acc
    assert np.isfinite(res.history).all()


def test_gcn_remat_parallel_matches_plain():
    """Mesh GCN remat (flat forward + fused-run stacked prefix) must be a
    pure memory lever — identical metrics with it on or off."""
    from parallel_gcn.data.parser import Dataset
    from parallel_gcn.parallel.train_parallel import fit_parallel

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )

    def run(remat):
        cfg = Config(
            gcn=GCNConfig(n_layers=3, hidden_dims=(8, 8),
                          dropouts=(0.3,) * 3, epochs=8, early_stopping=0,
                          remat=remat),
            exec=ExecConfig(backend="segment", seed=3, n_devices=4,
                          halo="boundary", matmul_precision="highest",
                          halo_fallback=False),
            train=TrainConfig(verbose=False, mode="scan"),
        )
        return fit_parallel(cfg, ds)

    a, b = run(False), run(True)
    np.testing.assert_allclose(a.history, b.history, rtol=1e-5, atol=1e-6)
    assert a.test_acc == pytest.approx(b.test_acc, abs=1e-6)


@pytest.mark.parametrize("halo", ["all_gather", "boundary"])
def test_gat_parallel_edge_chunk_matches_unchunked(halo):
    """VERDICT round-2 item 9: streaming (edge_chunk) attention over the
    mesh — per-device two-pass softmax on the local edge slab against the
    halo buffer. Must reproduce the unchunked mesh trajectory exactly (same
    math, f32 accumulation; feature-dropout keys are chunk-independent)."""
    from parallel_gcn.data.parser import Dataset
    from parallel_gcn.parallel.train_parallel import fit_parallel

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )

    def run(chunk):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.3, 0.3),
                          epochs=8, early_stopping=0, model="gat", heads=2,
                          remat=True),
            exec=ExecConfig(backend="segment", seed=7, n_devices=4, halo=halo,
                          matmul_precision="highest", edge_chunk=chunk,
                          halo_fallback=False),
            train=TrainConfig(verbose=False, mode="eager"),
        )
        return fit_parallel(cfg, ds)

    a, b = run(0), run(100)  # 100 does not divide the slab: pad-tail path
    np.testing.assert_allclose(a.history, b.history, rtol=2e-4, atol=2e-5)
    assert a.test_acc == pytest.approx(b.test_acc, abs=1e-4)


def test_gat_tile_parallel_rejects_unsupported_config():
    """model=gat has no tile route: backend=hybrid|bcsr is a config-time
    error that names backend=segment, for the mesh and the single device
    alike; ring/adaptive stay rejected on the COO mesh path."""
    from parallel_gcn.data.parser import Dataset
    from parallel_gcn.parallel.train_parallel import fit_parallel

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )

    def cfg(**ex_kw):
        return Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                          epochs=2, early_stopping=0, model="gat", heads=2),
            exec=ExecConfig(n_devices=4, **ex_kw),
            train=TrainConfig(verbose=False),
        )

    for backend in ("hybrid", "bcsr"):
        with pytest.raises(ValueError, match="backend=segment"):
            cfg(backend=backend)
    with pytest.raises(ValueError, match="gat"):
        fit_parallel(cfg(backend="segment", halo="adaptive"), ds)


def test_gat_parallel_rejects_unsupported_layouts():
    from parallel_gcn.data.parser import Dataset
    from parallel_gcn.parallel.train_parallel import fit_parallel

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    for ex in (
        ExecConfig(backend="segment", n_devices=4, halo="ring"),
        ExecConfig(backend="segment", n_devices=4, halo="adaptive"),
        ExecConfig(backend="segment", n_devices=2, tp=2),
    ):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                          epochs=2, early_stopping=0, model="gat", heads=2),
            exec=ex,
            train=TrainConfig(verbose=False),
        )
        with pytest.raises(ValueError, match="gat"):
            fit_parallel(cfg, ds)


def test_gat_checkpoint_roundtrip_and_resume(tmp_path):
    """GAT params are per-layer dicts — np.savez would silently PICKLE them
    as 0-d object arrays that np.load refuses to read back. The checkpoint
    layer must round-trip the dict structure and resume must continue the
    run (regression for a review finding)."""
    import os

    from parallel_gcn.data.parser import Dataset, to_device
    from parallel_gcn.utils.checkpoint import load_checkpoint

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)

    def cfg(ckpt_dir="", every=0):
        return Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.3, 0.3),
                          epochs=10, early_stopping=0, model="gat", heads=2),
            exec=ExecConfig(backend="segment", dense_threshold=0, seed=5),
            train=TrainConfig(verbose=False, mode="scan",
                              checkpoint_dir=ckpt_dir,
                              checkpoint_every=every),
        )

    plain = fit(cfg(), dds)
    ck = str(tmp_path / "ck")
    fit(cfg(ck, 4), dds)
    w, opt, epoch, key = load_checkpoint(os.path.join(ck, "ckpt_000004.npz"))
    assert isinstance(w[0], dict) and set(w[0]) == {"W", "a_src", "a_dst"}
    assert epoch == 4 and int(opt.step) == 4

    resumed = fit(cfg(), dds,
                  resume_from=os.path.join(ck, "ckpt_000004.npz"))
    assert resumed.epochs_run == 6
    np.testing.assert_allclose(resumed.history, plain.history[4:],
                               rtol=1e-5, atol=1e-6)
    assert resumed.test_acc == pytest.approx(plain.test_acc, abs=1e-6)


def test_gat_tile_routing_and_segment_rejection():
    """A tile-built (hybrid) graph carries only part of the edge list, so
    model=gat on it — by backend=auto or backend=segment — is a config-time
    error naming backend=segment, not a trace-time assert that -O strips."""
    from parallel_gcn.data.parser import Dataset, to_device
    from parallel_gcn.train import build_model

    csr, x, labels, split = _synthetic(n=300)
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds, hybrid=True, min_tile_nnz=4)

    def cfg(backend):
        return Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                          model="gat", heads=2),
            exec=ExecConfig(backend=backend),
            train=TrainConfig(verbose=False),
        )

    for backend in ("auto", "segment"):
        with pytest.raises(ValueError, match="backend=segment"):
            build_model(cfg(backend), dds)
    assert build_model(cfg("segment"), to_device(ds)).backend == "segment"


def test_gat_ignores_input_preagg():
    """input_preagg defaults True (the GCN hoist); GAT has no analog — fit
    must train WITHOUT the hoist instead of refusing or misaggregating."""
    from parallel_gcn.data.parser import Dataset, to_device

    csr, x, labels, split = _synthetic()
    ds = Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )
    dds = to_device(ds)
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                      epochs=3, early_stopping=0, model="gat", heads=2),
        exec=ExecConfig(backend="segment", dense_threshold=0, input_preagg=True),
        train=TrainConfig(verbose=False),
    )
    res = fit(cfg, dds)
    assert np.isfinite(res.history).all()
