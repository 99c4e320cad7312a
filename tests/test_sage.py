"""SAGE/GIN model families (models/sage.py) — golden-oracle, backend-parity,
and end-to-end training tests. The reference framework is GCN-only
(src/gcn.cu:47-142), so the oracles are golden.golden_sage_forward /
golden_gin_forward — independent dense NumPy re-expressions of the papers
(arXiv:1706.02216 mean aggregator; arXiv:1810.00826 GIN-eps), not ports.
Both models ride the symmetric-Â operator via exact diagonal rewrites, so the
tests sweep the same backends the GCN is sworn to (dense / segment / hybrid
tile packs)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gcn.config import AdamConfig, Config, GCNConfig, ExecConfig, TrainConfig
from parallel_gcn.data.graph import build_graph, random_graph
from parallel_gcn.golden import golden_gin_forward, golden_sage_forward
from parallel_gcn.models.sage import (
    GINModel,
    SAGEModel,
    init_gin_params,
    init_sage_params,
)
from parallel_gcn.train import fit

from tests.test_model import _synthetic


def _graph_pair(n=60, deg=5, seed=3, **kw):
    csr, _ = random_graph(n, deg, seed=seed)
    g = build_graph(csr, dense=True, node_pad=1, edge_pad=1, **kw)
    assert g.sqrt_deg is not None
    return csr, g


def _dataset():
    from parallel_gcn.data.parser import Dataset

    csr, x, labels, split = _synthetic()
    return Dataset(
        name="t", graph=csr, feature_csr=None, features=x, labels=labels,
        split=split, n_nodes=csr.n_rows, input_dim=x.shape[1],
        output_dim=int(labels.max()) + 1,
    )


@pytest.mark.parametrize("n_layers", [2, 3])
def test_sage_forward_matches_golden(n_layers):
    csr, g = _graph_pair()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((csr.n_rows, 10)).astype(np.float32)
    hidden = [6] * (n_layers - 1)
    params = init_sage_params(jax.random.PRNGKey(1), 10, hidden, 4)
    params_np = jax.tree.map(np.asarray, params)

    expected = golden_sage_forward(params_np, x, csr)
    for backend in ("dense", "segment"):
        model = SAGEModel(
            n_layers=n_layers, dropouts=(0.0,) * n_layers, backend=backend,
            precision="highest",
        )
        out = np.asarray(model.apply(params, jnp.asarray(x), g, training=False))
        np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5,
                                   err_msg=backend)


@pytest.mark.parametrize("n_layers,eps", [(2, 0.0), (3, 0.0), (2, 0.4)])
def test_gin_forward_matches_golden(n_layers, eps):
    csr, g = _graph_pair(seed=5)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((csr.n_rows, 9)).astype(np.float32)
    hidden = [7] * (n_layers - 1)
    params = init_gin_params(jax.random.PRNGKey(2), 9, hidden, 4)
    # inner layers carry the 2-layer MLP, the classifier is linear
    assert all(set(p) == {"w1", "w2"} for p in params[:-1])
    assert set(params[-1]) == {"w1"}
    params_np = jax.tree.map(np.asarray, params)

    expected = golden_gin_forward(params_np, x, csr, eps=eps)
    for backend in ("dense", "segment"):
        model = GINModel(
            n_layers=n_layers, dropouts=(0.0,) * n_layers, backend=backend,
            precision="highest", gin_eps=eps,
        )
        out = np.asarray(model.apply(params, jnp.asarray(x), g, training=False))
        np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5,
                                   err_msg=backend)


def test_sage_gin_hybrid_tiles_match_golden():
    """The diagonal rewrite must survive the hybrid tile pack (dense tiles +
    COO residual) — the backend the big graphs actually run."""
    csr, x, _, _ = _synthetic(n=300)
    gh = build_graph(csr, hybrid=True, min_tile_nnz=4, node_pad=1, edge_pad=1)
    assert gh.is_hybrid or gh.bcsr is not None
    # model contract: features arrive padded to graph.n_nodes (to_device does)
    xp = jnp.asarray(np.pad(x, ((0, gh.n_nodes - csr.n_rows), (0, 0))))

    params_s = init_sage_params(jax.random.PRNGKey(3), x.shape[1], [8], 3)
    exp_s = golden_sage_forward(jax.tree.map(np.asarray, params_s), x, csr)
    out_s = SAGEModel(n_layers=2, dropouts=(0.0, 0.0), backend="hybrid",
                      precision="highest").apply(
        params_s, xp, gh, training=False)
    np.testing.assert_allclose(np.asarray(out_s)[: csr.n_rows], exp_s,
                               rtol=2e-5, atol=2e-5)

    params_g = init_gin_params(jax.random.PRNGKey(4), x.shape[1], [8], 3)
    exp_g = golden_gin_forward(jax.tree.map(np.asarray, params_g), x, csr)
    out_g = GINModel(n_layers=2, dropouts=(0.0, 0.0), backend="hybrid",
                     precision="highest").apply(
        params_g, xp, gh, training=False)
    np.testing.assert_allclose(np.asarray(out_g)[: csr.n_rows], exp_g,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("family", ["sage", "gin"])
def test_backend_gradient_parity(family):
    """dense (matmul vs Â) and segment (scatter-add over COO) are
    independent aggregation implementations — gradients must agree."""
    csr, g = _graph_pair()
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((csr.n_rows, 8)).astype(np.float32))
    if family == "sage":
        params = init_sage_params(jax.random.PRNGKey(7), 8, [5], 3)
        make = lambda backend: SAGEModel(
            n_layers=2, dropouts=(0.0, 0.0), backend=backend,
            precision="highest")
    else:
        params = init_gin_params(jax.random.PRNGKey(7), 8, [5], 3)
        make = lambda backend: GINModel(
            n_layers=2, dropouts=(0.0, 0.0), backend=backend,
            precision="highest", gin_eps=0.1)

    def loss(params, backend):
        logits = make(backend).apply(params, x, g, training=False)
        return jnp.sum(logits * jnp.cos(logits))

    gd = jax.grad(lambda p: loss(p, "dense"))(params)
    gs = jax.grad(lambda p: loss(p, "segment"))(params)
    for a, b in zip(jax.tree.leaves(gd), jax.tree.leaves(gs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("family", ["sage", "gin"])
def test_remat_matches_plain(family):
    """jax.checkpoint'd layers are a pure memory lever — identical loss and
    gradients with remat on or off."""
    csr, g = _graph_pair(n=50, deg=4, seed=9)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((csr.n_rows, 8)).astype(np.float32))
    if family == "sage":
        params = init_sage_params(jax.random.PRNGKey(8), 8, [6], 3)
        make = lambda remat: SAGEModel(
            n_layers=2, dropouts=(0.2, 0.2), backend="segment",
            precision="highest", remat=remat)
    else:
        params = init_gin_params(jax.random.PRNGKey(8), 8, [6], 3)
        make = lambda remat: GINModel(
            n_layers=2, dropouts=(0.2, 0.2), backend="segment",
            precision="highest", remat=remat)

    def loss(params, remat):
        logits = make(remat).apply(params, x, g, training=True,
                                   key=jax.random.PRNGKey(12))
        return jnp.sum(logits * logits)

    l0, g0 = jax.value_and_grad(loss)(params, False)
    l1, g1 = jax.value_and_grad(loss)(params, True)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model,mode", [
    ("sage", "eager"), ("sage", "scan"),
    ("gin", "eager"), ("gin", "scan"),
])
def test_trains_end_to_end(model, mode):
    """model=sage / model=gin through the SAME trainer as the GCN — with the
    default input_preagg=True knob left ON (regression: the trainer reads
    model.input_preagg unconditionally; a missing trainer-contract field
    crashed make_eval_fn before the first epoch)."""
    from parallel_gcn.data.parser import to_device

    ds = _dataset()
    dds = to_device(ds)
    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.1, 0.1),
                      epochs=40, early_stopping=0, model=model),
        adam=AdamConfig(learning_rate=0.02, weight_decay=5e-4),
        exec=ExecConfig(backend="segment", dense_threshold=0,
                      matmul_precision="highest", seed=4, input_preagg=True),
        train=TrainConfig(verbose=False, mode=mode),
    )
    res = fit(cfg, dds)
    assert res.history[-1, 0] < res.history[0, 0]  # train loss decreased
    assert res.test_acc > 0.6, res.test_acc
    assert np.isfinite(res.history).all()


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_scan_matches_eager(model):
    """The fused scan run must reproduce the eager loop's trajectory (same
    key schedule; deferred-eval lane stacking gated OFF via
    supports_deferred_eval=False)."""
    from parallel_gcn.data.parser import to_device

    dds = to_device(_dataset())

    def run(mode):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.3, 0.3),
                          epochs=12, early_stopping=0, model=model),
            exec=ExecConfig(backend="segment", dense_threshold=0,
                          matmul_precision="highest", seed=7),
            train=TrainConfig(verbose=False, mode=mode),
        )
        return fit(cfg, dds)

    a, b = run("eager"), run("scan")
    np.testing.assert_allclose(a.history, b.history, rtol=1e-4, atol=1e-5)
    assert a.test_acc == pytest.approx(b.test_acc, abs=1e-6)


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_checkpoint_roundtrip_and_resume(model, tmp_path):
    """SAGE params are {neigh, self} dicts and GIN layers carry VARIABLE key
    sets ({w1, w2} inner / {w1} classifier) — the npz flattening must
    round-trip arbitrary dict keys via the per-layer key manifest (regression
    for a review finding: the old fixed-GAT-key assert raised on both)."""
    from parallel_gcn.data.parser import to_device
    from parallel_gcn.utils.checkpoint import load_checkpoint

    dds = to_device(_dataset())

    def cfg(ckpt_dir="", every=0):
        return Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.3, 0.3),
                          epochs=10, early_stopping=0, model=model),
            exec=ExecConfig(backend="segment", dense_threshold=0, seed=5),
            train=TrainConfig(verbose=False, mode="scan",
                              checkpoint_dir=ckpt_dir,
                              checkpoint_every=every),
        )

    plain = fit(cfg(), dds)
    ck = str(tmp_path / "ck")
    fit(cfg(ck, 4), dds)
    w, opt, epoch, key = load_checkpoint(os.path.join(ck, "ckpt_000004.npz"))
    if model == "sage":
        assert set(w[0]) == {"neigh", "self"}
    else:
        assert set(w[0]) == {"w1", "w2"} and set(w[1]) == {"w1"}
    assert epoch == 4 and int(opt.step) == 4

    resumed = fit(cfg(), dds,
                  resume_from=os.path.join(ck, "ckpt_000004.npz"))
    assert resumed.epochs_run == 6
    np.testing.assert_allclose(resumed.history, plain.history[4:],
                               rtol=1e-5, atol=1e-6)
    assert resumed.test_acc == pytest.approx(plain.test_acc, abs=1e-6)


@pytest.mark.parametrize("model,halo,backend", [
    ("sage", "all_gather", "segment"),
    ("sage", "boundary", "segment"),
    ("sage", "adaptive", "segment"),
    ("sage", "ring", "segment"),
    ("sage", "boundary", "hybrid"),
    ("gin", "all_gather", "segment"),
    ("gin", "adaptive", "segment"),
    ("gin", "boundary", "hybrid"),
])
def test_fit_parallel_matches_single_chip(model, halo, backend):
    """Mesh SAGE/GIN must reproduce the single-chip trajectory across every
    halo mode AND the hybrid tile slabs — the diagonal rewrite scales local
    rows before the exchange, so each halo design ships the scaled rows with
    no path-specific handling."""
    from parallel_gcn.data.parser import to_device
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()
    gcn_cfg = GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.0, 0.0),
                        epochs=12, early_stopping=0, model=model)
    cfg = Config(
        gcn=gcn_cfg,
        exec=ExecConfig(backend=backend, seed=7, n_devices=4, halo=halo,
                      matmul_precision="highest", halo_fallback=False,
                      min_tile_nnz=4 if backend == "hybrid" else 0),
        train=TrainConfig(verbose=False, mode="scan"),
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
    # accuracies are argmax counts over ~35-node splits: ONE borderline node
    # flipping under reordered f32 sums is 1/35 ≈ 0.029 — allow exactly that
    np.testing.assert_allclose(
        res_par.history[:, [1, 3]], res_one.history[:, [1, 3]], atol=0.03
    )
    assert abs(res_par.test_acc - res_one.test_acc) < 0.03


def test_fit_parallel_learns_with_dropout_and_remat():
    """Mesh SAGE with dropout (per-device folded keys) + remat must still
    learn; mesh GIN eager mode exercises the per-epoch step path."""
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()
    for model, mode in (("sage", "scan"), ("gin", "eager")):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.2, 0.2),
                          epochs=40, early_stopping=0, model=model,
                          remat=True),
            adam=AdamConfig(learning_rate=0.02, weight_decay=5e-4),
            exec=ExecConfig(backend="segment", seed=4, n_devices=4,
                          halo="boundary", halo_fallback=False),
            train=TrainConfig(verbose=False, mode=mode),
        )
        res = fit_parallel(cfg, ds)
        assert res.history[-1, 0] < res.history[0, 0], model
        assert res.test_acc > 0.6, (model, res.test_acc)
        assert np.isfinite(res.history).all()


@pytest.mark.parametrize("model,n_layers,hidden", [
    ("sage", 2, (8,)),
    ("sage", 3, (8, 8)),
    ("gin", 2, (8,)),
    ("gin", 3, (8, 8)),
])
def test_fit_parallel_tp_matches_single_chip(model, n_layers, hidden):
    """Tensor parallelism × SAGE/GIN (VERDICT r3 item 6): SAGE shards both
    per-layer matmuls on the GCN's alternating col/row schedule; GIN Megatron-
    shards each layer's MLP pair. A 4×2 (nodes, feat) mesh must reproduce the
    single-chip trajectory."""
    from parallel_gcn.data.parser import to_device
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()
    gcn_cfg = GCNConfig(n_layers=n_layers, hidden_dims=hidden,
                        dropouts=(0.0,) * n_layers, epochs=10,
                        early_stopping=0, model=model)
    cfg = Config(
        gcn=gcn_cfg,
        exec=ExecConfig(backend="segment", seed=7, n_devices=4, tp=2,
                      matmul_precision="highest"),
        train=TrainConfig(verbose=False, mode="scan"),
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
        res_par.history[:, [1, 3]], res_one.history[:, [1, 3]], atol=0.03
    )
    assert abs(res_par.test_acc - res_one.test_acc) < 0.03


def test_parallel_tp_learns_with_dropout_and_validates_dims():
    """TP SAGE/GIN with dropout + remat still learns (per-device folded keys;
    GIN keeps feat-replicated masks), and indivisible dims raise early."""
    from parallel_gcn.parallel.train_parallel import fit_parallel

    ds = _dataset()
    for model in ("sage", "gin"):
        cfg = Config(
            gcn=GCNConfig(n_layers=2, hidden_dims=(8,), dropouts=(0.3, 0.3),
                          epochs=40, early_stopping=0, model=model,
                          remat=True),
            adam=AdamConfig(learning_rate=0.02, weight_decay=5e-4),
            exec=ExecConfig(backend="segment", seed=7, n_devices=4, tp=2),
            train=TrainConfig(verbose=False, mode="scan"),
        )
        res = fit_parallel(cfg, ds)
        assert res.history[-1, 0] < res.history[0, 0], model
        assert np.isfinite(res.history).all()

    cfg = Config(
        gcn=GCNConfig(n_layers=2, hidden_dims=(7,), dropouts=(0.0, 0.0),
                      epochs=2, early_stopping=0, model="gin"),
        exec=ExecConfig(backend="segment", n_devices=4, tp=2),
        train=TrainConfig(verbose=False),
    )
    with pytest.raises(ValueError, match="divisible by tp"):
        fit_parallel(cfg, ds)


def test_early_stopping_and_residual_paths():
    """The shared trainer's remaining knobs (early stopping rule, residual
    connections) run the new families without error and stay finite."""
    from parallel_gcn.data.parser import to_device

    dds = to_device(_dataset())
    for model in ("sage", "gin"):
        cfg = Config(
            gcn=GCNConfig(n_layers=3, hidden_dims=(8, 8),
                          dropouts=(0.2,) * 3, epochs=30, early_stopping=5,
                          model=model, residual=True),
            exec=ExecConfig(backend="segment", dense_threshold=0, seed=6),
            train=TrainConfig(verbose=False, mode="scan"),
        )
        res = fit(cfg, dds)
        assert res.epochs_run <= 30
        assert np.isfinite(res.history).all()
