"""Smoke test of the GCN trainer on a GPU — the quickest proof that the
system still starts and computes correctly on the card.

    python chip_smoke.py            # one GPU: the phases below
    python chip_smoke.py --multi    # four GPUs: the mesh path only

Default phases, on synth-reddit (232,965 nodes, 602 features, 41 classes,
hidden 600 — the reference's reddit statistics, generated from a seed):

  fit      the tuned config (backend=hybrid, community reorder, int8 tiles,
           bf16 compute) trained 5 epochs in scan mode through
           load_config / prepare_device_dataset / fit, as the CLI calls them;
           losses finite and falling, and equal to a backend=segment run on
           the same seed and reorder within a bf16 tolerance.
  kernels  each op of that path against a plain float32 jax.numpy reference
           at precision="highest", at the real widths (F = 41 and the
           82-wide stacked train+eval pass): the aggregation forward and VJP,
           and dropout (keep fraction, ReLU commute, backward mask).

``--multi`` runs fit_parallel on 4 GPUs (halo=boundary over the hybrid tile
slabs, halo=all_gather over backend=segment) and compares its losses with a
single-GPU fit of the same seed, in this one process.

Prints the card's name and power limit, each phase's precision and each
comparison's error beside its tolerance. The last line is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``. Exits nonzero,
with no result line, when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import numpy as np

DATASET = "synth-reddit"
FIT_EPOCHS = 5
MULTI_EPOCHS = 3
MULTI_DEVICES = 4

# Loss agreement between two routes of the same bf16 model: both sum the
# same bf16 products in different groupings (tiles in f32 + bf16 residual vs
# one bf16 segment_sum, atomics in varying order), which moves a mean CE over
# 153K nodes by far less than this.
LOSS_RTOL = 1e-2
# Aggregation vs the f32 reference fed the SAME bf16-rounded operand, so
# input rounding is not counted: what remains is bf16 output rounding (2^-9
# relative per element) and the segment path's bf16 accumulation, whose
# error grows with the row degree (synth-reddit's hubs reach ~10^5 edges).
# Normwise relative error.
AGG_TOL_BF16 = 3e-2
# f32 operand at precision="highest": f32 accumulation, order varies with
# the GPU's atomics — a few ulps normwise.
AGG_TOL_F32 = 1e-5
DROPOUT_RATE = 0.1  # synth-reddit's hidden-layer dropout
SIGMAS = 5.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"  {name}: error {err:.3e} (tolerance {tol:.1e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def select_phases(argv: list[str]) -> list[str]:
    if argv == ["--multi"]:
        return ["multi"]
    if argv:
        raise SystemExit(f"usage: python chip_smoke.py [--multi], got {argv}")
    return ["fit", "kernels"]


def result_line(info: dict) -> str:
    return json.dumps({"ok": True, "device": info})


def _load(name: str, **overrides):
    from parallel_gcn.config import default_params_path, load_config

    return load_config(default_params_path(name), overrides)


def phase_fit(name: str = DATASET, epochs: int = FIT_EPOCHS):
    """Tuned-config training through the CLI's entry points, then the same
    seed and reorder on backend=segment. Returns (ds, hybrid dds, segment
    dds) for the kernel phase."""
    from parallel_gcn.data.parser import device_dataset, prepare_device_dataset
    from parallel_gcn.train import fit

    common = dict(epochs=epochs, early_stopping=0, verbose=False, mode="scan")
    cfg = _load(name, **common)
    log(f"[fit] {name}: backend={cfg.exec.backend} reorder={cfg.exec.reorder} "
        f"tiles={cfg.exec.tile_dtype} {cfg.exec.tile_size}x"
        f"{cfg.exec.tile_cols} compute={cfg.exec.compute_dtype} "
        f"matmul_precision={cfg.exec.matmul_precision} epochs={epochs}")
    t0 = time.perf_counter()
    ds, dds = prepare_device_dataset(cfg, name)
    log(f"  data: {ds.n_nodes} nodes, {ds.graph.nnz} nnz, {ds.input_dim} "
        f"features, {ds.output_dim} classes, tiles "
        f"{dds.graph.bcsr.n_tiles} x {dds.graph.bcsr.tiles.shape[1:]} "
        f"{dds.graph.bcsr.tiles.dtype}, residual {dds.graph.row.shape[0]} "
        f"edges — prepared in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = fit(cfg, dds)
    log(f"  hybrid fit: {time.perf_counter() - t0:.1f} s incl. compile")
    loss = res.history[:, 0]
    log(f"  train losses (hybrid):  {loss.tolist()}")
    if not np.isfinite(res.history).all():
        raise AssertionError("non-finite metrics in the hybrid run")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"loss not falling: {loss.tolist()}")

    cfg_seg = _load(name, backend="segment", **common)
    dds_seg = device_dataset(cfg_seg, ds)
    t0 = time.perf_counter()
    res_seg = fit(cfg_seg, dds_seg)
    log(f"  segment fit: {time.perf_counter() - t0:.1f} s incl. compile")
    log(f"  train losses (segment): {res_seg.history[:, 0].tolist()}")
    err = float(np.max(np.abs(res_seg.history[:, 0] - loss) / np.abs(loss)))
    check("train loss, hybrid vs segment (max relative)", err, LOSS_RTOL)
    return ds, dds, dds_seg


def check_memory_limit():
    """The large-GAT scan guard decides from bytes_limit; the GPU reports
    it."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    if not stats.get("bytes_limit"):
        raise AssertionError("device reports no bytes_limit")
    log(f"  device bytes_limit {stats['bytes_limit']}, peak "
        f"{stats.get('peak_bytes_in_use')}")


def _relerr(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def phase_kernels(ds, dds, dds_seg, widths=(41, 82)):
    import jax
    import jax.numpy as jnp

    from parallel_gcn.ops.dropout import dropout
    from parallel_gcn.ops.graphsum import graphsum

    g_hyb, g_seg = dds.graph, dds_seg.graph
    n = ds.n_nodes

    @jax.jit
    def reference(x, row, col, val):
        # Â·x over the complete COO: one gather + segment_sum, f32
        with jax.default_matmul_precision("highest"):
            return jax.ops.segment_sum(
                val[:, None] * x[col], row, num_segments=x.shape[0]
            )

    @partial(jax.jit, static_argnames=("backend", "prec"))
    def fwd_and_vjp(x, g, graph, backend, prec):
        def agg(h):
            return graphsum(h, graph, backend=backend, precision=prec)

        out, vjp = jax.vjp(agg, x)
        return out, vjp(g)[0]

    key = jax.random.PRNGKey(0)
    for f in widths:
        for dtype, tol in (("bfloat16", AGG_TOL_BF16), ("float32", AGG_TOL_F32)):
            prec = "highest" if dtype == "float32" else "default"
            log(f"[kernels] aggregation F={f} operand={dtype} "
                f"precision={prec}")
            kx, kg, key = jax.random.split(key, 3)
            x = jax.random.normal(kx, (g_hyb.n_nodes, f)).astype(dtype)
            g = jax.random.normal(kg, (g_hyb.n_nodes, f)).astype(dtype)
            x = x.at[n:].set(0)
            g = g.at[n:].set(0)
            coo = (g_seg.row, g_seg.col, g_seg.val)
            m = g_seg.n_nodes
            ref = np.asarray(reference(x.astype(jnp.float32)[:m], *coo))[:n]
            ref_g = np.asarray(reference(g.astype(jnp.float32)[:m], *coo))[:n]
            for backend, graph in (("hybrid", g_hyb), ("segment", g_seg)):
                out, dx = fwd_and_vjp(x[: graph.n_nodes], g[: graph.n_nodes],
                                      graph, backend, prec)
                check(f"{backend} forward", _relerr(out[:n], ref), tol)
                # Â symmetric: the VJP of Â·x applied to g is Â·g
                check(f"{backend} VJP", _relerr(dx[:n], ref_g), tol)

    hidden = 600
    log(f"[kernels] dropout rate={DROPOUT_RATE} on [{n} x {hidden}] bfloat16")
    kx, kd = jax.random.split(key)
    z = jax.random.normal(kx, (n, hidden), jnp.bfloat16)
    x = jnp.abs(z) + 1  # no zeros: kept elements are exactly the nonzeros
    keep_p = 1.0 - DROPOUT_RATE
    out, vjp = jax.jit(lambda h: jax.vjp(
        lambda h: dropout(h, DROPOUT_RATE, kd), h))(x)
    kept = np.asarray(out != 0)
    frac = float(kept.mean())
    sigma = float(np.sqrt(keep_p * (1 - keep_p) / kept.size))
    check(f"keep fraction {frac:.6f} vs {keep_p} (5 sigma binomial)",
          abs(frac - keep_p), SIGMAS * sigma)
    (dx,) = jax.jit(vjp)(jnp.ones_like(x))
    dx = np.asarray(dx, np.float32)
    check("backward mask vs forward mask (mismatched elements)",
          float(np.sum((dx != 0) != kept)), 0.0)
    scale = np.float32(jnp.bfloat16(1 / keep_p))
    check("backward scale vs 1/keep (max abs)",
          float(np.abs(dx[kept] - scale).max()), 0.0)
    relu_first = jax.jit(lambda h: dropout(jax.nn.relu(h), DROPOUT_RATE, kd))(z)
    relu_last = jax.jit(lambda h: jax.nn.relu(dropout(h, DROPOUT_RATE, kd)))(z)
    check("ReLU commutes with the mask (mismatched elements)",
          float(np.sum(np.asarray(relu_first != relu_last))), 0.0)


def phase_multi(name: str = DATASET, n_dev: int = MULTI_DEVICES,
                epochs: int = MULTI_EPOCHS):
    """fit_parallel on ``n_dev`` devices vs a one-device fit, same seed.
    Dropout is off so every route computes the same function: the mesh
    draws its masks per device, the single-device fit over the whole
    array."""
    import jax

    from parallel_gcn.data.parser import device_dataset, prepare_host_dataset
    from parallel_gcn.parallel.train_parallel import fit_parallel
    from parallel_gcn.train import fit

    if len(jax.devices()) < n_dev:
        raise AssertionError(f"--multi needs {n_dev} devices, "
                             f"have {len(jax.devices())}")
    common = dict(epochs=epochs, early_stopping=0, verbose=False,
                  mode="scan", dropouts=[0.0, 0.0])
    cfg1 = _load(name, **common)
    t0 = time.perf_counter()
    ds = prepare_host_dataset(cfg1, name)
    log(f"[multi] {name}: {ds.n_nodes} nodes, {ds.graph.nnz} nnz, prepared "
        f"in {time.perf_counter() - t0:.1f} s; dropout off, "
        f"compute={cfg1.exec.compute_dtype} epochs={epochs}")
    runs = {}
    for label, over in (
        # halo_fallback off: keep the boundary layout even where its
        # padded slabs are not smaller than the gathered matrix
        ("hybrid/boundary", dict(halo="boundary", halo_fallback=False)),
        ("segment/all_gather", dict(backend="segment", halo="all_gather")),
    ):
        cfg = _load(name, n_devices=n_dev, **over, **common)
        t0 = time.perf_counter()
        res = fit_parallel(cfg, ds)
        runs[label] = res.history[:, 0]
        log(f"  fit_parallel {label} on {n_dev} devices: "
            f"{time.perf_counter() - t0:.1f} s incl. partition + compile; "
            f"losses {runs[label].tolist()}")
        if not np.isfinite(res.history).all():
            raise AssertionError(f"non-finite metrics in {label}")
    peaks = [
        (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        for d in jax.devices()[:n_dev]
    ]
    log(f"  peak bytes per device: {peaks}")
    if min(peaks) < 0.25 * max(peaks):
        raise AssertionError(f"shards not spread over the devices: {peaks}")

    t0 = time.perf_counter()
    single = fit(cfg1, device_dataset(cfg1, ds)).history[:, 0]
    log(f"  single-device fit: {time.perf_counter() - t0:.1f} s; "
        f"losses {single.tolist()}")
    for label, loss in runs.items():
        err = float(np.max(np.abs(loss - single) / np.abs(single)))
        check(f"train loss, {label} vs single device (max relative)", err,
              LOSS_RTOL)


def main(argv: list[str] | None = None) -> int:
    phases = select_phases(sys.argv[1:] if argv is None else argv)
    import jax

    from parallel_gcn.utils.cache import enable_compile_cache
    from parallel_gcn.utils.device import card_line, require_gpu

    try:
        require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, devices: {jax.devices()}")
    enable_compile_cache()
    t_start = time.perf_counter()
    if phases == ["multi"]:
        phase_multi()
        count = MULTI_DEVICES
    else:
        ds, dds, dds_seg = phase_fit()
        check_memory_limit()
        phase_kernels(ds, dds, dds_seg)
        count = 1
    dev = jax.devices()[0]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(result_line({"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices()[:count])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
