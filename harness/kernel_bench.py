"""Aggregation and dropout routes on the GPU at synth-reddit's shapes.

Times, on one card and in one process:

* the aggregation ``Â·x`` at the bench's widths (F = 82, the stacked
  train+eval pass, and F = 41) by every route: the Pallas-Triton tile kernel
  (the GPU's tile product) and the plain-XLA tile product, each alone and
  with the COO residual (backend=hybrid), gather + segment_sum over the
  complete COO (backend=segment), and cuSPARSE CSR through
  ``jax.experimental.sparse`` (f32; it has no bf16 lowering); plus the
  kernel's block sizes;
* ReLU ⊗ dropout over the [N × 600] hidden activation, forward and
  forward+backward: the counter hash (ops/dropout.py) against
  ``jax.random`` threefry;
* end to end: bench.py's synth-reddit ms/epoch for the default path and with
  one route swapped at a time, plus a device-op profile of 10 fused epochs.

Each per-op number is the median host time of ``--reps`` calls ending in
``block_until_ready`` and the device time summed from a profiler trace.

    python harness/kernel_bench.py [--reps N] [--out chiprun_out/kernel_bench.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from parallel_gcn.utils.cache import enable_compile_cache
from parallel_gcn.utils.device import card_line, require_gpu
from parallel_gcn.utils.profiling import (
    device_op_events,
    print_trace_summary,
    profile_fn,
)

DATASET = "synth-reddit"
RATE = 0.1  # synth-reddit's hidden dropout


def log(*a):
    print(*a, flush=True)


def time_op(fn, args, reps):
    """(median host ms, device ms per call, compile+first s)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    n_tr = 5

    def traced():
        out = None
        for _ in range(n_tr):
            out = fn(*args)
        return jax.block_until_ready(out)

    _, tdir = profile_fn(traced)
    dev_ns = sum(d for _, d in device_op_events(tdir))
    return float(np.median(ts)), dev_ns / 1e6 / n_tr, first


def _record(results, tag, fn, args, reps, ref=None, n=None):
    try:
        host, dev, first = time_op(fn, args, reps)
        err = None
        if ref is not None:
            out = np.asarray(fn(*args), np.float32)[:n]
            err = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
        log(f"{tag}: host {host:.4f} ms, device {dev:.4f} ms, "
            f"first call {first:.1f} s, rel err vs segment {err}")
        results[tag] = dict(host_ms=host, device_ms=dev, first_s=first,
                            relerr=err)
    except Exception as e:  # a route that fails is a finding
        log(f"{tag}: FAILED {type(e).__name__}: {str(e)[:400]}")
        results[tag] = dict(error=f"{type(e).__name__}: {str(e)[:400]}")


def aggregation_routes(dds, dds_seg, reps, results):
    from jax.experimental import sparse

    import parallel_gcn.ops.bcsr as bcsr_mod
    from parallel_gcn.ops.bcsr import tile_product
    from parallel_gcn.ops.bcsr_triton import tile_product_triton
    from parallel_gcn.ops.graphsum import graphsum

    g, gs = dds.graph, dds_seg.graph
    b = g.bcsr
    n_pad = g.n_nodes
    indptr = np.zeros(gs.n_nodes + 1, np.int64)
    row = np.asarray(gs.row)
    live = np.asarray(gs.val) != 0
    np.add.at(indptr, row[live] + 1, 1)
    indptr = jnp.asarray(np.cumsum(indptr).astype(np.int32))
    col_l = jnp.asarray(np.asarray(gs.col)[live])
    val_l = jnp.asarray(np.asarray(gs.val)[live])
    tile_bytes = b.tiles.size * b.tiles.dtype.itemsize
    log(f"[agg] tiles {b.n_tiles} x {b.tiles.shape[1:]} {b.tiles.dtype} "
        f"({tile_bytes / 1e9:.3f} GB), residual {g.row.shape[0]} edges, "
        f"complete COO {int(live.sum())} edges, n_pad {n_pad}")
    results["agg_shapes"] = dict(
        n_tiles=int(b.n_tiles), tile=list(b.tiles.shape[1:]),
        tile_bytes=int(tile_bytes), residual_edges=int(g.row.shape[0]),
        coo_edges=int(live.sum()), n_pad=int(n_pad),
    )

    @partial(jax.jit, static_argnames=("impl", "kw"))
    def tiles(x, b, impl, kw=()):
        fn = {"xla": tile_product, "triton": tile_product_triton}[impl]
        return fn(b.tiles, b.tile_rows, b.tile_cols, x, b.n_nodes,
                  b.sym_scale, **dict(kw))

    @partial(jax.jit, static_argnames=("backend",))
    def agg(x, g, backend):
        return graphsum(x, g, backend=backend, precision="default")

    def hybrid_xla(x, g):
        orig = bcsr_mod.tile_product_triton
        bcsr_mod.tile_product_triton = bcsr_mod.tile_product
        try:
            return agg_x(x, g)
        finally:
            bcsr_mod.tile_product_triton = orig

    agg_x = jax.jit(lambda x, g: graphsum(x, g, backend="hybrid",
                                          precision="default"))

    @partial(jax.jit, static_argnums=(4,))
    def cusparse(x, val, col, ptr, n):
        a = sparse.CSR((val.astype(x.dtype), col, ptr), shape=(n, n))
        return a @ x

    key = jax.random.PRNGKey(0)
    for f in (82, 41):
        for dtype in ("bfloat16", "float32"):
            x = jax.random.normal(key, (n_pad, f)).astype(dtype)
            xs = x[: gs.n_nodes]
            ref = np.asarray(agg(xs, gs, "segment"), np.float32)
            n = gs.n_nodes
            pre = f"agg F={f} {dtype}"
            _record(results, f"{pre} tiles_triton",
                    partial(tiles, impl="triton"), (x, b), reps)
            _record(results, f"{pre} tiles_xla",
                    partial(tiles, impl="xla"), (x, b), reps)
            _record(results, f"{pre} hybrid (triton tiles)",
                    partial(agg, backend="hybrid"), (x, g), reps, ref, n)
            _record(results, f"{pre} hybrid (xla tiles)", hybrid_xla, (x, g),
                    reps, ref, n)
            _record(results, f"{pre} segment",
                    partial(agg, backend="segment"), (xs, gs), reps)
            if dtype == "float32":
                _record(results, f"{pre} cusparse_csr", cusparse,
                        (xs, val_l, col_l, indptr, gs.n_nodes), reps, ref, n)
        x = jax.random.normal(key, (n_pad, f)).astype("bfloat16")
        for bm, bk, stages in ((64, 64, 3), (128, 64, 3), (64, 128, 3),
                               (32, 64, 3), (64, 32, 3), (64, 64, 2),
                               (64, 64, 4), (128, 128, 2)):
            kw = (("block_m", bm), ("block_k", bk), ("num_stages", stages))
            _record(results, f"agg F={f} bfloat16 tiles_triton bm={bm} "
                    f"bk={bk} stages={stages}", partial(tiles, impl="triton",
                                                        kw=kw), (x, b), reps)


def dropout_routes(n, reps, results):
    from parallel_gcn.ops.dropout import dropout

    keep = 1.0 - RATE
    key = jax.random.PRNGKey(1)
    x = jax.random.normal(key, (n, 600), jnp.bfloat16)
    c = jax.random.normal(jax.random.PRNGKey(2), (n, 600), jnp.bfloat16)

    def threefry(h, k):
        m = jax.random.bernoulli(k, keep, h.shape)
        return jnp.where(m, jax.nn.relu(h) / jnp.asarray(keep, h.dtype), 0)

    def hashed(h, k):
        return dropout(jax.nn.relu(h), RATE, k)

    for name, f in (("threefry", threefry), ("hash_xla", hashed)):
        fwd = jax.jit(f)
        fb = jax.jit(jax.grad(
            lambda h, k, f=f: jnp.sum((f(h, k) * c).astype(jnp.float32))))
        for mode, fn in (("fwd", fwd), ("fwd+bwd", fb)):
            _record(results, f"dropout [{n}x600] bf16 {name} {mode}", fn,
                    (x, key), reps)


def end_to_end(cfg, ds, dds, model, results):
    import dataclasses

    import parallel_gcn.models.gcn as gcn_mod
    import parallel_gcn.ops.bcsr as bcsr_mod
    from parallel_gcn.data.parser import device_dataset
    from parallel_gcn.train import build_model, preaggregate_input

    reps = bench.REPS[DATASET]

    def run(label):
        try:
            times, out, first = bench.time_run(cfg, dds_v, model_v, reps)
        except Exception as e:  # a route that fails is a finding
            log(f"[e2e] {label}: FAILED {type(e).__name__}: {str(e)[:400]}")
            results[f"e2e {label}"] = dict(error=str(e)[:400])
            return
        ms = [t * 1e3 for t in times]
        hist = np.asarray(out[2])
        log(f"[e2e] {label}: ms/epoch min {min(ms):.4f} median "
            f"{np.median(ms):.4f} reps {ms}; compile+first {first:.1f} s; "
            f"final train loss {hist[-1, 0]:.5f} val acc {hist[-1, 3]:.4f}")
        results[f"e2e {label}"] = dict(ms_min=min(ms), ms_median=float(
            np.median(ms)), reps_ms=ms, first_s=first,
            final_train_loss=float(hist[-1, 0]), final_val_acc=float(
                hist[-1, 3]))

    dds_v, model_v = dds, model
    run("default (hybrid, Triton tile kernel, hash dropout)")

    orig_triton = bcsr_mod.tile_product_triton
    bcsr_mod.tile_product_triton = bcsr_mod.tile_product
    try:
        run("hybrid, plain-XLA tile product")
    finally:
        bcsr_mod.tile_product_triton = orig_triton

    orig_dropout = gcn_mod.dropout

    def threefry(h, rate, key, training=True):
        if not training or rate <= 0:
            return h
        m = jax.random.bernoulli(key, 1 - rate, h.shape)
        return jnp.where(m, h / jnp.asarray(1 - rate, h.dtype), 0)

    gcn_mod.dropout = threefry
    try:
        run("hybrid, threefry dropout")
    finally:
        gcn_mod.dropout = orig_dropout

    cfg_seg = dataclasses.replace(
        cfg, exec=dataclasses.replace(cfg.exec, backend="segment"))
    dds_seg = device_dataset(cfg_seg, ds)
    model_seg = build_model(cfg_seg, dds_seg)
    model_seg, dds_seg_pre = preaggregate_input(model_seg, dds_seg)
    dds_v, model_v = dds_seg_pre, model_seg
    run("segment (complete COO), hash dropout")
    return dds_seg, dds_seg_pre, model_seg


def profile_runs(cfg, dds, model, label, results):
    import dataclasses

    from parallel_gcn.optim import init_adam
    from parallel_gcn.train import _make_scan_run, init_model_params

    c10 = dataclasses.replace(cfg, gcn=dataclasses.replace(cfg.gcn, epochs=10))
    run = _make_scan_run(model, c10, dds)
    key = jax.random.PRNGKey(0)

    def fresh():
        w = init_model_params(c10, key, dds.input_dim, dds.output_dim)
        return w, init_adam(w)

    w, o = fresh()
    jax.block_until_ready(run(w, o, key))
    w, o = fresh()
    _, tdir = profile_fn(lambda: run(w, o, key))
    total = sum(d for _, d in device_op_events(tdir)) / 1e6 / 10
    log(f"[profile] {label}: device busy {total:.4f} ms/epoch; top ops over "
        "10 epochs:")
    print_trace_summary(tdir, top=15)
    results[f"profile {label} device_ms_per_epoch"] = total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/kernel_bench.json")
    args = ap.parse_args()
    info = require_gpu()
    card = card_line()
    log(f"card: {card}; device {info}")
    enable_compile_cache()
    results = {"card": card, "device": info}

    t0 = time.perf_counter()
    cfg, ds, dds, model = bench.prepare(DATASET)
    log(f"[setup] {DATASET} prepared in {time.perf_counter() - t0:.1f} s "
        f"(backend={model.backend}, compute={cfg.exec.compute_dtype}, "
        f"precision={cfg.exec.matmul_precision})")
    dds_seg, dds_seg_pre, model_seg = end_to_end(cfg, ds, dds, model, results)
    profile_runs(cfg, dds, model, "default hybrid", results)
    profile_runs(cfg, dds_seg_pre, model_seg, "segment", results)
    aggregation_routes(dds, dds_seg, args.reps, results)
    dropout_routes(ds.n_nodes, args.reps, results)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
