"""Execute the mesh path on one GPU — a 1-device mesh.

A 1-device mesh exercises the entire mesh machinery on the card —
shard_map lowering, the collective ops (degenerate but still lowered), the
slab tile product, sharded buffer layouts — and measures the SHARDING TAX:
fused mesh-epoch time vs the plain fit() epoch, the number that says what
the single-device path would pay for running as a 1-device mesh.

Routes: GCN over hybrid tile slabs under the boundary halo and GAT over the
flat COO partition, on cora and synth-reddit.

Usage:
    python harness/mesh_onechip.py [--epochs N] [--reps N] [--routes r1,r2]
Writes output/mesh_onechip.txt (device-stamped).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from parallel_gcn.config import default_params_path, load_config
from parallel_gcn.data.parser import TRAIN, VAL, prepare_host_dataset
from parallel_gcn.optim import init_adam
from parallel_gcn.train import init_model_params
from parallel_gcn.utils.cache import enable_compile_cache
from parallel_gcn.utils.device import require_gpu

ROUTES = {
    # route -> (dataset, overrides applied to the dataset's tuned config)
    "cora-gcn": ("cora", dict(backend="hybrid")),
    "cora-gat": ("cora", dict(backend="segment", model="gat", heads=2,
                              hidden_dims=(8,), dropouts=(0.1, 0.1))),
    "reddit-gcn": ("synth-reddit", dict()),
    "reddit-gat": ("synth-reddit", dict(backend="segment", model="gat",
                                        heads=2, hidden_dims=(32,),
                                        dropouts=(0.0, 0.1),
                                        edge_chunk=1048576, remat=True)),
}


def build_route(name: str, epochs: int):
    """Mirror fit_parallel's mesh setup exactly (train_parallel.py:1769-1814)
    for a 1-device mesh, returning the FUSED run and its device inputs."""
    from parallel_gcn.parallel.partition import (
        partition_graph, partition_graph_hybrid,
    )
    from parallel_gcn.parallel.train_parallel import (
        device_put_sharded_inputs, make_mesh, make_parallel_run,
        shard_dataset,
    )

    dataset, over = ROUTES[name]
    cfg = load_config(default_params_path(dataset))
    cfg.gcn.epochs = epochs
    cfg.gcn.early_stopping = 0
    cfg.train.verbose = False
    cfg.exec.matmul_precision = "default"
    for k, v in over.items():
        if hasattr(cfg.gcn, k):
            setattr(cfg.gcn, k, v)
        else:
            setattr(cfg.exec, k, v)
    # prepare_host_dataset applies the dataset's tuned reorder, exactly like
    # the CLI path that feeds fit_parallel
    ds = prepare_host_dataset(cfg, dataset)
    tile_dtype = cfg.exec.tile_dtype
    if tile_dtype == "auto":
        tile_dtype = (
            "float32" if cfg.exec.matmul_precision == "highest" else "bfloat16"
        )
    if cfg.exec.backend == "hybrid":
        sgraph = partition_graph_hybrid(
            ds.graph, 1, node_pad=cfg.exec.node_pad,
            tile_r=cfg.exec.tile_size, tile_c=cfg.exec.tile_cols,
            tile_dtype=np.dtype(tile_dtype),
            tile_budget_bytes=cfg.exec.tile_budget_mb * 1024 * 1024,
            min_tile_nnz=cfg.exec.min_tile_nnz or None,
            boundary=True,
            boundary_fallback=cfg.exec.halo_fallback,
        )
    else:
        sgraph = partition_graph(ds.graph, 1, node_pad=cfg.exec.node_pad,
                                 boundary=True,
                                 boundary_fallback=cfg.exec.halo_fallback)
    mesh = make_mesh(1)
    x, labels, split = shard_dataset(ds, sgraph)
    inputs = device_put_sharded_inputs(mesh, sgraph, x, labels, split)
    counts = {s: int((ds.split == s).sum()) for s in (TRAIN, VAL, 3)}
    run = make_parallel_run(cfg, mesh, sgraph, counts)

    def fresh_weights():
        # fresh pytree per call — the fused run DONATES weights/opt buffers
        return init_model_params(cfg, jax.random.PRNGKey(0), ds.input_dim,
                                 ds.output_dim)

    return run, fresh_weights, inputs, cfg


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--reddit-epochs", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--routes", default=",".join(ROUTES))
    args = ap.parse_args()

    require_gpu()
    enable_compile_cache()
    dev = jax.devices()[0]
    rows = []
    for name in args.routes.split(","):
        epochs = args.reddit_epochs if name.startswith("reddit") else args.epochs
        try:
            run, fresh_weights, inputs, cfg = build_route(name, epochs)
            key = jax.random.PRNGKey(cfg.exec.seed)

            def once():
                w = fresh_weights()
                ww, oo, metrics, er = run(
                    w, init_adam(w), key,
                    inputs[0], inputs[0], inputs[1], inputs[2], *inputs[3:],
                )
                m = np.asarray(metrics)
                assert np.isfinite(m[: int(er)]).all(), name
                return m

            once()  # compile
            once()  # warm
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                once()
                times.append((time.perf_counter() - t0) / epochs * 1e3)
            row = {
                "route": name,
                "device": dev.platform,
                "device_kind": getattr(dev, "device_kind", dev.platform),
                "n_devices": 1,
                "halo": "boundary",
                "epoch_ms_min": min(times),
                "epoch_ms_median": float(np.median(times)),
                "reps_ms": [round(t, 4) for t in times],
            }
            print(f"{name:12s} epoch {min(times):9.4f} ms "
                  f"(median {row['epoch_ms_median']:.4f}) on "
                  f"{row['device_kind']}", flush=True)
            rows.append(json.dumps(row))
        except Exception as e:
            print(f"{name:12s} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            rows.append(json.dumps({"route": name, "error": f"{type(e).__name__}: {e}"}))
    os.makedirs("output", exist_ok=True)
    with open("output/mesh_onechip.txt", "w") as f:
        f.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
