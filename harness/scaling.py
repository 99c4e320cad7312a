"""Multi-device scaling harness — measures node-parallel training throughput
across mesh sizes.

The reference is single-GPU (SURVEY.md §2.4); this measures the beyond-
reference scale-out path (parallel/train_parallel.py): epoch time of the
node-partitioned training step for n_devices ∈ {1, 2, 4, ...} with the
all_gather, ring and hybrid-slab halos, and the derived scaling efficiency.
Runs on the devices JAX finds; asking for more is an error.

Usage:
    python harness/scaling.py [dataset] [--epochs N] [--devices 1,2,4]
Writes output/scaling.txt.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from parallel_gcn.config import default_params_path, load_config
from parallel_gcn.data.parser import load_dataset
from parallel_gcn.train import init_model_params
from parallel_gcn.optim import init_adam
from parallel_gcn.parallel.partition import partition_graph, partition_graph_ring
from parallel_gcn.parallel.train_parallel import (
    device_put_sharded_inputs,
    make_mesh,
    make_parallel_epoch_step,
    shard_dataset,
)


def bench_mesh(ds, cfg, n_dev: int, halo: str, epochs: int) -> float:
    import dataclasses as _dc

    if halo == "hybrid":
        # tile-accelerated slabs (all_gather halo) — resolve tile dtype and
        # budget exactly like fit_parallel so the measured configuration is
        # the one the trainer runs
        import numpy as _np

        from parallel_gcn.parallel.partition import partition_graph_hybrid

        cfg = _dc.replace(cfg, exec=_dc.replace(cfg.exec, backend="hybrid"))
        tile_dtype = cfg.exec.tile_dtype
        if tile_dtype == "auto":
            tile_dtype = (
                "float32" if cfg.exec.matmul_precision == "highest" else "bfloat16"
            )
        sgraph = partition_graph_hybrid(
            ds.graph, n_dev, node_pad=cfg.exec.node_pad,
            tile_r=cfg.exec.tile_size, tile_c=cfg.exec.tile_cols,
            tile_dtype=_np.dtype(tile_dtype),
            tile_budget_bytes=cfg.exec.tile_budget_mb * 1024 * 1024,
            min_tile_nnz=cfg.exec.min_tile_nnz or None,
        )
    else:
        part = partition_graph_ring if halo == "ring" else partition_graph
        sgraph = part(ds.graph, n_dev, node_pad=cfg.exec.node_pad)
    mesh = make_mesh(n_dev)
    x, labels, split = shard_dataset(ds, sgraph)
    inputs = device_put_sharded_inputs(mesh, sgraph, x, labels, split)
    counts = {s: int((ds.split == s).sum()) for s in (1, 2, 3)}
    step = make_parallel_epoch_step(cfg, mesh, sgraph, counts)

    key = jax.random.PRNGKey(cfg.exec.seed)
    w = init_model_params(cfg, jax.random.PRNGKey(0), ds.input_dim, ds.output_dim)
    opt = init_adam(w)
    w, opt, key, m = step(w, opt, key, *inputs)  # compile
    np.asarray(m)
    t0 = time.perf_counter()
    for _ in range(epochs):
        w, opt, key, m = step(w, opt, key, *inputs)
    np.asarray(m)
    return (time.perf_counter() - t0) / epochs * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", default="synth-medium")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--devices", default="")
    args = ap.parse_args()

    sizes = [int(s) for s in args.devices.split(",") if s]
    avail = len(jax.devices())
    if sizes and max(sizes) > avail:
        raise SystemExit(f"--devices asks for {max(sizes)}, {avail} attached")
    sizes = sizes or [d for d in (1, 2, 4, 8, 16) if d <= avail]
    platform = jax.default_backend()
    print(f"platform={platform} devices={avail} sizes={sizes}", file=sys.stderr)

    cfg = load_config(default_params_path(args.dataset))
    cfg.train.verbose = False
    cfg.exec.matmul_precision = "default"
    ds = load_dataset(args.dataset, binarize_features=cfg.data.binarize_features)

    os.makedirs("output", exist_ok=True)
    lines = [f"# {args.dataset} on {platform}, {args.epochs} epochs/point"]
    for halo in ("all_gather", "ring", "hybrid"):
        base = None
        for n in sizes:
            ms = bench_mesh(ds, cfg, n, halo, args.epochs)
            base = base or ms * sizes[0]
            eff = base / (ms * n) * 100
            line = f"{halo:10s} n={n:2d} epoch {ms:8.3f} ms  efficiency {eff:5.1f}%"
            print(line)
            lines.append(line)

    with open("output/scaling.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
