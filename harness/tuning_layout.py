"""Execution-layout tuning harness — the analog of the reference's
tuning_cuda sweep (test/tuning_cuda.cpp: grid search over blocks-factor ×
thread counts per dataset).

Here the knobs are not launch geometry but the aggregation backend, the node
reordering, and the block-sparse tile size/budget. This sweeps them for one
dataset, measures fused-run epoch time on the GPU,
and writes output/tuning_layout_<dataset>.txt sorted fastest-first — the numbers
that justify each parameters/parameters_<dataset>.txt layout choice.

Usage:
    python harness/tuning_layout.py <dataset> [--epochs N] [--reps N]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from parallel_gcn.config import default_params_path, load_config
from parallel_gcn.data.parser import prepare_device_dataset
from parallel_gcn.train import init_model_params
from parallel_gcn.optim import init_adam
from parallel_gcn.train import _make_scan_run, build_model, preaggregate_input

# (backend, reorder, tile_size, tile_cols multiplier); tile knobs are ignored
# outside bcsr/hybrid
GRID = {
    "backend": ["dense", "segment", "hybrid"],
    "reorder": ["none", "rcm", "community"],
    "tile_size": [128, 256, 512],
    "cols_mult": [1, 2, 4],  # tile_cols = tile_size * mult (wide tiles)
}


def time_layout(dataset: str, backend: str, reorder: str, tile: int,
                epochs: int, reps: int, tile_cols: int = 0,
                tile_dtype: str = "auto",
                min_tile_nnz: int | None = None,
                adj_dtype: str = "auto") -> float | None:
    cfg = load_config(default_params_path(dataset))
    cfg.gcn.epochs = epochs
    cfg.gcn.early_stopping = 0
    cfg.train.verbose = False
    cfg.exec.matmul_precision = "default"
    cfg.exec.backend = backend
    cfg.exec.reorder = reorder
    cfg.exec.tile_size = tile
    cfg.exec.tile_cols = tile_cols
    cfg.exec.tile_dtype = tile_dtype
    cfg.exec.adj_dtype = adj_dtype
    if min_tile_nnz is not None:
        cfg.exec.min_tile_nnz = min_tile_nnz
    try:
        ds, dds = prepare_device_dataset(cfg, dataset)
        model = build_model(cfg, dds)
        if cfg.exec.input_preagg:
            model, dds = preaggregate_input(model, dds)
        run = _make_scan_run(model, cfg, dds)
        key = jax.random.PRNGKey(cfg.exec.seed)

        def once():
            w = init_model_params(
                cfg, jax.random.PRNGKey(cfg.exec.seed), dds.input_dim,
                dds.output_dim,
            )
            out = run(w, init_adam(w), key)
            np.asarray(out[2])

        once()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            once()
            times.append((time.perf_counter() - t0) / epochs * 1e3)
        return min(times)
    except Exception as e:  # OOM / unsupported combo: record and move on
        print(f"  {backend}/{reorder}/t{tile}: failed ({type(e).__name__})",
              file=sys.stderr, flush=True)
        return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backends", default="", help="comma filter, e.g. hybrid")
    ap.add_argument("--reorders", default="", help="comma filter, e.g. rcm")
    ap.add_argument("--tiles", default="",
                    help="comma filter on tile_size, e.g. 512 (bounds the "
                    "grid at products scale where each config costs minutes "
                    "of pack building)")
    ap.add_argument("--mults", default="",
                    help="comma filter on the tile_cols multiplier, e.g. 2,4")
    ap.add_argument("--tile-dtypes", default="auto",
                    help="comma list for tile backends, e.g. auto,int8")
    ap.add_argument("--adj-dtypes", default="auto",
                    help="comma list for the dense backend, e.g. "
                    "auto,int8 (int8 = exact 0/1 pattern + outside "
                    "d-scaling, half the Â bytes)")
    ap.add_argument("--min-nnz", default="",
                    help="comma list of min_tile_nnz thresholds to sweep "
                    "jointly with the tile shape (tile/residual break-even; "
                    "empty = the dataset config's value)")
    args = ap.parse_args()
    nnz_list = ([int(v) for v in args.min_nnz.split(",")]
                if args.min_nnz else [None])
    grid = dict(GRID)
    if args.backends:
        known = ("dense", "segment", "bcsr", "hybrid")
        requested = args.backends.split(",")
        unknown = [b for b in requested if b not in known]
        if unknown:
            print(f"unknown backend(s) {unknown}; choose from {known}",
                  file=sys.stderr)
            return 2
        # honor the request directly — bcsr is sweepable even though the
        # default grid omits it (a full-coverage pack is oversized at reddit
        # scale, but citation graphs sweep fine)
        grid["backend"] = requested
    if args.reorders:
        grid["reorder"] = [r for r in grid["reorder"] if r in args.reorders.split(",")]
    if args.tiles:
        grid["tile_size"] = [int(t) for t in args.tiles.split(",")]
    if args.mults:
        grid["cols_mult"] = [int(m) for m in args.mults.split(",")]

    rows = []
    seen = set()
    for backend, reorder, tile, mult, tdt, nnz, adt in itertools.product(
        grid["backend"], grid["reorder"], grid["tile_size"], grid["cols_mult"],
        args.tile_dtypes.split(","), nnz_list, args.adj_dtypes.split(","),
    ):
        tile_cols = tile * mult
        # tile knobs only matter for tile-based backends, adj_dtype only for
        # dense — dedupe the rest
        tiled = backend in ("bcsr", "hybrid")
        dense = backend == "dense"
        key = (backend, reorder, tile if tiled else 0, tile_cols if tiled else 0,
               tdt if tiled else "auto", nnz if tiled else None,
               adt if dense else "auto")
        if key in seen:
            continue
        seen.add(key)
        ms = time_layout(args.dataset, backend, reorder, tile,
                         args.epochs, args.reps, tile_cols=tile_cols,
                         tile_dtype=tdt if tiled else "auto",
                         min_tile_nnz=nnz if tiled else None,
                         adj_dtype=adt if dense else "auto")
        if ms is None:
            continue
        label = f"{backend}/{reorder}" + (
            f"/t{tile}x{tile_cols}/{tdt}" if tiled else ""
        ) + (f"/nnz{nnz}" if tiled and nnz is not None else "") + (
            f"/adj-{adt}" if dense and adt != "auto" else ""
        )
        print(f"{args.dataset} {label:24s} epoch {ms:.4f} ms", flush=True)
        rows.append((ms, label))

    rows.sort()
    os.makedirs("output", exist_ok=True)
    with open(f"output/tuning_layout_{args.dataset}.txt", "w") as f:
        for ms, label in rows:
            f.write(f"{ms:.4f} {args.dataset} {label}\n")
    if rows:
        print(f"\nbest: {rows[0][1]} at {rows[0][0]:.4f} ms/epoch")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
