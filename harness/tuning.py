"""Hyperparameter tuning harness — port of the reference's tuning_accuracy
sweep (test/tuning_accuracy.cpp): grid over layers × hidden dims × dropouts ×
weight decay, each config scored as mean val accuracy over N seeds (seeds run
in parallel on-device via vmap, see harness/accuracy.py).

The reference's coarse grid (:56-60) and refined -DSECOND grid (:63-83) become
runtime presets. Results go to output/tuning_<dataset>.txt sorted by mean
val acc
(the job of script/ordering.py in the reference).

Usage:
    python harness/tuning.py <dataset> [--preset coarse|fine] [--seeds N]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from parallel_gcn.config import default_params_path, load_config
from parallel_gcn.data.parser import prepare_device_dataset
from parallel_gcn.train import init_model_params
from parallel_gcn.optim import init_adam
from parallel_gcn.train import _make_scan_run, build_model

# reference grids (test/tuning_accuracy.cpp:56-83), trimmed to fit a round
PRESETS = {
    "coarse": {
        "n_layers": [2, 3],
        "hidden": [8, 16, 32, 64],
        "dropout": [0.2, 0.5],
        "wd": [5e-3, 5e-4, 5e-5],
    },
    "fine": {
        "n_layers": [2],
        "hidden": [16, 32, 48, 72, 96],
        "dropout": [0.0, 0.2, 0.4, 0.6],
        "wd": [5e-4, 1e-4, 5e-5],
    },
}


def sweep(dataset: str, preset: str, seeds: int, epochs: int):
    import dataclasses

    from parallel_gcn.ops.graphsum import graphsum

    base = load_config(default_params_path(dataset))
    base.exec.matmul_precision = "default"
    ds, dds = prepare_device_dataset(base, dataset)

    # Â·X is config-independent — compute it ONCE for the whole sweep instead
    # of once per grid point inside preaggregate_input
    base_model = build_model(base, dds)
    x_agg_once = jax.jit(
        lambda x, g: graphsum(
            x, g, backend=base_model.backend,
            edge_chunk=base_model.edge_chunk,
            dense_threshold=base_model.dense_threshold,
            precision=base_model.precision,
        )
    )(dds.x, dds.graph)

    grid = PRESETS[preset]
    results = []
    for n_layers, hidden, dropout, wd in itertools.product(
        grid["n_layers"], grid["hidden"], grid["dropout"], grid["wd"]
    ):
        cfg = load_config(default_params_path(dataset))
        cfg.gcn.n_layers = n_layers
        cfg.gcn.hidden_dims = (hidden,) * (n_layers - 1)
        cfg.gcn.dropouts = (dropout,) * n_layers
        cfg.gcn.epochs = epochs
        cfg.adam.weight_decay = wd
        cfg.exec.matmul_precision = "default"
        cfg.train.verbose = False
        model = build_model(cfg, dds)
        # keep the shared ``dds`` pristine (a dropout-0 config swaps x for Â·X)
        # and reuse the sweep-wide Â·X instead of recomputing it per config
        cfg_model, cfg_dds = model, dds
        if cfg.exec.input_preagg:
            if model.dropouts[0] == 0.0:
                cfg_model = dataclasses.replace(model, input_preagg=True)
                cfg_dds = dataclasses.replace(dds, x=x_agg_once)
            else:
                cfg_dds = dataclasses.replace(dds, x_agg=x_agg_once)
        run = _make_scan_run(cfg_model, cfg, cfg_dds)

        init_keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seeds))
        run_keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seeds) + 10_000)

        def one(ik, rk):
            w = init_model_params(cfg, ik, cfg_dds.input_dim, cfg_dds.output_dim)
            weights, _, metrics, epochs_run = run(w, init_adam(w), rk)
            return metrics[jnp.maximum(epochs_run - 1, 0)][3]

        val = np.asarray(jax.vmap(one)(init_keys, run_keys))
        row = {
            "n_layers": n_layers, "hidden": hidden, "dropout": dropout, "wd": wd,
            "val_mean": float(val.mean() * 100),
            "val_max": float(val.max() * 100),
            "val_sd": float(val.std(ddof=1) * 100) if seeds > 1 else 0.0,
        }
        print(
            f"L={n_layers} H={hidden:3d} D={dropout} wd={wd:g}: "
            f"val {row['val_mean']:.2f}±{row['val_sd']:.3f} (max {row['val_max']:.2f})",
            flush=True,
        )
        results.append(row)

    results.sort(key=lambda r: -r["val_mean"])
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--preset", choices=list(PRESETS), default="coarse")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=400)
    args = ap.parse_args()

    results = sweep(args.dataset, args.preset, args.seeds, args.epochs)
    os.makedirs("output", exist_ok=True)
    with open(f"output/tuning_{args.dataset}.txt", "w") as f:
        for r in results:
            f.write(
                f"{r['val_mean']:.3f} {r['val_sd']:.3f} {r['val_max']:.3f} "
                f"L={r['n_layers']} H={r['hidden']} D={r['dropout']} wd={r['wd']:g}\n"
            )
    best = results[0]
    print(f"\nbest: L={best['n_layers']} H={best['hidden']} D={best['dropout']} "
          f"wd={best['wd']:g} → val {best['val_mean']:.2f}±{best['val_sd']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
