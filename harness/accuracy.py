"""Accuracy statistics harness — port of the reference's tuning_accuracy
methodology (test/tuning_accuracy.cpp:156-185): run each config with N random
seeds and report mean/max/sd of the final validation accuracy (plus test
accuracy, which the reference reports separately in Table 5).

Twist: all N seeds train simultaneously via jax.vmap over the fused
whole-run program — 20 seeds cost barely more wall-clock than one.

Usage:
    python harness/accuracy.py [dataset ...] [--seeds N] [--epochs N]
                               [--set key=value ...]
``--set`` applies CLI-style config overrides to every dataset — e.g.
``--set model=gat heads=8 hidden_dims=8 attn_dropout=0.6`` sweeps the GAT
family with the same 20-seed methodology (results then go to
output/accuracy_gat.txt via --tag).
Writes output/accuracy.txt and prints a comparison against the published
numbers (BASELINE.md).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from parallel_gcn.config import default_params_path, load_config
from parallel_gcn.data.parser import TEST, prepare_device_dataset
from parallel_gcn.train import init_model_params
from parallel_gcn.optim import init_adam
from parallel_gcn.train import _make_scan_run, build_model, make_eval_fn, preaggregate_input

# published val-accuracy mean±sd with tuned params (report p.13 Table 4)
PUBLISHED_VAL = {"citeseer": (81.46, 0.495), "cora": (88.42, 0.297), "pubmed": (90.01, 0.314)}
PUBLISHED_TEST = {"citeseer": 80.0, "cora": 87.9, "pubmed": 89.6, "reddit": 26.4}


def run_seeds(dataset: str, n_seeds: int, epochs: int | None, base_seed: int = 0,
              overrides: dict | None = None):
    cfg = load_config(default_params_path(dataset), overrides)
    if epochs:
        cfg.gcn.epochs = epochs
    cfg.train.verbose = False
    cfg.exec.matmul_precision = "default"

    ds, dds = prepare_device_dataset(cfg, dataset)
    model = build_model(cfg, dds)
    if cfg.exec.input_preagg:
        model, dds = preaggregate_input(model, dds)
    run = _make_scan_run(model, cfg, dds)
    test_fn = make_eval_fn(model, cfg, dds, TEST)

    seeds = jnp.arange(base_seed, base_seed + n_seeds)
    init_keys = jax.vmap(jax.random.PRNGKey)(seeds)
    run_keys = jax.vmap(jax.random.PRNGKey)(seeds + 10_000)

    def one(init_key, run_key):
        w = init_model_params(cfg, init_key, dds.input_dim, dds.output_dim)
        opt = init_adam(w)
        weights, _, metrics, epochs_run = run(w, opt, run_key)
        test_loss, test_acc = test_fn(weights)
        # final val accuracy = the last recorded epoch's val_acc
        final = metrics[jnp.maximum(epochs_run - 1, 0)]
        return final[3], test_acc, epochs_run

    t0 = time.time()
    val_accs, test_accs, epochs_run = jax.vmap(one)(init_keys, run_keys)
    val_accs = np.asarray(val_accs)
    test_accs = np.asarray(test_accs)
    epochs_run = np.asarray(epochs_run)
    elapsed = time.time() - t0
    return {
        "dataset": dataset,
        "n_seeds": n_seeds,
        "val_mean": float(val_accs.mean() * 100),
        "val_max": float(val_accs.max() * 100),
        "val_sd": float(val_accs.std(ddof=1) * 100) if n_seeds > 1 else 0.0,
        "test_mean": float(test_accs.mean() * 100),
        "test_max": float(test_accs.max() * 100),
        "epochs_mean": float(epochs_run.mean()),
        "elapsed_s": elapsed,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="config overrides applied to every dataset")
    ap.add_argument("--tag", default="",
                    help="suffix for the output file name")
    args = ap.parse_args()
    from parallel_gcn.config import parse_override

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_override(v)
    # accuracy statistics only mean something on real data: cora + citeseer
    # (pubmed/reddit features are unshipped blobs; see data/synthetic.py)
    datasets = args.datasets or ["cora", "citeseer"]

    os.makedirs("output", exist_ok=True)
    rows = []
    for name in datasets:
        try:
            r = run_seeds(name, args.seeds, args.epochs, overrides=overrides)
        except FileNotFoundError:
            print(f"[{name}] dataset unavailable, skipping", file=sys.stderr)
            continue
        pub_v = PUBLISHED_VAL.get(name)
        pub_t = PUBLISHED_TEST.get(name)
        line = (
            f"{name:10s} val {r['val_mean']:.2f}±{r['val_sd']:.3f} (max {r['val_max']:.2f}) "
            f"test {r['test_mean']:.2f} (max {r['test_max']:.2f}) "
            f"epochs~{r['epochs_mean']:.0f} [{r['n_seeds']} seeds, {r['elapsed_s']:.1f}s]"
        )
        if pub_v:
            line += f"  | published val {pub_v[0]}±{pub_v[1]}"
        if pub_t:
            line += f", test {pub_t}"
        print(line)
        rows.append(line)

    out = f"output/accuracy{('_' + args.tag) if args.tag else ''}.txt"
    with open(out, "w") as f:
        f.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
