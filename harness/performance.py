"""Performance harness — port of the reference's performance_gpu methodology
(test/performance_gpu.cpp): average epoch time per dataset with fixed
hyperparameters, many repetitions, written to an output file and compared
against the published baselines (BASELINE.md).

The reference runs 200 separate 100-epoch trainings per dataset (20 for
reddit); here each repetition is a fused on-device run, so a handful of reps
gives tighter numbers than 200 host-driven loops would.

Usage:
    python harness/performance.py [dataset ...] [--epochs N] [--reps N]
Writes output/performance.txt.
"""

from __future__ import annotations

import argparse
import json
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
from parallel_gcn.utils.cache import enable_compile_cache
from parallel_gcn.utils.device import require_gpu

BASELINE_GPU_MS = {"cora": 0.277, "citeseer": 0.325, "pubmed": 1.418, "reddit": 231.518}
BASELINE_CPU_MS = {"cora": 5.002, "citeseer": 7.291, "pubmed": 49.827, "reddit": 9826.111}
# synth-reddit matches reddit's published size statistics (SURVEY.md §6);
# synth-pubmed runs the REAL pubmed graph+split with synthetic features
# (the .svmlight blob is not shipped). Comparisons against the reference's
# numbers are like-for-like in FLOPs/edges, not dataset-identical.
BASELINE_GPU_MS["synth-reddit"] = BASELINE_GPU_MS["reddit"]
BASELINE_CPU_MS["synth-reddit"] = BASELINE_CPU_MS["reddit"]
BASELINE_GPU_MS["synth-pubmed"] = BASELINE_GPU_MS["pubmed"]
BASELINE_CPU_MS["synth-pubmed"] = BASELINE_CPU_MS["pubmed"]


def bench(dataset: str, epochs: int, reps: int) -> dict:
    cfg = load_config(default_params_path(dataset))
    cfg.gcn.epochs = epochs
    cfg.gcn.early_stopping = 0
    cfg.train.verbose = False
    cfg.exec.matmul_precision = "default"

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
        opt = init_adam(w)
        out = run(w, opt, key)
        np.asarray(out[2])  # device barrier
        return out

    once()  # compile
    once()  # warm: the first post-compile run is not epoch time
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append((time.perf_counter() - t0) / epochs * 1e3)
    edges = ds.graph.nnz
    best = min(times)
    dev = jax.devices()[0]
    return {
        "dataset": dataset,
        "backend": model.backend,
        # measurement provenance: an epoch time is indistinguishable from a
        # regression unless the row says what it ran on
        "device": dev.platform,
        "device_kind": getattr(dev, "device_kind", dev.platform),
        "epoch_ms_min": best,
        # median, not mean: one cold/GC outlier rep must not dominate the row
        "epoch_ms_median": float(np.median(times)),
        "epoch_ms_sd": float(np.std(times)),
        "reps_ms": [round(t, 4) for t in times],
        "edges_per_s": edges / (best / 1e3),
        # datasets without published baselines (e.g. synth-medium) report null
        "vs_gpu_baseline": (
            BASELINE_GPU_MS[dataset] / best if dataset in BASELINE_GPU_MS else None
        ),
        "vs_cpu_baseline": (
            BASELINE_CPU_MS[dataset] / best if dataset in BASELINE_CPU_MS else None
        ),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    out_path = "output/performance.txt"
    # pubmed/reddit blobs ship separately and are absent here; synth-pubmed
    # (real graph, synthetic features) and synth-reddit (statistics-matched
    # graph) are the stand-ins (data/synthetic.py)
    datasets = args.datasets or [
        "cora", "citeseer", "pubmed", "reddit", "synth-pubmed", "synth-reddit",
    ]

    os.makedirs("output", exist_ok=True)
    rows = []
    for name in datasets:
        try:
            r = bench(name, args.epochs, args.reps)
        except FileNotFoundError:
            print(f"[{name}] dataset unavailable, skipping", file=sys.stderr)
            continue
        line = (
            f"{name:10s} backend={r['backend']:8s} "
            f"epoch {r['epoch_ms_min']:.4f} ms (median {r['epoch_ms_median']:.4f}±{r['epoch_ms_sd']:.4f}) "
            f"{r['edges_per_s'] / 1e6:.1f} Medge/s "
            + (
                f"| {r['vs_gpu_baseline']:.2f}x T4, "
                f"{r['vs_cpu_baseline']:.0f}x CPU baseline"
                if r["vs_gpu_baseline"] is not None
                else "| (no published baseline)"
            )
        )
        print(line)
        rows.append(json.dumps(r))

    with open(out_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
