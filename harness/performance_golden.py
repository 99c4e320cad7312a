"""Sequential golden-model timing — the analog of the reference's
performance_cpu harness (test/performance_cpu.cpp: averaged epoch time of the
single-threaded CPU baseline, the denominator of the published speedups).

Times the pure-NumPy golden path (parallel_gcn/golden.py — the semantic
oracle every op is tested against) for one full train epoch (forward + full
hand-written backward + Adam) per dataset, and reports our GPU epoch time's
speedup over it, next to the reference's published GPU-vs-CPU speedups
(report p.12 Table 3: 18.0-42.4x).

Usage:
    python harness/performance_golden.py [dataset ...] [--epochs N]
Writes output/performance_golden.txt.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from parallel_gcn.config import default_params_path, load_config
from parallel_gcn.data.parser import load_dataset
from parallel_gcn.golden import (
    GoldenAdamState,
    glorot_range,
    golden_adam_step,
    golden_grads,
)

REFERENCE_CPU_MS = {
    "cora": 5.002, "citeseer": 7.291, "pubmed": 49.827, "reddit": 9826.111,
    "synth-pubmed": 49.827, "synth-reddit": 9826.111,
}


def bench_golden(dataset: str, epochs: int) -> dict:
    cfg = load_config(default_params_path(dataset))
    ds = load_dataset(dataset, binarize_features=cfg.data.binarize_features)
    rng = np.random.default_rng(0)
    dims = [ds.input_dim, *cfg.gcn.hidden_dims, ds.output_dim]
    weights = [
        rng.uniform(-glorot_range(a, b), glorot_range(a, b), (a, b)).astype(np.float32)
        for a, b in zip(dims[:-1], dims[1:])
    ]
    state = GoldenAdamState(
        m=[np.zeros_like(w) for w in weights],
        v=[np.zeros_like(w) for w in weights],
    )
    mask = ds.split == 1
    decay_flags = [True] + [False] * (len(weights) - 1)
    a = cfg.adam

    # the timed epoch includes the dropout multiplies and residual adds the
    # dataset's config actually trains with (the sequential reference applies
    # dropout per layer too, hpdga-spring23/src/module.cpp) — omitting them
    # would make the golden denominator systematically cheaper
    dropouts = list(cfg.gcn.dropouts)
    keep_probs = [1.0 - d for d in dropouts]

    def epoch():
        masks = [
            (rng.random((ds.n_nodes, dims[i])) < keep_probs[i]).astype(np.float32)
            if dropouts[i] > 0 else None
            for i in range(len(weights))
        ]
        grads, _ = golden_grads(
            weights, ds.features, ds.graph, ds.labels, mask,
            dropout_masks=masks, keep_probs=keep_probs,
            residual=cfg.gcn.residual,
        )
        golden_adam_step(
            weights, grads, state, a.learning_rate, a.weight_decay,
            a.beta1, a.beta2, a.eps, decay_flags,
        )

    epoch()  # warm numpy caches
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        epoch()
        times.append(time.perf_counter() - t0)
    ms = float(np.mean(times) * 1e3)
    return {"dataset": dataset, "golden_epoch_ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    datasets = args.datasets or ["cora", "citeseer", "synth-pubmed"]

    os.makedirs("output", exist_ok=True)
    lines = []
    for name in datasets:
        try:
            r = bench_golden(name, args.epochs)
        except FileNotFoundError:
            print(f"[{name}] dataset unavailable, skipping", file=sys.stderr)
            continue
        ref = REFERENCE_CPU_MS.get(name)
        # note: the golden path is the dense-math ORACLE (correctness spec),
        # not an optimized CPU implementation — compare GPU numbers against
        # the reference's own published CPU/GPU baselines (BASELINE.md)
        line = f"{name:14s} golden-oracle epoch {r['golden_epoch_ms']:.2f} ms"
        if ref:
            line += f" (reference's optimized CPU baseline: {ref} ms)"
        print(line)
        lines.append(line)

    with open("output/performance_golden.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
