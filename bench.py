"""Headline benchmark — prints ONE JSON line.

Metric: per-epoch training time (train fwd+bwd + Adam + full val eval, fused
scan mode, tuned configs) on the GPU, and its speedup over the reference's
published Tesla T4 numbers (report p.12 Table 3 / BASELINE.md). The
per-epoch quantity is exactly what the reference's performance harness
measures (test/performance_gpu.cpp, TMR_TRAIN wraps train_epoch()+eval(2),
src/gcn.cu:363-374).

Datasets default to the configured ones this repository can build without
outside files: synth-reddit (community-structured graph matched to reddit's
published statistics). cora, citeseer and synth-pubmed are selectable by name
where their files are present. Exits nonzero when JAX finds no GPU or any
requested dataset fails.

    python bench.py [dataset ...]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

# the reference's published Tesla T4 epoch times (BASELINE.md), ms
BASELINE_MS = {
    "cora": 0.277,
    "citeseer": 0.325,
    "pubmed": 1.418,
    "reddit": 231.518,
    "synth-pubmed": 1.418,   # real pubmed graph; features synthetic
    "synth-reddit": 231.518,  # statistics-matched graph
}
# Many epochs per run call: the whole run is one fused device program, so a
# longer run amortizes the single host dispatch. The reference likewise
# averages per-epoch time across full runs (test/performance_gpu.cpp).
EPOCHS = {"synth-reddit": 100}
EPOCHS_DEFAULT = 1000
REPS = {"synth-reddit": 5}
REPS_DEFAULT = 9
DATASETS = ["synth-reddit"]
MATMUL_PRECISION = "default"  # f32 matmuls may use TF32; bf16 configs unaffected


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def prepare(name: str, **overrides):
    """(cfg, ds, dds, model) for ``name``'s tuned config in bench mode."""
    from parallel_gcn.config import default_params_path, load_config
    from parallel_gcn.data.parser import prepare_device_dataset
    from parallel_gcn.train import build_model, preaggregate_input

    cfg = load_config(default_params_path(name), overrides)
    cfg.gcn.epochs = EPOCHS.get(name, EPOCHS_DEFAULT)
    cfg.gcn.early_stopping = 0
    cfg.train.verbose = False
    cfg.exec.matmul_precision = MATMUL_PRECISION
    ds, dds = prepare_device_dataset(cfg, name)
    model = build_model(cfg, dds)
    if cfg.exec.input_preagg:
        model, dds = preaggregate_input(model, dds)
    return cfg, ds, dds, model


def time_run(cfg, dds, model, reps: int):
    """Compile + warm one fused run, then time ``reps`` runs. Returns
    (per-epoch seconds list, last run's outputs, compile seconds)."""
    import jax

    from parallel_gcn.optim import init_adam
    from parallel_gcn.train import _make_scan_run, init_model_params

    run = _make_scan_run(model, cfg, dds)
    key = jax.random.PRNGKey(cfg.exec.seed)

    def once():
        w = init_model_params(
            cfg, jax.random.PRNGKey(cfg.exec.seed), dds.input_dim,
            dds.output_dim,
        )
        out = run(w, init_adam(w), key)
        jax.block_until_ready(out)
        return out

    t0 = time.perf_counter()
    out = once()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = once()
        times.append((time.perf_counter() - t0) / cfg.gcn.epochs)
    return times, out, compile_s


def bench_dataset(name: str) -> dict:
    from parallel_gcn.data.parser import TEST
    from parallel_gcn.train import make_eval_fn

    cfg, _, dds, model = prepare(name)
    log(f"[{name}] backend={model.backend} epochs={cfg.gcn.epochs} "
        f"compute={cfg.exec.compute_dtype} precision={cfg.exec.matmul_precision}")
    times, final, compile_s = time_run(cfg, dds, model,
                                       REPS.get(name, REPS_DEFAULT))
    test_fn = make_eval_fn(model, cfg, dds, TEST)
    _, test_acc = (float(v) for v in test_fn(final[0]))
    ms = [t * 1e3 for t in times]
    log(f"[{name}] epoch min {min(ms)} ms (reps {ms}), "
        f"compile+first run {compile_s} s, test_acc={test_acc}")
    return {
        "epoch_ms": min(ms),
        "epoch_ms_reps": ms,
        "test_acc": test_acc,
        "vs_t4": BASELINE_MS[name] / min(ms),
        "backend": model.backend,
        "compute_dtype": cfg.exec.compute_dtype,
        "matmul_precision": cfg.exec.matmul_precision,
    }


def main() -> int:
    from parallel_gcn.utils.cache import enable_compile_cache
    from parallel_gcn.utils.device import card_line, require_gpu

    device = require_gpu()
    card = card_line()
    enable_compile_cache()
    datasets = sys.argv[1:] or list(DATASETS)
    detail = {}
    failed = []
    for name in datasets:
        try:
            detail[name] = bench_dataset(name)
        except Exception as e:  # report every dataset, then fail the run
            log(f"[{name}] FAILED: {type(e).__name__}: {e}")
            failed.append(name)
    speedups = [d["vs_t4"] for d in detail.values()]
    geomean = float(np.exp(np.mean(np.log(speedups)))) if speedups else None
    print(json.dumps({
        "metric": "epoch_speedup_geomean_vs_t4",
        "value": geomean,
        "unit": "x",
        "device": device,
        "card": card,
        "datasets_ok": sorted(detail),
        "datasets_failed": failed,
        "detail": detail,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
