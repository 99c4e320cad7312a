"""Profiling harness — capture a device trace of one training epoch and print
the per-op cost table (the analog of the reference's `nsys profile` workflow,
SURVEY.md §5.1).

Usage:
    python harness/profile.py <dataset> [--top N] [--keep-trace DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from parallel_gcn.config import default_params_path, load_config
from parallel_gcn.data.parser import prepare_device_dataset
from parallel_gcn.train import init_model_params
from parallel_gcn.optim import init_adam
from parallel_gcn.train import (
    _make_scan_run, build_model, make_epoch_step, preaggregate_input,
)
from parallel_gcn.utils.cache import enable_compile_cache
from parallel_gcn.utils.device import require_gpu
from parallel_gcn.utils.profiling import print_trace_summary, profile_fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--keep-trace", default=None)
    ap.add_argument("--mode", choices=["eager", "scan"], default="eager",
                    help="scan profiles N fused epochs in one program "
                         "(the bench path, incl. deferred-eval stacking)")
    ap.add_argument("--scan-epochs", type=int, default=10)
    args = ap.parse_args()

    require_gpu()
    enable_compile_cache()

    cfg = load_config(default_params_path(args.dataset))
    cfg.train.verbose = False
    cfg.exec.matmul_precision = "default"
    ds, dds = prepare_device_dataset(cfg, args.dataset)
    model = build_model(cfg, dds)
    if cfg.exec.input_preagg:
        model, dds = preaggregate_input(model, dds)
    key = jax.random.PRNGKey(cfg.exec.seed)

    def fresh():
        w = init_model_params(cfg, jax.random.PRNGKey(0), dds.input_dim,
                              dds.output_dim)
        return w, init_adam(w)

    if args.mode == "scan":
        cfg.gcn.epochs = args.scan_epochs
        cfg.gcn.early_stopping = 0
        run = _make_scan_run(model, cfg, dds)
        w, opt = fresh()
        np.asarray(run(w, opt, key)[2])  # compile + warm
        w, opt = fresh()
        out, trace_dir = profile_fn(
            lambda: run(w, opt, key), trace_dir=args.keep_trace
        )
        np.asarray(out[2])
        print(f"# {args.scan_epochs}-epoch fused-run device-op profile: "
              f"{args.dataset} (backend={model.backend}, trace: {trace_dir}) "
              f"— divide by {args.scan_epochs} for per-epoch cost")
        print_trace_summary(trace_dir, top=args.top)
        return 0

    step = make_epoch_step(model, cfg, dds)
    w, opt = fresh()
    w, opt, key, m = step(w, opt, key)  # compile + warm
    np.asarray(m)

    (w, opt, key, m), trace_dir = profile_fn(
        lambda: step(w, opt, key), trace_dir=args.keep_trace
    )
    np.asarray(m)
    print(f"# one-epoch device-op profile: {args.dataset} "
          f"(backend={model.backend}, trace: {trace_dir})")
    print_trace_summary(trace_dir, top=args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
