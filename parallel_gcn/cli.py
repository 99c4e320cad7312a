"""CLI entry point.

Usage (mirrors the reference binary `./exec/gcn-par <dataset> [file=params.txt]`,
src/main.cpp:24-32, plus free-form key=value overrides):

    python -m parallel_gcn <dataset> [file=<params.txt>] [key=value ...]

e.g.  python -m parallel_gcn cora
      python -m parallel_gcn cora file=my_params.txt epochs=100 mode=eager
"""

from __future__ import annotations

import sys

import jax

from parallel_gcn.config import (
    Config,
    default_params_path,
    load_config,
    parse_override,
)
from parallel_gcn.data.parser import prepare_device_dataset
from parallel_gcn.train import fit
from parallel_gcn.utils.cache import enable_compile_cache


def print_device_info() -> None:
    """Analog of print_gpu_info (include/utils.cuh:81-111)."""
    devices = jax.devices()
    print(f"jax {jax.__version__} — {len(devices)} device(s):")
    for d in devices:
        print(f"  [{d.id}] {d.device_kind} ({d.platform})")
    print()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2

    dataset = argv[0]
    overrides = {}
    params_file = None
    resume_from = None
    for arg in argv[1:]:
        if "=" not in arg:
            # a silently-ignored typo'd override would train with the wrong
            # config without a word — hard error instead
            print(f"error: malformed argument {arg!r} (expected key=value)")
            return 2
        key, val = arg.split("=", 1)
        if key == "file":
            params_file = val
        elif key == "resume_from":
            resume_from = val
        else:
            overrides[key] = parse_override(val)

    try:
        cfg = load_config(params_file or default_params_path(dataset), overrides)
    except (KeyError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}")
        return 2

    # the mesh path handles both node partitioning (n_devices) and tensor
    # parallelism (tp) — a tp-only config must not fall through to the
    # single-device fit(), which has no tp concept
    use_mesh = cfg.exec.n_devices > 1 or cfg.exec.tp > 1
    need = max(cfg.exec.n_devices, 1) * cfg.exec.tp

    enable_compile_cache()
    print_device_info()

    if need > len(jax.devices()):
        print(
            f"error: {need} devices requested (n_devices="
            f"{cfg.exec.n_devices} x tp={cfg.exec.tp}) but "
            f"{len(jax.devices())} are attached"
        )
        return 2

    print(f"PARSING {dataset} ...")
    try:
        if use_mesh:
            from parallel_gcn.data.parser import prepare_host_dataset

            ds, dds = prepare_host_dataset(cfg, dataset), None
        else:
            ds, dds = prepare_device_dataset(cfg, dataset)
    except FileNotFoundError as e:
        print(f"error: {e}")
        return 2
    print(
        f"nodes={ds.n_nodes} edges(nnz incl self-loops)={ds.graph.nnz} "
        f"features={ds.input_dim} classes={ds.output_dim} "
        f"train/val/test={ds.train_dim}/{ds.val_dim}/{ds.test_dim}"
    )

    print("TRAINING AND EVALUATION OF GCN:")
    if use_mesh:
        from parallel_gcn.parallel.train_parallel import fit_parallel

        print(
            f"multi-device: {cfg.exec.n_devices or 'auto'} node-shards "
            f"x tp={cfg.exec.tp}, halo={cfg.exec.halo}"
        )
        result = fit_parallel(cfg, ds, resume_from=resume_from)
    else:
        result = fit(cfg, dds, resume_from=resume_from)
    print(
        f"epochs_run={result.epochs_run} "
        f"avg_epoch_time={result.avg_epoch_time_s * 1e3:.3f} ms"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
