"""Device-side profiling helpers.

The reference profiles with host timers + nsys (SURVEY.md §5.1); here the
analog is a ``jax.profiler`` trace. ``profile_fn`` captures a trace of one
call and ``summarize_trace`` aggregates per-op GPU time from the trace's
xplane file: events of the ``/device:GPU:*`` planes, read from their
``XLA Ops`` line (one event per HLO op) or, where a trace has none, from the
CUDA stream lines (one event per kernel).
"""

from __future__ import annotations

import collections
import glob
import os
import tempfile

import jax
import numpy as np


def profile_fn(fn, *args, trace_dir: str | None = None):
    """Run ``fn(*args)`` under a profiler trace; returns (result, trace_dir)."""
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="pgcn_trace_")
    with jax.profiler.trace(trace_dir):
        out = fn(*args)
        np.asarray(jax.tree.leaves(out)[0])  # force completion
    return out, trace_dir


def device_op_events(trace_dir: str):
    """Yield (op_name, duration_ns) for every GPU op event in the newest
    trace under ``trace_dir``."""
    paths = glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        return
    data = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for line in ops or [ln for ln in lines if ln.name.startswith("Stream")]:
            for ev in line.events:
                yield ev.name, ev.duration_ns


def summarize_trace(trace_dir: str, top: int = 20) -> list[tuple[str, float, int]]:
    """Aggregate GPU op durations from a trace directory.

    Returns [(op_name, total_ms, count)] sorted by total time, device ops only.
    """
    durs: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for name, dur_ns in device_op_events(trace_dir):
        durs[name] += dur_ns
        counts[name] += 1
    return [(n, d / 1e6, counts[n]) for n, d in durs.most_common(top)]


def print_trace_summary(trace_dir: str, top: int = 20) -> None:
    rows = summarize_trace(trace_dir, top)
    for name, ms, count in rows:
        print(f"{ms:10.3f} ms  x{count:<6} {name[:80]}")
