"""Checkpoint / resume.

The reference has none (SURVEY.md §5.4 — training always restarts from fresh
Glorot init; Variable::save only dumps tensors as debug text). Here: full
training state (weights, Adam moments, step, epoch, RNG key) as a single
plain ``.npz`` — numeric arrays only, no pickling, so files stay loadable
across environments.

Two per-layer weight structures exist in the framework and both round-trip:
plain arrays (GCN; saved as ``w{i}``) and str-keyed dicts (GAT's
{W, a_src, a_dst}, SAGE's {neigh, self}, GIN's {w1[, w2]}; saved as
``w{i}_<key>`` plus a ``w{i}__keys`` string-array manifest — np.savez would
otherwise silently PICKLE a dict as a 0-d object array that np.load then
refuses to read back). Loading falls back to the GAT key set for pre-manifest
checkpoints.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from parallel_gcn.optim import AdamState

_GAT_KEYS = ("W", "a_src", "a_dst")


def _put(flat: dict, name: str, layer) -> None:
    if isinstance(layer, dict):
        keys = sorted(layer)
        assert all(isinstance(k, str) and k for k in keys), keys
        flat[f"{name}__keys"] = np.asarray(keys)
        for k in keys:
            flat[f"{name}_{k}"] = np.asarray(layer[k])
    else:
        flat[name] = np.asarray(layer)


def _get(data, name: str):
    if name in data:
        return jnp.asarray(data[name])
    if f"{name}__keys" in data:
        keys = [str(k) for k in data[f"{name}__keys"]]
    else:  # checkpoints written before the per-layer key manifest
        keys = list(_GAT_KEYS)
    return {k: jnp.asarray(data[f"{name}_{k}"]) for k in keys}


def _state_to_flat(weights, opt_state: AdamState, epoch: int, key) -> dict:
    flat = {"epoch": np.asarray(epoch), "step": np.asarray(opt_state.step)}
    if key is not None:
        flat["key"] = np.asarray(jax.random.key_data(key))
    for i, w in enumerate(weights):
        _put(flat, f"w{i}", w)
        _put(flat, f"m{i}", opt_state.m[i])
        _put(flat, f"v{i}", opt_state.v[i])
    flat["n_weights"] = np.asarray(len(weights))
    return flat


def save_checkpoint(path: str, weights, opt_state: AdamState, epoch: int, key=None):
    """Write a single-file checkpoint (``.npz``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_state_to_flat(weights, opt_state, epoch, key))


def load_checkpoint(path: str):
    """Returns (weights, opt_state, epoch, key-or-None)."""
    with np.load(path) as data:
        n = int(data["n_weights"])
        weights = [_get(data, f"w{i}") for i in range(n)]
        opt_state = AdamState(
            step=jnp.asarray(data["step"]),
            m=[_get(data, f"m{i}") for i in range(n)],
            v=[_get(data, f"v{i}") for i in range(n)],
        )
        epoch = int(data["epoch"])
        key = None
        if "key" in data:
            key = jax.random.wrap_key_data(jnp.asarray(data["key"]))
        return weights, opt_state, epoch, key
