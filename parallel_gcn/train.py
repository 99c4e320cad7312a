"""Training loop — the counterpart of GCN::run / train_epoch / eval.

Reference semantics reproduced exactly (src/gcn.cu:293-455):
  * per epoch: forward(train) → metrics → backward → Adam → eval(val) on the
    **updated** weights (the reference's event graph makes eval's matmuls wait
    on the Adam kernels, src/optim.cu:75-92).
  * reported loss = CE/num_samples + wd·||W0||²/2, for train AND eval
    (finalize, src/gcn.cu:440-455).
  * early stopping: after epoch e ≥ k, stop if val_loss > mean of the last k
    val losses (window includes the current epoch, src/gcn.cu:377-395).

The reference hand-schedules 4 CUDA streams + 6 event classes to overlap
backward, the optimizer, and the next eval (src/gcn.cu:5-11, SURVEY.md §3.2).
Here one jitted ``epoch_step`` contains the whole epoch's dataflow; XLA's async
scheduler provides that overlap, and in ``scan`` mode the entire training run
(epoch loop + early stopping) is a single compiled ``lax.while_loop`` with zero
host↔device round-trips — beating the reference's "3 floats per epoch" D2H
traffic at its own game.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from parallel_gcn.config import GAT_TILE_ERROR, Config
from parallel_gcn.data.parser import TEST, TRAIN, VAL, DeviceDataset
from parallel_gcn.models.gcn import GCNModel, init_params
from parallel_gcn.ops.loss import l2_penalty, masked_softmax_xent
from parallel_gcn.optim import AdamState, adam_step, init_adam


# fused-scan GAT memory guard: above this many edges, fit() AOT-compiles the
# fused program and asks XLA for its memory footprint before executing — a
# whole-run lax.scan GAT at reddit scale (11.8M edges) can exhaust device
# memory, while pubmed-scale ~0.5M runs fine, so small graphs skip the
# check's compile cost. The decision is computed from memory_analysis() vs
# the device's bytes_limit (no magic byte constants), with "no reported
# limit on an accelerator" treated as can't-tell; see _gat_scan_fits_hbm.
_GAT_SCAN_CHECK_EDGES = 1_000_000
_GAT_SCAN_HBM_SAFETY = 0.92  # leave headroom for the allocator/runtime


def _gat_scan_fits_hbm(run, weights, opt_state, key):
    """AOT-compile the fused GAT scan program and decide from XLA's own
    memory analysis whether it fits the device: peak bytes = temps +
    (arguments + outputs − donation aliases). Returns
    (fits, detail, compiled) — ``compiled`` is the AOT executable on a
    usable verdict (so the caller can run it instead of re-jitting) and
    None otherwise. Any failure to answer (analysis unavailable or returning
    None, a size attribute missing on this jax version, compile error)
    reports fits=False with the reason — a device out-of-memory must never
    be what the user sees, so no answer means the conservative path."""
    import jax as _jax

    try:
        compiled = run.lower(weights, opt_state, key).compile()
        ma = compiled.memory_analysis()
        if ma is None:
            # documented possibility: analysis unavailable on this backend —
            # "can't tell" must take the conservative path, not fits=True
            return False, "memory analysis returned None", None
        # no getattr defaults: a renamed attribute on a future jax must land
        # in the except (fits=False), not silently read as need=0
        temp = int(ma.temp_size_in_bytes)
        args = int(ma.argument_size_in_bytes)
        outs = int(ma.output_size_in_bytes)
        alias = int(ma.alias_size_in_bytes)
        need = temp + args + outs - alias
        dev = _jax.devices()[0]
        stats = dev.memory_stats() or {}
        limit = int(stats.get("bytes_limit", 0))
        if not limit:
            if dev.platform == "cpu":
                # CPU: host memory, nothing to exceed
                return (
                    True,
                    f"need≈{need / 1e9:.2f} GB, CPU reports no limit",
                    compiled,
                )
            # an accelerator that does not report its limit: no answer
            # means the conservative path
            return (
                False,
                f"need≈{need / 1e9:.2f} GB, but the device reports no "
                "memory limit to check against",
                None,
            )
        budget = int(limit * _GAT_SCAN_HBM_SAFETY)
        detail = (
            f"XLA memory analysis: temps {temp / 1e9:.2f} GB + args+outs−donated "
            f"{(args + outs - alias) / 1e9:.2f} GB = {need / 1e9:.2f} GB vs "
            f"{budget / 1e9:.2f} GB budget ({_GAT_SCAN_HBM_SAFETY:.0%} of "
            f"{limit / 1e9:.2f} GB HBM)"
        )
        return need <= budget, detail, compiled
    except Exception as e:  # pragma: no cover - backend-specific
        return (
            False,
            f"memory analysis unavailable ({type(e).__name__}: {e})",
            None,
        )


@dataclass
class FitResult:
    weights: list
    history: np.ndarray  # [epochs_run, 4]: train_loss, train_acc, val_loss, val_acc
    epochs_run: int
    test_loss: float
    test_acc: float
    avg_epoch_time_s: float
    total_time_s: float


def init_model_params(cfg: Config, init_key, input_dim: int, output_dim: int):
    """Glorot-init the configured model family's params pytree — the ONE
    place that pairs with build_model (GCN: list of arrays; GAT: list of
    {W, a_src, a_dst} dicts). Harnesses and trainers all route through here
    so a model=gat override cannot be paired with flat GCN weights."""
    if cfg.gcn.model == "gat":
        from parallel_gcn.models.gat import init_gat_params

        return init_gat_params(
            init_key, input_dim, cfg.gcn.hidden_dims, output_dim,
            cfg.gcn.heads,
        )
    if cfg.gcn.model == "sage":
        from parallel_gcn.models.sage import init_sage_params

        return init_sage_params(
            init_key, input_dim, cfg.gcn.hidden_dims, output_dim
        )
    if cfg.gcn.model == "gin":
        from parallel_gcn.models.sage import init_gin_params

        return init_gin_params(
            init_key, input_dim, cfg.gcn.hidden_dims, output_dim
        )
    return init_params(init_key, input_dim, cfg.gcn.hidden_dims, output_dim)


def build_model(cfg: Config, dds: DeviceDataset):
    from parallel_gcn.ops.graphsum import resolve_backend

    # one source of truth with ops.graphsum: auto prefers an existing
    # hybrid/bcsr pack, then dense (when the adj was built), then segment
    if cfg.gcn.model == "gat" and dds.graph.bcsr is not None:
        # attention needs per-edge logits over the complete COO; a tile pack
        # (hybrid/bcsr build) carries only part of the edge list
        raise ValueError(GAT_TILE_ERROR)
    backend = resolve_backend(dds.graph, cfg.exec.backend, cfg.exec.dense_threshold)
    if cfg.gcn.model == "gat":
        from parallel_gcn.models.gat import GATModel

        gat_backend = "dense" if backend == "dense" else "segment"
        return GATModel(
            n_layers=cfg.gcn.n_layers,
            dropouts=tuple(cfg.gcn.dropouts),
            heads=cfg.gcn.heads,
            attn_dropout=cfg.gcn.attn_dropout,
            backend=gat_backend,
            compute_dtype=cfg.exec.compute_dtype,
            precision=cfg.exec.matmul_precision,
            residual=cfg.gcn.residual,
            remat=cfg.gcn.remat,
            edge_chunk=cfg.exec.edge_chunk,
        )
    if cfg.gcn.model in ("sage", "gin"):
        from parallel_gcn.models.sage import GINModel, SAGEModel

        common = dict(
            n_layers=cfg.gcn.n_layers,
            dropouts=tuple(cfg.gcn.dropouts),
            backend=backend,
            edge_chunk=cfg.exec.edge_chunk,
            dense_threshold=cfg.exec.dense_threshold,
            compute_dtype=cfg.exec.compute_dtype,
            precision=cfg.exec.matmul_precision,
            remat=cfg.gcn.remat,
            residual=cfg.gcn.residual,
        )
        if cfg.gcn.model == "sage":
            return SAGEModel(**common)
        return GINModel(gin_eps=cfg.gcn.gin_eps, **common)
    return GCNModel(
        n_layers=cfg.gcn.n_layers,
        dropouts=tuple(cfg.gcn.dropouts),
        residual=cfg.gcn.residual,
        backend=backend,
        edge_chunk=cfg.exec.edge_chunk,
        dense_threshold=cfg.exec.dense_threshold,
        compute_dtype=cfg.exec.compute_dtype,
        precision=cfg.exec.matmul_precision,
        remat=cfg.gcn.remat,
    )


def _l2_term(wd, w0):
    """wd·||W0||²/2 — the reported-loss regularizer (finalize,
    src/gcn.cu:440-455; L2 applies to the first weight only). Tracks the
    exact leaf adam_step's default decay mask updates (optim.decayed_leaf)."""
    from parallel_gcn.optim import decayed_leaf

    return jnp.float32(wd) * l2_penalty(decayed_leaf(w0)) / 2.0


def preaggregate_input(
    model: GCNModel, dds: DeviceDataset
) -> tuple[GCNModel, DeviceDataset]:
    """Hoist the input layer's aggregation out of the epoch loop wherever it
    is loop-invariant.

    With zero input dropout, layer 0 computes Â·(X·W0) every epoch with
    constant X — algebraically equal to (Â·X)·W0, so Â·X is computed ONCE here
    and the per-epoch hot path loses its widest SpMM (this applies to the
    reference's own tuned pubmed/reddit configs, input dropout 0.0,
    report p.13 Table 4 — an optimization the modular stream-scheduled CUDA
    design could not express). With NONZERO input dropout the training path
    must keep its per-epoch dropout→transform→aggregate, but evaluation never
    applies dropout, so Â·X is still loop-invariant for every eval forward —
    it is stored in ``dds.x_agg`` and the eval paths skip layer 0's
    aggregation. Both rewrites are exact (reassociation only).
    """
    import dataclasses

    if not hasattr(model, "aggregate"):
        # models without a loop-invariant linear first aggregation (GAT:
        # attention is data-dependent) have nothing to hoist — no-op, so
        # harness callers need no model-family special-casing
        return model, dds
    if model.input_preagg or dds.x_agg is not None:
        return model, dds

    x_agg = jax.jit(model.aggregate)(dds.x, dds.graph)
    # store Â·X directly in the compute dtype: apply() would cast per use
    # anyway, and bf16 storage halves the reads of the widest activation
    if jnp.dtype(model.compute_dtype) != jnp.float32:
        x_agg = x_agg.astype(jnp.dtype(model.compute_dtype))
    if model.dropouts[0] == 0.0:
        model = dataclasses.replace(model, input_preagg=True)
        dds = dataclasses.replace(dds, x=x_agg)
    else:
        dds = dataclasses.replace(dds, x_agg=x_agg)
    return model, dds


def make_epoch_step(model: GCNModel, cfg: Config, dds: DeviceDataset) -> Callable:
    """Build the jitted one-epoch function:

    (weights, opt_state, key) -> (weights', opt_state', key', metrics[4])

    The dataset arrays (graph, features, labels) are passed through jit as
    arguments, not trace-time constants — embedding a multi-MB graph as an HLO
    constant bloats compiles and breaks remote compilation for large graphs.
    """
    adam = cfg.adam
    wd = adam.weight_decay
    n_train = dds.split_counts[TRAIN]
    n_val = dds.split_counts[VAL]
    train_mask = jax.device_put(dds.split == TRAIN)
    val_mask = jax.device_put(dds.split == VAL)
    # eval forwards always skip layer 0's aggregation when Â·X is available
    # (exact: no dropout at eval; see preaggregate_input)
    x_eval_host = dds.x_agg if dds.x_agg is not None else dds.x
    eval_preagg = model.input_preagg or dds.x_agg is not None

    def epoch_step(weights, opt_state, key, graph, x, x_eval, labels,
                   train_mask, val_mask):
        def ce_loss(weights, key):
            logits = model.apply(weights, x, graph, training=True, key=key)
            loss, acc = masked_softmax_xent(logits, labels, train_mask, n_train)
            return loss, acc

        key, dropout_key = jax.random.split(key)
        (ce, train_acc), grads = jax.value_and_grad(ce_loss, has_aux=True)(
            weights, dropout_key
        )
        # reported train loss includes the L2 term of the PRE-update W0
        # (get_l2_penalty runs right after the forward, src/gcn.cu:314).
        train_loss = ce + _l2_term(wd, weights[0])

        weights, opt_state = adam_step(
            weights,
            grads,
            opt_state,
            learning_rate=adam.learning_rate,
            weight_decay=wd,
            beta1=adam.beta1,
            beta2=adam.beta2,
            eps=adam.eps,
        )

        # validation on the updated weights (src/gcn.cu:369 + event graph)
        val_logits = model.apply(
            weights, x_eval, graph, training=False, input_preagg=eval_preagg
        )
        val_ce, val_acc = masked_softmax_xent(val_logits, labels, val_mask, n_val)
        val_loss = val_ce + _l2_term(wd, weights[0])

        metrics = jnp.stack([train_loss, train_acc, val_loss, val_acc])
        return weights, opt_state, key, metrics

    jitted = jax.jit(epoch_step, donate_argnums=(0, 1))

    def bound(weights, opt_state, key):
        return jitted(
            weights, opt_state, key, dds.graph, dds.x, x_eval_host, dds.labels,
            train_mask, val_mask,
        )

    return bound


def make_eval_fn(model: GCNModel, cfg: Config, dds: DeviceDataset, split: int) -> Callable:
    mask_host = jax.device_put(dds.split == split)
    n = dds.split_counts[split]
    wd = cfg.adam.weight_decay
    x_eval_host = dds.x_agg if dds.x_agg is not None else dds.x
    eval_preagg = model.input_preagg or dds.x_agg is not None

    def eval_fn(weights, graph, x, labels, mask):
        ce_val, acc = masked_softmax_xent(
            model.apply(weights, x, graph, training=False,
                        input_preagg=eval_preagg),
            labels, mask, n,
        )
        loss = ce_val + _l2_term(wd, weights[0])
        return loss, acc

    jitted = jax.jit(eval_fn)

    def bound(weights):
        return jitted(weights, dds.graph, x_eval_host, dds.labels, mask_host)

    return bound


def _fused_deferred_forward(
    model: GCNModel,
    weights,
    x_train,
    x_eval,
    graph,
    dkey,
    *,
    eval_preagg: bool,
):
    """Train forward + DEFERRED eval forward with the last aggregation stacked
    along the lane (class) dimension.

    The last layer's aggregation is only ``n_classes`` wide (41 on reddit), so
    its index traffic dwarfs its feature traffic; train logits and eval
    logits stacked side-by-side ride ONE aggregation pass over the edges
    instead of two. Valid because both
    forwards use the SAME weights when the eval is the one the reference runs
    after the PREVIOUS epoch's Adam step (src/gcn.cu:369: eval(2) on updated
    weights == the weights this epoch's train forward starts from). The caller
    (the no-early-stopping scan path) realigns the val metrics by one epoch
    and runs one standalone eval for the final epoch.

    Prefix layers (0..L-2) are shared between the halves outright when every
    prefix dropout is 0 (the tuned pubmed/reddit configs) — eval's prefix is
    then bitwise the train prefix. Returns (train_logits, eval_logits), f32.
    """
    dtype = jnp.dtype(model.compute_dtype)
    L = model.n_layers
    assert L >= 2, "deferred-eval fusion needs the last layer's aggregation"
    if any(d > 0 for d in model.dropouts):
        keys = list(jax.random.split(dkey, L))
    else:
        keys = [None] * L

    def agg(h):
        return model.aggregate(h, graph)

    # without residuals the trailing ReLU defers into the next layer's entry
    # (fuses with its dropout kernel — see GCNModel.layer_pre pre_relu); the
    # prefix then returns a PRE-ReLU activation and the last layer applies it
    defer_relu = not model.residual

    def prefix(h, training, preagg):
        # layers 0..L-2 of GCNModel.apply, via the shared per-layer core
        def layer_fn(h, weights, key, layer, skip_agg, pre_relu):
            h = model.layer_pre(h, layer, weights, key, training, pre_relu=pre_relu)
            if not skip_agg:
                h = agg(h)
            return h

        prev = None
        pending_relu = False
        for layer in range(L - 1):
            fn = layer_fn
            if model.remat and training:
                # same lever as GCNModel.apply — without this the fused
                # deferred path (the DEFAULT training schedule) would
                # silently ignore the remat knob
                fn = jax.checkpoint(layer_fn, static_argnums=(3, 4, 5))
            h = fn(
                h, weights, keys[layer], layer, layer == 0 and preagg,
                pending_relu,
            )
            pending_relu = False
            if (
                model.residual
                and 0 < layer < L - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if defer_relu:
                pending_relu = True
            else:
                h = jax.nn.relu(h)
                prev = h
        return h

    train_preagg = model.input_preagg
    # halves are identical whenever the prefix is deterministic AND both read
    # the same input with the same layer-0 treatment (preagg on both sides,
    # or preagg on neither — x_train is x_eval in both cases)
    share = (
        all(d == 0 for d in model.dropouts[: L - 1])
        and train_preagg == eval_preagg
    )
    ht = prefix(x_train.astype(dtype), True, train_preagg)
    he = ht if share else prefix(x_eval.astype(dtype), False, eval_preagg)

    at = model.layer_pre(ht, L - 1, weights, keys[L - 1], True, pre_relu=defer_relu)
    ae = model.layer_pre(he, L - 1, weights, None, False, pre_relu=defer_relu)
    n_classes = at.shape[1]
    stacked = agg(jnp.concatenate([at, ae], axis=1))
    return (
        stacked[:, :n_classes].astype(jnp.float32),
        stacked[:, n_classes:].astype(jnp.float32),
    )


@jax.jit
def _advance_key(key, n):
    """Advance a carry key by ``n`` per-epoch splits — replays exactly the
    ``key, _ = jax.random.split(key)`` each executed epoch performs inside
    the fused run (which returns metrics but not the advanced key), so
    scan-mode checkpoints are resume-exact: the resumed run CONTINUES the
    dropout-key stream instead of replaying the original run's first epochs.
    """
    return jax.lax.fori_loop(0, n, lambda i, k: jax.random.split(k)[0], key)


def _first_chunk_len(cfg, remaining, ckpt_dir):
    """The epoch count of the FIRST fused program `_drive_scan_run` will
    build for this run — mirrors its chunking rules exactly. The GAT HBM
    guard compiles this length so it checks (and can hand back) the very
    executable the run starts with: `epochs` is a program constant, so
    checking a different length would both measure a different program's
    footprint and miss the persistent compile cache."""
    ckpt_every = cfg.train.checkpoint_every if ckpt_dir else 0
    if ckpt_every and cfg.gcn.early_stopping:
        ckpt_every = 0  # _drive_scan_run disables chunking (with a warning)
    if ckpt_every and remaining > ckpt_every:
        return min(ckpt_every, remaining)
    return remaining


def _drive_scan_run(build_run, weights, opt_state, key, cfg, start_epoch,
                    ckpt_dir, verbose, precompiled=None):
    """Shared scan-mode driver for fit and fit_parallel: runs the fused
    whole-run program, optionally chunked at ``checkpoint_every`` (exact on
    static schedules — the inter-chunk `_advance_key` replays the per-epoch
    key splits), writing intermediate checkpoints to ``ckpt_dir``.

    ``build_run(n_epochs)`` returns a fused run callable
    ``(weights, opt_state, key) -> (weights, opt_state, metrics, epochs_run)``
    for a static trip count of ``n_epochs`` (mesh callers close over their
    data args). Built runs are cached per length, so a 1000-epoch run chunked
    at 10 builds two programs, not 100.

    Returns ``(weights, opt_state, history, epochs_run, key)`` — ``key``
    advanced past the executed epochs when checkpoints are in play.

    ``precompiled`` optionally maps chunk length → an already-AOT-compiled
    executable (the GAT HBM guard compiles the first chunk anyway; reusing
    it avoids compiling the big program twice per run).
    """
    import warnings

    remaining = max(cfg.gcn.epochs - start_epoch, 0)
    if start_epoch and 0 < remaining < cfg.gcn.early_stopping and verbose:
        print(
            f"warning: {remaining} epochs remain after resume but the "
            f"early_stopping window needs {cfg.gcn.early_stopping} "
            "post-resume val losses — the stopping rule cannot fire "
            "on this tail"
        )
    ckpt_every = cfg.train.checkpoint_every if ckpt_dir else 0
    if ckpt_every and cfg.gcn.early_stopping:
        ckpt_every = 0
        # a multi-hour run silently losing its periodic checkpoints must be
        # heard regardless of verbosity
        warnings.warn(
            "scan-mode periodic checkpoints require early_stopping=0 (fused "
            "chunks would reset the stopping window); only ckpt_final.npz "
            "will be written — use mode=eager for periodic checkpoints with "
            "early stopping",
            stacklevel=3,
        )

    # fused program per distinct chunk length (seeded with any guard-compiled
    # executable)
    runs: dict[int, object] = dict(precompiled or {})

    def run_for(n):
        if n not in runs:
            runs[n] = build_run(n)
        return runs[n]

    if ckpt_every and remaining > ckpt_every:
        from parallel_gcn.utils.checkpoint import save_checkpoint

        seg_rows, done = [], 0
        while done < remaining:
            n = min(ckpt_every, remaining - done)
            weights, opt_state, m, _ = run_for(n)(weights, opt_state, key)
            key = _advance_key(key, n)
            done += n
            seg_rows.append(np.asarray(m))
            if done < remaining:  # the tail is covered by ckpt_final
                save_checkpoint(
                    os.path.join(ckpt_dir, f"ckpt_{start_epoch + done:06d}.npz"),
                    weights, opt_state, start_epoch + done, key,
                )
        history = (
            np.concatenate(seg_rows)
            if seg_rows else np.zeros((0, 4), np.float32)
        )
        epochs_run = done
    else:
        weights, opt_state, metrics, epochs_run = run_for(remaining)(
            weights, opt_state, key
        )
        epochs_run = int(epochs_run)
        history = np.asarray(metrics)[:epochs_run]
        if ckpt_dir:
            key = _advance_key(key, epochs_run)
    return weights, opt_state, history, epochs_run, key


def _make_scan_run(model: GCNModel, cfg: Config, dds: DeviceDataset):
    """The fused whole-run jit: lax.while_loop over epochs with on-device early
    stopping. Returns (weights, opt, metrics[epochs,4], epochs_run).

    Dataset arrays are jit arguments (see make_epoch_step)."""
    adam = cfg.adam
    epochs = cfg.gcn.epochs
    k = cfg.gcn.early_stopping
    if k > epochs:
        # the stopping test (epoch+1 >= k) can never fire — and the k-sized
        # window would not fit the epochs-sized history buffer
        k = 0
    n_train = dds.split_counts[TRAIN]
    n_val = dds.split_counts[VAL]
    wd = adam.weight_decay
    train_mask_host = jax.device_put(dds.split == TRAIN)
    val_mask_host = jax.device_put(dds.split == VAL)
    x_eval_host = dds.x_agg if dds.x_agg is not None else dds.x
    eval_preagg = model.input_preagg or dds.x_agg is not None

    def run(weights, opt_state, key, graph, x, x_eval, labels, train_mask,
            val_mask):
        def ce_loss(weights, key):
            logits = model.apply(weights, x, graph, training=True, key=key)
            loss, acc = masked_softmax_xent(logits, labels, train_mask, n_train)
            return loss, acc

        def one_epoch(weights, opt_state, key):
            key, dropout_key = jax.random.split(key)
            (ce, train_acc), grads = jax.value_and_grad(ce_loss, has_aux=True)(
                weights, dropout_key
            )
            train_loss = ce + _l2_term(wd, weights[0])
            weights, opt_state = adam_step(
                weights, grads, opt_state,
                learning_rate=adam.learning_rate, weight_decay=wd,
                beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps,
            )
            val_logits = model.apply(
                weights, x_eval, graph, training=False, input_preagg=eval_preagg
            )
            val_ce, val_acc = masked_softmax_xent(val_logits, labels, val_mask, n_val)
            val_loss = val_ce + _l2_term(wd, weights[0])
            return weights, opt_state, key, train_loss, train_acc, val_loss, val_acc

        # deferred-eval fusion applies when the epoch schedule is static (no
        # early stopping — the stopping rule needs epoch e's val loss BEFORE
        # deciding to run e+1, but the deferred schedule produces it during
        # e+1) and the model has a last-layer aggregation to stack (a 1-layer
        # model with input_preagg aggregates nowhere).
        fused_eval = (
            k == 0 and epochs > 0 and model.n_layers >= 2
            and getattr(model, "supports_deferred_eval", True)
        )
        if fused_eval:
            # epoch e's body computes the train step AND epoch e-1's val
            # forward in one stacked last aggregation (see
            # _fused_deferred_forward); val metrics are realigned by one
            # epoch after the scan, with one standalone eval for the final
            # epoch. Numerically identical to the plain schedule.
            def scan_body(carry, _):
                weights, opt_state, key = carry
                key, dkey = jax.random.split(key)

                def fused_loss(w, dkey):
                    lt, le = _fused_deferred_forward(
                        model, w, x, x_eval, graph, dkey,
                        eval_preagg=eval_preagg,
                    )
                    loss, acc = masked_softmax_xent(lt, labels, train_mask, n_train)
                    vce, vacc = masked_softmax_xent(
                        jax.lax.stop_gradient(le), labels, val_mask, n_val
                    )
                    return loss, (acc, vce, vacc)

                (ce, (ta, vce, vacc)), grads = jax.value_and_grad(
                    fused_loss, has_aux=True
                )(weights, dkey)
                # l2 of the PRE-update W0 — for the train loss by reference
                # semantics (src/gcn.cu:314), for the val loss because these
                # weights ARE the ones the deferred eval ran on
                pen = _l2_term(wd, weights[0])
                tl = ce + pen
                vl = vce + pen
                weights, opt_state = adam_step(
                    weights, grads, opt_state,
                    learning_rate=adam.learning_rate, weight_decay=wd,
                    beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps,
                )
                return (weights, opt_state, key), jnp.stack([tl, ta, vl, vacc])

            (weights, opt_state, _), em = jax.lax.scan(
                scan_body, (weights, opt_state, key), None, length=epochs
            )
            # em[e, 2:4] holds epoch e-1's val metrics (em[0] evaluated the
            # initial weights — dropped); the final epoch's eval runs here
            val_logits = model.apply(
                weights, x_eval, graph, training=False, input_preagg=eval_preagg
            )
            vce, vacc = masked_softmax_xent(val_logits, labels, val_mask, n_val)
            vl_fin = vce + _l2_term(wd, weights[0])
            val_cols = jnp.concatenate(
                [em[1:, 2:4], jnp.stack([vl_fin, vacc])[None, :]], axis=0
            )
            metrics = jnp.concatenate([em[:, :2], val_cols], axis=1)
            return weights, opt_state, metrics, jnp.asarray(epochs, jnp.int32)

        if k == 0:
            # no early stopping: a plain scan — no stopped-lane freezing, no
            # val-loss history, no dynamic metric writes. At citation-graph
            # scale the epoch is kernel-launch-bound, so dropping ~15 tiny
            # bookkeeping ops per epoch is a measurable win.
            def scan_body(carry, _):
                weights, opt_state, key = carry
                weights, opt_state, key, tl, ta, vl, va = one_epoch(
                    weights, opt_state, key
                )
                return (weights, opt_state, key), jnp.stack([tl, ta, vl, va])

            (weights, opt_state, _), metrics = jax.lax.scan(
                scan_body, (weights, opt_state, key), None, length=epochs
            )
            return weights, opt_state, metrics, jnp.asarray(epochs, jnp.int32)

        metrics0 = jnp.zeros((epochs, 4), jnp.float32)
        hist0 = jnp.zeros((epochs,), jnp.float32)  # val-loss history

        def cond(carry):
            _, _, _, epoch, _, _, stopped = carry
            return jnp.logical_and(epoch < epochs, jnp.logical_not(stopped))

        def body(carry):
            weights, opt_state, key, epoch, hist, metrics, stopped = carry
            was_stopped = stopped
            new_w, new_opt, new_key, tl, ta, vl, va = one_epoch(
                weights, opt_state, key
            )
            # Freeze already-stopped lanes: on a single device the loop cond
            # exits before body ever sees stopped=True, but under vmap (the
            # seed-parallel accuracy harness) all lanes iterate until the
            # slowest finishes and stopped lanes must be no-ops.
            frozen = lambda new, old: jax.tree.map(
                lambda a, b: jnp.where(stopped, b, a), new, old
            )
            weights = frozen(new_w, weights)
            opt_state = frozen(new_opt, opt_state)
            key = jnp.where(stopped, key, new_key)
            new_metrics = jax.lax.dynamic_update_slice(
                metrics, jnp.stack([tl, ta, vl, va])[None, :], (epoch, 0)
            )
            metrics = jnp.where(stopped, metrics, new_metrics)
            hist = jnp.where(stopped, hist, hist.at[epoch].set(vl))
            if k > 0:
                # window = last k val losses including the current epoch
                # (src/gcn.cu:383-389: indices epoch-k .. epoch-1, 1-based).
                start = jnp.maximum(epoch + 1 - k, 0)
                window = jax.lax.dynamic_slice(hist, (start,), (k,))
                now_stop = jnp.logical_and(epoch + 1 >= k, vl > jnp.mean(window))
                stopped = jnp.logical_or(stopped, now_stop)
            # the stopping epoch itself ran and counts (reference records it
            # before breaking); only lanes that were ALREADY stopped hold.
            epoch = epoch + jnp.where(was_stopped, 0, 1)
            return weights, opt_state, key, epoch, hist, metrics, stopped

        init = (weights, opt_state, key, jnp.asarray(0, jnp.int32), hist0, metrics0,
                jnp.asarray(False))
        weights, opt_state, key, epochs_run, _, metrics, _ = jax.lax.while_loop(
            cond, body, init
        )
        return weights, opt_state, metrics, epochs_run

    jitted = jax.jit(run, donate_argnums=(0, 1))

    def bound(weights, opt_state, key):
        return jitted(
            weights, opt_state, key, dds.graph, dds.x, x_eval_host, dds.labels,
            train_mask_host, val_mask_host,
        )

    def lower(weights, opt_state, key):
        """AOT-lower the fused program with the real (closed-over) data args
        — lets callers compile-and-inspect (memory_analysis) without
        executing; see fit()'s GAT HBM check."""
        return jitted.lower(
            weights, opt_state, key, dds.graph, dds.x, x_eval_host, dds.labels,
            train_mask_host, val_mask_host,
        )

    def bind_compiled(compiled):
        """Wrap an executable from ``lower(...).compile()`` back into the
        3-arg ``(weights, opt_state, key)`` calling convention (the
        executable itself wants the full 9-arg lowered signature) — so the
        HBM guard's AOT compile can be executed instead of re-jitted."""
        def bound_compiled(weights, opt_state, key):
            return compiled(
                weights, opt_state, key, dds.graph, dds.x, x_eval_host,
                dds.labels, train_mask_host, val_mask_host,
            )
        return bound_compiled

    bound.lower = lower
    bound.bind_compiled = bind_compiled
    return bound


def fit(
    cfg: Config,
    dds: DeviceDataset,
    *,
    key: jax.Array | None = None,
    verbose: bool | None = None,
    resume_from: str | None = None,
) -> FitResult:
    """Full training run: init → epoch loop (+early stopping) → test eval.

    Counterpart of main() + GCN::run (src/main.cpp:9-62, src/gcn.cu:347-436),
    plus checkpoint/resume which the reference lacks (SURVEY.md §5.4):
    ``resume_from`` restores weights/opt/key from a checkpoint file, and
    cfg.train.checkpoint_dir enables saving (periodic in eager mode, final in
    both modes).
    """
    verbose = cfg.train.verbose if verbose is None else verbose
    if key is None:
        key = jax.random.PRNGKey(cfg.exec.seed)
    key, init_key = jax.random.split(key)

    model = build_model(cfg, dds)
    if cfg.exec.input_preagg and cfg.gcn.model == "gat":
        # Â·(X·W0) == (Â·X)·W0 is a GCN identity; GAT's aggregation is
        # data-dependent, so the hoist does not exist — ignore the (default
        # True) knob rather than refuse to run. Benign: nothing is lost, the
        # rewrite simply has no GAT analog.
        if verbose:
            print("note: input_preagg has no GAT analog — ignored")
    elif cfg.exec.input_preagg:
        model, dds = preaggregate_input(model, dds)
    start_epoch = 0
    if resume_from:
        from parallel_gcn.utils.checkpoint import load_checkpoint

        weights, opt_state, start_epoch, saved_key = load_checkpoint(resume_from)
        if saved_key is not None:
            key = saved_key
        if verbose:
            print(f"resumed from {resume_from} at epoch {start_epoch}")
    else:
        weights = init_model_params(cfg, init_key, dds.input_dim,
                                    dds.output_dim)
        opt_state = init_adam(weights)
    test_fn = make_eval_fn(model, cfg, dds, TEST)

    ckpt_dir = cfg.train.checkpoint_dir

    def maybe_checkpoint(epoch, weights, opt_state, key):
        if ckpt_dir and cfg.train.checkpoint_every and (
            epoch % cfg.train.checkpoint_every == 0
        ):
            from parallel_gcn.utils.checkpoint import save_checkpoint

            save_checkpoint(
                os.path.join(ckpt_dir, f"ckpt_{epoch:06d}.npz"),
                weights, opt_state, epoch, key,
            )

    mode = cfg.train.mode
    precompiled = None  # seeded by the GAT HBM guard's AOT compile on fits
    t0 = time.perf_counter()
    if mode == "scan":
        import copy

        def build_run(n_epochs):
            # the fused program's trip count is static — derive a config for
            # exactly the epochs this (chunk of the) run will execute
            seg_cfg = copy.deepcopy(cfg)
            seg_cfg.gcn.epochs = n_epochs
            return _make_scan_run(model, seg_cfg, dds)

        if (
            cfg.gcn.model == "gat"
            and cfg.exec.gat_scan_check
            and max(dds.graph.row.shape[0], dds.graph.n_real_edges)
            > _GAT_SCAN_CHECK_EDGES
        ):
            # a large-GAT fused whole-run program can exceed device memory
            # (the edge_chunk streaming attention at reddit scale holds
            # ~5.6 GB of epoch-invariant temporaries). Ask the compiler, not
            # a magic constant: AOT-compile the program and compare XLA's
            # own memory analysis to the device limit; "can't tell" also
            # takes the eager path. The extra compile is a persistent-cache
            # hit on the CLI/bench entries.
            import warnings

            remaining = max(cfg.gcn.epochs - start_epoch, 1)
            first_len = _first_chunk_len(cfg, remaining, ckpt_dir)
            check_run = build_run(first_len)
            fits, detail, compiled = _gat_scan_fits_hbm(
                check_run, weights, opt_state, key
            )
            if fits:
                if verbose:
                    print(f"fused GAT scan fits HBM — {detail}")
                rebind = getattr(check_run, "bind_compiled", None)
                if compiled is not None and rebind is not None:
                    precompiled = {first_len: rebind(compiled)}
            else:
                warnings.warn(
                    f"large-graph model=gat "
                    f"({max(dds.graph.row.shape[0], dds.graph.n_real_edges)}"
                    f" edges): the fused scan-mode program cannot be cleared "
                    f"against device memory ({detail}) — falling back to "
                    "mode=eager (identical model/metrics, one host "
                    "round-trip per epoch). Set gat_scan_check=false to run "
                    "the scan unguarded",
                    stacklevel=2,
                )
                mode = "eager"

    if mode == "scan":
        weights, opt_state, history, epochs_run, key = _drive_scan_run(
            build_run, weights, opt_state, key, cfg, start_epoch,
            ckpt_dir, verbose, precompiled=precompiled,
        )
        if verbose:
            for e in range(epochs_run):
                tl, ta, vl, va = history[e]
                print(
                    f"epoch={start_epoch + e + 1} train_loss={tl:.5f} "
                    f"train_acc={ta:.5f} val_loss={vl:.5f} val_acc={va:.5f}"
                )
            if start_epoch + epochs_run < cfg.gcn.epochs:
                print("Early stopping...")
    else:
        epoch_step = make_epoch_step(model, cfg, dds)
        k = cfg.gcn.early_stopping
        rows = []
        loss_history: list[float] = []
        for epoch in range(start_epoch + 1, cfg.gcn.epochs + 1):
            te = time.perf_counter()
            weights, opt_state, key, metrics = epoch_step(weights, opt_state, key)
            tl, ta, vl, va = (float(v) for v in metrics)
            rows.append((tl, ta, vl, va))
            maybe_checkpoint(epoch, weights, opt_state, key)
            if verbose:
                print(
                    f"epoch={epoch} train_loss={tl:.5f} train_acc={ta:.5f} "
                    f"val_loss={vl:.5f} val_acc={va:.5f} "
                    f"time={time.perf_counter() - te:.5f}"
                )
            if k > 0:
                loss_history.append(vl)
                # window counts POST-RESUME epochs (len of the history), like a
                # fresh run and like the scan-mode resume
                if len(loss_history) >= k and vl > float(np.mean(loss_history[-k:])):
                    if verbose:
                        print("Early stopping...")
                    break
        history = np.asarray(rows, dtype=np.float32).reshape(-1, 4)
        epochs_run = len(rows)
    total_time = time.perf_counter() - t0

    if ckpt_dir:
        from parallel_gcn.utils.checkpoint import save_checkpoint

        save_checkpoint(
            os.path.join(ckpt_dir, "ckpt_final.npz"),
            weights, opt_state, start_epoch + epochs_run, key,
        )

    test_loss, test_acc = (float(v) for v in test_fn(weights))
    if verbose:
        print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f}")
        print(f"total time: {total_time:.5f}")

    return FitResult(
        weights=weights,
        history=history,
        epochs_run=epochs_run,
        test_loss=test_loss,
        test_acc=test_acc,
        avg_epoch_time_s=total_time / max(epochs_run, 1),
        total_time_s=total_time,
    )
