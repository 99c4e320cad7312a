"""Multi-chip training step via shard_map over a device mesh.

What the reference does not have (it is single-GPU; SURVEY.md §2.4): the
graph's rows are partitioned across the ``nodes`` mesh axis, each device
aggregates its own rows' edges after an ``all_gather`` of source features
between devices, weight gradients are ``psum``-reduced, and the Adam step runs
replicated. The reference's intra-device stream/event overlap
(src/gcn.cu:5-11) maps to XLA's async collectives + latency-hiding scheduler;
on GPUs the collectives lower to NCCL.

Runs unchanged on a virtual CPU mesh (tests) and on several GPUs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parallel_gcn.config import GAT_TILE_ERROR, Config
from parallel_gcn.data.parser import TRAIN, VAL, Dataset
from parallel_gcn.ops.dropout import dropout
from parallel_gcn.ops.loss import l2_penalty as _l2_penalty_arr
from parallel_gcn.ops.sparse_matmul import feature_transform
from parallel_gcn.optim import adam_step, decayed_leaf as _decayed_leaf
from parallel_gcn.parallel.partition import (
    HybridShardedGraph,
    ShardedGraph,
)

AXIS = "nodes"
FEAT = "feat"  # tensor-parallel mesh axis (SURVEY.md §2.4 TP row)


def l2_penalty(w0):
    """Σw² of the decayed leaf (optim.decayed_leaf — the exact leaf
    adam_step's default decay mask updates; see train._l2_term)."""
    return _l2_penalty_arr(_decayed_leaf(w0))


def make_mesh(n_devices: int | None = None, devices=None, tp: int = 1) -> Mesh:
    """1-D ``(nodes,)`` mesh, or with ``tp > 1`` a 2-D ``(nodes, feat)`` mesh
    of n_devices × tp devices: rows partitioned over ``nodes`` (data-parallel
    analog), weight/hidden feature dims over ``feat`` (tensor parallel).
    The layout follows the algorithm only: ``jax.devices()`` order, tp-major
    within a row of the mesh."""
    devices = devices if devices is not None else jax.devices()
    if tp > 1:
        n_nodes_axis = n_devices or len(devices) // tp
        devices = np.asarray(devices[: n_nodes_axis * tp]).reshape(
            n_nodes_axis, tp
        )
        return Mesh(devices, (AXIS, FEAT))
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def _tp_schedule(n_layers: int) -> list[str]:
    """Per-layer Megatron-style sharding kinds over the feat axis.

    'col': W sharded on the OUTPUT dim (input replicated over feat, output
    feature-sharded — no collective). 'row': W sharded on the INPUT dim
    (input feature-sharded; partial outputs reduced over feat). Alternating
    col/row gives one reduction per layer pair; the LAST layer is always
    'row' so logits come out replicated for the loss. An even-indexed last
    layer (odd n_layers) takes a replicated input, which the row branch
    slices locally — zero communication."""
    return [
        "row" if (i % 2 == 1 or i == n_layers - 1) else "col"
        for i in range(n_layers)
    ]


def _weight_specs(n_layers: int, tp: int, model: str = "gcn"):
    """shard_map in_specs pytree for the weights pytree (and Adam moments).

    GCN: one array per layer on the col/row schedule. SAGE: {neigh, self}
    share the layer's schedule kind (two parallel matmuls of the same shape).
    GIN: each inner layer's MLP is its own Megatron pair (w1 col, w2 row);
    the last layer's linear classifier is row-sharded."""
    if tp <= 1:
        return P()
    col, row = P(None, FEAT), P(FEAT, None)
    if model == "sage":
        return [
            {k: (col if kind == "col" else row) for k in ("neigh", "self")}
            for kind in _tp_schedule(n_layers)
        ]
    if model == "gin":
        return [
            {"w1": col, "w2": row} if i < n_layers - 1 else {"w1": row}
            for i in range(n_layers)
        ]
    return [
        col if kind == "col" else row for kind in _tp_schedule(n_layers)
    ]


def _opt_specs(wspecs):
    from parallel_gcn.optim import AdamState

    if not isinstance(wspecs, list):
        return P()
    return AdamState(step=P(), m=list(wspecs), v=list(wspecs))


def validate_tp_dims(input_dim: int, hidden_dims, output_dim: int, tp: int,
                     model: str = "gcn"):
    """Raise early (host-side) when a dim cannot be sharded tp ways."""
    if tp <= 1:
        return
    dims = [input_dim, *hidden_dims, output_dim]
    n_layers = len(dims) - 1
    if model == "gin":
        # inner MLP pairs: w1 col-sharded on dims[i+1], w2 row-sharded on the
        # same width; last layer row-shards its input dims[L-1]
        for i in range(n_layers - 1):
            if dims[i + 1] % tp:
                raise ValueError(
                    f"tp={tp} requires GIN layer {i}'s hidden dim "
                    f"{dims[i + 1]} divisible by tp (Megatron MLP pair)"
                )
        if dims[n_layers - 1] % tp:
            raise ValueError(
                f"tp={tp} requires the GIN classifier input dim "
                f"{dims[n_layers - 1]} divisible by tp (row-sharded)"
            )
        return
    # gcn and sage share the alternating col/row schedule (SAGE's two
    # per-layer matmuls have identical shapes)
    for i, kind in enumerate(_tp_schedule(n_layers)):
        if kind == "col" and dims[i + 1] % tp:
            raise ValueError(
                f"tp={tp} requires layer {i}'s output dim {dims[i + 1]} "
                "divisible by tp (column-sharded weight)"
            )
        if kind == "row" and i < n_layers - 1 and dims[i + 1] % tp:
            raise ValueError(
                f"tp={tp} requires layer {i}'s output dim {dims[i + 1]} "
                "divisible by tp (reduce_scatter over feat)"
            )
        if kind == "row" and i % 2 == 1 and dims[i] % tp:
            raise ValueError(
                f"tp={tp} requires layer {i}'s input dim {dims[i]} "
                "divisible by tp (row-sharded weight)"
            )
    if n_layers == 1 and input_dim % tp:
        raise ValueError(
            f"tp={tp} with a single layer requires input_dim {input_dim} "
            "divisible by tp"
        )


def shard_weights(weights, mesh: Mesh, tp: int, model: str = "gcn"):
    """Place full (host/replicated) weights as feat-sharded device arrays."""
    wspecs = _weight_specs(len(weights), tp, model)
    if not isinstance(wspecs, list):
        return jax.tree.map(
            lambda w: jax.device_put(w, NamedSharding(mesh, P())), weights
        )
    # PartitionSpec is a tuple subclass — flatten the weights pytree and
    # match specs positionally instead of tree-mapping into the specs
    flat_w, treedef = jax.tree.flatten(weights)
    flat_s = treedef.flatten_up_to(wspecs)
    placed = [
        jax.device_put(w, NamedSharding(mesh, s))
        for w, s in zip(flat_w, flat_s)
    ]
    return jax.tree.unflatten(treedef, placed)


def shard_dataset(ds: Dataset, sgraph: ShardedGraph):
    """Pad host arrays to the sharded node count; returns numpy arrays shaped
    for row-sharding over the mesh. Applies the partition's slab-balancing
    node permutation when present (partition_graph_hybrid balance=True) so
    node-keyed arrays line up with the permuted graph layout."""
    n_pad = sgraph.n_nodes_pad
    x = np.zeros((n_pad, ds.input_dim), dtype=np.float32)
    x[: ds.n_nodes] = ds.features
    labels = np.full(n_pad, -1, dtype=np.int32)
    labels[: ds.n_nodes] = ds.labels
    split = np.zeros(n_pad, dtype=np.int32)
    split[: ds.n_nodes] = ds.split
    perm = getattr(sgraph, "node_perm", None)
    if perm is not None:
        x, labels, split = x[perm], labels[perm], split[perm]
    return x, labels, split


def _halo_buffer(x_local, send_idx, axis):
    """Boundary halo exchange: each device sends to each peer exactly the
    local rows that peer's edges/tile-columns reference (send_idx, built at
    partition time), via one all_to_all between devices. Returns the compact
    ``[x_local ; received halo rows]`` buffer that the partition's remapped
    column indices resolve against — peak per-device feature memory is
    O(n_local + n_dev·halo) instead of the all_gather's O(N)."""
    send = jnp.take(x_local, send_idx, axis=0)
    halo = jax.lax.all_to_all(
        send, axis, split_axis=0, concat_axis=0, tiled=True
    )
    return jnp.concatenate([x_local, halo], axis=0)


def _gather_buffer(x_local, send_idx, axis):
    if send_idx is None:
        return jax.lax.all_gather(x_local, axis, axis=0, tiled=True)
    return _halo_buffer(x_local, send_idx, axis)


def graphsum_dist(x_local, row_local, col, val, n_local, axis=AXIS,
                  send_idx=None):
    """Distributed Â·x over row-sharded features.

    ``send_idx=None`` (all_gather halo): gather ALL remote source features
    between devices at once; ``col`` carries global node ids. Simple and fast while
    the full gathered matrix fits HBM; XLA overlaps the collective with the
    preceding matmul. With ``send_idx`` (boundary halo,
    partition_graph(boundary=True)): exchange only referenced boundary rows
    via all_to_all; ``col`` indexes the compact local+halo buffer. Autodiff
    transposes both variants correctly (take→scatter-add, all_to_all reverses,
    all_gather→psum-scatter)."""
    x_buf = _gather_buffer(x_local, send_idx, axis)
    gathered = val[:, None].astype(x_local.dtype) * x_buf[col]
    return jax.ops.segment_sum(
        gathered, row_local, num_segments=n_local, indices_are_sorted=True
    )


def graphsum_dist_adaptive(x_local, row_local, col, val, prow, pcol, pval,
                           precv, n_local, axis=AXIS, send_idx=None):
    """Distributed Â·x with the per-pair PUSH/PULL halo
    (partition_graph(adaptive=True)).

    Pull pairs + local edges ride the boundary machinery (compact
    local+halo buffer via one all_to_all of raw feature rows). Push pairs are
    owned by the SOURCE device: it partial-sums its local features into the
    compact slot buffer (prow = dst_dev·push_slab + slot), a second
    all_to_all ships the partial ROWS, and the receiver scatter-adds them at
    precv (padding slots point past n_local and drop). On hub-heavy graphs
    this bounds each exchange slab by min(pull, push) per pair — the hub
    owner's halo collapses from "every hub neighborhood" to "one partial row
    per hub". Autodiff transposes the whole pipeline exactly (take↔scatter-
    add, all_to_all reverses, segment_sum↔gather), and the global operator
    stays Â·x, so the symmetric-Â VJP shortcut upstream remains valid.
    """
    out = graphsum_dist(x_local, row_local, col, val, n_local, axis,
                        send_idx=send_idx)
    contrib = pval[:, None].astype(x_local.dtype) * x_local[pcol]
    part = jax.ops.segment_sum(
        contrib, prow, num_segments=precv.shape[0], indices_are_sorted=True
    )
    recv = jax.lax.all_to_all(
        part, axis, split_axis=0, concat_axis=0, tiled=True
    )
    return out.at[precv].add(recv.astype(out.dtype), mode="drop")


def _agg_hybrid_impl(x_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
                     n_local, n_buf, axis):
    from parallel_gcn.ops.bcsr import BCSR, bcsr_matmul_rect

    x_buf = _gather_buffer(x_local, send_idx, axis)
    pack = BCSR(
        tiles=tiles, tile_rows=trow, tile_cols=tcol,
        n_nodes=n_buf, n_tiles_real=tiles.shape[0], n_rows=n_local,
    )
    out = bcsr_matmul_rect(pack, x_buf).astype(x_local.dtype)
    gathered = rval[:, None].astype(x_local.dtype) * x_buf[rcol]
    return out + jax.ops.segment_sum(
        gathered, rrow, num_segments=n_local, indices_are_sorted=True
    )


@partial(jax.custom_vjp, nondiff_argnums=(8, 9, 10))
def graphsum_dist_hybrid(x_local, send_idx, tiles, trow, tcol, rrow, rcol,
                         rval, n_local, n_buf, axis=AXIS):
    """Distributed Â·x with per-device dense tile slabs + COO residual
    (partition.HybridShardedGraph); halo = all_gather (send_idx None) or the
    boundary all_to_all exchange (send_idx from the partition). ``n_buf`` is
    the per-device source-buffer row count (sgraph.n_buf).

    Self-adjoint at the collective level: the GLOBAL matrix is symmetric, so
    d/dx restricted to device d's rows is the SAME operation applied to the
    exchanged cotangent (dx_d = slab_d · halo(g)) — no transposed tile
    pack, mirroring the single-chip symmetric-Â shortcut
    (src/module.cu:188-208) across the mesh. This holds for the boundary halo
    too: the cotangent is row-sharded exactly like x, and sum_b A[b,d]ᵀ·g_b =
    sum_b A[d,b]·g_b = (Â·g) on d's rows.
    """
    return _agg_hybrid_impl(
        x_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        n_local, n_buf, axis,
    )


def _agg_hybrid_fwd(x_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
                    n_local, n_buf, axis):
    out = _agg_hybrid_impl(
        x_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        n_local, n_buf, axis,
    )
    return out, (send_idx, tiles, trow, tcol, rrow, rcol, rval)


def _agg_hybrid_bwd(n_local, n_buf, axis, res, g):
    send_idx, tiles, trow, tcol, rrow, rcol, rval = res
    dx = _agg_hybrid_impl(
        g, send_idx, tiles, trow, tcol, rrow, rcol, rval, n_local, n_buf, axis
    )
    return dx, None, None, None, None, None, None, None


graphsum_dist_hybrid.defvjp(_agg_hybrid_fwd, _agg_hybrid_bwd)


def _agg_hybrid_scaled_impl(x_local, d_local, send_idx, tiles, trow, tcol,
                            rrow, rcol, rval, n_local, n_buf, axis):
    # int8 pattern slabs: scale BEFORE the exchange (halo(d_loc ⊙ x) ==
    # d ⊙ halo(x) row-wise, one collective), aggregate the 0/1 tiles +
    # unit-valued residual, scale the local output rows — exactly
    # d ⊙ B (d ⊙ x) = Â·x per local slab.
    xs = (d_local[:, None] * x_local.astype(jnp.float32)).astype(x_local.dtype)
    out = _agg_hybrid_impl(
        xs, send_idx, tiles, trow, tcol, rrow, rcol, rval, n_local, n_buf, axis
    )
    return (d_local[:, None] * out).astype(out.dtype)


@partial(jax.custom_vjp, nondiff_argnums=(9, 10, 11))
def graphsum_dist_hybrid_scaled(x_local, d_local, send_idx, tiles, trow, tcol,
                                rrow, rcol, rval, n_local, n_buf, axis=AXIS):
    """graphsum_dist_hybrid for int8 PATTERN slabs (partition_graph_hybrid
    with tile_dtype=int8): tiles hold the exact 0/1 structure, residual values
    are 1, and d (= deg^{-1/2}, row-sharded) carries the normalization.
    Self-adjoint like the value version: diag(d)·B·diag(d) is symmetric."""
    return _agg_hybrid_scaled_impl(
        x_local, d_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        n_local, n_buf, axis,
    )


def _agg_hybrid_scaled_fwd(x_local, d_local, send_idx, tiles, trow, tcol,
                           rrow, rcol, rval, n_local, n_buf, axis):
    out = _agg_hybrid_scaled_impl(
        x_local, d_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        n_local, n_buf, axis,
    )
    return out, (d_local, send_idx, tiles, trow, tcol, rrow, rcol, rval)


def _agg_hybrid_scaled_bwd(n_local, n_buf, axis, res, g):
    d_local, send_idx, tiles, trow, tcol, rrow, rcol, rval = res
    dx = _agg_hybrid_scaled_impl(
        g, d_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        n_local, n_buf, axis,
    )
    return dx, None, None, None, None, None, None, None, None


graphsum_dist_hybrid_scaled.defvjp(_agg_hybrid_scaled_fwd, _agg_hybrid_scaled_bwd)


def _agg_hybrid_adaptive_impl(x_local, send_idx, tiles, trow, tcol, rrow,
                              rcol, rval, ptiles, ptrow, ptcol, pt_dst, prow,
                              pcol, pval, precv, n_local, n_buf, axis):
    """Hybrid tiles + COO residual with the per-pair PUSH/PULL halo
    (partition_graph_hybrid(adaptive=True)).

    Pull pairs + local edges ride graphsum_dist_hybrid's machinery (compact
    boundary buffer, rect tile kernel + residual segment_sum). Push pairs are
    owned by the SOURCE device: its push-tile slab (compact output blocks,
    LOCAL columns) partial-sums by the tile product, the push residual segment-sums
    straight into the exchange slab slots, pt_dst scatters the compact tile
    rows into the slab (pads drop), one all_to_all ships the partial ROWS,
    and the receiver scatter-adds them at precv."""
    from parallel_gcn.ops.bcsr import BCSR, bcsr_matmul_rect

    out = _agg_hybrid_impl(
        x_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        n_local, n_buf, axis,
    )
    n_slab = precv.shape[0]  # n_dev · push_slab
    # residual partials: slot-sorted segment_sum (pad slots -> n_slab, cut)
    contrib = pval[:, None].astype(x_local.dtype) * x_local[pcol]
    slab = jax.ops.segment_sum(
        contrib, prow, num_segments=n_slab + 1, indices_are_sorted=True
    )[:n_slab]
    # tile partials over LOCAL columns, compact output rows
    pk = BCSR(
        tiles=ptiles, tile_rows=ptrow, tile_cols=ptcol,
        n_nodes=n_local, n_tiles_real=ptiles.shape[0],
        n_rows=pt_dst.shape[0],
    )
    part = bcsr_matmul_rect(pk, x_local).astype(slab.dtype)
    slab = slab.at[pt_dst].add(part, mode="drop")
    recv = jax.lax.all_to_all(
        slab, axis, split_axis=0, concat_axis=0, tiled=True
    )
    return out.at[precv].add(recv.astype(out.dtype), mode="drop")


@partial(jax.custom_vjp, nondiff_argnums=(16, 17, 18))
def graphsum_dist_hybrid_adaptive(x_local, send_idx, tiles, trow, tcol, rrow,
                                  rcol, rval, ptiles, ptrow, ptcol, pt_dst,
                                  prow, pcol, pval, precv, n_local, n_buf,
                                  axis=AXIS):
    """Distributed Â·x: hybrid tile slabs + adaptive push/pull halo.

    Self-adjoint at the collective level like graphsum_dist_hybrid: the
    GLOBAL matrix is symmetric and the cotangent is row-sharded exactly like
    x, so dx on device d's rows is the SAME pipeline applied to g — however
    the edges were routed (pulled blocks, pushed partials)."""
    return _agg_hybrid_adaptive_impl(
        x_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        ptiles, ptrow, ptcol, pt_dst, prow, pcol, pval, precv,
        n_local, n_buf, axis,
    )


def _agg_hybrid_adaptive_fwd(x_local, send_idx, tiles, trow, tcol, rrow, rcol,
                             rval, ptiles, ptrow, ptcol, pt_dst, prow, pcol,
                             pval, precv, n_local, n_buf, axis):
    out = _agg_hybrid_adaptive_impl(
        x_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        ptiles, ptrow, ptcol, pt_dst, prow, pcol, pval, precv,
        n_local, n_buf, axis,
    )
    return out, (send_idx, tiles, trow, tcol, rrow, rcol, rval,
                 ptiles, ptrow, ptcol, pt_dst, prow, pcol, pval, precv)


def _agg_hybrid_adaptive_bwd(n_local, n_buf, axis, res, g):
    dx = _agg_hybrid_adaptive_impl(g, *res, n_local, n_buf, axis)
    return (dx,) + (None,) * 15


graphsum_dist_hybrid_adaptive.defvjp(
    _agg_hybrid_adaptive_fwd, _agg_hybrid_adaptive_bwd
)


def _agg_hybrid_adaptive_scaled_impl(x_local, d_local, *rest):
    # int8 pattern slabs (cf. _agg_hybrid_scaled_impl): scale the local rows
    # BEFORE any exchange — both the pulled halo rows and the pushed partial
    # sums then carry d-scaled operands — and scale the local output rows:
    # d ⊙ B (d ⊙ x) = Â·x, however the edges were routed.
    xs = (d_local[:, None] * x_local.astype(jnp.float32)).astype(x_local.dtype)
    out = _agg_hybrid_adaptive_impl(xs, *rest)
    return (d_local[:, None] * out).astype(out.dtype)


@partial(jax.custom_vjp, nondiff_argnums=(17, 18, 19))
def graphsum_dist_hybrid_adaptive_scaled(x_local, d_local, send_idx, tiles,
                                         trow, tcol, rrow, rcol, rval, ptiles,
                                         ptrow, ptcol, pt_dst, prow, pcol,
                                         pval, precv, n_local, n_buf,
                                         axis=AXIS):
    """graphsum_dist_hybrid_adaptive for int8 PATTERN slabs (multiplicity
    tiles + d = deg^{-1/2} row-sharded). diag(d)·B·diag(d) stays symmetric,
    so the self-adjoint collective shortcut holds unchanged."""
    return _agg_hybrid_adaptive_scaled_impl(
        x_local, d_local, send_idx, tiles, trow, tcol, rrow, rcol, rval,
        ptiles, ptrow, ptcol, pt_dst, prow, pcol, pval, precv,
        n_local, n_buf, axis,
    )


def _agg_hybrid_adaptive_scaled_fwd(x_local, d_local, *rest):
    out = _agg_hybrid_adaptive_scaled_impl(x_local, d_local, *rest)
    return out, (d_local,) + rest[:15]


def _agg_hybrid_adaptive_scaled_bwd(n_local, n_buf, axis, res, g):
    dx = _agg_hybrid_adaptive_scaled_impl(
        g, *res, n_local, n_buf, axis
    )
    return (dx,) + (None,) * 16


graphsum_dist_hybrid_adaptive_scaled.defvjp(
    _agg_hybrid_adaptive_scaled_fwd, _agg_hybrid_adaptive_scaled_bwd
)


def graphsum_ring(x_local, row_slabs, col_slabs, val_slabs, n_local, n_dev, axis=AXIS):
    """Distributed Â·x, ``ppermute`` ring halo (SURVEY.md §7.7): node blocks
    rotate around the device ring while each device aggregates the slab of edges
    whose sources are in the block it currently holds. Peak memory is one
    remote block (n_local × F) instead of the full gathered matrix
    (n_nodes × F), and XLA overlaps each rotation with the current slab's
    gather/segment_sum — the multi-chip analog of the reference's
    stream-overlap design (src/gcn.cu:5-11).

    Slabs come from ``partition_graph_ring``: slab ``s`` holds the edges whose
    source block arrives after ``s`` rotations. The scan runs n_dev steps; the
    final rotation returns blocks home (its result is unused).
    """
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def body(carry, slab):
        acc, blk = carry
        r, c, v = slab
        acc = acc + jax.ops.segment_sum(
            v[:, None].astype(blk.dtype) * blk[c],
            r,
            num_segments=n_local,
            indices_are_sorted=True,
        )
        blk = jax.lax.ppermute(blk, axis, perm)
        return (acc, blk), None

    acc0 = jnp.zeros((n_local, x_local.shape[-1]), x_local.dtype)
    (acc, _), _ = jax.lax.scan(
        body, (acc0, x_local), (row_slabs, col_slabs, val_slabs)
    )
    return acc


def _masked_ce_local(logits_local, labels_local, mask_local, num_samples,
                     axis=AXIS):
    """Masked softmax-CE + accuracy over the mesh: the shared row-wise core
    (ops.loss.masked_softmax_xent_sums — one source of truth for the
    max-subtraction/LSE/one-hot-select expression and the argmax==label
    accuracy count) reduced with psum across the node shards."""
    from parallel_gcn.ops.loss import masked_softmax_xent_sums

    loss_sum, correct = masked_softmax_xent_sums(
        logits_local, labels_local, mask_local
    )
    loss = jax.lax.psum(loss_sum, axis) / jnp.float32(num_samples)
    acc = jax.lax.psum(correct, axis) / jnp.float32(num_samples)
    return loss, acc


def _make_forward(cfg: Config, sgraph):
    """Shared sharded forward used by the train step, eval fns, and the fused
    whole-run program. Returns a namespace with:

    - ``aggregate(h, graph_args)`` — one distributed Â·h
    - ``forward(weights, x_local, graph_args, training, key, preagg=False)``
      — the full sharded GCN forward; ``preagg=True`` skips layer 0's
      aggregation (x_local already holds Â·X, see train.preaggregate_input)
    - ``forward_stacked(weights, x_local, x_eval_local, graph_args, dkey,
      train_preagg, eval_preagg)`` — train forward + DEFERRED eval forward
      with the last aggregation stacked along the lane dimension (the mesh
      port of train._fused_deferred_forward; same validity conditions)

    ``graph_args`` is the per-device tuple of graph arrays: (rowl, colg, val)
    for COO partitions (flat or ring) or (tiles, trow, tcol, rrow, rcol, rval)
    for the hybrid tile partition — plus sym_scale/send_idx per _graph_specs.
    """
    dropouts = tuple(cfg.gcn.dropouts)
    n_layers = cfg.gcn.n_layers
    n_local = sgraph.n_local
    n_dev = sgraph.n_dev
    hybrid = isinstance(sgraph, HybridShardedGraph)
    ring = (not hybrid) and sgraph.ring
    n_buf = sgraph.n_buf
    boundary = sgraph.send_idx is not None
    adaptive = (not hybrid) and getattr(sgraph, "push_slab", 0) > 0
    hyb_adaptive = hybrid and getattr(sgraph, "push_slab", 0) > 0
    scaled = hybrid and sgraph.sym_scale is not None
    precision = cfg.exec.matmul_precision
    residual = cfg.gcn.residual
    dtype = jnp.dtype(cfg.exec.compute_dtype)
    tp = max(getattr(cfg.exec, "tp", 1), 1)
    sched = _tp_schedule(n_layers) if tp > 1 else None
    agg_variant = cfg.gcn.model in ("sage", "gin")
    gin = cfg.gcn.model == "gin"
    gat = cfg.gcn.model == "gat"
    if gat and (hybrid or ring or adaptive or tp > 1):
        raise ValueError(
            "model=gat over the mesh supports the flat COO partition "
            "(all_gather/boundary halo; the per-destination edge softmax "
            "must stay device-local; tp is GCN-only) — set backend=segment, "
            "halo=all_gather|boundary, tp=1"
        )

    def _aggregate(h, graph_args):
        # graph_args order matches _graph_specs: base arrays, then sym_scale
        # (int8 packs), then send_idx (boundary halo), then the push group
        # (adaptive halo: 4 COO arrays, or 8 for the hybrid tile variant) —
        # peel statically
        args = list(graph_args)
        push_args = None
        if adaptive:
            push_args = args[-4:]
            del args[-4:]
        elif hyb_adaptive:
            push_args = args[-8:]
            del args[-8:]
        send = args.pop() if boundary else None
        if adaptive:
            return graphsum_dist_adaptive(
                h, *args, *push_args, n_local, send_idx=send
            )
        if hybrid:
            if hyb_adaptive:
                if scaled:
                    d = args.pop()
                    return graphsum_dist_hybrid_adaptive_scaled(
                        h, d, send, *args, *push_args, n_local, n_buf
                    )
                return graphsum_dist_hybrid_adaptive(
                    h, send, *args, *push_args, n_local, n_buf
                )
            if scaled:
                d = args.pop()
                return graphsum_dist_hybrid_scaled(
                    h, d, send, *args, n_local, n_buf
                )
            return graphsum_dist_hybrid(h, send, *args, n_local, n_buf)
        if ring:
            return graphsum_ring(h, *args, n_local, n_dev)
        return graphsum_dist(h, *args, n_local, send_idx=send)

    def _keys(key, training):
        if training and any(d > 0 for d in dropouts):
            # per-device independent dropout masks over the local rows
            key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
            keys = list(jax.random.split(key, n_layers))
            if tp > 1 and not gin:
                # feat-SHARDED layer inputs need independent masks per feat
                # device (together they form one iid mask over the full
                # width); feat-REPLICATED inputs ('col' layers) must mask
                # identically across feat or the replication invariant —
                # and the reference's shared-input-mask semantics — breaks.
                # a layer's input is feat-sharded exactly when the layer is
                # 'row' at index >= 1 (layer 0's input x is replicated; col
                # layers see the post-all_gather replicated form).
                # (GIN TP: every layer psums to a replicated output, so all
                # inputs are replicated — shared masks, no folding)
                tidx = jax.lax.axis_index(FEAT)
                keys = [
                    jax.random.fold_in(k, tidx)
                    if (i > 0 and sched[i] == "row") else k
                    for i, k in enumerate(keys)
                ]
            return keys
        return [None] * n_layers

    # remat × tp: checkpointing a TP layer must NOT re-run its feat-axis
    # collectives in the backward recompute — tag their outputs and save
    # exactly those (everything else — dropout masks, matmul intermediates,
    # the gathered halo buffers — is recomputed, which is the memory win)
    from jax.ad_checkpoint import checkpoint_name as _ckpt_name
    _TP_SAVE = jax.checkpoint_policies.save_only_these_names("tp_comm")

    def _rep_in_schedule():
        """Static per-layer replication flags for the TP forward: rep_in[l]
        says whether layer l's input is feat-replicated; gather_after[l] says
        the inter-layer all_gather runs after layer l (next layer is 'col'
        with a feat-sharded input)."""
        rep_in, gather_after = [], []
        rep = True
        for i, kind in enumerate(sched):
            rep_in.append(rep)
            last = i == n_layers - 1
            rep = kind == "row" and last
            gather = (not last) and sched[i + 1] == "col" and not rep
            gather_after.append(gather)
            if gather:
                rep = True
        return rep_in, gather_after

    def _tp_layer(h, rep, layer, w, graph_args, lkey, training, preagg):
        """One tensor-parallel layer: dropout → (sharded) matmul →
        reduction/aggregation per the col/row schedule. ``rep`` (static) says
        whether ``h`` is feat-replicated; returns h'.

        The key property making every halo mode compose: Â·H is COLUMN-
        independent, so aggregating the feature-sharded [n_local, d/tp]
        activations does exactly 1/tp of the aggregation work per device —
        the inter-layer psum of Megatron splits into reduce_scatter →
        aggregate → all_gather with no replicated aggregation anywhere
        except the n_classes-wide last layer."""
        kind = sched[layer]
        last = layer == n_layers - 1
        h = dropout(h, dropouts[layer], lkey, training=training)
        if kind == "col":
            # input replicated; W [d_in, d_out/tp] → output feat-sharded
            h = feature_transform(
                h, w, precision=precision, out_dtype=dtype
            )
            if not (layer == 0 and preagg):
                h = _aggregate(h, graph_args).astype(dtype)
            return h
        if rep:
            # replicated input into a row-sharded weight: local slice is free
            shard = w.shape[0]
            h = jax.lax.dynamic_slice_in_dim(
                h, jax.lax.axis_index(FEAT) * shard, shard, 1
            )
        partial = feature_transform(
            h, w, precision=precision, out_dtype=dtype
        )
        if last:
            # n_classes wide: plain psum; the (tiny) aggregation replicates
            h = _ckpt_name(jax.lax.psum(partial, FEAT), "tp_comm")
            if not (layer == 0 and preagg):
                h = _aggregate(h, graph_args).astype(dtype)
            return h
        h = _ckpt_name(
            jax.lax.psum_scatter(partial, FEAT, scatter_dimension=1,
                                 tiled=True),
            "tp_comm",
        )
        if not (layer == 0 and preagg):
            h = _aggregate(h, graph_args).astype(dtype)
        return h

    def _tp_layer_fn(layer, rep, training, preagg, graph_args):
        """Bind a layer's static config; checkpoint when remat is on (the
        tagged collectives stay saved — backward re-runs no feat-axis
        collective; the halo exchange re-runs only where its output is not a
        checkpoint boundary, i.e. never for these layer bodies)."""
        def run(h, w, lkey):
            return _tp_layer(h, rep, layer, w, graph_args, lkey, training,
                             preagg)

        if cfg.gcn.remat and training:
            return jax.checkpoint(run, policy=_TP_SAVE)
        return run

    def forward_tp(weights, x_local, graph_args, training, key, preagg=False):
        keys = _keys(key, training)
        h = x_local.astype(dtype)
        rep_in, gather_after = _rep_in_schedule()
        prev = None  # kept in the feat-sharded (pre-gather) form
        for layer in range(n_layers):
            fn = _tp_layer_fn(layer, rep_in[layer], training, preagg,
                              graph_args)
            h = fn(h, weights[layer], keys[layer])
            if (
                residual
                and 0 < layer < n_layers - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if layer < n_layers - 1:
                h = jax.nn.relu(h)
                prev = h
                if gather_after[layer]:
                    # next layer wants a replicated input
                    h = jax.lax.all_gather(h, FEAT, axis=1, tiled=True)
        return h.astype(jnp.float32)

    def forward_stacked_tp(weights, x_local, x_eval_local, graph_args, dkey,
                           train_preagg, eval_preagg):
        # TP port of forward_stacked: the prefix ends feat-sharded (layer
        # n-1 is 'row'), the stacked [train|eval] logits ride ONE psum over
        # feat and ONE last aggregation.
        L = n_layers
        keys = _keys(dkey, True)
        rep_in, gather_after = _rep_in_schedule()

        def prefix(h, training, preagg):
            prev = None
            ks = keys if training else [None] * L
            for layer in range(L - 1):
                fn = _tp_layer_fn(layer, rep_in[layer], training, preagg,
                                  graph_args)
                h = fn(h, weights[layer], ks[layer])
                if (
                    residual
                    and 0 < layer < L - 1
                    and prev is not None
                    and prev.shape == h.shape
                ):
                    h = h + prev
                h = jax.nn.relu(h)
                prev = h
                if layer + 1 < L - 1 and gather_after[layer]:
                    h = jax.lax.all_gather(h, FEAT, axis=1, tiled=True)
            return h, rep_in[L - 1]

        share = (
            all(d == 0 for d in dropouts[: L - 1])
            and train_preagg == eval_preagg
        )
        ht, rep_t = prefix(x_local.astype(dtype), True, train_preagg)
        he, rep_e = (ht, rep_t) if share else prefix(
            x_eval_local.astype(dtype), False, eval_preagg
        )

        def last_in(h, rep):
            if rep:  # odd n_layers: slice the replicated input locally
                shard = weights[L - 1].shape[0]
                h = jax.lax.dynamic_slice_in_dim(
                    h, jax.lax.axis_index(FEAT) * shard, shard, 1
                )
            return h

        at = dropout(ht, dropouts[L - 1], keys[L - 1], training=True)
        at = feature_transform(
            last_in(at, rep_t), weights[L - 1], precision=precision,
            out_dtype=dtype,
        )
        ae = feature_transform(
            last_in(he, rep_e), weights[L - 1], precision=precision,
            out_dtype=dtype,
        )
        n_classes = at.shape[1]
        stacked = jax.lax.psum(jnp.concatenate([at, ae], axis=1), FEAT)
        stacked = _aggregate(stacked, graph_args)
        return (
            stacked[:, :n_classes].astype(jnp.float32),
            stacked[:, n_classes:].astype(jnp.float32),
        )

    def forward_gat(weights, x_local, graph_args, training, key,
                    preagg=False):
        """Mesh GAT forward: each device owns ALL edges of its dst rows, so
        the per-destination edge softmax is device-local; ONE halo exchange
        per layer carries the concatenated [W·h | t] rows (the attention's
        remote operands travel together). The aggregation is models/gat.py's
        segment backend over the flat COO node partition, full or
        edge-chunked streaming, on the all_gather or boundary halo — the
        ring splits a row's
        edges across rotation steps and the adaptive push pairs move them
        off-device, either of which would break the local row softmax."""
        from parallel_gcn.models.gat import LEAKY_SLOPE, _NEG

        heads = cfg.gcn.heads
        attn_rate = cfg.gcn.attn_dropout
        edge_chunk = cfg.exec.edge_chunk
        args = list(graph_args)
        send = args.pop() if boundary else None
        rowl, colb, val = args
        live = (val != 0.0)[:, None]
        assert not preagg  # no GAT analog (data-dependent aggregation)
        h = x_local.astype(dtype)
        if training and (any(d > 0 for d in dropouts) or attn_rate > 0):
            assert key is not None
            key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
            keys = list(jax.random.split(key, 2 * n_layers))
        else:
            keys = [None] * (2 * n_layers)

        def _attend_full(s, t_buf, hw_buf, k_attn):
            e = jax.nn.leaky_relu(s[rowl] + t_buf[colb], LEAKY_SLOPE)
            e = jnp.where(live, e, jnp.asarray(_NEG, e.dtype))
            m = jax.ops.segment_max(e, rowl, num_segments=n_local,
                                    indices_are_sorted=True)
            m = jnp.maximum(m, jnp.asarray(_NEG, e.dtype))
            wgt = jnp.where(live, jnp.exp(e - m[rowl]), 0.0)
            # f32 accumulation: bf16 accumulators drop per-edge increments
            # on high-degree rows (see models/gat.py)
            den = jax.ops.segment_sum(wgt.astype(jnp.float32), rowl,
                                      num_segments=n_local,
                                      indices_are_sorted=True)
            den_e = jnp.maximum(den, 1e-16)[rowl]
            alpha = wgt / den_e.astype(wgt.dtype)
            if training and attn_rate > 0:
                alpha = dropout(alpha, attn_rate, k_attn, training=True)
            return jax.ops.segment_sum(
                (alpha[:, :, None] * hw_buf[colb]).astype(jnp.float32),
                rowl, num_segments=n_local, indices_are_sorted=True,
            )

        def _attend_chunked(s, t_buf, hw_buf, k_attn):
            """Per-device streaming edge softmax over the LOCAL slab — the
            mesh port of models/gat.py._attend_segment_chunked (two-pass:
            running segment-max, then exp-accumulate numerator/denominator),
            gathering sources from the halo buffer. Bounds the per-edge
            working set to O(edge_chunk) per chip so reddit-scale attention
            shards without materializing the [E/D, heads] logits."""
            E = rowl.shape[0]
            chunk = min(edge_chunk, E)
            nc = -(-E // chunk)
            pad = nc * chunk - E
            row_c, col_c, live_c = rowl, colb, (val != 0.0)
            if pad:
                row_c = jnp.concatenate(
                    [row_c, jnp.full(pad, n_local - 1, row_c.dtype)])
                col_c = jnp.concatenate([col_c, jnp.zeros(pad, col_c.dtype)])
                live_c = jnp.concatenate([live_c, jnp.zeros(pad, bool)])
            xs = (
                row_c.reshape(nc, chunk),
                col_c.reshape(nc, chunk),
                live_c.reshape(nc, chunk),
                jnp.arange(nc),
            )

            def logits(r, c, lv):
                e = jax.nn.leaky_relu(s[r] + t_buf[c], LEAKY_SLOPE)
                return jnp.where(lv[:, None], e, jnp.asarray(_NEG, e.dtype))

            def max_body(m, x):
                r, c, lv, _ = x
                cm = jax.ops.segment_max(logits(r, c, lv), r,
                                         num_segments=n_local,
                                         indices_are_sorted=True)
                return jnp.maximum(m, cm), None

            m0 = jnp.full((n_local, heads), _NEG, s.dtype)
            m, _ = jax.lax.scan(max_body, m0, xs)
            # exact: softmax is invariant to the subtracted max (see
            # models/gat.py) — stop-gradient keeps scan-backward from saving
            # the max pass's per-chunk residuals
            m = jax.lax.stop_gradient(m)
            drop = training and attn_rate > 0.0

            def acc_body(carry, x):
                num, den = carry
                r, c, lv, i = x
                e = logits(r, c, lv)
                wgt = jnp.where(lv[:, None], jnp.exp(e - m[r]), 0.0)
                den = den + jax.ops.segment_sum(
                    wgt.astype(jnp.float32), r, num_segments=n_local,
                    indices_are_sorted=True,
                )
                wn = wgt
                if drop:
                    wn = dropout(wgt, attn_rate, jax.random.fold_in(k_attn, i))
                num = num + jax.ops.segment_sum(
                    (wn[:, :, None] * hw_buf[c]).astype(jnp.float32), r,
                    num_segments=n_local, indices_are_sorted=True,
                )
                return (num, den), None

            d_out = hw_buf.shape[-1]
            num0 = jnp.zeros((n_local, heads, d_out), jnp.float32)
            den0 = jnp.zeros((n_local, heads), jnp.float32)
            # checkpoint each step: scan-backward saves only the O(n_local)
            # carries and recomputes the chunk internals
            (num, den), _ = jax.lax.scan(jax.checkpoint(acc_body),
                                         (num0, den0), xs)
            return num / jnp.maximum(den, 1e-16)[:, :, None]

        def layer_fn(h, w, k_feat, k_attn, last):
            d_out = w["a_src"].shape[1]
            h = dropout(h, dropouts[layer], k_feat, training=training)
            hw = feature_transform(h, w["W"], precision=precision,
                                   out_dtype=dtype)
            hw3 = hw.reshape(hw.shape[0], heads, d_out)
            s = jnp.einsum("nhd,hd->nh", hw3, w["a_src"].astype(dtype))
            t = jnp.einsum("nhd,hd->nh", hw3, w["a_dst"].astype(dtype))
            buf = _gather_buffer(jnp.concatenate([hw, t], axis=1), send, AXIS)
            hw_buf = buf[:, : hw.shape[1]].reshape(-1, heads, d_out)
            t_buf = buf[:, hw.shape[1]:]
            if edge_chunk and edge_chunk < rowl.shape[0]:
                attend = _attend_chunked
            else:
                attend = _attend_full
            out = attend(s, t_buf, hw_buf, k_attn).astype(dtype)
            if last:
                return out.mean(axis=1)
            return out.reshape(out.shape[0], heads * d_out)

        prev = None
        for layer in range(n_layers):
            last = layer == n_layers - 1
            fn = layer_fn
            if cfg.gcn.remat and training:
                # same lever as the single-chip model: recompute this
                # layer's per-edge intermediates in backward
                fn = jax.checkpoint(layer_fn, static_argnums=(4,))
            h = fn(h, weights[layer], keys[2 * layer], keys[2 * layer + 1],
                   last)
            if not last:
                if (
                    residual and layer > 0 and prev is not None
                    and prev.shape == h.shape
                ):
                    h = h + prev
                h = jax.nn.elu(h)
                prev = h
        return h.astype(jnp.float32)

    def forward_agg_variant(weights, x_local, graph_args, training, key,
                            preagg=False):
        """Mesh SAGE/GIN forward (models/sage.py over the node partition).

        The exact diagonal rewrites route everything through the SAME
        distributed Â·x operator: SUM = s ⊙ Â·(s ⊙ h), MEAN = Â·(s ⊙ h) / s
        with s = sqrt(deg) row-sharded like x. The scaling is applied to the
        LOCAL rows before _aggregate, so the scaled rows are what every halo
        design ships (boundary all_to_all, adaptive push partials, ring
        blocks, tile slabs, int8 scaled packs) — no exchange-path changes.
        ``graph_args`` carries sdeg_local LAST (sharded_sqrt_deg /
        _graph_specs with_sdeg contract)."""
        assert not preagg  # no loop-invariant first aggregation to hoist
        sdeg, gargs = graph_args[-1], graph_args[:-1]
        sage = cfg.gcn.model == "sage"
        h = x_local.astype(dtype)
        keys = _keys(key, training)
        s = sdeg.astype(dtype)[:, None]
        eps = jnp.asarray(cfg.gcn.gin_eps, dtype)

        def layer_fn(h, w, lkey, layer):
            h = dropout(h, dropouts[layer], lkey, training=training)
            if sage:
                h_self = feature_transform(
                    h, w["self"], precision=precision, out_dtype=dtype
                )
                h_neigh = feature_transform(
                    h, w["neigh"], precision=precision, out_dtype=dtype
                )
                mean = (_aggregate(s * h_neigh, gargs) / s).astype(dtype)
                return h_self + mean
            z = eps * h + (s * _aggregate(s * h, gargs)).astype(dtype)
            z = feature_transform(
                z, w["w1"], precision=precision, out_dtype=dtype
            )
            if "w2" in w:
                z = feature_transform(
                    jax.nn.relu(z), w["w2"], precision=precision,
                    out_dtype=dtype,
                )
            return z

        prev = None
        for layer in range(n_layers):
            fn = layer_fn
            if cfg.gcn.remat and training:
                fn = jax.checkpoint(layer_fn, static_argnums=(3,))
            h = fn(h, weights[layer], keys[layer], layer)
            if (
                residual
                and 0 < layer < n_layers - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if layer < n_layers - 1:
                h = jax.nn.relu(h)
                prev = h
        return h.astype(jnp.float32)

    def forward_agg_tp(weights, x_local, graph_args, training, key,
                       preagg=False):
        """Tensor-parallel SAGE/GIN over the (nodes, feat) mesh.

        SAGE rides the GCN's alternating col/row Megatron schedule with BOTH
        per-layer weights (self/neigh — identical shapes) sharded the same
        way; the neighbor mean's aggregation is column-independent, so 'col'
        layers aggregate the feat-sharded width with zero communication and
        'row' layers reduce each matmul's partials with ONE psum_scatter
        before aggregating the shard (the last layer psums to replicated
        logits). GIN treats each layer's MLP as its own Megatron pair
        (w1 col → relu feat-sharded → w2 row → psum): the aggregation runs on
        the REPLICATED layer input before the pair (redundant across feat —
        GIN aggregates pre-MLP, so sharding it would trade the redundancy
        for an extra all_gather of the same bytes), and every layer output
        is replicated."""
        assert not preagg
        sdeg, gargs = graph_args[-1], graph_args[:-1]
        sage = cfg.gcn.model == "sage"
        keys = _keys(key, training)
        s = sdeg.astype(dtype)[:, None]
        eps = jnp.asarray(cfg.gcn.gin_eps, dtype)
        rep_in, gather_after = _rep_in_schedule() if sage else (None, None)

        def agg_mean(z):
            return (_aggregate(s * z, gargs) / s).astype(dtype)

        def sage_layer(h, w, lkey, layer, rep):
            kind = sched[layer]
            last = layer == n_layers - 1
            h = dropout(h, dropouts[layer], lkey, training=training)
            if kind == "col":
                hs = feature_transform(h, w["self"], precision=precision,
                                       out_dtype=dtype)
                hn = feature_transform(h, w["neigh"], precision=precision,
                                       out_dtype=dtype)
                return hs + agg_mean(hn)
            if rep:
                shard = w["self"].shape[0]
                h = jax.lax.dynamic_slice_in_dim(
                    h, jax.lax.axis_index(FEAT) * shard, shard, 1
                )
            ps = feature_transform(h, w["self"], precision=precision,
                                   out_dtype=dtype)
            pn = feature_transform(h, w["neigh"], precision=precision,
                                   out_dtype=dtype)
            if last:
                ps = _ckpt_name(jax.lax.psum(ps, FEAT), "tp_comm")
                pn = _ckpt_name(jax.lax.psum(pn, FEAT), "tp_comm")
            else:
                ps = _ckpt_name(
                    jax.lax.psum_scatter(ps, FEAT, scatter_dimension=1,
                                         tiled=True), "tp_comm")
                pn = _ckpt_name(
                    jax.lax.psum_scatter(pn, FEAT, scatter_dimension=1,
                                         tiled=True), "tp_comm")
            return ps + agg_mean(pn)

        def gin_layer(h, w, lkey, layer, rep):
            del rep  # every GIN TP layer input is replicated
            h = dropout(h, dropouts[layer], lkey, training=training)
            z = eps * h + (s * _aggregate(s * h, gargs)).astype(dtype)
            if "w2" in w:
                z1 = feature_transform(z, w["w1"], precision=precision,
                                       out_dtype=dtype)  # col → feat-sharded
                p = feature_transform(jax.nn.relu(z1), w["w2"],
                                      precision=precision, out_dtype=dtype)
                return _ckpt_name(jax.lax.psum(p, FEAT), "tp_comm")
            shard = w["w1"].shape[0]
            zs = jax.lax.dynamic_slice_in_dim(
                z, jax.lax.axis_index(FEAT) * shard, shard, 1
            )
            p = feature_transform(zs, w["w1"], precision=precision,
                                  out_dtype=dtype)
            return _ckpt_name(jax.lax.psum(p, FEAT), "tp_comm")

        layer_fn = sage_layer if sage else gin_layer
        h = x_local.astype(dtype)
        prev = None
        for layer in range(n_layers):
            fn = layer_fn
            if cfg.gcn.remat and training:
                fn = jax.checkpoint(layer_fn, policy=_TP_SAVE,
                                    static_argnums=(3, 4))
            h = fn(h, weights[layer], keys[layer], layer,
                   rep_in[layer] if sage else False)
            if (
                residual
                and 0 < layer < n_layers - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if layer < n_layers - 1:
                h = jax.nn.relu(h)
                prev = h
                if sage and gather_after[layer]:
                    h = jax.lax.all_gather(h, FEAT, axis=1, tiled=True)
        return h.astype(jnp.float32)

    def forward(weights, x_local, graph_args, training, key, preagg=False):
        if gat:
            return forward_gat(weights, x_local, graph_args, training, key,
                               preagg)
        if agg_variant:
            if tp > 1:
                return forward_agg_tp(weights, x_local, graph_args,
                                      training, key, preagg)
            return forward_agg_variant(weights, x_local, graph_args,
                                       training, key, preagg)
        if tp > 1:
            return forward_tp(weights, x_local, graph_args, training, key,
                              preagg)
        h = x_local.astype(dtype)
        keys = _keys(key, training)

        def layer_fn(h, w, lkey, layer, skip_agg):
            h = dropout(h, dropouts[layer], lkey, training=training)
            h = feature_transform(h, w, precision=precision, out_dtype=dtype)
            if not skip_agg:
                h = _aggregate(h, graph_args).astype(dtype)
            return h

        prev = None
        for layer in range(n_layers):
            fn = layer_fn
            if cfg.gcn.remat and training:
                # same per-layer recompute lever as the single-chip model
                fn = jax.checkpoint(layer_fn, static_argnums=(3, 4))
            h = fn(h, weights[layer], keys[layer], layer,
                   layer == 0 and preagg)
            if (
                residual
                and 0 < layer < n_layers - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if layer < n_layers - 1:
                h = jax.nn.relu(h)
                prev = h
        return h.astype(jnp.float32)

    def forward_stacked(weights, x_local, x_eval_local, graph_args, dkey,
                        train_preagg, eval_preagg):
        # mesh port of train._fused_deferred_forward: the last layer's
        # aggregation is only n_classes wide — train and (deferred) eval
        # logits stacked side-by-side ride ONE aggregation (and, under the
        # halo designs, ONE collective) at the same hardware cost. Valid only
        # on the static-epoch schedule; caller realigns val metrics by one.
        if tp > 1:
            return forward_stacked_tp(
                weights, x_local, x_eval_local, graph_args, dkey,
                train_preagg, eval_preagg,
            )
        L = n_layers
        keys = _keys(dkey, True)

        def prefix(h, training, preagg):
            def layer_fn(h, w, lkey, layer, skip_agg):
                h = dropout(h, dropouts[layer], lkey, training=training)
                h = feature_transform(h, w, precision=precision,
                                      out_dtype=dtype)
                if not skip_agg:
                    h = _aggregate(h, graph_args).astype(dtype)
                return h

            prev = None
            for layer in range(L - 1):
                fn = layer_fn
                if cfg.gcn.remat and training:
                    fn = jax.checkpoint(layer_fn, static_argnums=(3, 4))
                h = fn(h, weights[layer],
                       keys[layer] if training else None, layer,
                       layer == 0 and preagg)
                if (
                    residual
                    and 0 < layer < L - 1
                    and prev is not None
                    and prev.shape == h.shape
                ):
                    h = h + prev
                h = jax.nn.relu(h)
                prev = h
            return h

        share = (
            all(d == 0 for d in dropouts[: L - 1])
            and train_preagg == eval_preagg
        )
        ht = prefix(x_local.astype(dtype), True, train_preagg)
        he = ht if share else prefix(
            x_eval_local.astype(dtype), False, eval_preagg
        )
        at = dropout(ht, dropouts[L - 1], keys[L - 1], training=True)
        at = feature_transform(at, weights[L - 1], precision=precision,
                               out_dtype=dtype)
        ae = feature_transform(he, weights[L - 1], precision=precision,
                               out_dtype=dtype)
        n_classes = at.shape[1]
        stacked = _aggregate(jnp.concatenate([at, ae], axis=1), graph_args)
        return (
            stacked[:, :n_classes].astype(jnp.float32),
            stacked[:, n_classes:].astype(jnp.float32),
        )

    from types import SimpleNamespace

    return SimpleNamespace(
        forward=forward, aggregate=_aggregate, forward_stacked=forward_stacked,
        n_layers=n_layers, supports_stacked=not gat and not agg_variant,
    )


def sharded_sqrt_deg(ds, sgraph) -> np.ndarray:
    """Row-sharded self-loop-inclusive sqrt(deg) [n_dev, n_local] (f32, 1.0 on
    padding rows) — the diagonal of the SAGE/GIN rewrites, aligned with the
    partition's node permutation like shard_dataset's arrays. Mirrors
    data.graph.build_graph's single-chip Graph.sqrt_deg."""
    s = np.ones(sgraph.n_nodes_pad, np.float32)
    s[: ds.n_nodes] = np.sqrt(np.diff(ds.graph.indptr).astype(np.float32))
    perm = getattr(sgraph, "node_perm", None)
    if perm is not None:
        s = s[perm]
    return s.reshape(sgraph.n_dev, sgraph.n_local)


def _graph_specs(sgraph, with_sdeg: bool = False):
    """(in_specs tuple, array tuple) for the partition's graph arrays.

    Order contract (mirrored by _make_forward._aggregate): base arrays, then
    sym_scale when present (int8 packs), then send_idx when present (boundary
    halo), then the push group when present (adaptive halo).
    ``with_sdeg=True`` (SAGE/GIN) reserves ONE extra trailing slot for the
    sharded_sqrt_deg array, which device_put_sharded_inputs appends and
    forward_agg_variant peels before _aggregate sees the tuple."""
    hybrid = isinstance(sgraph, HybridShardedGraph)
    if hybrid:
        arrays = (sgraph.tiles, sgraph.trow, sgraph.tcol,
                  sgraph.res_row, sgraph.res_col, sgraph.res_val)
        specs = (P(AXIS, None, None, None), P(AXIS, None), P(AXIS, None),
                 P(AXIS, None), P(AXIS, None), P(AXIS, None))
        if sgraph.sym_scale is not None:
            arrays = arrays + (sgraph.sym_scale,)
            specs = specs + (P(AXIS, None),)
    elif sgraph.ring:
        arrays = (sgraph.row_local, sgraph.col, sgraph.val)
        specs = (P(AXIS, None, None),) * 3
    else:
        arrays = (sgraph.row_local, sgraph.col, sgraph.val)
        specs = (P(AXIS, None),) * 3
    if sgraph.send_idx is not None:
        arrays = arrays + (sgraph.send_idx,)
        specs = specs + (P(AXIS, None),)
    if getattr(sgraph, "push_slab", 0):
        if hybrid:
            arrays = arrays + (sgraph.ptiles, sgraph.ptrow, sgraph.ptcol,
                               sgraph.pt_dst, sgraph.prow, sgraph.pcol,
                               sgraph.pval, sgraph.push_recv)
            specs = specs + (P(AXIS, None, None, None),) + (
                (P(AXIS, None),) * 7
            )
        else:
            arrays = arrays + (sgraph.push_row, sgraph.push_col,
                               sgraph.push_val, sgraph.push_recv)
            specs = specs + (P(AXIS, None),) * 4
    if with_sdeg:
        specs = specs + (P(AXIS, None),)
    return specs, arrays


def make_parallel_epoch_step(
    cfg: Config,
    mesh: Mesh,
    sgraph: ShardedGraph,
    split_counts: dict,
):
    """Build the jitted multi-chip epoch step.

    Signature: (weights, opt_state, key, x, labels, split) ->
               (weights', opt_state', key', metrics[4])
    where x/labels/split are row-sharded over the mesh and weights/opt are
    replicated.
    """
    adam = cfg.adam
    wd = adam.weight_decay
    tp = max(cfg.exec.tp, 1)
    n_train = split_counts[TRAIN]
    n_val = split_counts[VAL]
    forward = _make_forward(cfg, sgraph).forward
    graph_specs, _ = _graph_specs(
        sgraph, with_sdeg=cfg.gcn.model in ("sage", "gin"))
    wspecs = _weight_specs(cfg.gcn.n_layers, tp, cfg.gcn.model)

    def _pen(w0):
        # W0 is feat-sharded under tp: the L2 norm needs the full weight
        l2 = l2_penalty(w0)
        if tp > 1:
            l2 = jax.lax.psum(l2, FEAT)
        return jnp.float32(wd) * l2 / 2.0

    def step(weights, opt_state, key, x_local, labels_local, split_local,
             *graph_args):
        # graph arrays arrive with a leading size-1 device axis; drop it
        graph_args = tuple(a[0] for a in graph_args)
        key, dkey = jax.random.split(key)
        train_mask = split_local == TRAIN

        def loss_fn(w):
            logits = forward(w, x_local, graph_args, True, dkey)
            loss, acc = _masked_ce_local(logits, labels_local, train_mask, n_train)
            return loss, acc

        (ce, train_acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(weights)
        # weight grads reduce over the node shards only — each feat device
        # owns its weight shard and its grad is already complete
        grads = jax.lax.psum(grads, AXIS)
        train_loss = ce + _pen(weights[0])

        weights, opt_state = adam_step(
            weights, grads, opt_state,
            learning_rate=adam.learning_rate, weight_decay=wd,
            beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps,
        )

        val_logits = forward(weights, x_local, graph_args, False, None)
        val_ce, val_acc = _masked_ce_local(
            val_logits, labels_local, split_local == VAL, n_val
        )
        val_loss = val_ce + _pen(weights[0])
        metrics = jnp.stack([train_loss, train_acc, val_loss, val_acc])
        return weights, opt_state, key, metrics

    sharded_step = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(
            wspecs, _opt_specs(wspecs), P(),  # weights, opt, key
            P(AXIS, None), P(AXIS), P(AXIS),  # x, labels, split: row-sharded
            *graph_specs,
        ),
        out_specs=(wspecs, _opt_specs(wspecs), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded_step, donate_argnums=(0, 1))


def make_parallel_eval_fn(
    cfg: Config,
    mesh: Mesh,
    sgraph: ShardedGraph,
    split_counts: dict,
    split: int,
    preagg: bool = False,
):
    """Jitted multi-chip eval on one split: (weights, *inputs) -> (loss, acc).

    Counterpart of GCN::eval (src/gcn.cu:293-303) over the node-partitioned
    graph; loss includes the wd*||W0||^2/2 term like finalize
    (src/gcn.cu:440-455). ``preagg=True``: x_local already holds Â·X and
    layer 0's aggregation is skipped."""
    wd = cfg.adam.weight_decay
    tp = max(cfg.exec.tp, 1)
    n = split_counts[split]
    forward = _make_forward(cfg, sgraph).forward
    graph_specs, _ = _graph_specs(
        sgraph, with_sdeg=cfg.gcn.model in ("sage", "gin"))
    wspecs = _weight_specs(cfg.gcn.n_layers, tp, cfg.gcn.model)

    def eval_step(weights, x_local, labels_local, split_local, *graph_args):
        graph_args = tuple(a[0] for a in graph_args)
        logits = forward(weights, x_local, graph_args, False, None,
                         preagg=preagg)
        ce, acc = _masked_ce_local(logits, labels_local, split_local == split, n)
        l2 = l2_penalty(weights[0])
        if tp > 1:
            l2 = jax.lax.psum(l2, FEAT)
        loss = ce + jnp.float32(wd) * l2 / 2.0
        return loss, acc

    sharded = jax.shard_map(
        eval_step,
        mesh=mesh,
        in_specs=(
            wspecs,
            P(AXIS, None), P(AXIS), P(AXIS),
            *graph_specs,
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_preagg_fn(cfg: Config, mesh: Mesh, sgraph):
    """One sharded Â·X pass for the input pre-aggregation hoist — the mesh
    counterpart of train.preaggregate_input (exact reassociation:
    Â·(X·W0) = (Â·X)·W0 with zero input dropout; eval side always)."""
    pm = _make_forward(cfg, sgraph)
    graph_specs, _ = _graph_specs(sgraph)

    def f(x_local, *graph_args):
        graph_args = tuple(a[0] for a in graph_args)
        return pm.aggregate(x_local, graph_args)

    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(AXIS, None), *graph_specs),
        out_specs=P(AXIS, None), check_vma=False,
    ))


def make_parallel_run(
    cfg: Config,
    mesh: Mesh,
    sgraph: ShardedGraph,
    split_counts: dict,
    train_preagg: bool = False,
    eval_preagg: bool = False,
):
    """Fused multi-chip whole-run program — the mesh port of
    train._make_scan_run: ONE jitted shard_map contains the entire epoch loop
    (lax.scan on the static schedule, lax.while_loop with ON-DEVICE early
    stopping otherwise), so a full training run makes ZERO per-epoch
    host↔device round-trips (the eager parallel path pays one metrics D2H per
    epoch). On the static schedule the deferred-eval lane stacking rides
    train+eval logits through ONE last aggregation — which under the halo
    designs also halves the epoch's last-layer collectives.

    Signature: (weights, opt, key, x_train, x_eval, labels, split, *graph) ->
               (weights', opt', metrics[epochs, 4], epochs_run)
    where x_train/x_eval are row-sharded (pre-aggregated per the
    train_preagg/eval_preagg flags) and metrics/epochs_run are replicated.
    """
    # same invariant GCNModel.apply asserts: Â·(drop(X)·W0) ≠ drop(Â·X)·W0,
    # so the train-side hoist is only an exact rewrite with zero input dropout
    assert not (train_preagg and cfg.gcn.dropouts[0] > 0), (
        "train_preagg requires input dropout 0 (the hoist is not exact "
        "under dropout; see train.preaggregate_input)"
    )
    adam = cfg.adam
    wd = adam.weight_decay
    tp = max(cfg.exec.tp, 1)
    epochs = cfg.gcn.epochs
    k = cfg.gcn.early_stopping
    if k > epochs:
        # the stopping test (epoch+1 >= k) can never fire — and the k-sized
        # window would not fit the epochs-sized history buffer
        k = 0
    n_train = split_counts[TRAIN]
    n_val = split_counts[VAL]
    pm = _make_forward(cfg, sgraph)
    graph_specs, _ = _graph_specs(
        sgraph, with_sdeg=cfg.gcn.model in ("sage", "gin"))
    wspecs = _weight_specs(cfg.gcn.n_layers, tp, cfg.gcn.model)

    def run(weights, opt_state, key, x_local, x_eval_local, labels_local,
            split_local, *graph_args):
        graph_args = tuple(a[0] for a in graph_args)
        train_mask = split_local == TRAIN
        val_mask = split_local == VAL

        def pen(w0):
            l2 = l2_penalty(w0)
            if tp > 1:
                l2 = jax.lax.psum(l2, FEAT)
            return jnp.float32(wd) * l2 / 2.0

        def take_adam_step(weights, grads, opt_state):
            return adam_step(
                weights, grads, opt_state,
                learning_rate=adam.learning_rate, weight_decay=wd,
                beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps,
            )

        def eval_val(weights):
            logits = pm.forward(
                weights, x_eval_local, graph_args, False, None,
                preagg=eval_preagg,
            )
            return _masked_ce_local(logits, labels_local, val_mask, n_val)

        def one_epoch(weights, opt_state, key):
            key, dkey = jax.random.split(key)

            def loss_fn(w):
                logits = pm.forward(
                    w, x_local, graph_args, True, dkey, preagg=train_preagg
                )
                return _masked_ce_local(logits, labels_local, train_mask,
                                        n_train)

            (ce, train_acc), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(weights)
            grads = jax.lax.psum(grads, AXIS)
            train_loss = ce + pen(weights[0])
            weights, opt_state = take_adam_step(weights, grads, opt_state)
            val_ce, val_acc = eval_val(weights)
            val_loss = val_ce + pen(weights[0])
            return (weights, opt_state, key,
                    train_loss, train_acc, val_loss, val_acc)

        # deferred-eval fusion: valid only on the static-epoch schedule (the
        # stopping rule needs epoch e's val loss before e+1 runs) with a
        # last-layer aggregation to stack — same conditions as single-chip
        fused_eval = (k == 0 and epochs > 0 and pm.n_layers >= 2
                      and pm.supports_stacked)
        if fused_eval:
            def scan_body(carry, _):
                weights, opt_state, key = carry
                key, dkey = jax.random.split(key)

                def fused_loss(w, dkey):
                    lt, le = pm.forward_stacked(
                        w, x_local, x_eval_local, graph_args, dkey,
                        train_preagg, eval_preagg,
                    )
                    loss, acc = _masked_ce_local(lt, labels_local, train_mask,
                                                 n_train)
                    vce, vacc = _masked_ce_local(
                        jax.lax.stop_gradient(le), labels_local, val_mask,
                        n_val,
                    )
                    return loss, (acc, vce, vacc)

                (ce, (ta, vce, vacc)), grads = jax.value_and_grad(
                    fused_loss, has_aux=True
                )(weights, dkey)
                grads = jax.lax.psum(grads, AXIS)
                # l2 of the PRE-update W0 — for the train loss by reference
                # semantics (src/gcn.cu:314), for the val loss because these
                # weights ARE the ones the deferred eval ran on
                p = pen(weights[0])
                tl = ce + p
                vl = vce + p
                weights, opt_state = take_adam_step(weights, grads, opt_state)
                return (weights, opt_state, key), jnp.stack([tl, ta, vl, vacc])

            (weights, opt_state, _), em = jax.lax.scan(
                scan_body, (weights, opt_state, key), None, length=epochs
            )
            # em[e, 2:4] holds epoch e-1's val metrics (em[0] evaluated the
            # initial weights — dropped); the final epoch's eval runs here
            vce, vacc = eval_val(weights)
            vl_fin = vce + pen(weights[0])
            val_cols = jnp.concatenate(
                [em[1:, 2:4], jnp.stack([vl_fin, vacc])[None, :]], axis=0
            )
            metrics = jnp.concatenate([em[:, :2], val_cols], axis=1)
            return weights, opt_state, metrics, jnp.asarray(epochs, jnp.int32)

        if k == 0:
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

        # early stopping: on-device while_loop, reference window rule
        # (src/gcn.cu:377-395 — mean of last k val losses incl. current)
        metrics0 = jnp.zeros((epochs, 4), jnp.float32)
        hist0 = jnp.zeros((epochs,), jnp.float32)

        def cond(carry):
            _, _, _, epoch, _, _, stopped = carry
            return jnp.logical_and(epoch < epochs, jnp.logical_not(stopped))

        def body(carry):
            weights, opt_state, key, epoch, hist, metrics, stopped = carry
            weights, opt_state, key, tl, ta, vl, va = one_epoch(
                weights, opt_state, key
            )
            metrics = jax.lax.dynamic_update_slice(
                metrics, jnp.stack([tl, ta, vl, va])[None, :], (epoch, 0)
            )
            hist = hist.at[epoch].set(vl)
            start = jnp.maximum(epoch + 1 - k, 0)
            window = jax.lax.dynamic_slice(hist, (start,), (k,))
            stopped = jnp.logical_and(epoch + 1 >= k, vl > jnp.mean(window))
            return weights, opt_state, key, epoch + 1, hist, metrics, stopped

        init = (weights, opt_state, key, jnp.asarray(0, jnp.int32), hist0,
                metrics0, jnp.asarray(False))
        weights, opt_state, _, epochs_run, _, metrics, _ = jax.lax.while_loop(
            cond, body, init
        )
        return weights, opt_state, metrics, epochs_run

    sharded_run = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(
            wspecs, _opt_specs(wspecs), P(),  # weights, opt, key
            P(AXIS, None), P(AXIS, None),  # x_train, x_eval: row-sharded
            P(AXIS), P(AXIS),  # labels, split
            *graph_specs,
        ),
        out_specs=(wspecs, _opt_specs(wspecs), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded_run, donate_argnums=(0, 1))


def fit_parallel(
    cfg: Config,
    ds,
    *,
    n_devices: int | None = None,
    halo: str | None = None,
    key=None,
    verbose: bool | None = None,
    resume_from: str | None = None,
):
    """Complete multi-chip training run — the mesh counterpart of train.fit:
    node-partition the graph, train with per-epoch val metrics and the
    reference's early-stopping rule (mean of last k val losses,
    src/gcn.cu:377-395), then evaluate the test split.

    ``halo``: "all_gather" (full remote feature gather), "boundary"
    (all_to_all of only the referenced remote rows/tile-blocks — memory
    scales as N/D + halo), "adaptive" (boundary + per-pair push of partial
    sums where that ships fewer rows; COO backends), or "ring" (ppermute
    block rotation; COO backends). Defaults from cfg.exec.halo.

    Feature parity with the single-chip fit: cfg.train.mode="scan" (default)
    runs the fused whole-run program (make_parallel_run — on-device early
    stopping, deferred-eval lane stacking, zero per-epoch host transfers),
    input pre-aggregation applies per cfg.exec.input_preagg, and
    checkpoint/resume works through the same utils.checkpoint files.
    """
    import os as _os
    import time as _time

    from parallel_gcn.optim import init_adam
    from parallel_gcn.parallel.partition import (
        partition_graph,
        partition_graph_hybrid,
        partition_graph_ring,
    )
    from parallel_gcn.train import FitResult

    halo = halo or cfg.exec.halo
    tp = max(cfg.exec.tp, 1)
    avail = len(jax.devices())
    n_devices = n_devices or cfg.exec.n_devices or avail // tp
    if n_devices * tp > avail:
        raise RuntimeError(
            f"fit_parallel needs {n_devices}x{tp} devices, have {avail}; for "
            "a virtual CPU mesh set XLA_FLAGS=--xla_force_host_platform_"
            f"device_count={n_devices * tp} before importing jax"
        )
    validate_tp_dims(ds.input_dim, cfg.gcn.hidden_dims, ds.output_dim,
                     tp, cfg.gcn.model)
    verbose = cfg.train.verbose if verbose is None else verbose

    agg_variant = cfg.gcn.model in ("sage", "gin")
    gat = cfg.gcn.model == "gat"
    if gat and (halo in ("ring", "adaptive") or tp > 1):
        # the per-destination edge softmax must stay device-local: the ring
        # splits a row's edges across rotation steps and the adaptive push
        # pairs move them to the source owner; tp is GCN-only (same check
        # _make_forward enforces for direct builders)
        raise ValueError(
            "model=gat over the mesh supports the flat COO partition with "
            "the all_gather or boundary halo — set halo=all_gather|boundary, "
            "tp=1"
        )
    if gat and cfg.exec.backend in ("hybrid", "bcsr"):
        raise ValueError(GAT_TILE_ERROR)

    if cfg.exec.backend in ("hybrid", "bcsr"):
        if halo == "ring":
            raise ValueError(
                "backend=hybrid/bcsr uses per-device tile slabs against the "
                "all_gather, boundary or adaptive halo; the ppermute ring is "
                "only available with the COO backends (set backend=segment, "
                "or halo=boundary|adaptive to keep the tile slabs AND "
                "memory scaling)"
            )
        # tile-accelerated per-device aggregation
        tile_dtype = cfg.exec.tile_dtype
        if tile_dtype == "auto":
            tile_dtype = (
                "float32" if cfg.exec.matmul_precision == "highest" else "bfloat16"
            )
        sgraph = partition_graph_hybrid(
            ds.graph, n_devices, node_pad=cfg.exec.node_pad,
            tile_r=cfg.exec.tile_size, tile_c=cfg.exec.tile_cols,
            tile_dtype=np.dtype(tile_dtype),
            tile_budget_bytes=cfg.exec.tile_budget_mb * 1024 * 1024,
            min_tile_nnz=cfg.exec.min_tile_nnz or None,
            boundary=halo == "boundary",
            adaptive=halo == "adaptive",
            balance=cfg.exec.balance_slabs,
            # never ship a "compact" buffer bigger than the gathered matrix
            boundary_fallback=cfg.exec.halo_fallback,
        )
    elif halo == "ring":
        sgraph = partition_graph_ring(ds.graph, n_devices,
                                      node_pad=cfg.exec.node_pad)
    else:
        sgraph = partition_graph(ds.graph, n_devices,
                                 node_pad=cfg.exec.node_pad,
                                 boundary=halo == "boundary",
                                 adaptive=halo == "adaptive",
                                 boundary_fallback=cfg.exec.halo_fallback)
    mesh = make_mesh(n_devices, tp=tp)
    x, labels, split = shard_dataset(ds, sgraph)
    sdeg = sharded_sqrt_deg(ds, sgraph) if agg_variant else None
    x_dev, labels_dev, split_dev, *graph_dev = device_put_sharded_inputs(
        mesh, sgraph, x, labels, split, sqrt_deg=sdeg
    )
    counts = {s: int((ds.split == s).sum()) for s in (TRAIN, VAL, 3)}

    if key is None:
        key = jax.random.PRNGKey(cfg.exec.seed)
    key, init_key = jax.random.split(key)
    start_epoch = 0
    if resume_from:
        from parallel_gcn.utils.checkpoint import load_checkpoint

        weights, opt_state, start_epoch, saved_key = load_checkpoint(resume_from)
        if saved_key is not None:
            key = saved_key
        if tp > 1:
            from parallel_gcn.optim import AdamState

            weights = shard_weights(weights, mesh, tp, cfg.gcn.model)
            opt_state = AdamState(
                step=opt_state.step,
                m=shard_weights(list(opt_state.m), mesh, tp, cfg.gcn.model),
                v=shard_weights(list(opt_state.v), mesh, tp, cfg.gcn.model),
            )
        if verbose:
            print(f"resumed from {resume_from} at epoch {start_epoch}")
    else:
        from parallel_gcn.train import init_model_params

        weights = init_model_params(cfg, init_key, ds.input_dim,
                                    ds.output_dim)
        if tp > 1:
            # shard first so init_adam's zeros_like inherits the placement
            weights = shard_weights(weights, mesh, tp, cfg.gcn.model)
        opt_state = init_adam(weights)

    # input pre-aggregation hoist (exact; see train.preaggregate_input):
    # train-side when input dropout is 0, eval-side always
    x_train_dev, x_eval_dev = x_dev, x_dev
    train_preagg = eval_preagg = False
    if cfg.exec.input_preagg and (cfg.gcn.model == "gat" or agg_variant):
        # no analog for data-dependent (GAT) or interleaved (SAGE/GIN)
        # layer algebra (see train.fit) — ignore the default-True knob
        pass
    elif cfg.exec.input_preagg and cfg.gcn.n_layers >= 2:
        x_agg = make_preagg_fn(cfg, mesh, sgraph)(x_dev, *graph_dev)
        if jnp.dtype(cfg.exec.compute_dtype) != jnp.float32:
            x_agg = x_agg.astype(jnp.dtype(cfg.exec.compute_dtype))
        x_eval_dev, eval_preagg = x_agg, True
        if cfg.gcn.dropouts[0] == 0.0:
            x_train_dev, train_preagg = x_agg, True

    test_fn = make_parallel_eval_fn(cfg, mesh, sgraph, counts, split=3,
                                    preagg=eval_preagg)
    ckpt_dir = cfg.train.checkpoint_dir

    t0 = _time.perf_counter()
    if cfg.train.mode == "scan":
        import copy

        from parallel_gcn.train import _drive_scan_run

        data_args = (x_train_dev, x_eval_dev, labels_dev, split_dev,
                     *graph_dev)

        def build_run(n_epochs):
            seg_cfg = copy.deepcopy(cfg)
            seg_cfg.gcn.epochs = n_epochs
            run = make_parallel_run(seg_cfg, mesh, sgraph, counts,
                                    train_preagg, eval_preagg)
            return lambda w, o, k: run(w, o, k, *data_args)

        weights, opt_state, history, epochs_run, key = _drive_scan_run(
            build_run, weights, opt_state, key, cfg, start_epoch,
            ckpt_dir, verbose,
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
        step = make_parallel_epoch_step(cfg, mesh, sgraph, counts)
        inputs = (x_dev, labels_dev, split_dev, *graph_dev)
        k = cfg.gcn.early_stopping
        rows = []
        for epoch in range(start_epoch + 1, cfg.gcn.epochs + 1):
            te = _time.perf_counter()
            weights, opt_state, key, metrics = step(
                weights, opt_state, key, *inputs
            )
            tl, ta, vl, va = (float(v) for v in metrics)
            rows.append((tl, ta, vl, va))
            if ckpt_dir and cfg.train.checkpoint_every and (
                epoch % cfg.train.checkpoint_every == 0
            ):
                from parallel_gcn.utils.checkpoint import save_checkpoint

                save_checkpoint(
                    _os.path.join(ckpt_dir, f"ckpt_{epoch:06d}.npz"),
                    weights, opt_state, epoch, key,
                )
            if verbose:
                print(
                    f"epoch={epoch} train_loss={tl:.5f} train_acc={ta:.5f} "
                    f"val_loss={vl:.5f} val_acc={va:.5f} "
                    f"time={_time.perf_counter() - te:.5f}"
                )
            if k > 0 and len(rows) >= k:
                window = [r[2] for r in rows[-k:]]
                if vl > float(np.mean(window)):
                    if verbose:
                        print("Early stopping...")
                    break
        history = np.asarray(rows, dtype=np.float32).reshape(-1, 4)
        epochs_run = len(rows)
    total = _time.perf_counter() - t0

    if ckpt_dir:
        from parallel_gcn.utils.checkpoint import save_checkpoint

        save_checkpoint(
            _os.path.join(ckpt_dir, "ckpt_final.npz"),
            weights, opt_state, start_epoch + epochs_run, key,
        )

    test_loss, test_acc = (float(v) for v in test_fn(
        weights, x_eval_dev, labels_dev, split_dev, *graph_dev
    ))
    if verbose:
        print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f}")

    return FitResult(
        weights=weights,
        history=history,
        epochs_run=epochs_run,
        test_loss=test_loss,
        test_acc=test_acc,
        avg_epoch_time_s=total / max(epochs_run, 1),
        total_time_s=total,
    )


def device_put_sharded_inputs(mesh: Mesh, sgraph, x, labels, split,
                              sqrt_deg=None):
    """Place the row-sharded arrays on the mesh. Returns
    (x, labels, split, *graph_arrays) matching the step/eval signatures.
    ``sqrt_deg`` (SAGE/GIN, from sharded_sqrt_deg) rides as the LAST graph
    array per the _graph_specs with_sdeg contract."""
    row_sh = NamedSharding(mesh, P(AXIS))
    mat_sh = NamedSharding(mesh, P(AXIS, None))
    graph_specs, graph_arrays = _graph_specs(
        sgraph, with_sdeg=sqrt_deg is not None
    )
    if sqrt_deg is not None:
        graph_arrays = graph_arrays + (sqrt_deg,)
    placed_graph = tuple(
        jax.device_put(a, NamedSharding(mesh, s))
        for a, s in zip(graph_arrays, graph_specs)
    )
    return (
        jax.device_put(x, mat_sh),
        jax.device_put(labels, row_sh),
        jax.device_put(split, row_sh),
        *placed_graph,
    )
