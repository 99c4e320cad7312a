"""N-layer Graph Convolutional Network.

Architecture (reference: src/gcn.cu:47-142, report eq. 1):

    layer 0:      dropout → X·W0        → Â·(·) → ReLU
    layer 1..L-2: dropout → H·Wi [+res] → Â·(·) → ReLU
    layer L-1:    dropout → H·W_{L-1}   → Â·(·) → (logits → masked CE)

Params are one pytree (a list of weight matrices, no biases — the reference has
none). Glorot-uniform init with half-range sqrt(6/(rows+cols))
(src/variable.cu:63-83), threefry keys standing in for the Philox pool.

The optional residual connection mirrors -DRESIDUAL_CONNECTIONS
(src/module.cu:566-593): inner layers with matching dims add the previous
layer's activation after aggregation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import jax
import jax.numpy as jnp

from parallel_gcn.data.graph import Graph
from parallel_gcn.ops.dropout import dropout
from parallel_gcn.ops.graphsum import graphsum
from parallel_gcn.ops.sparse_matmul import feature_transform


def glorot(key: jax.Array, rows: int, cols: int, dtype=jnp.float32) -> jnp.ndarray:
    r = (6.0 / (rows + cols)) ** 0.5
    return jax.random.uniform(key, (rows, cols), dtype=dtype, minval=-r, maxval=r)


def init_params(
    key: jax.Array, input_dim: int, hidden_dims: Sequence[int], output_dim: int
) -> list[jnp.ndarray]:
    """One Glorot-initialized weight per layer (reference: src/gcn.cu:171-172)."""
    dims = [input_dim, *hidden_dims, output_dim]
    keys = jax.random.split(key, len(dims) - 1)
    return [glorot(k, dims[i], dims[i + 1]) for i, k in enumerate(keys)]


@dataclass(frozen=True)
class GCNModel:
    """Static model description; ``apply`` is the pure forward function."""

    n_layers: int
    dropouts: tuple[float, ...]
    residual: bool = False
    backend: str = "auto"  # graphsum backend
    edge_chunk: int = 0
    dense_threshold: int = 8192
    compute_dtype: str = "float32"
    # f32 matmul precision: "highest" = true f32 (reference parity);
    # "default" lets the GPU use TF32. Irrelevant when compute_dtype=bfloat16.
    precision: str = "highest"
    # input pre-aggregation: when the input-layer dropout is 0, the first
    # layer's aggregation is loop-invariant — Â·(X·W0) == (Â·X)·W0 with Â·X
    # computed once at setup (see train.preaggregate_input). ``x`` then already
    # holds Â·X and layer 0 skips its graphsum. Exact algebraic rewrite, not an
    # approximation; the tuned reddit/pubmed configs (input dropout 0.0,
    # report p.13 Table 4) qualify.
    input_preagg: bool = False
    # rematerialize each layer in backward (jax.checkpoint): useful for deep
    # GCNs on graphs whose per-layer activations crowd HBM; same knob as the
    # GAT's (cfg.gcn.remat)
    remat: bool = False
    # the deferred-eval lane stacking (train._fused_deferred_forward) is valid
    # because Â is the SAME linear operator for the train and eval lanes —
    # attention models (gat.py) set this False
    supports_deferred_eval = True

    def aggregate(self, h, graph):
        """``Â·h`` with this model's backend/precision knobs — the single home
        for the graphsum call shared by apply, the deferred-eval fused path
        (train._fused_deferred_forward) and input pre-aggregation."""
        return graphsum(
            h,
            graph,
            backend=self.backend,
            edge_chunk=self.edge_chunk,
            dense_threshold=self.dense_threshold,
            precision=self.precision,
        )

    def layer_pre(self, h, layer, weights, key, training, pre_relu: bool = False):
        """Layer ``layer``'s pre-aggregation half: [relu →] dropout → feature
        transform. Shared by ``apply`` and the deferred-eval fused path
        (train._fused_deferred_forward) so the per-layer semantics have one
        source of truth.

        ``pre_relu``: the PREVIOUS layer's trailing ReLU, deferred into this
        layer's entry by the non-residual apply loop so XLA fuses it with the
        dropout and the matmul's operand read. Identical to relu-then-dropout:
        masking commutes with max(·, 0)."""
        dtype = jnp.dtype(self.compute_dtype)
        if pre_relu:
            h = jax.nn.relu(h)
        h = dropout(h, self.dropouts[layer], key, training=training)
        return feature_transform(
            h, weights[layer], precision=self.precision, out_dtype=dtype
        )

    def apply(
        self,
        weights: list[jnp.ndarray],
        x: jnp.ndarray,
        graph: Graph,
        *,
        training: bool,
        key: jax.Array | None = None,
        input_preagg: bool | None = None,
    ) -> jnp.ndarray:
        """Forward pass → logits [n_nodes, output_dim] (float32).

        ``input_preagg`` overrides the model flag per call: pass True together
        with ``x = Â·X`` to skip layer 0's aggregation ((Â·X)·W0 == Â·(X·W0)).
        Callers use this for EVAL forwards even when the training input dropout
        is nonzero — evaluation never applies dropout, so the hoist is always
        exact there (see train.preaggregate_input).
        """
        assert len(weights) == self.n_layers
        preagg = self.input_preagg if input_preagg is None else input_preagg
        dtype = jnp.dtype(self.compute_dtype)
        h = x.astype(dtype)
        if training and any(d > 0 for d in self.dropouts):
            assert key is not None, "training forward needs a dropout key"
            keys = jax.random.split(key, self.n_layers)
        else:
            keys = [None] * self.n_layers

        if preagg and training:
            assert self.dropouts[0] == 0.0, (
                "input_preagg is only exact for training with zero input dropout"
            )
        def layer_fn(h, weights, key, layer, skip_agg, pre_relu):
            h = self.layer_pre(h, layer, weights, key, training, pre_relu=pre_relu)
            if not skip_agg:
                h = self.aggregate(h, graph)
            return h

        # Without residual connections the trailing ReLU is deferred into the
        # NEXT layer's entry (pre_relu) so it fuses with that layer's
        # dropout. With residuals the skip path needs the post-ReLU
        # activation, so the eager ReLU placement stays.
        defer_relu = not self.residual
        prev = None
        pending_relu = False
        for layer in range(self.n_layers):
            fn = layer_fn
            if self.remat and training:
                fn = jax.checkpoint(layer_fn, static_argnums=(3, 4, 5))
            h = fn(
                h, weights, keys[layer], layer, layer == 0 and preagg,
                pending_relu,
            )
            pending_relu = False
            if (
                self.residual
                and 0 < layer < self.n_layers - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if layer < self.n_layers - 1:
                if defer_relu:
                    pending_relu = True
                else:
                    h = jax.nn.relu(h)
                    prev = h
        return h.astype(jnp.float32)
