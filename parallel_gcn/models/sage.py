"""GraphSAGE (mean aggregator) and GIN model families — beyond-reference.

The reference framework is GCN-only (src/gcn.cu:47-142); these widen the
model zoo on the SAME data layer, trainer, loss, and aggregation backends.
Both are expressed through the existing symmetric-Â operator (ops/graphsum.py)
via exact diagonal rewrites, so every backend — dense, segment,
BCSR/hybrid tiles, int8 pattern packs — and the backward-equals-forward
custom VJP work unchanged:

    Â = D^{-1/2} (A+I) D^{-1/2}   (self-loop-inclusive, src/parser.cpp:164-181)
    SUM:  (A+I)·h          = s ⊙ Â·(s ⊙ h)          with s = sqrt(deg)
    MEAN: D^{-1}(A+I)·h    = s^{-1} ⊙ Â·(s ⊙ h)

(the MEAN identity follows by scaling SUM with D^{-1}; both are algebraic
identities up to f32 rounding of the stored 1/sqrt(deg·deg) edge values).
``s`` is Graph.sqrt_deg, computed once at build time (data/graph.py).

GraphSAGE (Hamilton et al., arXiv:1706.02216), mean variant over N(i)∪{i}:

    h_i' = act( W_self·h_i  +  W_neigh·mean_{j∈N(i)∪{i}} h_j )

The neighbor transform is applied BEFORE aggregation (exact — aggregation is
linear), so the aggregation runs at hidden width like the GCN's, not input
width. No L2 embedding normalization (we classify, not embed).

GIN (Xu et al., arXiv:1810.00826), the GIN-eps node-classification form:

    h_i' = MLP_k( (1+eps)·h_i + Σ_{j∈N(i)} h_j )

with a 2-layer MLP (Linear→ReLU→Linear) per inner layer and a single linear
classifier after the last aggregation. eps is a fixed hyperparameter
(cfg.gcn.gin_eps; the paper's GIN-0 — eps=0 — is its best performer). The
self-loop-inclusive sum gives (1+eps)·h_i + Σ_{N(i)} = eps·h_i + Σ_{N(i)∪{i}}.

Both models run on the standard trainer (train.fit, scan or eager mode) with
dropout before every transform, the reference's Adam and first-leaf weight
decay (optim.decayed_leaf: SAGE decays layer 0's W_neigh, GIN layer 0's w1),
early stopping, and checkpointing — and over the mesh (fit_parallel) with
every halo mode: the rewrites scale the LOCAL rows before the distributed
aggregation, so the scaled rows are what the halo exchanges ship
(parallel/train_parallel.forward_agg_variant; sqrt_deg rides row-sharded).
Tensor parallelism is GCN-only (config-time error).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp

from parallel_gcn.data.graph import Graph
from parallel_gcn.models.gcn import glorot
from parallel_gcn.ops.dropout import dropout
from parallel_gcn.ops.graphsum import graphsum
from parallel_gcn.ops.sparse_matmul import feature_transform


def init_sage_params(
    key: jax.Array, input_dim: int, hidden_dims: Sequence[int], output_dim: int
) -> list[dict]:
    """Per layer: {neigh: W, self: W}, both Glorot like the GCN's weights.
    optim.decayed_leaf picks leaves[0] = 'neigh' (dict keys sort) as the
    decayed/L2-reported leaf of layer 0 — one consistent convention with
    the GCN (decays only W0, src/gcn.cu:157-158) and the GAT."""
    dims = [input_dim, *hidden_dims, output_dim]
    keys = jax.random.split(key, 2 * (len(dims) - 1))
    return [
        {
            "neigh": glorot(keys[2 * i], dims[i], dims[i + 1]),
            "self": glorot(keys[2 * i + 1], dims[i], dims[i + 1]),
        }
        for i in range(len(dims) - 1)
    ]


def init_gin_params(
    key: jax.Array,
    input_dim: int,
    hidden_dims: Sequence[int],
    output_dim: int,
) -> list[dict]:
    """Inner layers: {w1: d_k→d_{k+1}, w2: d_{k+1}→d_{k+1}} (the 2-layer
    MLP); last layer: {w1: d_{L-1}→n_classes} (linear classifier)."""
    dims = [input_dim, *hidden_dims, output_dim]
    L = len(dims) - 1
    keys = jax.random.split(key, 2 * L)
    params: list[dict] = []
    for i in range(L - 1):
        params.append(
            {
                "w1": glorot(keys[2 * i], dims[i], dims[i + 1]),
                "w2": glorot(keys[2 * i + 1], dims[i + 1], dims[i + 1]),
            }
        )
    params.append({"w1": glorot(keys[2 * L - 1], dims[L - 1], dims[L])})
    return params


def _require_sqrt_deg(graph: Graph) -> jnp.ndarray:
    if graph.sqrt_deg is None:
        raise ValueError(
            "this model needs Graph.sqrt_deg (build the graph through "
            "data.graph.build_graph / data.parser.to_device)"
        )
    return graph.sqrt_deg


@dataclass(frozen=True)
class _AggVariantBase:
    """Shared trainer-protocol knobs + the diagonal-rewrite aggregators."""

    n_layers: int
    dropouts: tuple[float, ...]
    backend: str = "auto"
    edge_chunk: int = 0
    dense_threshold: int = 8192
    compute_dtype: str = "float32"
    precision: str = "highest"
    remat: bool = False
    residual: bool = False
    # trainer-contract field (train.make_eval_fn / make_epoch_step read
    # model.input_preagg unconditionally): always False here — there is no
    # loop-invariant first Â-aggregation to hoist (layer algebra differs from
    # the GCN's transform→aggregate), and train.preaggregate_input keys off
    # the absence of an `aggregate` attr so it never flips this on
    input_preagg: bool = False
    supports_deferred_eval = False

    def _graphsum(self, h, graph):
        return graphsum(
            h,
            graph,
            backend=self.backend,
            edge_chunk=self.edge_chunk,
            dense_threshold=self.dense_threshold,
            precision=self.precision,
        )

    def _sum_agg(self, h, graph):
        """Σ_{j∈N(i)∪{i}} h_j = s ⊙ Â·(s ⊙ h), exact diagonal rewrite."""
        s = _require_sqrt_deg(graph).astype(h.dtype)[:, None]
        return s * self._graphsum(s * h, graph)

    def _mean_agg(self, h, graph):
        """mean_{j∈N(i)∪{i}} h_j = s^{-1} ⊙ Â·(s ⊙ h)."""
        s = _require_sqrt_deg(graph).astype(h.dtype)[:, None]
        return self._graphsum(s * h, graph) / s

    def _keys(self, key, training):
        if training and any(d > 0 for d in self.dropouts):
            assert key is not None, "training forward needs a dropout key"
            return jax.random.split(key, self.n_layers)
        return [None] * self.n_layers

    def _check_apply(self, weights, input_preagg):
        assert len(weights) == self.n_layers
        assert not input_preagg, (
            "input pre-aggregation is a GCN-specific rewrite "
            "(Â·(X·W0) == (Â·X)·W0); this model's layer algebra differs"
        )


@dataclass(frozen=True)
class SAGEModel(_AggVariantBase):
    """GraphSAGE-mean for full-batch node classification."""

    def apply(
        self,
        weights: list[dict],
        x: jnp.ndarray,
        graph: Graph,
        *,
        training: bool,
        key: jax.Array | None = None,
        input_preagg: bool | None = None,
    ) -> jnp.ndarray:
        self._check_apply(weights, input_preagg)
        dtype = jnp.dtype(self.compute_dtype)
        h = x.astype(dtype)
        keys = self._keys(key, training)

        def layer_fn(h, weights, lkey, layer):
            h = dropout(h, self.dropouts[layer], lkey, training=training)
            w = weights[layer]
            h_self = feature_transform(
                h, w["self"], precision=self.precision, out_dtype=dtype
            )
            h_neigh = feature_transform(
                h, w["neigh"], precision=self.precision, out_dtype=dtype
            )
            return h_self + self._mean_agg(h_neigh, graph).astype(dtype)

        prev = None
        for layer in range(self.n_layers):
            fn = layer_fn
            if self.remat and training:
                fn = jax.checkpoint(layer_fn, static_argnums=(3,))
            h = fn(h, weights, keys[layer], layer)
            if (
                self.residual
                and 0 < layer < self.n_layers - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if layer < self.n_layers - 1:
                h = jax.nn.relu(h)
                prev = h
        return h.astype(jnp.float32)


@dataclass(frozen=True)
class GINModel(_AggVariantBase):
    """GIN-eps for full-batch node classification."""

    gin_eps: float = 0.0

    def apply(
        self,
        weights: list[dict],
        x: jnp.ndarray,
        graph: Graph,
        *,
        training: bool,
        key: jax.Array | None = None,
        input_preagg: bool | None = None,
    ) -> jnp.ndarray:
        self._check_apply(weights, input_preagg)
        dtype = jnp.dtype(self.compute_dtype)
        h = x.astype(dtype)
        keys = self._keys(key, training)
        eps = jnp.asarray(self.gin_eps, dtype)

        def layer_fn(h, weights, lkey, layer):
            h = dropout(h, self.dropouts[layer], lkey, training=training)
            # (1+eps)·h_i + Σ_{N(i)} h_j, via the self-loop-inclusive sum
            z = eps * h + self._sum_agg(h, graph).astype(dtype)
            w = weights[layer]
            z = feature_transform(
                z, w["w1"], precision=self.precision, out_dtype=dtype
            )
            if "w2" in w:
                z = feature_transform(
                    jax.nn.relu(z), w["w2"], precision=self.precision,
                    out_dtype=dtype,
                )
            return z

        prev = None
        for layer in range(self.n_layers):
            fn = layer_fn
            if self.remat and training:
                fn = jax.checkpoint(layer_fn, static_argnums=(3,))
            h = fn(h, weights, keys[layer], layer)
            if (
                self.residual
                and 0 < layer < self.n_layers - 1
                and prev is not None
                and prev.shape == h.shape
            ):
                h = h + prev
            if layer < self.n_layers - 1:
                h = jax.nn.relu(h)
                prev = h
        return h.astype(jnp.float32)
