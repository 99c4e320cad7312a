"""Graph Attention Network (Veličković et al., arXiv:1710.10903).

A second model family on the same data layer, trainer, and loss as the GCN
(the reference framework is GCN-only — src/gcn.cu; this extends the
framework beyond it using the same architectural conventions: one params
pytree, pure apply, Glorot init, no biases).

Per layer (paper eqs. 1-6, with the standard two-vector decomposition of the
attention MLP):

    e_ij   = LeakyReLU(a_srcᵀ(W h_i) + a_dstᵀ(W h_j))        edge logits
    α_ij   = softmax_j(e_ij)   over j ∈ N(i) ∪ {i}           per-dest softmax
    h_i'   = ELU( ‖_k Σ_j α_ij^k (W^k h_j) )                 K heads concat
    last layer: heads are AVERAGED, no nonlinearity (logits)

Two aggregation backends mirror ops/graphsum.py's design split:

- ``dense``: the masked [heads, N, N] attention matrix as matmuls — the edge
  softmax is a plain masked row softmax and the aggregation one batched
  matmul. The right shape for citation-scale graphs, exactly like the dense-Â
  graphsum backend.
- ``segment``: per-edge logits on the padded COO triplets with a
  segment-max/exp/segment-sum softmax — O(E·heads) memory, mirroring the
  segment graphsum backend.

The attention coefficients are data-dependent, so unlike the GCN there is no
loop-invariant first aggregation (no input_preagg) and no deferred-eval lane
stacking (train and eval lanes would need different attention matrices);
GATModel advertises that via ``supports_deferred_eval = False`` and the
trainer's plain scan/while_loop paths run it unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from parallel_gcn.data.graph import Graph
from parallel_gcn.models.gcn import glorot
from parallel_gcn.ops.dropout import dropout
from parallel_gcn.ops.sparse_matmul import feature_transform

LEAKY_SLOPE = 0.2  # paper §2.1
_NEG = -1e9  # masked-logit fill; finite so empty softmax rows stay finite


def init_gat_params(
    key: jax.Array,
    input_dim: int,
    hidden_dims,
    output_dim: int,
    heads: int,
):
    """Per-layer {W, a_src, a_dst}. ``hidden_dims`` are PER-HEAD widths (paper
    cora config: 8 heads × 8 features); hidden layers concatenate heads, so
    layer l+1 sees heads·hidden_dims[l] inputs. The last layer's heads are
    averaged over ``output_dim``-wide logits."""
    dims_in = [input_dim] + [heads * d for d in hidden_dims]
    dims_out = list(hidden_dims) + [output_dim]
    params = []
    for i, (f_in, d) in enumerate(zip(dims_in, dims_out)):
        key, kw, ks, kd = jax.random.split(key, 4)
        params.append({
            "W": glorot(kw, f_in, heads * d),
            # attention vectors: glorot ranges on the [2·D, 1] MLP the pair
            # (a_src, a_dst) factorizes
            "a_src": glorot(ks, heads, d),
            "a_dst": glorot(kd, heads, d),
        })
    return params


def _edge_softmax_segment(graph: Graph, s, t, n_nodes):
    """Per-edge attention weights α over the padded COO triplets.

    ``s``/``t`` are [N, heads] per-node logit halves; returns α [E, heads].
    Padding edges (val == 0) get logit _NEG → weight ~0; rows with no live
    edges (padding rows) degrade to finite garbage that the split mask drops.
    """
    live = (graph.val != 0.0)[:, None]
    e = s[graph.row] + t[graph.col]
    e = jax.nn.leaky_relu(e, LEAKY_SLOPE)
    e = jnp.where(live, e, _NEG)
    m = jax.ops.segment_max(e, graph.row, num_segments=n_nodes,
                            indices_are_sorted=True)
    m = jnp.maximum(m, _NEG)  # empty segments: -inf would poison exp below
    # exact: softmax is invariant to the subtracted max (gradient
    # contributions through it cancel); skipping them avoids a useless
    # scatter-of-argmax backward pass
    m = jax.lax.stop_gradient(m)
    w = jnp.exp(e - m[graph.row])
    w = jnp.where(live, w, 0.0)
    # f32 denominator: a bf16 accumulator loses per-edge increments on
    # high-degree rows (see _attend_segment_chunked)
    denom = jax.ops.segment_sum(w.astype(jnp.float32), graph.row,
                                num_segments=n_nodes,
                                indices_are_sorted=True)
    den_e = jnp.maximum(denom, 1e-16)[graph.row]
    return w / den_e.astype(w.dtype)


@dataclass(frozen=True)
class GATModel:
    """Static model description; ``apply`` is the pure forward function.

    Mirrors GCNModel's trainer contract (n_layers/dropouts/apply signature);
    ``backend`` ∈ {dense, segment} picks the attention aggregation path.
    ``attn_dropout`` drops normalized attention coefficients during training
    (paper §3.3 applies 0.6 on the citation datasets)."""

    n_layers: int
    dropouts: tuple[float, ...]
    heads: int = 8
    attn_dropout: float = 0.0
    backend: str = "dense"
    compute_dtype: str = "float32"
    precision: str = "highest"
    residual: bool = False
    input_preagg: bool = False  # trainer contract; preagg is a GCN rewrite
    # rematerialize each layer in the backward pass (jax.checkpoint): the
    # [E, heads, d] edge intermediates are recomputed instead of stored, so
    # activation memory drops from O(L·E·heads·d) to one layer's worth —
    # reddit-scale attention needs this to bound activation memory
    remat: bool = False
    # edge-chunked streaming attention for the segment backend (0 = off):
    # process the COO edges in lax.scan chunks with a two-pass softmax
    # (running segment-max, then exp-accumulate numerator/denominator and
    # divide once). Bounds the per-edge working set to O(chunk) instead of
    # the unchunked path's O(E·heads·d) edge intermediates.
    edge_chunk: int = 0
    supports_deferred_eval = False  # attention is data-dependent per lane

    def _attend_dense(self, graph, hw3, s, t, akey, training):
        mask = (graph.adj > 0)[None]  # [1, N, N] — edge pattern incl. pads
        e = s.T[:, :, None] + t.T[:, None, :]  # [heads, N, N]
        e = jax.nn.leaky_relu(e, LEAKY_SLOPE)
        e = jnp.where(mask, e, jnp.asarray(_NEG, e.dtype))
        a = jax.nn.softmax(e, axis=-1)
        if training and self.attn_dropout > 0.0:
            a = dropout(a, self.attn_dropout, akey, training=True)
        prec = jax.lax.Precision.HIGHEST if self.precision == "highest" else None
        return jnp.einsum("hij,jhd->ihd", a, hw3, precision=prec)

    def _attend_segment(self, graph, hw3, s, t, akey, training):
        n = hw3.shape[0]
        E = graph.row.shape[0]
        if not self.edge_chunk or self.edge_chunk >= E:
            alpha = _edge_softmax_segment(graph, s, t, n)
            if training and self.attn_dropout > 0.0:
                alpha = dropout(alpha, self.attn_dropout, akey, training=True)
            contrib = (alpha[:, :, None] * hw3[graph.col]).astype(jnp.float32)
            return jax.ops.segment_sum(
                contrib, graph.row, num_segments=n, indices_are_sorted=True
            ).astype(hw3.dtype)
        return self._attend_segment_chunked(graph, hw3, s, t, akey, training)

    def _attend_segment_chunked(self, graph, hw3, s, t, akey, training):
        """Streaming edge softmax + aggregation in ``edge_chunk``-sized
        lax.scan steps: pass 1 builds the per-destination running max; pass 2
        accumulates the exp numerator (per head × feature) and denominator
        and divides once at the end. Exact (same math, f32 accumulation);
        attention dropout applies to the numerator terms only — identical to
        dropping the normalized α (the denominator is the undropped softmax
        normalizer, as in the paper/unchunked path) with a chunk-indexed key
        stream."""
        n, heads, d = hw3.shape
        row, col, val = graph.row, graph.col, graph.val
        E = row.shape[0]
        chunk = self.edge_chunk
        nc = -(-E // chunk)
        pad = nc * chunk - E
        if pad:
            # harmless extras: val 0 => dead, pointed at the last row/col 0
            row = jnp.concatenate([row, jnp.full(pad, n - 1, row.dtype)])
            col = jnp.concatenate([col, jnp.zeros(pad, col.dtype)])
            val = jnp.concatenate([val, jnp.zeros(pad, val.dtype)])
        xs = (
            row.reshape(nc, chunk),
            col.reshape(nc, chunk),
            (val != 0.0).reshape(nc, chunk),
            jnp.arange(nc),
        )

        def logits(r, c, lv):
            e = jax.nn.leaky_relu(s[r] + t[c], LEAKY_SLOPE)
            return jnp.where(lv[:, None], e, jnp.asarray(_NEG, e.dtype))

        def max_body(m, x):
            r, c, lv, _ = x
            cm = jax.ops.segment_max(logits(r, c, lv), r, num_segments=n,
                                     indices_are_sorted=True)
            return jnp.maximum(m, cm), None

        m0 = jnp.full((n, heads), _NEG, s.dtype)
        m, _ = jax.lax.scan(max_body, m0, xs)
        # softmax is invariant to the subtracted max, so its gradient
        # contributions cancel exactly — stopping them here is exact AND
        # keeps scan-backward from saving the max pass's per-chunk residuals
        m = jax.lax.stop_gradient(m)

        keep = 1.0 - self.attn_dropout
        drop = training and self.attn_dropout > 0.0

        def acc_body(carry, x):
            num, den = carry
            r, c, lv, i = x
            e = logits(r, c, lv)
            w = jnp.where(lv[:, None], jnp.exp(e - m[r]), 0.0)
            # f32 accumulation regardless of the compute dtype: a bf16
            # accumulator stops absorbing per-edge increments once it
            # exceeds ~256x the addend — exactly a reddit community hub's
            # regime (measured 15-50% relative error on degree-4000 rows)
            den = den + jax.ops.segment_sum(
                w.astype(jnp.float32), r, num_segments=n,
                indices_are_sorted=True,
            )
            wn = w
            if drop:
                wn = dropout(w, self.attn_dropout, jax.random.fold_in(akey, i))
            num = num + jax.ops.segment_sum(
                (wn[:, :, None] * hw3[c]).astype(jnp.float32), r,
                num_segments=n, indices_are_sorted=True,
            )
            return (num, den), None

        num0 = jnp.zeros((n, heads, d), jnp.float32)
        den0 = jnp.zeros((n, heads), jnp.float32)
        # checkpoint each step: scan-backward then saves only the O(n)
        # carries per chunk and recomputes the chunk's [chunk, heads(, d)]
        # internals — without this the residuals stack to full-E size again
        (num, den), _ = jax.lax.scan(jax.checkpoint(acc_body), (num0, den0),
                                     xs)
        out = num / jnp.maximum(den, 1e-16)[:, :, None]
        return out.astype(hw3.dtype)

    def apply(
        self,
        weights,
        x: jnp.ndarray,
        graph: Graph,
        *,
        training: bool,
        key: jax.Array | None = None,
        input_preagg: bool | None = None,
    ) -> jnp.ndarray:
        """Forward pass → logits [n_nodes, output_dim] (float32)."""
        assert len(weights) == self.n_layers
        assert not input_preagg, "GAT has no loop-invariant first aggregation"
        if self.backend == "dense":
            assert graph.adj is not None, (
                "GAT dense backend needs the dense adjacency (small graphs); "
                "use backend=segment otherwise"
            )
        else:
            assert graph.coo_complete, (
                "GAT segment backend needs complete COO triplets (tile-only "
                "hybrid packs carry no per-edge list)"
            )
        dtype = jnp.dtype(self.compute_dtype)
        h = x.astype(dtype)
        needs_keys = training and (
            any(d > 0 for d in self.dropouts) or self.attn_dropout > 0
        )
        if needs_keys:
            assert key is not None, "training forward needs a dropout key"
            keys = jax.random.split(key, 2 * self.n_layers)
        else:
            keys = [None] * (2 * self.n_layers)

        attend = {
            "dense": self._attend_dense,
            "segment": self._attend_segment,
        }[self.backend]

        def layer_fn(h, w, k_feat, k_attn, last):
            n_out = w["a_src"].shape[1]
            if training and self.dropouts[layer] > 0.0:
                h = dropout(h, self.dropouts[layer], k_feat, training=True)
            hw = feature_transform(h, w["W"], precision=self.precision,
                                   out_dtype=dtype)
            hw3 = hw.reshape(hw.shape[0], self.heads, n_out)
            s = jnp.einsum("nhd,hd->nh", hw3, w["a_src"].astype(dtype))
            t = jnp.einsum("nhd,hd->nh", hw3, w["a_dst"].astype(dtype))
            out = attend(graph, hw3, s, t, k_attn, training)
            if last:
                return out.mean(axis=1)  # average heads (paper eq. 6)
            return out.reshape(out.shape[0], self.heads * n_out)

        prev = None
        for layer in range(self.n_layers):
            last = layer == self.n_layers - 1
            fn = layer_fn
            if self.remat and training:
                # recompute this layer's [E, heads, d] edge intermediates in
                # the backward pass instead of storing them across the run
                fn = jax.checkpoint(layer_fn, static_argnums=(4,))
            h = fn(h, weights[layer], keys[2 * layer], keys[2 * layer + 1],
                   last)
            if not last:
                if (
                    self.residual
                    and layer > 0
                    and prev is not None
                    and prev.shape == h.shape
                ):
                    h = h + prev
                h = jax.nn.elu(h)
                prev = h
        return h.astype(jnp.float32)
