"""feature_transform — first-layer feature × weight product.

Reference: SparseMatmul (src/module.cu:101-163) multiplies the sparse feature
CSR by the dense weight, with a hand-written transpose-SpMM (atomicAdd scatter)
for the weight gradient only — the sparse input is data and gets no grad.

Every dataset the reference supports has a feature matrix that comfortably
fits dense in device memory (reddit: 233K × 602 ≈ 0.56 GB), and a dense
``X @ W`` is one GEMM — so **dense is the default**. The
sparse path (gather/segment over the feature CSR's COO triplets) exists for
memory-constrained inputs and for numerical parity tests; its weight gradient
comes out of autograd as the gather-transpose scatter, the functional
equivalent of the reference's atomicAdd kernel (src/module.cu:136-152), with no
atomics because XLA scatters are deterministic.

Whether the sparse path wins on the GPU for cora/citeseer (~1% dense
features) is not measured yet (ROADMAP S7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def feature_transform(
    x: jnp.ndarray, w: jnp.ndarray, precision: str | None = "highest",
    out_dtype=None,
) -> jnp.ndarray:
    """Dense path: ``X @ W`` with f32 accumulation.

    ``precision`` matters for f32 operands: at default precision the GPU may
    use TF32; "highest" forces full f32 for parity with the reference's fp32
    CUDA GEMM (src/module.cu:274-328). Pass None/"default" for speed.

    ``out_dtype`` (default f32) sets the RESULT dtype only — the matmul still
    accumulates in f32; emitting bf16 directly halves the activation write and
    lets XLA fuse the consumer (a separate f32 intermediate + convert pass cost
    ~0.7 ms/epoch on the 233K×600 reddit hidden layer).
    """
    prec = None if precision in (None, "default") else precision
    return jnp.dot(
        x, w.astype(x.dtype),
        preferred_element_type=jnp.dtype(out_dtype or jnp.float32),
        precision=prec,
    )


def sparse_feature_transform(
    feat_row: jnp.ndarray,  # int32 [nnz_pad] — row id per nonzero (sorted)
    feat_col: jnp.ndarray,  # int32 [nnz_pad] — feature id per nonzero
    feat_val: jnp.ndarray,  # float32 [nnz_pad] — 0 on padding
    w: jnp.ndarray,  # [input_dim, H]
    n_nodes: int,
) -> jnp.ndarray:
    """Sparse path: out[n] = Σ_j val_j · W[col_j] over row n's nonzeros.

    Differentiable in ``w`` only (the features are data), matching the
    reference's backward (src/module.cu:136-163).
    """
    gathered = feat_val[:, None].astype(w.dtype) * w[feat_col]
    return jax.ops.segment_sum(
        gathered, feat_row, num_segments=n_nodes, indices_are_sorted=True
    )
