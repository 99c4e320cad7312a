"""Fused masked softmax cross-entropy with accuracy.

Reference: the fused kernel src/module.cu:484-524 computes, per labeled node,
max-subtracted logits, log-sum-exp loss, and (when training) the softmax
gradient in one pass; accuracy re-uses the max-subtraction ("truth logit == row
max ⇒ correct", src/gcn.cu:264-289); finalize divides by the split's sample
count and adds wd·||W0||²/2 (src/gcn.cu:440-455).

Here the same fusion is expressed as one differentiable function — XLA fuses
the elementwise chain, and autograd of this exact expression reproduces the
reference's hand-written gradient ``(prob − onehot)·mask / num_samples``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

def masked_softmax_xent_sums(
    logits: jnp.ndarray,  # [N, C] float
    labels: jnp.ndarray,  # [N] int32, -1 (or anything) on unlabeled rows
    mask: jnp.ndarray,  # [N] bool — nodes of the current split
):
    """Local (loss_sum, correct_count) over the masked rows — the shared core
    of the single-chip CE and the multi-chip psum'd CE (one source of truth
    for the numerically-sensitive expression)."""
    logits = logits.astype(jnp.float32)
    lmax = jax.lax.stop_gradient(jnp.max(logits, axis=-1, keepdims=True))
    shifted = logits - lmax
    lse = jnp.log(jnp.sum(jnp.exp(shifted), axis=-1))
    safe_labels = jnp.clip(labels, 0, logits.shape[-1] - 1)
    # truth logit via one-hot select+reduce instead of a row gather: it
    # fuses into the softmax chain as a streamed reduction over [N, C].
    # Numerically identical (selects one element).
    class_ids = jax.lax.broadcasted_iota(jnp.int32, shifted.shape, 1)
    onehot = class_ids == safe_labels[:, None]
    truth = jnp.sum(jnp.where(onehot, shifted, 0.0), axis=-1)

    maskf = mask.astype(jnp.float32)
    loss_sum = jnp.sum(maskf * (lse - truth))
    # Accuracy: prediction = argmax, correct iff it equals the label. The
    # reference instead tests truth_logit - max >= 0 on its STORED logits
    # (src/gcn.cu:271-278) — that exact-cancellation trick is unsound under
    # XLA, which may duplicate the logits computation into the max-reduce and
    # the subtract with different fusion/rounding (observed on the sharded
    # int8 path: truth - max = -2e-9 on correctly-classified rows, and
    # lax.optimization_barrier does NOT prevent the duplication). argmax is a
    # single reduction over ONE evaluation of the row, and the == label test
    # is integer — immune to recomputation noise. Semantics differ from the
    # reference only on EXACT logit ties (argmax takes the first max; the
    # reference counts any tied truth as correct), which do not occur with
    # trained float logits.
    pred = jnp.argmax(jax.lax.stop_gradient(logits), axis=-1)
    correct = jnp.sum(maskf * (pred == safe_labels))
    return loss_sum, correct


def masked_softmax_xent(
    logits: jnp.ndarray,  # [N, C] float
    labels: jnp.ndarray,  # [N] int32, -1 (or anything) on unlabeled rows
    mask: jnp.ndarray,  # [N] bool — nodes of the current split
    num_samples: jnp.ndarray | int,  # scalar: size of the split
):
    """Returns (mean_ce_loss, accuracy) over the masked nodes.

    ``num_samples`` is passed separately (rather than ``mask.sum()``) to mirror
    the reference's per-split sample counts (src/module.cu:552-562) and to keep
    it a compile-time-friendly scalar under jit.
    """
    loss_sum, correct = masked_softmax_xent_sums(logits, labels, mask)
    denom = jnp.asarray(num_samples, dtype=jnp.float32)
    return loss_sum / denom, correct / denom


def l2_penalty(w: jnp.ndarray) -> jnp.ndarray:
    """Σw² (reference: get_l2_penalty warp-reduce, src/gcn.cu:230-260)."""
    w = w.astype(jnp.float32)
    return jnp.sum(w * w)
