"""Graph reordering for block-sparse locality.

A GCN is permutation-equivariant, so we may relabel nodes freely before
training; a bandwidth-reducing order concentrates edges near the diagonal and
makes 128×128 tiles of Â dense enough for the block-sparse tile product
(ops/bcsr.py). This plays the role the reference's per-dataset CUDA
launch tuning plays (test/performance_gpu.cpp:37-49): a host-side, per-dataset
preprocessing step that buys kernel efficiency.

The ordering is pseudo-RCM: level-synchronous BFS from a minimum-degree seed,
nodes within each frontier sorted by degree, result reversed (Cuthill-McKee
semantics, vectorized per level so reddit-scale graphs stay fast).
"""

from __future__ import annotations

import numpy as np

from parallel_gcn.data.graph import HostCSR


def rcm_permutation(csr: HostCSR) -> np.ndarray:
    """Return ``perm`` with new_id = perm_inverse[old_id]; ``perm[i]`` is the
    old id placed at new position i."""
    n = csr.n_rows
    deg = np.diff(csr.indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    indptr, indices = csr.indptr, csr.indices

    remaining = np.argsort(deg, kind="stable")
    rem_idx = 0
    while pos < n:
        # next unvisited min-degree seed
        while rem_idx < len(remaining) and visited[remaining[rem_idx]]:
            rem_idx += 1
        seed = remaining[rem_idx]
        visited[seed] = True
        order[pos] = seed
        pos += 1
        frontier = np.array([seed], dtype=np.int64)
        while len(frontier):
            # gather all neighbors of the frontier at once
            starts = indptr[frontier]
            ends = indptr[frontier + 1]
            counts = (ends - starts).astype(np.int64)
            if counts.sum() == 0:
                break
            flat = np.concatenate(
                [indices[s:e] for s, e in zip(starts, ends)]
            ).astype(np.int64)
            nxt = np.unique(flat)
            nxt = nxt[~visited[nxt]]
            if len(nxt) == 0:
                break
            nxt = nxt[np.argsort(deg[nxt], kind="stable")]
            visited[nxt] = True
            order[pos : pos + len(nxt)] = nxt
            pos += len(nxt)
            frontier = nxt
    return order[::-1].copy()  # reverse Cuthill-McKee


def _propagate_labels_numpy(
    rows_lp: np.ndarray, cols_lp: np.ndarray, n: int, n_iters: int
) -> np.ndarray:
    """Vectorized NumPy label propagation — the semantic spec for the native
    sweep (csrc/loader.cpp pgcn_community_labels). O(E log E) per sweep."""
    labels = np.arange(n, dtype=np.int64)
    for _ in range(n_iters):
        key = rows_lp * n + labels[cols_lp]
        uk, counts = np.unique(key, return_counts=True)
        r = uk // n
        lab = uk % n
        order = np.lexsort((lab, counts, r))  # per row: by count, then label
        # rows with no surviving edges keep their current label
        last = np.searchsorted(r[order], np.arange(n), side="right") - 1
        first = np.searchsorted(r[order], np.arange(n), side="left")
        present = first <= last
        new_labels = labels.copy()
        new_labels[present] = lab[order][last[present]]
        labels = new_labels
    return labels


def _propagate_labels(
    rows_lp: np.ndarray, cols_lp: np.ndarray, n: int, n_iters: int
) -> np.ndarray:
    if len(rows_lp):
        try:
            # native sweeps: per-row span sorts in C++/OpenMP, ~10× the NumPy
            # full-array sort per sweep at reddit scale; same semantics
            # (tested against the NumPy spec in tests/test_data.py)
            from parallel_gcn.data.native import community_labels_native

            return community_labels_native(rows_lp, cols_lp, n, n_iters)
        except Exception:
            pass
    return _propagate_labels_numpy(rows_lp, cols_lp, n, n_iters)


def community_order(
    csr: HostCSR, n_iters: int = 8, hub_block: int = 1024
) -> np.ndarray:
    """Community-clustering node order: label propagation + hubs-first.

    Social graphs (reddit's subreddits) are community-structured; placing each
    community's nodes contiguously makes the intra-community edges — the vast
    majority — fall into dense 128×128 tiles for the block-sparse product,
    while pulling the top-degree hubs into one leading block concentrates the
    hub-to-hub inter-community edges the same way (a Rabbit-Order-style
    degree+community layout). Vectorized label propagation: each sweep, every
    node adopts the most frequent label among its neighbors (ties toward the
    larger label id, deterministic); O(E log E) per sweep via one sort.

    Returns ``perm`` with perm[i] = old id placed at new position i (same
    contract as ``rcm_permutation``).
    """
    n = csr.n_rows
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    deg = np.diff(csr.indptr).astype(np.int64)
    by_deg_desc = np.argsort(-deg, kind="stable")

    # Exclude hub-incident edges from the propagation: hubs carry most of the
    # INTER-community edges, and their high degree lets them broadcast a
    # foreign label through whole communities, merging clusters (measured on
    # synth-reddit: 8.3K vs 4.8K occupied 512-tiles with/without exclusion).
    # The hubs end up in the leading block regardless. Scale the excluded set
    # to the graph — removing a large FRACTION of nodes starves the
    # propagation and degrades small graphs.
    n_hub = min(hub_block, n // 64)
    if n_hub > 0:
        hub = np.zeros(n, dtype=bool)
        hub[by_deg_desc[:n_hub]] = True
        keep = ~(hub[rows] | hub[cols])
        rows_lp, cols_lp = rows[keep], cols[keep]
    else:
        rows_lp, cols_lp = rows, cols

    labels = _propagate_labels(rows_lp, cols_lp, n, n_iters)
    nonhub = np.ones(n, dtype=np.int8)
    if n_hub > 0:
        nonhub[by_deg_desc[:n_hub]] = 0
    # primary: hubs first; then community label; then degree (desc) within
    return np.lexsort((-deg, labels, nonhub)).astype(np.int64)


def permute_csr(csr: HostCSR, perm: np.ndarray) -> HostCSR:
    """Relabel nodes: new node i is old node perm[i]. Neighbor lists are
    re-sorted; edge VALUES move with their edges (an exact permutation
    similarity P·Â·Pᵀ — recomputing from the coalesced CSR's degrees would
    silently change the operator on duplicate-carrying graphs, where the
    reference's degrees count every copy)."""
    n = csr.n_rows
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)

    old_rows = csr.row_ids().astype(np.int64)
    new_rows = inv[old_rows]
    new_cols = inv[csr.indices.astype(np.int64)]
    order = np.lexsort((new_cols, new_rows))
    new_rows = new_rows[order]
    new_cols = new_cols[order]

    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, new_rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return HostCSR(
        indptr=indptr,
        indices=new_cols.astype(np.int32),
        values=csr.values[order],
        n_rows=n,
        n_cols=csr.n_cols,
        sym_scale=None if csr.sym_scale is None else csr.sym_scale[perm],
    )


def permute_dataset(ds, perm: np.ndarray):
    """Apply a node permutation to a whole Dataset (features/labels/split move
    with their nodes)."""
    from dataclasses import replace

    return replace(
        ds,
        graph=permute_csr(ds.graph, perm),
        features=ds.features[perm],
        labels=ds.labels[perm],
        split=ds.split[perm],
        feature_csr=None,  # invalidated; dense features are authoritative here
    )
