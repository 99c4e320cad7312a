"""Dataset readers for the `.graph` / `.svmlight` / `.split` format.

Same on-disk format as the reference (src/parser.cpp):
  <name>.graph     one line per node: space-separated neighbor ids (an implicit
                   self-loop is prepended as the first CSR entry per row,
                   src/parser.cpp:29-31)
  <name>.svmlight  one line per node: "<label> <feat_id>:<feat_val> ..."
                   input_dim = max feature id + 1, output_dim = max label + 1
                   (src/parser.cpp:59-112)
  <name>.split     one integer per node: 1=train 2=val 3=test (src/parser.cpp:114-132)

A fast C++ reader (csrc/loader.cpp, loaded via ctypes) is used when the shared
library has been built; this module is the pure-Python fallback and the
semantic spec.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from parallel_gcn.data.graph import (
    Graph,
    HostCSR,
    add_self_loops_csr,
    build_graph,
    normalized_adjacency_values,
    pad_to_multiple,
)

TRAIN, VAL, TEST = 1, 2, 3

_DATA_DIR_CANDIDATES = (
    os.environ.get("PGCN_DATA_DIR", ""),
    "data",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data"),
)


def find_data_dir(
    dataset: str, data_dir: str = "", exts=("graph", "svmlight", "split")
) -> str:
    candidates = [data_dir] if data_dir else list(_DATA_DIR_CANDIDATES)
    for cand in candidates:
        if cand and all(
            os.path.exists(os.path.join(cand, f"{dataset}.{ext}"))
            for ext in exts
        ):
            return cand
    raise FileNotFoundError(
        f"dataset {dataset!r} not found (need {exts}); searched {candidates}. "
        "Set PGCN_DATA_DIR or pass data_dir."
    )


@dataclass
class Dataset:
    """Host-side dataset — analog of the reference's GCNData (include/gcn.cuh:53-60)
    plus the dims the reference keeps in GCNParams (num_nodes, input_dim,
    output_dim, train/val/test_dim)."""

    name: str
    graph: HostCSR  # normalized adjacency Â, self-loop inclusive
    feature_csr: HostCSR  # sparse features (values possibly binarized)
    features: np.ndarray  # dense float32 [n_nodes, input_dim]
    labels: np.ndarray  # int32 [n_nodes]
    split: np.ndarray  # int32 [n_nodes] of {1,2,3}
    n_nodes: int
    input_dim: int
    output_dim: int

    @property
    def train_dim(self) -> int:
        return int((self.split == TRAIN).sum())

    @property
    def val_dim(self) -> int:
        return int((self.split == VAL).sum())

    @property
    def test_dim(self) -> int:
        return int((self.split == TEST).sum())


def parse_graph_file(path: str) -> HostCSR:
    """Adjacency edgelist → CSR with implicit self-loops and Â values."""
    neighbor_lists = []
    with open(path) as f:
        for line in f:
            neighbor_lists.append(np.fromstring(line, dtype=np.int32, sep=" "))
    return add_self_loops_csr(neighbor_lists)


def parse_svmlight_file(
    path: str, binarize: bool = False
) -> tuple[HostCSR, np.ndarray, int, int]:
    """Labels + sparse feature CSR. ``binarize`` mirrors -DNO_FEATURE
    (src/parser.cpp:100-104): all feature values become 1.0."""
    labels: list[int] = []
    indptr: list[int] = [0]
    idx_chunks: list[np.ndarray] = []
    val_chunks: list[np.ndarray] = []
    max_idx = 0
    max_label = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                labels.append(-1)
                indptr.append(indptr[-1])
                continue
            label = int(parts[0])
            labels.append(label)
            max_label = max(max_label, label)
            if len(parts) > 1:
                kv = np.array([p.split(":") for p in parts[1:]])
                idx = kv[:, 0].astype(np.int32)
                val = kv[:, 1].astype(np.float32)
                idx_chunks.append(idx)
                val_chunks.append(val)
                max_idx = max(max_idx, int(idx.max()))
                indptr.append(indptr[-1] + len(idx))
            else:
                indptr.append(indptr[-1])

    indices = (
        np.concatenate(idx_chunks) if idx_chunks else np.zeros(0, dtype=np.int32)
    )
    values = (
        np.concatenate(val_chunks) if val_chunks else np.zeros(0, dtype=np.float32)
    )
    if binarize:
        values = np.ones_like(values)
    input_dim = max_idx + 1
    output_dim = max_label + 1
    csr = HostCSR(
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=indices,
        values=values,
        n_rows=len(labels),
        n_cols=input_dim,
    )
    return csr, np.asarray(labels, dtype=np.int32), input_dim, output_dim


def local_clustering_coefficient(csr: HostCSR, node: int) -> float:
    """Local clustering coefficient of ``node`` over the self-loop-first CSR —
    the exact semantics of the reference's (unused) graph-analysis experiment
    (src/parser.cpp:135-162), quirks included: the adjacency here contains
    the implicit self-loop, which the reference counts in the degree
    denominator AND walks as a neighbor when counting triangles (only the
    back-edge to ``node`` itself is skipped). Diagnostic only — nothing on
    the training path consumes it, mirroring the reference."""
    start, end = int(csr.indptr[node]), int(csr.indptr[node + 1])
    edges = end - start
    if edges <= 1:
        return 0.0
    nbrs = csr.indices[start:end]
    triangles = 0
    for nb in nbrs:
        nn = csr.indices[int(csr.indptr[nb]):int(csr.indptr[nb + 1])]
        nn = nn[nn != node]
        triangles += int(np.isin(nn, nbrs).sum())
    return 2.0 * triangles / (edges * (edges - 1))


def parse_split_file(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int32).reshape(-1)


def _try_native_loader(directory: str, name: str, binarize: bool):
    """Use the C++ loader (csrc/loader.cpp) when built; None on any failure."""
    try:
        from parallel_gcn.data import native

        return native.load_dataset_native(directory, name, binarize)
    except Exception:
        return None


def load_dataset(
    name: str, data_dir: str = "", binarize_features: bool = False, use_native: bool = True
) -> Dataset:
    """Load one of the reference datasets (cora/citeseer/pubmed/reddit) or any
    dataset in the same format. Names registered in data.synthetic
    (synth-reddit, …) are generated in memory at matched scale instead."""
    from parallel_gcn.data.synthetic import (
        SYNTH_FEATURE_SPECS,
        SYNTHETIC_SPECS,
        make_synth_feature_dataset,
        make_synthetic_dataset,
    )

    if name in SYNTHETIC_SPECS:
        return make_synthetic_dataset(name)
    if name in SYNTH_FEATURE_SPECS:
        return make_synth_feature_dataset(name, data_dir=data_dir)

    directory = find_data_dir(name, data_dir)

    native_result = (
        _try_native_loader(directory, name, binarize_features) if use_native else None
    )
    if native_result is not None:
        graph, feature_csr, labels, split, input_dim, output_dim = native_result
    else:
        graph = parse_graph_file(os.path.join(directory, f"{name}.graph"))
        feature_csr, labels, input_dim, output_dim = parse_svmlight_file(
            os.path.join(directory, f"{name}.svmlight"), binarize=binarize_features
        )
        split = parse_split_file(os.path.join(directory, f"{name}.split"))

    features = feature_csr.to_dense()
    return Dataset(
        name=name,
        graph=graph,
        feature_csr=feature_csr,
        features=features,
        labels=labels,
        split=split,
        n_nodes=graph.n_rows,
        input_dim=input_dim,
        output_dim=output_dim,
    )


@dataclass
class DeviceDataset:
    """Padded, device-ready arrays. Nodes are padded to ``node_pad`` so every
    array under jit has static padded shapes; padded nodes carry label -1
    and split 0 so they are masked out of loss/accuracy everywhere."""

    graph: Graph
    x: "jax.Array"  # float32 [n_pad, input_dim]
    labels: "jax.Array"  # int32 [n_pad], -1 on padding
    split: "jax.Array"  # int32 [n_pad], 0 on padding
    n_real_nodes: int
    input_dim: int
    output_dim: int
    split_counts: dict  # {1: train_dim, 2: val_dim, 3: test_dim}
    # Â·X, precomputed once for EVAL forwards when the training input dropout
    # is nonzero (train.preaggregate_input); None until then
    x_agg: "jax.Array | None" = None


def to_device(
    ds: Dataset,
    *,
    node_pad: int = 8,
    dense: bool = False,
    bcsr: bool = False,
    hybrid: bool = False,
    n_nodes_pad: int | None = None,
    tile_dtype="float32",
    tile_size: int = 128,
    tile_cols: int = 0,
    tile_budget_mb: int = 3072,
    min_tile_nnz: int = 0,
    adj_dtype="float32",
) -> DeviceDataset:
    import jax.numpy as jnp

    if bcsr or hybrid:
        node_pad = max(node_pad, tile_cols or tile_size)
    n_pad = n_nodes_pad or pad_to_multiple(ds.n_nodes, node_pad)
    graph = build_graph(
        ds.graph, node_pad=node_pad, dense=dense, bcsr=bcsr, hybrid=hybrid,
        n_nodes_pad=n_pad, tile_dtype=np.dtype(tile_dtype), tile_size=tile_size,
        tile_cols=tile_cols, adj_dtype=jnp.dtype(adj_dtype),
        tile_budget_bytes=tile_budget_mb * 1024 * 1024,
        min_tile_nnz=min_tile_nnz or None,
    )

    x = np.zeros((n_pad, ds.input_dim), dtype=np.float32)
    x[: ds.n_nodes] = ds.features
    labels = np.full(n_pad, -1, dtype=np.int32)
    labels[: ds.n_nodes] = ds.labels
    split = np.zeros(n_pad, dtype=np.int32)
    split[: ds.n_nodes] = ds.split

    return DeviceDataset(
        graph=graph,
        x=jnp.asarray(x),
        labels=jnp.asarray(labels),
        split=jnp.asarray(split),
        n_real_nodes=ds.n_nodes,
        input_dim=ds.input_dim,
        output_dim=ds.output_dim,
        split_counts={s: int((ds.split == s).sum()) for s in (TRAIN, VAL, TEST)},
    )


def prepare_host_dataset(cfg, name: str) -> Dataset:
    """Load + (optionally) reorder — the host-side half of data preparation,
    shared by the single-chip device layout and the multi-chip partitioner."""
    ds = load_dataset(
        name, cfg.data.data_dir, binarize_features=cfg.data.binarize_features
    )

    if cfg.exec.reorder != "none":
        from parallel_gcn.data.reorder import (
            community_order,
            permute_dataset,
            rcm_permutation,
        )

        if cfg.exec.reorder == "community":
            order = community_order(ds.graph, hub_block=cfg.exec.reorder_hub_block)
        else:
            order = rcm_permutation(ds.graph)
        ds = permute_dataset(ds, order)
    return ds


def prepare_device_dataset(cfg, name: str) -> tuple[Dataset, DeviceDataset]:
    """Load → (optionally) reorder → device layout, driven by one Config.

    The single entry point used by the CLI, bench, and harnesses so that the
    reorder/backends knobs behave identically everywhere.
    """
    ds = prepare_host_dataset(cfg, name)
    return ds, device_dataset(cfg, ds)


def device_dataset(cfg, ds: Dataset) -> DeviceDataset:
    """The device layout ``cfg`` asks for, of an already loaded (and
    reordered) host dataset."""
    # harnesses mutate cfg.exec programmatically after construction — re-check
    # the invariants the dataclass validator enforces for file-sourced values
    cfg.exec.__post_init__()
    backend = cfg.exec.backend
    # an explicit dense request is honored at any size; "auto" only goes dense
    # below the threshold (the adj is n_pad^2 floats)
    dense = backend == "dense" or (
        backend == "auto" and ds.n_nodes <= cfg.exec.dense_threshold
    )
    # bf16 tiles double the coverage per byte of tile budget; keep true-f32
    # tiles only when full f32 parity is requested. int8 stores the exact
    # 0/1 pattern with the degree scaling applied around the product — see
    # ExecConfig.
    tile_dtype = cfg.exec.tile_dtype
    if tile_dtype == "auto":
        tile_dtype = (
            "float32" if cfg.exec.matmul_precision == "highest" else "bfloat16"
        )
    return to_device(
        ds,
        node_pad=cfg.exec.node_pad,
        dense=dense,
        bcsr=backend == "bcsr",
        hybrid=backend == "hybrid",
        tile_dtype=tile_dtype,
        adj_dtype=(
            ("float32" if cfg.exec.matmul_precision == "highest"
             else "bfloat16")
            if cfg.exec.adj_dtype == "auto" else cfg.exec.adj_dtype
        ),
        tile_size=cfg.exec.tile_size,
        tile_cols=cfg.exec.tile_cols,
        tile_budget_mb=cfg.exec.tile_budget_mb,
        min_tile_nnz=cfg.exec.min_tile_nnz,
    )
