"""ctypes bindings for the native C++ dataset loader (csrc/loader.cpp).

Builds the shared library on first use when a compiler is available (no
pybind11 in this image — plain C ABI + ctypes). Falls back silently to the
pure-Python parser when the build or load fails; parser.py treats any
exception here as "use Python".
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from parallel_gcn.data.graph import HostCSR

_HERE = os.path.dirname(os.path.abspath(__file__))
# ABI-versioned filename: bump when csrc/loader.cpp's C interface changes.
# A rebuild over a dlopen'd path is a no-op (ctypes never dlcloses — the old
# link map wins) and can corrupt the mapped library; a new name sidesteps
# both. Stale _native*.so files from older revisions are simply ignored.
_ABI_VERSION = 4
_SO_PATH = os.path.join(_HERE, f"_native_v{_ABI_VERSION}.so")
_CSRC = os.path.normpath(os.path.join(_HERE, "..", "..", "csrc"))

_lib = None
_build_failed = False


def _build() -> bool:
    src = os.path.join(_CSRC, "loader.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared",
             "-o", _SO_PATH, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def _get_lib():
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        raise RuntimeError("native loader build failed previously")
    if not os.path.exists(_SO_PATH) and not _build():
        _build_failed = True
        raise RuntimeError("native loader unavailable")
    lib = ctypes.CDLL(_SO_PATH)

    lib.pgcn_load.restype = ctypes.c_void_p
    lib.pgcn_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    for name in ("pgcn_status",):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in (
        "pgcn_n_nodes", "pgcn_input_dim", "pgcn_output_dim",
        "pgcn_graph_nnz", "pgcn_feat_nnz", "pgcn_split_len",
    ):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    ptr_specs = {
        "pgcn_graph_indptr": ctypes.POINTER(ctypes.c_int64),
        "pgcn_graph_indices": ctypes.POINTER(ctypes.c_int32),
        "pgcn_graph_values": ctypes.POINTER(ctypes.c_float),
        "pgcn_feat_indptr": ctypes.POINTER(ctypes.c_int64),
        "pgcn_feat_indices": ctypes.POINTER(ctypes.c_int32),
        "pgcn_feat_values": ctypes.POINTER(ctypes.c_float),
        "pgcn_labels": ctypes.POINTER(ctypes.c_int32),
        "pgcn_split": ctypes.POINTER(ctypes.c_int32),
    }
    for name, restype in ptr_specs.items():
        getattr(lib, name).restype = restype
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.pgcn_free.restype = None
    lib.pgcn_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _copy(ptr, n, dtype):
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def load_dataset_native(directory: str, name: str, binarize: bool):
    """Returns (graph HostCSR, feature HostCSR, labels, split, input_dim,
    output_dim) — the same tuple parser.py's Python path produces."""
    lib = _get_lib()
    handle = lib.pgcn_load(
        directory.encode(), name.encode(), 1 if binarize else 0
    )
    if not handle:
        raise RuntimeError("pgcn_load returned NULL")
    try:
        status = lib.pgcn_status(handle)
        if status != 0:
            raise FileNotFoundError(f"native loader status {status} for {name}")
        n = lib.pgcn_n_nodes(handle)
        g_nnz = lib.pgcn_graph_nnz(handle)
        f_nnz = lib.pgcn_feat_nnz(handle)
        s_len = lib.pgcn_split_len(handle)
        input_dim = lib.pgcn_input_dim(handle)
        output_dim = lib.pgcn_output_dim(handle)

        from parallel_gcn.data.graph import coalesce_duplicate_edges

        # the C loader mirrors the reference parser and keeps duplicate
        # neighbor entries (degree-inclusive values already computed); merge
        # them into single weighted edges like the python path
        # (add_self_loops_csr) so matrix-shaped backends apply the same
        # operator — see data.graph.coalesce_duplicate_edges
        g_indptr = _copy(lib.pgcn_graph_indptr(handle), n + 1, np.int64)
        # duplicate-inclusive degrees exist only pre-coalesce — carry
        # d = deg^{-1/2} for exact int8 pattern factorization downstream
        # (data.graph.sym_scale_for)
        g_deg = np.diff(g_indptr).astype(np.float64)
        graph = coalesce_duplicate_edges(HostCSR(
            indptr=g_indptr,
            indices=_copy(lib.pgcn_graph_indices(handle), g_nnz, np.int32),
            values=_copy(lib.pgcn_graph_values(handle), g_nnz, np.float32),
            n_rows=int(n),
            n_cols=int(n),
            sym_scale=(1.0 / np.sqrt(np.maximum(g_deg, 1.0))).astype(np.float32),
        ))
        features = HostCSR(
            indptr=_copy(lib.pgcn_feat_indptr(handle), n + 1, np.int64),
            indices=_copy(lib.pgcn_feat_indices(handle), f_nnz, np.int32),
            values=_copy(lib.pgcn_feat_values(handle), f_nnz, np.float32),
            n_rows=int(n),
            n_cols=int(input_dim),
        )
        labels = _copy(lib.pgcn_labels(handle), n, np.int32)
        split = _copy(lib.pgcn_split(handle), s_len, np.int32)
        return graph, features, labels, split, int(input_dim), int(output_dim)
    finally:
        lib.pgcn_free(handle)


def community_labels_native(
    rows: np.ndarray, cols: np.ndarray, n: int, n_iters: int
) -> np.ndarray:
    """Native label-propagation sweeps (csrc/loader.cpp pgcn_community_labels).

    ``rows`` must be sorted ascending. Returns the final labels (init: iota).
    Raises on any unavailability; callers fall back to the NumPy loop."""
    lib = _get_lib()
    fn = lib.pgcn_community_labels
    if fn.argtypes is None:  # configure the signature once per process
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
    rows64 = np.ascontiguousarray(rows, dtype=np.int64)
    cols64 = np.ascontiguousarray(cols, dtype=np.int64)
    labels = np.arange(n, dtype=np.int64)
    fn(
        rows64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(rows64)),
        ctypes.c_int64(n),
        ctypes.c_int(n_iters),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return labels
