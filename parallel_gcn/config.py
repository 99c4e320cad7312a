"""Config system.

The reference uses a vendored GetPot key=value parser plus compile-time ``-D``
flags (reference: src/parser.cpp:211-271, Makefile:3-63, include/GetPot). Here
everything is one runtime dataclass tree parsed from the same ``key = value``
file format, so the per-dataset files under ``parameters/`` remain drop-in
compatible with the reference's ``parameters/parameters_<name>.txt``.

Compile-time flags of the reference become runtime booleans:
  -DNO_FEATURE            -> ``DataConfig.binarize_features``
  -DRESIDUAL_CONNECTIONS  -> ``GCNConfig.residual``
  -DNO_OUTPUT             -> ``TrainConfig.verbose``
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Sequence


def _parse_scalar(text: str):
    text = text.strip()
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    return text


def parse_keyvalue_file(path: str) -> dict:
    """Parse a GetPot-style ``key = value`` file (comments start with ``#``).

    Mirrors what the reference reads through GetPot (src/parser.cpp:213-247);
    values that contain commas are returned as lists.
    """
    out: dict = {}
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            val = val.strip()
            if "," in val:
                out[key] = [_parse_scalar(v) for v in val.split(",") if v.strip()]
            else:
                out[key] = _parse_scalar(val)
    return out


@dataclass
class GCNConfig:
    """Model hyperparameters (reference: include/gcn.cuh:40-49)."""

    n_layers: int = 2
    hidden_dims: Sequence[int] = (16,)
    dropouts: Sequence[float] = (0.5, 0.5)
    epochs: int = 100
    early_stopping: int = 0
    residual: bool = False  # -DRESIDUAL_CONNECTIONS (include/module.cuh:149)
    # model family: gcn (reference parity), gat (models/gat.py — attention
    # aggregation; hidden_dims are then PER-HEAD widths), sage (GraphSAGE-mean)
    # or gin (GIN-eps) — both in models/sage.py
    model: str = "gcn"
    heads: int = 8  # GAT attention heads (paper cora config)
    attn_dropout: float = 0.0  # GAT: dropout on normalized attention coeffs
    gin_eps: float = 0.0  # GIN: fixed eps (the paper's GIN-0 default)
    # rematerialize layers in backward (jax.checkpoint) — trades one extra
    # forward's FLOPs for one-layer activation memory. GAT: required for
    # reddit-scale attention on one 16 GB chip (O(L·E·heads·d) ->
    # O(E·heads·d)); GCN: useful for deep models on huge graphs
    remat: bool = False

    def __post_init__(self):
        if self.model not in ("gcn", "gat", "sage", "gin"):
            raise ValueError(
                f"model must be gcn|gat|sage|gin, got {self.model!r}"
            )
        if self.heads < 1:
            raise ValueError(f"heads must be >= 1, got {self.heads}")
        if not 0.0 <= self.attn_dropout < 1.0:
            raise ValueError(
                f"attn_dropout must be in [0, 1), got {self.attn_dropout}"
            )
        if isinstance(self.hidden_dims, (int, float)):
            self.hidden_dims = (int(self.hidden_dims),)
        self.hidden_dims = tuple(int(h) for h in self.hidden_dims)
        if isinstance(self.dropouts, (int, float)):
            self.dropouts = (float(self.dropouts),)
        self.dropouts = tuple(float(d) for d in self.dropouts)
        if len(self.hidden_dims) != self.n_layers - 1:
            raise ValueError(
                f"need n_layers-1={self.n_layers - 1} hidden_dims, got {self.hidden_dims}"
            )
        if len(self.dropouts) != self.n_layers:
            raise ValueError(
                f"need n_layers={self.n_layers} dropouts, got {self.dropouts}"
            )


@dataclass
class AdamConfig:
    """Optimizer hyperparameters (reference: include/optim.cuh:16-19)."""

    learning_rate: float = 0.01
    weight_decay: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


@dataclass
class DataConfig:
    data_dir: str = ""  # resolved by data.parser.find_data_dir when empty
    binarize_features: bool = False  # -DNO_FEATURE (src/parser.cpp:100-104)


@dataclass
class ExecConfig:
    """Execution knobs — the analog of the reference's CudaParams
    (include/utils.cuh:17-23), re-thought for XLA: instead of launch geometry we
    choose an aggregation backend, compute dtype, and edge-chunk budget."""

    backend: str = "auto"  # auto | dense | segment | bcsr | hybrid (tiles + COO)
    # node reordering before device layout: none | rcm | community
    # (permutation-equivariant preprocessing for block-sparse locality,
    # data/reorder.py — plays the role of the reference's per-dataset tuning)
    reorder: str = "none"
    # hub-block size for the community reorder (top-degree nodes pulled into
    # one leading block; their edges are excluded from label propagation).
    # 1024 suits reddit scale; graphs an order of magnitude larger need a
    # proportionally larger block or hub edges fragment the clustering
    reorder_hub_block: int = 1024
    compute_dtype: str = "float32"  # float32 | bfloat16 (matmul inputs)
    matmul_precision: str = "highest"  # highest (f32 parity) | default (TF32 on GPU)
    # segment-aggregation edge chunking: GCN 0 = auto from memory budget
    # (ops.graphsum._pick_n_chunks); GAT 0 = unchunked (chunking there is a
    # memory knob only — see models/gat.py _attend_segment_chunked)
    edge_chunk: int = 0
    dense_threshold: int = 8192  # use dense Â·X below this many (padded) nodes
    node_pad: int = 8  # pad nodes to a multiple of this
    # hoist the input layer's Â·X out of the epoch loop when input dropout is 0
    # (exact rewrite; see train.preaggregate_input)
    input_preagg: bool = True
    # bcsr/hybrid tile rows (multiple of 128); larger tiles amortize Pallas
    # grid-step overhead on graphs with big community blocks
    tile_size: int = 128
    # tile columns (0 = square); wide tiles suit banded (RCM) structure —
    # must be a multiple of tile_size
    tile_cols: int = 0
    # tile storage dtype for bcsr/hybrid packs: auto (float32 when
    # matmul_precision=highest, else bfloat16) | float32 | bfloat16 | int8.
    # int8 stores the exact 0/1 edge pattern with the degree normalization
    # applied outside the kernel (out = d ⊙ B(d ⊙ x), d = deg^{-1/2}) — an
    # exact factorization, NOT quantization; halves the bf16 tile stream
    tile_dtype: str = "auto"
    # dense-backend Â storage: auto (float32 when matmul_precision=highest,
    # else bfloat16) | float32 | bfloat16 | int8. int8 is the tile trick
    # applied to the dense path — the exact 0/1·k pattern with
    # out = d ⊙ (A₈ @ (d ⊙ x)) scaling outside the matmul; halves the
    # dominant Â read of citation-scale epochs (swept by tuning_layout)
    adj_dtype: str = "auto"
    # byte budget for resident Â tiles (hybrid backend)
    tile_budget_mb: int = 3072
    # minimum nnz for a tile to qualify (0 = auto break-even vs gather cost)
    min_tile_nnz: int = 0
    # multi-chip training: number of mesh devices (0/1 = single-chip path)
    # and the halo-exchange strategy for the node-partitioned aggregation:
    # all_gather (full remote feature gather — fast while N·F fits HBM),
    # boundary (all_to_all of only the referenced remote rows/tile-blocks —
    # per-device memory O(N/D + halo); works with ALL backends incl. hybrid
    # tiles), adaptive (boundary + per-pair PUSH of partial sums where that
    # ships fewer rows — bounds the slab by min(pull, push); hub-heavy
    # graphs; COO backends only), ring (ppermute block rotation; COO only)
    n_devices: int = 0
    # large-GAT scan guard (train._gat_scan_fits_hbm): AOT memory check with
    # conservative fallback to eager on can't-tell — incl. accelerators that
    # report no bytes_limit. False skips the guard: scan proceeds unguarded.
    gat_scan_check: bool = True
    halo: str = "all_gather"
    # auto-fallback to all_gather when the boundary/adaptive compact buffer
    # would NOT be smaller than the gathered matrix (the all_to_all pads every
    # pair slab to the max pair, so uniform boundary sets can overshoot) —
    # a memory-saving halo must never cost MORE memory, silently. False keeps
    # the requested layout and only warns (structural tests/dryruns).
    halo_fallback: bool = True
    # tensor parallelism: size of the second ("feat") mesh axis. Weights
    # alternate Megatron-style column/row sharding over it, hidden
    # activations stay feature-sharded through the aggregations (which are
    # column-independent, so every halo mode composes unchanged), and the
    # inter-layer psum splits into reduce_scatter -> aggregate -> all_gather
    # so no aggregation work is replicated. Total devices = n_devices * tp.
    # Every hidden dim must be divisible by tp (input dim too when
    # n_layers == 1). 1 = off (SURVEY.md §2.4 TP row).
    tp: int = 1
    # spread hot tile-row blocks across devices via a whole-block node
    # permutation when the natural order concentrates tiles (hybrid backend;
    # parallel.partition._balance_block_perm)
    balance_slabs: bool = True
    seed: int = 19990304  # reference default seed (include/utils.cuh:22)

    def __post_init__(self):
        """Validate layout invariants. Also re-invoked by
        data.parser.prepare_device_dataset to cover harnesses that mutate the
        config programmatically after construction."""
        if self.backend not in ("auto", "dense", "segment", "bcsr", "hybrid"):
            raise ValueError(
                "backend must be auto|dense|segment|bcsr|hybrid, "
                f"got {self.backend!r}"
            )
        if self.reorder not in ("none", "rcm", "community"):
            raise ValueError(
                f"reorder must be none|rcm|community, got {self.reorder!r}"
            )
        if self.tile_size % 128 != 0:
            raise ValueError(f"tile_size must be a multiple of 128, got {self.tile_size}")
        if self.tile_cols and self.tile_cols % self.tile_size != 0:
            raise ValueError(
                f"tile_cols ({self.tile_cols}) must be a multiple of "
                f"tile_size ({self.tile_size})"
            )
        if self.halo not in ("all_gather", "boundary", "adaptive", "ring"):
            raise ValueError(
                "halo must be all_gather|boundary|adaptive|ring, "
                f"got {self.halo!r}"
            )
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.edge_chunk < 0:
            raise ValueError(
                f"edge_chunk must be >= 0 (0 = auto/off), got {self.edge_chunk}"
            )
        if self.tile_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                "tile_dtype must be auto|float32|bfloat16|int8, "
                f"got {self.tile_dtype!r}"
            )
        if self.adj_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                "adj_dtype must be auto|float32|bfloat16|int8, "
                f"got {self.adj_dtype!r}"
            )


@dataclass
class TrainConfig:
    verbose: bool = True
    mode: str = "scan"  # scan (fused jitted epoch loop) | eager (python loop)
    checkpoint_dir: str = ""
    checkpoint_every: int = 0  # epochs; 0 = disabled

    def __post_init__(self):
        # a typo'd mode would silently fall through the == "scan" check into
        # the eager loop, changing performance and checkpoint cadence
        if self.mode not in ("scan", "eager"):
            raise ValueError(
                f"train.mode must be 'scan' or 'eager', got {self.mode!r}"
            )


GAT_TILE_ERROR = (
    "model=gat has no tile route: attention runs over the complete COO — "
    "use backend=segment (or backend=dense on small graphs)"
)


@dataclass
class Config:
    gcn: GCNConfig = field(default_factory=GCNConfig)
    adam: AdamConfig = field(default_factory=AdamConfig)
    data: DataConfig = field(default_factory=DataConfig)
    exec: ExecConfig = field(default_factory=ExecConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def __post_init__(self):
        if self.gcn.model == "gat" and self.exec.backend in ("hybrid", "bcsr"):
            raise ValueError(GAT_TILE_ERROR)


# keys the reference keeps in CudaParams / parameters files that have no
# meaning here (launch geometry) — accepted and ignored for drop-in file
# compatibility.
_IGNORED_KEYS = {"num_blocks_factor", "num_threads"}

_KEYMAP = {
    "n_layers": ("gcn", "n_layers"),
    "hidden_dims": ("gcn", "hidden_dims"),
    "dropouts": ("gcn", "dropouts"),
    "epochs": ("gcn", "epochs"),
    "early_stopping": ("gcn", "early_stopping"),
    "residual": ("gcn", "residual"),
    "model": ("gcn", "model"),
    "heads": ("gcn", "heads"),
    "attn_dropout": ("gcn", "attn_dropout"),
    "gin_eps": ("gcn", "gin_eps"),
    "remat": ("gcn", "remat"),
    "learning_rate": ("adam", "learning_rate"),
    "weight_decay": ("adam", "weight_decay"),
    "beta1": ("adam", "beta1"),
    "beta2": ("adam", "beta2"),
    "eps": ("adam", "eps"),
    "seed": ("exec", "seed"),
    "backend": ("exec", "backend"),
    "reorder": ("exec", "reorder"),
    "reorder_hub_block": ("exec", "reorder_hub_block"),
    "tile_size": ("exec", "tile_size"),
    "tile_budget_mb": ("exec", "tile_budget_mb"),
    "tile_cols": ("exec", "tile_cols"),
    "tile_dtype": ("exec", "tile_dtype"),
    "adj_dtype": ("exec", "adj_dtype"),
    "min_tile_nnz": ("exec", "min_tile_nnz"),
    "n_devices": ("exec", "n_devices"),
    "halo": ("exec", "halo"),
    "halo_fallback": ("exec", "halo_fallback"),
    "gat_scan_check": ("exec", "gat_scan_check"),
    "tp": ("exec", "tp"),
    "balance_slabs": ("exec", "balance_slabs"),
    "input_preagg": ("exec", "input_preagg"),
    "node_pad": ("exec", "node_pad"),
    "compute_dtype": ("exec", "compute_dtype"),
    "matmul_precision": ("exec", "matmul_precision"),
    "edge_chunk": ("exec", "edge_chunk"),
    "dense_threshold": ("exec", "dense_threshold"),
    "binarize_features": ("data", "binarize_features"),
    "data_dir": ("data", "data_dir"),
    "verbose": ("train", "verbose"),
    "mode": ("train", "mode"),
    "checkpoint_dir": ("train", "checkpoint_dir"),
    "checkpoint_every": ("train", "checkpoint_every"),
}


_SECTION_CLS = None  # filled lazily (Config classes defined above)


def _check_value_type(section: str, name: str, val):
    """Hard-error on type mismatches so a typo'd override (``epochs=10O``
    parses as the string "10O") cannot silently fall back to a default or
    misbehave downstream. Declared field annotations are strings
    (``from __future__ import annotations``), so match on the text.
    Returns the value, coerced where accepted-but-mistyped (``epochs=50.0``
    becomes int 50 instead of crashing range()/scan() deep in training)."""
    global _SECTION_CLS
    if _SECTION_CLS is None:
        _SECTION_CLS = {
            "gcn": GCNConfig, "adam": AdamConfig, "data": DataConfig,
            "exec": ExecConfig, "train": TrainConfig,
        }
    ftype = {f.name: f.type for f in dataclasses.fields(_SECTION_CLS[section])}[name]
    is_num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
    if ftype == "int":
        ok = is_num(val) and float(val) == int(val)
        if ok:
            val = int(val)
    elif ftype == "float":
        ok = is_num(val)
        if ok:
            val = float(val)
    elif ftype == "bool":
        ok = isinstance(val, bool)
    elif ftype == "str":
        ok = isinstance(val, str)
    else:  # Sequence[int] / Sequence[float]: scalar or list of numbers
        vals = val if isinstance(val, (list, tuple)) else [val]
        ok = len(vals) > 0 and all(is_num(v) for v in vals)
    if not ok:
        raise ValueError(
            f"config key {name}={val!r} is not a valid {ftype}"
        )
    return val


def parse_override(value: str):
    """Parse one CLI-style override VALUE: a comma list becomes a list of
    scalars, otherwise one scalar (shared by cli.py and harness --set)."""
    if "," in value:
        return [_parse_scalar(v) for v in value.split(",")]
    return _parse_scalar(value)


def load_config(path: str, overrides: dict | None = None) -> Config:
    """Build a Config from a key=value file plus optional overrides.

    Drop-in reader for the reference's parameters files
    (parameters/parameters_<dataset>.txt)."""
    raw = parse_keyvalue_file(path)
    if overrides:
        raw.update(overrides)

    sections = {"gcn": {}, "adam": {}, "data": {}, "exec": {}, "train": {}}
    for key, val in raw.items():
        if key in _IGNORED_KEYS:
            continue
        if key not in _KEYMAP:
            raise KeyError(f"unknown config key {key!r} in {path}")
        section, name = _KEYMAP[key]
        sections[section][name] = _check_value_type(section, name, val)

    return Config(
        gcn=GCNConfig(**sections["gcn"]),
        adam=AdamConfig(**sections["adam"]),
        data=DataConfig(**sections["data"]),
        exec=ExecConfig(**sections["exec"]),
        train=TrainConfig(**sections["train"]),
    )


def default_params_path(dataset: str) -> str:
    """Locate parameters/parameters_<dataset>.txt next to the repo root."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(here, "parameters", f"parameters_{dataset}.txt")
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(f"no parameters file for dataset {dataset!r} at {cand}")
