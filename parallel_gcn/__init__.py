"""parallel_gcn — a JAX framework for training Graph Convolutional Networks.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference CUDA
framework davide-gurrieri/parallel-GCN (surveyed in SURVEY.md):

- data layer: `.graph/.svmlight/.split` readers, CSR with implicit self-loops,
  symmetric-normalized adjacency precompute (reference: src/parser.cpp).
- ops: neighborhood aggregation ``graphsum`` (Â·X) with a symmetric-Â custom VJP,
  sparse/dense feature transform, inverted dropout, fused masked softmax
  cross-entropy with loss + accuracy (reference: src/module.cu).
- models: N-layer GCN with per-layer dropout, selective L2 decay on the first
  weight only (reference: src/gcn.cu); plus a beyond-reference GAT family
  (multi-head attention aggregation, models/gat.py).
- optim: Adam with bias-corrected step size matching the reference math
  (reference: src/optim.cu).
- parallel: node-partitioned multi-device aggregation over a
  `jax.sharding.Mesh` (beyond the reference, which is single-GPU).

The compute path is pure-functional JAX: the reference's manual CUDA streams and
events (src/smart_object.cu, src/gcn.cu:5-11) are replaced by XLA's async
dispatch; its in-place dropout / set_input restore dance (src/gcn.cu:181-200)
vanishes under functional purity.
"""

__version__ = "0.1.0"

from parallel_gcn.config import AdamConfig, Config, GCNConfig, ExecConfig, load_config
from parallel_gcn.data.graph import Graph
from parallel_gcn.data.parser import (
    load_dataset,
    prepare_device_dataset,
    prepare_host_dataset,
    to_device,
)

__all__ = [
    "AdamConfig",
    "Config",
    "GCNConfig",
    "ExecConfig",
    "Graph",
    "load_config",
    "load_dataset",
    "prepare_device_dataset",
    "prepare_host_dataset",
    "to_device",
    "fit",
    "fit_parallel",
    "GCNModel",
    "GATModel",
    "__version__",
]


def __getattr__(name):
    # lazy imports: train/models pull in jax transforms; keep bare package
    # import light for tooling
    if name == "fit":
        from parallel_gcn.train import fit

        return fit
    if name == "fit_parallel":
        from parallel_gcn.parallel.train_parallel import fit_parallel

        return fit_parallel
    if name == "GCNModel":
        from parallel_gcn.models.gcn import GCNModel

        return GCNModel
    if name == "GATModel":
        from parallel_gcn.models.gat import GATModel

        return GATModel
    raise AttributeError(name)
