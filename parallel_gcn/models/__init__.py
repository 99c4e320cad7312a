from parallel_gcn.models.gat import GATModel, init_gat_params
from parallel_gcn.models.gcn import GCNModel, init_params
from parallel_gcn.models.sage import (
    GINModel,
    SAGEModel,
    init_gin_params,
    init_sage_params,
)

__all__ = [
    "GATModel",
    "GCNModel",
    "GINModel",
    "SAGEModel",
    "init_gat_params",
    "init_gin_params",
    "init_params",
    "init_sage_params",
]
