from parallel_gcn.parallel.partition import ShardedGraph, partition_graph
from parallel_gcn.parallel.train_parallel import (
    make_parallel_epoch_step,
    shard_dataset,
)

__all__ = [
    "ShardedGraph",
    "make_parallel_epoch_step",
    "partition_graph",
    "shard_dataset",
]
