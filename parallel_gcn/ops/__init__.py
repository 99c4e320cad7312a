from parallel_gcn.ops.dropout import dropout
from parallel_gcn.ops.graphsum import graphsum
from parallel_gcn.ops.loss import masked_softmax_xent
from parallel_gcn.ops.sparse_matmul import feature_transform

__all__ = ["dropout", "feature_transform", "graphsum", "masked_softmax_xent"]
