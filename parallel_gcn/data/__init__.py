from parallel_gcn.data.graph import Graph, build_graph, pad_to_multiple
from parallel_gcn.data.parser import Dataset, load_dataset

__all__ = ["Graph", "Dataset", "build_graph", "load_dataset", "pad_to_multiple"]
