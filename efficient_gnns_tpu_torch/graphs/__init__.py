from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.graphs.preprocess import (
    add_self_loops,
    build_graph,
    gcn_norm_weights,
    induced_subgraph,
    pad_length,
    to_bidirected,
)

__all__ = [
    "Graph",
    "add_self_loops",
    "build_graph",
    "gcn_norm_weights",
    "induced_subgraph",
    "pad_length",
    "to_bidirected",
]
