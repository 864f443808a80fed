from efficient_gnns_tpu_torch.graphs.batching import pack_graphs, pack_node_features
from efficient_gnns_tpu_torch.graphs.container import BatchedGraphs, Graph
from efficient_gnns_tpu_torch.graphs.hetero import GroupedHetero, group_hetero_graph, mag_preprocess
from efficient_gnns_tpu_torch.graphs.hub_dense import HubPartition, auto_hub_size
from efficient_gnns_tpu_torch.graphs.preprocess import (
    add_self_loops,
    build_graph,
    gcn_norm_weights,
    induced_subgraph,
    pad_length,
    to_bidirected,
)
from efficient_gnns_tpu_torch.graphs.row_split import (
    ROW_SPLIT_THRESHOLD,
    RowSplit,
    build_row_split,
    sddmm_by_split,
    segment_reduce_by_split,
)

__all__ = [
    "BatchedGraphs",
    "Graph",
    "GroupedHetero",
    "HubPartition",
    "ROW_SPLIT_THRESHOLD",
    "RowSplit",
    "add_self_loops",
    "auto_hub_size",
    "build_graph",
    "build_row_split",
    "gcn_norm_weights",
    "group_hetero_graph",
    "induced_subgraph",
    "mag_preprocess",
    "pack_graphs",
    "pack_node_features",
    "pad_length",
    "sddmm_by_split",
    "segment_reduce_by_split",
    "to_bidirected",
]
