from efficient_gnns_tpu_torch.ops.edge_softmax import edge_softmax
from efficient_gnns_tpu_torch.ops.sddmm import sddmm_add
from efficient_gnns_tpu_torch.ops.segment import (
    gather,
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_sum,
)
from efficient_gnns_tpu_torch.ops.spmm import spmm, spmm_heads, spmm_mean

__all__ = [
    "edge_softmax",
    "gather",
    "sddmm_add",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_sum",
    "spmm",
    "spmm_heads",
    "spmm_mean",
]
