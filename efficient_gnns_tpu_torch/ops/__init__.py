from efficient_gnns_tpu_torch.ops.edge_softmax import edge_softmax
from efficient_gnns_tpu_torch.ops.sddmm import sddmm_add, sddmm_dot
from efficient_gnns_tpu_torch.ops.segment import (
    gather,
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_sum,
)
from efficient_gnns_tpu_torch.ops.sorted_segment import csr_segment_sum_sorted, gather_rows_csr
from efficient_gnns_tpu_torch.ops.spmm import spmm, spmm_heads, spmm_mean

__all__ = [
    "csr_segment_sum_sorted",
    "edge_softmax",
    "gather",
    "gather_rows_csr",
    "sddmm_add",
    "sddmm_dot",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_sum",
    "spmm",
    "spmm_heads",
    "spmm_mean",
]
