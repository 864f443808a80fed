from efficient_gnns_tpu_torch.ops.segment import gather, segment_sum
from efficient_gnns_tpu_torch.ops.spmm import spmm

__all__ = ["gather", "segment_sum", "spmm"]
