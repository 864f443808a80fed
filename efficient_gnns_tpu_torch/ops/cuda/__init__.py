"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and their
plain PyTorch versions. Nothing is compiled at import: a kernel's library is
built with ``nvcc`` at its first launch (see ``build.py``)."""

from efficient_gnns_tpu_torch.ops.cuda.segment_sum import (
    csr_segment_sum,
    csr_segment_sum_plain,
)

__all__ = ["csr_segment_sum", "csr_segment_sum_plain"]
