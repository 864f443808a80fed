"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and their
plain PyTorch versions. Nothing is compiled at import: a kernel's library is
built with ``nvcc`` at its first launch (see ``build.py``). Every wrapper
binds, checks, launches and counts through ``launch.py``, whose
``launch.COUNTED`` holds each wrapper's ``launches`` counter.

K1 ``csr_segment_sum``; K2 ``csr_segment_sum_heads``; K3 ``csr_sddmm``; K4
``csr_sddmm_heads``; K5 ``csr_segment_sum_thin``; K6 ``csr_segment_max_thin``;
K7 ``csr_tile_rows_thin`` (numbered as the TPU kernels they replace). The
hub attention layer's fused elementwise passes around K1, which replace no
TPU kernel: ``hub_messages``, ``hub_epilogue``, ``hub_cotangent``,
``hub_message_grad`` (``hub_fused.py``). MaskedBatchNorm + ReLU, forward,
backward and eval, which replaces no TPU kernel either:
``masked_batch_norm`` (``masked_bn.py``). OGB's atom and bond encoders,
the lookup-and-sum forward and every table's gradient, which replace no TPU
kernel either: ``categorical_encode`` (``categorical.py``).
"""

from efficient_gnns_tpu_torch.ops.cuda.categorical import (
    categorical_encode,
    categorical_encode_plain,
)
from efficient_gnns_tpu_torch.ops.cuda.hub_fused import (
    hub_cotangent,
    hub_cotangent_plain,
    hub_epilogue,
    hub_epilogue_plain,
    hub_message_grad,
    hub_message_grad_plain,
    hub_messages,
    hub_messages_plain,
)
from efficient_gnns_tpu_torch.ops.cuda.masked_bn import (
    masked_batch_norm,
    masked_batch_norm_plain,
)
from efficient_gnns_tpu_torch.ops.cuda.segment_heads import (
    csr_sddmm_heads,
    csr_sddmm_heads_plain,
    csr_segment_sum_heads,
    csr_segment_sum_heads_plain,
)
from efficient_gnns_tpu_torch.ops.cuda.segment_sddmm import csr_sddmm, csr_sddmm_plain
from efficient_gnns_tpu_torch.ops.cuda.segment_sum import (
    csr_segment_sum,
    csr_segment_sum_plain,
)
from efficient_gnns_tpu_torch.ops.cuda.segment_thin import (
    csr_segment_max_thin,
    csr_segment_reduce_thin_plain,
    csr_segment_sum_thin,
    csr_tile_rows_thin,
    csr_tile_rows_thin_plain,
)

__all__ = [
    "categorical_encode",
    "categorical_encode_plain",
    "csr_sddmm",
    "csr_sddmm_heads",
    "csr_sddmm_heads_plain",
    "csr_sddmm_plain",
    "csr_segment_max_thin",
    "csr_segment_reduce_thin_plain",
    "csr_segment_sum",
    "csr_segment_sum_heads",
    "csr_segment_sum_heads_plain",
    "csr_segment_sum_plain",
    "csr_segment_sum_thin",
    "csr_tile_rows_thin",
    "csr_tile_rows_thin_plain",
    "hub_cotangent",
    "hub_cotangent_plain",
    "hub_epilogue",
    "hub_epilogue_plain",
    "hub_message_grad",
    "hub_message_grad_plain",
    "hub_messages",
    "hub_messages_plain",
    "masked_batch_norm",
    "masked_batch_norm_plain",
]
