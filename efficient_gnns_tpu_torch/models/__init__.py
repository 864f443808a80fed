from efficient_gnns_tpu_torch.models.gnns import GCN, GATTeacher
from efficient_gnns_tpu_torch.models.layers import (
    DGLGATConv,
    ElementWiseLinear,
    GCNConv,
    MaskedBatchNorm,
)
from efficient_gnns_tpu_torch.models.transplant import from_jax_params

__all__ = [
    "DGLGATConv",
    "ElementWiseLinear",
    "GATTeacher",
    "GCN",
    "GCNConv",
    "MaskedBatchNorm",
    "from_jax_params",
]
