from efficient_gnns_tpu_torch.models.gnns import (
    GCN,
    SAGE,
    GATTeacher,
    ProjectionGCD,
    ProjectionLinear,
    ProjectionMLP,
    SIGN,
)
from efficient_gnns_tpu_torch.models.layers import (
    DGLGATConv,
    ElementWiseLinear,
    FeedForwardNet,
    GCNConv,
    MaskedBatchNorm,
    SAGEConv,
)
from efficient_gnns_tpu_torch.models.transplant import from_jax_params

__all__ = [
    "DGLGATConv",
    "ElementWiseLinear",
    "FeedForwardNet",
    "GATTeacher",
    "GCN",
    "GCNConv",
    "MaskedBatchNorm",
    "ProjectionGCD",
    "ProjectionLinear",
    "ProjectionMLP",
    "SAGE",
    "SAGEConv",
    "SIGN",
    "from_jax_params",
]
