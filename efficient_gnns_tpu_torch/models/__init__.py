from efficient_gnns_tpu_torch.models.gnns import GCN
from efficient_gnns_tpu_torch.models.layers import GCNConv, MaskedBatchNorm
from efficient_gnns_tpu_torch.models.transplant import from_jax_params

__all__ = ["GCN", "GCNConv", "MaskedBatchNorm", "from_jax_params"]
