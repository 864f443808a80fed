from efficient_gnns_tpu_torch.sampling.hop_precompute import neighbor_average_features
from efficient_gnns_tpu_torch.sampling.minibatch import NodeBatcher

__all__ = ["NodeBatcher", "neighbor_average_features"]
