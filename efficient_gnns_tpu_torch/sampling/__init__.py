from efficient_gnns_tpu_torch.sampling.hop_precompute import neighbor_average_features
from efficient_gnns_tpu_torch.sampling.minibatch import NodeBatcher
from efficient_gnns_tpu_torch.sampling.saint import GraphSaintRandomWalkSampler, SaintSubgraph

__all__ = ["GraphSaintRandomWalkSampler", "NodeBatcher", "SaintSubgraph",
           "neighbor_average_features"]
