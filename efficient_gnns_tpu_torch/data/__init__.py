from efficient_gnns_tpu_torch.data.synthetic import NodeDataset, synthetic_node_dataset

__all__ = ["NodeDataset", "synthetic_node_dataset"]
