from efficient_gnns_tpu_torch.data.ogb import load_ogbn_arxiv
from efficient_gnns_tpu_torch.data.synthetic import NodeDataset, synthetic_node_dataset

__all__ = ["NodeDataset", "load_ogbn_arxiv", "synthetic_node_dataset"]
