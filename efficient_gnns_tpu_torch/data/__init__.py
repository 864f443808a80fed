from efficient_gnns_tpu_torch.data.mag import MagDataset, load_ogbn_mag, synthetic_mag_dataset
from efficient_gnns_tpu_torch.data.ogb import load_ogbn_arxiv
from efficient_gnns_tpu_torch.data.ppi import (
    PPIDataset,
    PPIGraph,
    load_ppi,
    micro_f1,
    synthetic_ppi_dataset,
)
from efficient_gnns_tpu_torch.data.synthetic import NodeDataset, synthetic_node_dataset

__all__ = [
    "MagDataset",
    "NodeDataset",
    "PPIDataset",
    "PPIGraph",
    "load_ogbn_arxiv",
    "load_ogbn_mag",
    "load_ppi",
    "micro_f1",
    "synthetic_mag_dataset",
    "synthetic_node_dataset",
    "synthetic_ppi_dataset",
]
