from efficient_gnns_tpu_torch.data.mag import MagDataset, load_ogbn_mag, synthetic_mag_dataset
from efficient_gnns_tpu_torch.data.molhiv import (
    MolBatch,
    MolBatcher,
    MolDataset,
    Molecule,
    load_molhiv,
    roc_auc,
    synthetic_molhiv_dataset,
)
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
    "MolBatch",
    "MolBatcher",
    "MolDataset",
    "Molecule",
    "NodeDataset",
    "PPIDataset",
    "PPIGraph",
    "load_molhiv",
    "load_ogbn_arxiv",
    "load_ogbn_mag",
    "load_ppi",
    "micro_f1",
    "roc_auc",
    "synthetic_mag_dataset",
    "synthetic_molhiv_dataset",
    "synthetic_node_dataset",
    "synthetic_ppi_dataset",
]
