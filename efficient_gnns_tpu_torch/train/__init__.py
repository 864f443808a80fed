from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.gat_teacher import GATTeacherTrainer, TeacherConfig
from efficient_gnns_tpu_torch.train.layerwise import RGCNLayerwiseInference
from efficient_gnns_tpu_torch.train.logger import Logger
from efficient_gnns_tpu_torch.train.mag_trainer import MagTrainer, rgcn_for
from efficient_gnns_tpu_torch.train.metrics import MetricsWriter
from efficient_gnns_tpu_torch.train.mol_trainer import MolTrainer
from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer
from efficient_gnns_tpu_torch.train.ppi_trainer import PPITrainer
from efficient_gnns_tpu_torch.train.sign_trainer import SIGNTrainer

__all__ = [
    "DistillConfig",
    "GATTeacherTrainer",
    "Logger",
    "MagTrainer",
    "MetricsWriter",
    "MolTrainer",
    "NodeDistillTrainer",
    "PPITrainer",
    "RGCNLayerwiseInference",
    "SIGNTrainer",
    "TeacherConfig",
    "rgcn_for",
]
