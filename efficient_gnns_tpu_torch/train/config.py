"""Run configuration (counterpart of ``efficient_gnns_tpu/train/config.py``).

The field names, defaults and training modes are the JAX package's.
"""

from __future__ import annotations

import dataclasses

TRAINING_MODES = (
    "supervised",
    "kd",
    "fitnet",
    "at",
    "gpw",  # GSP (the reference's flag name)
    "lpw",  # LSP
    "nce",  # G-CRD
    "gcd",  # graph-conditioned G-CRD
)
# label- and edge-conditioned G-CRD, dispatched beside TRAINING_MODES
STRUCTURED_NCE_MODES = ("nce-labels", "nce-edges", "nce-labels-edges")


@dataclasses.dataclass
class DistillConfig:
    # experiment
    training: str = "supervised"  # TRAINING_MODES or STRUCTURED_NCE_MODES
    kd_and_aux: bool = False  # compose the aux loss with logit KD
    runs: int = 10
    epochs: int = 500
    seed: int = 0
    log_every: int = 1

    # model
    model: str = "gcn"
    num_layers: int = 2
    hidden: int = 256
    dropout: float = 0.5
    lr: float = 0.01
    weight_decay: float = 0.0

    # logit KD (arxiv_pyg defaults)
    alpha: float = 0.9
    kd_T: float = 4.0
    # "numel" = reference parity (F.kl_div 'mean', KL / (N*C));
    # "batchmean" = standard Hinton scaling (see distill/criteria.py)
    kd_reduction: str = "numel"

    # representation distillation
    beta: float = 1000.0
    kernel: str = "cosine"  # cosine | poly | l2 | rbf
    max_samples: int = 8192
    proj_dim: int = 256
    nce_T: float = 0.075

    # teacher feature dim (750 for the arxiv GAT dumps)
    teacher_dim: int = 750

    def __post_init__(self):
        if self.training not in TRAINING_MODES + STRUCTURED_NCE_MODES:
            raise ValueError(f"unknown training mode {self.training!r}")

    def needs_mlp_proj(self) -> bool:
        return self.training in ("fitnet", "gpw", "nce") + STRUCTURED_NCE_MODES

    def needs_gcd_proj(self) -> bool:
        return self.training == "gcd"

    def needs_teacher(self) -> bool:
        return self.training != "supervised" or self.kd_and_aux

    def needs_train_subgraph(self) -> bool:
        return self.training == "lpw" or self.training.endswith("edges")
