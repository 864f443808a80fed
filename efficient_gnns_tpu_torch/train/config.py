"""Run configuration (counterpart of ``efficient_gnns_tpu/train/config.py``).

The field names and defaults are the JAX package's. The port trains the
``supervised`` and ``kd`` modes; the others raise until they are ported.
"""

from __future__ import annotations

import dataclasses

PORTED_MODES = ("supervised", "kd")
_NOT_PORTED = (
    "is not ported yet: representation-distillation modes, their projection "
    "heads and --kd_and_aux wait for ROADMAP.md Queue 1 items 5 and 6"
)


@dataclasses.dataclass
class DistillConfig:
    # experiment
    training: str = "supervised"
    kd_and_aux: bool = False
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

    # representation distillation (carried for flag parity; unused so far)
    beta: float = 1000.0
    kernel: str = "cosine"
    max_samples: int = 8192
    proj_dim: int = 256
    nce_T: float = 0.075
    teacher_dim: int = 750

    def __post_init__(self):
        if self.training not in PORTED_MODES:
            raise NotImplementedError(f"training mode {self.training!r} {_NOT_PORTED}")
        if self.kd_and_aux:
            raise NotImplementedError(f"kd_and_aux {_NOT_PORTED}")

    def needs_teacher(self) -> bool:
        return self.training != "supervised"
