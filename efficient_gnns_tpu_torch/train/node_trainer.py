"""Full-graph node-classification distillation trainer (counterpart of
``efficient_gnns_tpu/train/node_trainer.py``; ``supervised`` and ``kd``).

Each epoch is one train step (forward in train mode, loss, backward, Adam
update) followed by one evaluation in eval mode, as in the JAX epoch body.
The per-epoch statistics stay on the device until the end of a
``run_epochs`` chunk, so a chunk costs one host synchronisation.

Teacher coupling is offline: the teacher's logits are a device-resident
tensor, as the reference loads its GAT dumps.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.train.config import DistillConfig


def _on(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


class NodeDistillTrainer:
    """Trains one model in one mode on one full graph.

    ``model`` is moved to ``device``; the graph, features, labels, splits
    and teacher logits (NumPy arrays or tensors) are copied there once.
    Optimizer: ``torch.optim.Adam`` (``AdamW`` when ``weight_decay > 0``),
    whose update matches ``optax.adam`` / ``optax.adamw``: bias-corrected
    moments, eps added outside the square root, decoupled weight decay.
    Dropout draws from a ``torch.Generator`` on ``device``, seeded from
    ``(seed, epoch)`` at every epoch.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        config: DistillConfig,
        graph: Graph,
        x,
        y,
        split_idx: Dict[str, np.ndarray],
        teacher_logits=None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.cfg = config
        self.seed = seed
        self.model = model.to(self.device)
        self.graph = graph.to(self.device)
        self.x = _on(x, torch.float32, self.device)
        self.y = _on(y, torch.long, self.device)
        self.split_idx = {k: _on(v, torch.long, self.device)
                          for k, v in split_idx.items()}
        if config.needs_teacher() and teacher_logits is None:
            raise ValueError(f"training mode {config.training!r} needs teacher logits")
        self.teacher_logits = (None if teacher_logits is None
                               else _on(teacher_logits, torch.float32, self.device))
        params = self.model.parameters()
        self.opt = (
            torch.optim.Adam(params, lr=config.lr) if config.weight_decay == 0
            else torch.optim.AdamW(params, lr=config.lr,
                                   weight_decay=config.weight_decay)
        )
        self.generator = torch.Generator(device=self.device)

    def _train_step(self, epoch: int):
        cfg = self.cfg
        tr = self.split_idx["train"]
        self.generator.manual_seed(
            int(np.random.SeedSequence([self.seed, epoch]).generate_state(1)[0])
        )
        self.model.train()
        logits, _ = self.model(self.graph, self.x, generator=self.generator)
        out, labels = logits[tr], self.y[tr]
        if cfg.training == "supervised":
            loss = criteria.cls_ce(out, labels)
            loss_cls, loss_aux = loss, loss * 0
        else:  # "kd"; DistillConfig refuses every other mode
            loss, loss_cls, loss_aux = criteria.kd_criterion(
                out, labels, self.teacher_logits[tr], cfg.alpha, cfg.kd_T,
                reduction=cfg.kd_reduction,
            )
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach(), loss_cls.detach(), loss_aux.detach()

    @torch.no_grad()
    def _eval_step(self):
        self.model.eval()
        logits, _ = self.model(self.graph, self.x)
        pred = logits.argmax(-1)
        return tuple(
            (pred[self.split_idx[k]] == self.y[self.split_idx[k]]).float().mean()
            for k in ("train", "valid", "test")
        )

    def run_epochs(self, start_epoch: int, k: int) -> np.ndarray:
        """Run ``k`` epochs; returns float32[k, 6] per-epoch
        (loss, loss_cls, loss_aux, acc_train, acc_valid, acc_test)."""
        rows = []
        for epoch in range(start_epoch, start_epoch + k):
            losses = self._train_step(epoch)
            rows.append(torch.stack([*losses, *self._eval_step()]))
        return torch.stack(rows).float().cpu().numpy()
