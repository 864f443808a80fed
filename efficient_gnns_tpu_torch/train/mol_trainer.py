"""ogbg-molhiv graph-classification distillation trainer (counterpart of
``efficient_gnns_tpu/train/mol_trainer.py``).

One Adam step a packed batch of molecules (``data/molhiv.py::MolBatcher``,
the JAX batch order): the student's forward, the online teacher's under
``torch.no_grad()`` in eval mode, the loss of the mode on the graph-level
outputs, and the update. The criteria compare pooled graph embeddings:
``nce``, ``fitnet`` and ``gpw`` project both through MLP heads first, ``at``
compares them raw; the classification loss is BCE with logits and logit KD
is BCE against the teacher's sigmoid (``cls_bce`` / ``kd_criterion_bce``),
every term masked by ``graph_mask``. Evaluation is ROC-AUC.

A train batch is packed on the host and moved to the device in one
``MolBatch.to``; the unshuffled evaluation batches are packed once and kept
on the device. The JAX trainer reads each step's losses on the host: here
they are summed on the device and copied once an epoch, and an evaluation
copies its scores once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.data.molhiv import MolBatch, MolBatcher, MolDataset, roc_auc
from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.models.gnns import ProjectionMLP
from efficient_gnns_tpu_torch.models.mol import MolGNN
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.node_trainer import _derived_seed

_MODES = ("supervised", "kd", "fitnet", "at", "gpw", "nce")
SPLITS = ("train", "valid", "test")


class MolTrainer:
    """Trains one :class:`MolGNN` in one mode on a :class:`MolDataset`.

    ``student`` (and ``teacher``, a module that already holds its weights,
    when the mode needs one) move to ``device``. Optimizer:
    ``torch.optim.Adam`` over the student and, in ``nce`` / ``fitnet`` /
    ``gpw``, the projection heads ``sproj`` and ``tproj``, whose update
    matches ``optax.adam``. Row subsampling (``gpw``, ``nce``) and dropout
    draw from a ``torch.Generator`` on ``device`` seeded from ``(seed,
    epoch, step)``. ``max_atoms`` sets the batches' node and edge budgets
    (``MolBatcher``).
    """

    def __init__(self, config: DistillConfig, ds: MolDataset, student: MolGNN,
                 teacher: Optional[MolGNN] = None, batch_size: int = 32, max_atoms: int = 32,
                 seed: int = 0, device="cuda"):
        if config.training not in _MODES:
            raise ValueError(f"mol training mode must be one of {_MODES}, "
                             f"got {config.training!r}")
        if config.needs_teacher() and teacher is None:
            raise ValueError(f"training mode {config.training!r} needs a teacher")
        self.cfg, self.ds, self.seed = config, ds, seed
        self.device = torch.device(device)
        self.model = student.to(self.device)
        self.teacher = None
        if config.needs_teacher():
            self.teacher = teacher.to(self.device).eval().requires_grad_(False)
        self.batcher = MolBatcher(ds.train, batch_size, max_atoms, shuffle=True)
        self.eval_batchers = {k: MolBatcher(getattr(ds, k), batch_size, max_atoms,
                                            shuffle=False) for k in SPLITS}
        self._eval_batches: Dict[str, Tuple[List[MolBatch], np.ndarray]] = {}

        self.sproj = self.tproj = None
        if config.training in ("nce", "fitnet", "gpw"):
            self.sproj = ProjectionMLP(self.model.feat_dim, config.proj_dim,
                                       seed=_derived_seed(seed, 0, 1), device=self.device)
            self.tproj = ProjectionMLP(self.teacher.feat_dim, config.proj_dim,
                                       seed=_derived_seed(seed, 0, 2), device=self.device)
        self.modules = torch.nn.ModuleList(
            m for m in (self.model, self.sproj, self.tproj) if m is not None)
        self.opt = torch.optim.Adam(self.modules.parameters(), lr=config.lr)
        self.generator = torch.Generator(device=self.device)

    def _aux_term(self, feat, t_feat, mask):
        cfg, mode, gen = self.cfg, self.cfg.training, self.generator
        if self.sproj is not None:
            sf, tf = self.sproj(feat, mask), self.tproj(t_feat, mask)
        else:
            sf, tf = feat, t_feat
        if mode == "fitnet":
            return criteria.fitnet_term(sf, tf, mask)
        if mode == "at":
            return criteria.at_term(sf, tf, mask)
        if mode == "gpw":
            return criteria.gsp_term(sf, tf, cfg.kernel, generator=gen,
                                     max_samples=cfg.max_samples, mask=mask)
        return criteria.nce_term(sf, tf, cfg.nce_T, generator=gen,
                                 max_samples=cfg.max_samples, mask=mask)

    def _train_step(self, mb: MolBatch) -> torch.Tensor:
        """One Adam step on one batch on the device; returns (loss, loss_cls,
        loss_aux) on the device."""
        cfg = self.cfg
        mask = mb.batch.graph_mask
        out, feat = self.model(mb.batch, mb.atoms, mb.bonds, generator=self.generator)
        logits = out[:, 0]
        if cfg.training == "supervised":
            loss = criteria.cls_bce(logits, mb.labels, mask)
            loss_cls, loss_aux = loss, loss * 0
        else:
            with torch.no_grad():
                t_out, t_feat = self.teacher(mb.batch, mb.atoms, mb.bonds)
            t_logits = t_out[:, 0]
            if cfg.training == "kd":
                loss, loss_cls, loss_aux = criteria.kd_criterion_bce(
                    logits, mb.labels, t_logits, cfg.alpha, cfg.kd_T, mask)
            else:
                loss_aux = self._aux_term(feat, t_feat, mask)
                if cfg.kd_and_aux:  # loss = KD total + beta * aux
                    kd_loss, loss_cls, _ = criteria.kd_criterion_bce(
                        logits, mb.labels, t_logits, cfg.alpha, cfg.kd_T, mask)
                    loss = kd_loss + cfg.beta * loss_aux
                else:
                    loss_cls = criteria.cls_bce(logits, mb.labels, mask)
                    loss = loss_cls + cfg.beta * loss_aux
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return torch.stack([loss, loss_cls, loss_aux]).detach()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One Adam step a batch, in the JAX trainer's order (the batcher's
        permutation of seed ``seed * 613 + epoch``); returns the mean
        ``loss``, ``loss_cls`` and ``loss_aux`` (one host copy)."""
        self.modules.train()
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        n = 0
        for n, mb in enumerate(self.batcher.epoch(self.seed * 613 + epoch), start=1):
            self.generator.manual_seed(_derived_seed(self.seed, epoch, n - 1))
            totals += self._train_step(mb.to(self.device)).double()
        means = (totals / max(n, 1)).tolist()
        return dict(zip(("loss", "loss_cls", "loss_aux"), means))

    def eval_batches(self, split: str) -> Tuple[List[MolBatch], np.ndarray]:
        """The batches of ``split`` in order on the device, and the labels of
        its real molecules on the host: packed at the first call and kept
        (they are the same every epoch)."""
        if split not in self._eval_batches:
            batches = list(self.eval_batchers[split].epoch(0))
            labels = np.concatenate([mb.labels[: mb.batch.n_graph].numpy() for mb in batches])
            self._eval_batches[split] = [mb.to(self.device) for mb in batches], labels
        return self._eval_batches[split]

    @torch.no_grad()
    def scores(self, split: str) -> Tuple[np.ndarray, np.ndarray]:
        """``(scores, labels)`` of the real molecules of ``split``, in order
        (one host copy)."""
        self.model.eval()
        batches, labels = self.eval_batches(split)
        out = torch.cat([self.model(mb.batch, mb.atoms, mb.bonds)[0][: mb.batch.n_graph, 0]
                         for mb in batches])
        return out.cpu().numpy(), labels

    def evaluate(self, split: str) -> float:
        """ROC-AUC of ``split`` (``train``, ``valid`` or ``test``)."""
        return roc_auc(*self.scores(split))

    def evaluate_all(self) -> Tuple[float, float, float]:
        return tuple(self.evaluate(k) for k in SPLITS)
