"""PPI inductive trainer (counterpart of
``efficient_gnns_tpu/train/ppi_trainer.py``): one padded graph per Adam step
over the train graphs, the online teacher's forward inside the student's
step, the BCE criteria (``ppi_pyg/criterion.py``) and micro-F1 over the
valid nodes of a graph set. ``nce`` and ``fitnet`` project both features
through MLP heads (the teacher's ``teacher_feat_dim`` wide: 1,024 for
TeacherNet); ``at``, ``gpw`` and ``lpw`` compare the raw features
(``ppi_pyg/gnn.py:229-250``).

Every graph, with its features and labels, moves to the device once, at
construction; a step copies nothing to the host. The JAX trainer reads each
step's losses on the host: here they are summed on the device and copied
once an epoch, and an evaluation counts its true and false positives on the
device and copies them once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.data.ppi import PPIDataset, f1_from_counts
from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.models.gnns import ProjectionMLP
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.node_trainer import _derived_seed

_MODES = ("supervised", "kd", "fitnet", "at", "gpw", "lpw", "nce")


class PPITrainer:
    """Trains one model in one mode on a :class:`PPIDataset`.

    ``student`` (and ``teacher``, a module that already holds its weights,
    when the mode needs one) move to ``device``; the teacher runs in eval
    mode under ``torch.no_grad()``. Optimizer: ``torch.optim.Adam`` over the
    student and, in ``nce`` / ``fitnet``, the projection heads ``sproj`` and
    ``tproj``, whose update matches ``optax.adam``. Row subsampling (``gpw``,
    ``nce``) and dropout draw from a ``torch.Generator`` on ``device`` seeded
    from ``(seed, epoch, step)``. Padding nodes (past each graph's
    ``n_node_valid``) stay out of every loss, the heads' BatchNorm
    statistics and micro-F1.
    """

    def __init__(self, config: DistillConfig, ds: PPIDataset, student: torch.nn.Module,
                 teacher: Optional[torch.nn.Module] = None, teacher_feat_dim: int = 1024,
                 seed: int = 0, device="cuda"):
        if config.training not in _MODES:
            raise ValueError(f"PPI training mode must be one of {_MODES}, "
                             f"got {config.training!r}")
        if config.needs_teacher() and teacher is None:
            raise ValueError(f"training mode {config.training!r} needs a teacher")
        self.cfg, self.seed = config, seed
        self.device = torch.device(device)
        self.model = student.to(self.device)
        self.teacher = None
        if config.needs_teacher():
            self.teacher = teacher.to(self.device).eval().requires_grad_(False)

        def on_device(graphs):
            return [(g.graph.to(self.device), torch.from_numpy(g.x).to(self.device),
                     torch.from_numpy(g.y).to(self.device)) for g in graphs]

        self.train_graphs = on_device(ds.train)
        self.valid_graphs = on_device(ds.valid)
        self.test_graphs = on_device(ds.test)

        self.sproj = self.tproj = None
        if config.training in ("nce", "fitnet"):
            self.sproj = ProjectionMLP(self.model.feat_dim, config.proj_dim,
                                       seed=_derived_seed(seed, 0, 1), device=self.device)
            self.tproj = ProjectionMLP(teacher_feat_dim, config.proj_dim,
                                       seed=_derived_seed(seed, 0, 2), device=self.device)
        self.modules = torch.nn.ModuleList(
            m for m in (self.model, self.sproj, self.tproj) if m is not None)
        self.opt = torch.optim.Adam(self.modules.parameters(), lr=config.lr)
        self.generator = torch.Generator(device=self.device)

    def _aux_term(self, graph, feat, t_feat, mask):
        cfg, mode, gen = self.cfg, self.cfg.training, self.generator
        if mode in ("nce", "fitnet"):
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
        if mode == "lpw":
            return criteria.lsp_term(graph, sf, tf, cfg.kernel)
        return criteria.nce_term(sf, tf, cfg.nce_T, generator=gen,
                                 max_samples=cfg.max_samples, mask=mask)

    def _train_step(self, graph, x, y) -> torch.Tensor:
        """One Adam step on one graph; returns (loss, loss_cls, loss_aux) on
        the device."""
        cfg = self.cfg
        mask = graph.node_mask
        logits, feat = self.model(graph, x, generator=self.generator)
        if cfg.training == "supervised":
            loss = criteria.cls_bce(logits, y, mask)
            loss_cls, loss_aux = loss, loss * 0
        else:
            with torch.no_grad():
                t_logits, t_feat = self.teacher(graph, x)
            if cfg.training == "kd":
                loss, loss_cls, loss_aux = criteria.kd_criterion_bce(
                    logits, y, t_logits, cfg.alpha, cfg.kd_T, mask)
            else:
                loss_aux = self._aux_term(graph, feat, t_feat, mask)
                if cfg.kd_and_aux:  # loss = KD total + beta * aux
                    kd_loss, loss_cls, _ = criteria.kd_criterion_bce(
                        logits, y, t_logits, cfg.alpha, cfg.kd_T, mask)
                    loss = kd_loss + cfg.beta * loss_aux
                else:
                    loss_cls = criteria.cls_bce(logits, y, mask)
                    loss = loss_cls + cfg.beta * loss_aux
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return torch.stack([loss, loss_cls, loss_aux]).detach()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One Adam step on each train graph, in the JAX trainer's order
        ``np.random.default_rng(seed * 7919 + epoch).permutation``; returns
        the mean ``loss``, ``loss_cls`` and ``loss_aux`` (one host copy)."""
        order = np.random.default_rng(self.seed * 7919 + epoch).permutation(
            len(self.train_graphs))
        self.modules.train()
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        for i, gi in enumerate(order):
            self.generator.manual_seed(_derived_seed(self.seed, epoch, i))
            totals += self._train_step(*self.train_graphs[gi]).double()
        means = (totals / len(order)).tolist()
        return dict(zip(("loss", "loss_cls", "loss_aux"), means))

    @torch.no_grad()
    def _f1_counts(self, graphs) -> torch.Tensor:
        """int64 [3]: true positives, false positives and false negatives of
        ``logits > 0`` over the valid nodes of ``graphs``, on the device."""
        self.model.eval()
        counts = torch.zeros(3, dtype=torch.int64, device=self.device)
        for graph, x, y in graphs:
            logits, _ = self.model(graph, x)
            valid = graph.node_mask[:, None]
            pred = (logits > 0) & valid
            true = y.long()
            counts += torch.stack([(pred & (true == 1)).sum(), (pred & (true == 0)).sum(),
                                   (~pred & valid & (true == 1)).sum()])
        return counts

    def evaluate(self, graphs: List) -> float:
        """Micro-F1 over the concatenated valid nodes of ``graphs``, a list of
        ``(graph, x, y)`` on the device (``train_graphs``, ...)."""
        return f1_from_counts(*self._f1_counts(graphs).tolist())

    def evaluate_all(self) -> Tuple[float, float, float]:
        """Micro-F1 of the train, valid and test graphs (one host copy)."""
        counts = torch.stack([self._f1_counts(gs) for gs in
                              (self.train_graphs, self.valid_graphs, self.test_graphs)])
        return tuple(f1_from_counts(*c) for c in counts.tolist())
