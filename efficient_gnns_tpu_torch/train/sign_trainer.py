"""SIGN minibatch distillation trainer (counterpart of
``efficient_gnns_tpu/train/sign_trainer.py``).

After the hop precompute there is no graph left: an epoch is a pass of
static-size minibatches of train node ids (``sampling/minibatch.py``; the
last batch padded and masked) through the :class:`SIGN` MLPs. The hop
features, labels and teacher arrays live on the device, and a batch is an
``index_select`` of them.

Modes: ``supervised``, ``kd``, and ``fitnet``, ``at``, ``gpw``, ``nce``
composed with cross-entropy or, with ``kd_and_aux``, with logit KD. The
graph-dependent ``lpw`` and ``gcd`` (and the graph-conditioned ``nce-*``
modes) are undefined here and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.models.gnns import SIGN, ProjectionMLP
from efficient_gnns_tpu_torch.sampling.minibatch import NodeBatcher
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.node_trainer import _derived_seed, _on

SIGN_MODES = ("supervised", "kd", "fitnet", "at", "gpw", "nce")


class SIGNTrainer:
    """Trains one :class:`SIGN` on precomputed hop features ``feats``
    (``R + 1`` arrays or tensors ``[N, F]``, copied to ``device`` once).

    The modes with projection heads (``fitnet``, ``gpw``, ``nce``) train a
    student head ``sproj`` and a teacher head ``tproj`` (:class:`ProjectionMLP`,
    the batch mask keeping padded rows out of their BatchNorm statistics)
    with the model under one optimizer. Optimizer: ``torch.optim.Adam`` with
    its coupled L2 ``weight_decay`` (added to the gradient before the
    moments), the JAX trainer's ``add_decayed_weights`` + ``scale_by_adam``.
    Batch ``n`` of epoch ``e`` is drawn from ``np.random.default_rng(seed *
    100003 + e)`` as in the JAX trainer; dropout and row subsampling from a
    ``torch.Generator`` seeded from ``(seed, e, n)``.
    """

    def __init__(
        self,
        config: DistillConfig,
        feats: Sequence,
        y,
        split_idx: Dict[str, np.ndarray],
        num_classes: int,
        batch_size: int = 50_000,
        eval_batch_size: int = 100_000,
        teacher_feat=None,
        teacher_logits=None,
        ff_layers: int = 2,
        input_drop: float = 0.0,
        seed: int = 0,
        device="cuda",
    ):
        cfg = self.cfg = config
        if cfg.training not in SIGN_MODES:
            raise NotImplementedError(
                f"training mode {cfg.training!r} is undefined for the graph-agnostic "
                f"SIGN path (its modes: {', '.join(SIGN_MODES)})")
        if cfg.needs_teacher() and teacher_logits is None:
            raise ValueError(f"training mode {cfg.training!r} needs teacher logits")
        if cfg.training in ("fitnet", "at", "gpw", "nce") and teacher_feat is None:
            raise ValueError(f"training mode {cfg.training!r} needs teacher features")
        self.device = torch.device(device)
        self.seed, self.num_classes = seed, num_classes
        self.feats = [_on(f, torch.float32, self.device) for f in feats]
        self.y = _on(y, torch.long, self.device)
        self.split_idx = {k: _on(v, torch.long, self.device) for k, v in split_idx.items()}
        self.teacher_feat = (None if teacher_feat is None
                             else _on(teacher_feat, torch.float32, self.device))
        self.teacher_logits = (None if teacher_logits is None
                               else _on(teacher_logits, torch.float32, self.device))
        self.num_nodes = self.feats[0].shape[0]

        self.model = SIGN(self.feats[0].shape[1], cfg.hidden, num_classes, len(self.feats),
                          ff_layers, cfg.dropout, input_drop, seed=seed, device=self.device)
        self.sproj = self.tproj = None
        if cfg.training in ("fitnet", "gpw", "nce"):
            self.sproj = ProjectionMLP(cfg.hidden * len(self.feats), cfg.proj_dim,
                                       seed=_derived_seed(seed, 0, 1), device=self.device)
            self.tproj = ProjectionMLP(self.teacher_feat.shape[1], cfg.proj_dim,
                                       seed=_derived_seed(seed, 0, 2), device=self.device)
        self.modules = torch.nn.ModuleList(
            m for m in (self.model, self.sproj, self.tproj) if m is not None)
        self.opt = torch.optim.Adam(self.modules.parameters(), lr=cfg.lr,
                                    weight_decay=cfg.weight_decay)
        self.batcher = NodeBatcher(split_idx["train"], batch_size, shuffle=True)
        self.eval_batcher = NodeBatcher(np.arange(self.num_nodes), eval_batch_size,
                                        shuffle=False)
        self.generator = torch.Generator(device=self.device)

    def _aux_term(self, feat, ids, mask):
        cfg, mode, gen = self.cfg, self.cfg.training, self.generator
        teacher_feat = self.teacher_feat.index_select(0, ids)
        if mode == "at":
            return criteria.at_term(feat, teacher_feat, mask)
        sf, tf = self.sproj(feat, mask), self.tproj(teacher_feat, mask)
        if mode == "fitnet":
            return criteria.fitnet_term(sf, tf, mask)
        if mode == "gpw":
            return criteria.gsp_term(sf, tf, cfg.kernel, generator=gen,
                                     max_samples=cfg.max_samples, mask=mask)
        return criteria.nce_term(sf, tf, cfg.nce_T, generator=gen,
                                 max_samples=cfg.max_samples, mask=mask)

    def _train_step(self, ids: torch.Tensor, mask: torch.Tensor, epoch: int, n: int):
        cfg = self.cfg
        self.generator.manual_seed(_derived_seed(self.seed, epoch, n))
        self.modules.train()
        logits, feat = self.model([f.index_select(0, ids) for f in self.feats],
                                  generator=self.generator)
        labels = self.y.index_select(0, ids)
        if cfg.training == "supervised":
            loss = criteria.cls_ce(logits, labels, mask)
            loss_cls, loss_aux = loss, loss * 0
        elif cfg.training == "kd":
            loss, loss_cls, loss_aux = criteria.kd_criterion(
                logits, labels, self.teacher_logits.index_select(0, ids), cfg.alpha,
                cfg.kd_T, mask)
        else:
            loss_aux = self._aux_term(feat, ids, mask)
            if cfg.kd_and_aux:
                kd_loss, loss_cls, _ = criteria.kd_criterion(
                    logits, labels, self.teacher_logits.index_select(0, ids), cfg.alpha,
                    cfg.kd_T, mask)
                loss = kd_loss + cfg.beta * loss_aux
            else:
                loss_cls = criteria.cls_ce(logits, labels, mask)
                loss = loss_cls + cfg.beta * loss_aux
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return torch.stack([loss.detach(), loss_cls.detach(), loss_aux.detach()])

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(ids).to(self.device, torch.long)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train ids; returns the unweighted mean over the
        batches of ``loss``, ``loss_cls`` and ``loss_aux`` (one host copy)."""
        rows = [self._train_step(self._ids(ids), torch.from_numpy(mask).to(self.device),
                                 epoch, n)
                for n, (ids, mask) in enumerate(
                    self.batcher.epoch(seed=self.seed * 100003 + epoch))]
        means = torch.stack(rows).cpu().double().mean(0).tolist()
        return dict(zip(("loss", "loss_cls", "loss_aux"), means))

    @torch.no_grad()
    def evaluate(self) -> Tuple[float, float, float]:
        """Accuracy on the train, valid and test ids of the argmax over every
        node, evaluated in ``eval_batch_size`` batches."""
        self.model.eval()
        preds = []
        for ids, mask in self.eval_batcher.epoch(seed=0):
            ids_t = self._ids(ids)
            logits, _ = self.model([f.index_select(0, ids_t) for f in self.feats])
            preds.append(logits.argmax(-1)[: int(mask.sum())])  # the padding is last
        pred = torch.cat(preds)
        accs = torch.stack([(pred[idx] == self.y[idx]).float().mean()
                            for idx in (self.split_idx[k] for k in ("train", "valid", "test"))])
        return tuple(accs.cpu().tolist())

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())
