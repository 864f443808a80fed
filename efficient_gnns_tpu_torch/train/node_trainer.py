"""Full-graph node-classification distillation trainer (counterpart of
``efficient_gnns_tpu/train/node_trainer.py``; every training mode of
``train/config.py``, alone or composed with logit KD).

Each epoch is one train step (forward in train mode, loss, backward, Adam
update) followed by one evaluation in eval mode, as in the JAX epoch body.
The per-epoch statistics stay on the device until the end of a
``run_epochs`` chunk, so a chunk costs one host synchronisation.

Teacher coupling is offline: the teacher's features and logits are
device-resident tensors, as the reference loads its GAT dumps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.models.gnns import ProjectionGCD, ProjectionMLP
from efficient_gnns_tpu_torch.tracing import span
from efficient_gnns_tpu_torch.train import checkpoint
from efficient_gnns_tpu_torch.train.config import DistillConfig


def _on(a, dtype, device) -> torch.Tensor:
    """``a`` (a tensor on any device, or an array) as a ``dtype`` tensor on
    ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def _derived_seed(*key: int) -> int:
    return int(np.random.SeedSequence(key).generate_state(1)[0])


class NodeDistillTrainer:
    """Trains one model in one mode on one full graph.

    ``model`` is moved to ``device``; the graph, features, labels, splits,
    teacher features and logits (NumPy arrays or tensors) and the train
    subgraph ``lsp_graph`` are copied there once. The modes with projection
    heads (``DistillConfig.needs_mlp_proj`` / ``needs_gcd_proj``) create a
    student head ``sproj`` and a teacher head ``tproj`` and train them with
    the model under one optimizer. Optimizer: ``torch.optim.Adam`` (``AdamW``
    when ``weight_decay > 0``), whose update matches ``optax.adam`` /
    ``optax.adamw``: bias-corrected moments, eps added outside the square
    root, decoupled weight decay. Dropout and row subsampling draw from a
    ``torch.Generator`` on ``device``, seeded from ``(seed, epoch)`` at every
    epoch, so a run restored from a checkpoint continues as it would have.
    ``bn_group`` is the heads' BatchNorm group (as in ``GCN``; the row-sharded
    trainer's axis).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        config: DistillConfig,
        graph: Graph,
        x,
        y,
        split_idx: Dict[str, np.ndarray],
        teacher_feat=None,
        teacher_logits=None,
        lsp_graph: Optional[Graph] = None,
        seed: int = 0,
        device="cuda",
        bn_group=None,
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
        if config.training not in ("supervised", "kd") and teacher_feat is None:
            raise ValueError(f"training mode {config.training!r} needs teacher features")
        if config.needs_train_subgraph() and lsp_graph is None:
            raise ValueError(f"training mode {config.training!r} needs the train subgraph")
        self.teacher_logits = (None if teacher_logits is None
                               else _on(teacher_logits, torch.float32, self.device))
        self.teacher_feat = (None if teacher_feat is None
                             else _on(teacher_feat, torch.float32, self.device))
        self.lsp_graph = None if lsp_graph is None else lsp_graph.to(self.device)

        self.sproj = self.tproj = None
        if config.needs_mlp_proj() or config.needs_gcd_proj():
            feat_dim = self.model.convs[-1].weight.shape[0]  # width of out_feat
            kw = {"bn_group": bn_group}
            head = ProjectionMLP
            if config.needs_gcd_proj():
                # composed with logit KD the head drops its parallel linear
                head, kw["use_linear"] = ProjectionGCD, not config.kd_and_aux
            self.sproj = head(feat_dim, config.proj_dim, seed=_derived_seed(seed, 0, 1),
                              device=self.device, **kw)
            self.tproj = head(self.teacher_feat.shape[1], config.proj_dim,
                              seed=_derived_seed(seed, 0, 2), device=self.device, **kw)
        self.modules = torch.nn.ModuleList(
            m for m in (self.model, self.sproj, self.tproj) if m is not None)
        params = self.modules.parameters()
        self.opt = (
            torch.optim.Adam(params, lr=config.lr) if config.weight_decay == 0
            else torch.optim.AdamW(params, lr=config.lr,
                                   weight_decay=config.weight_decay)
        )
        self.generator = torch.Generator(device=self.device)
        self.step = 0  # train steps taken (one an epoch)

    def _projected(self, feat, tr):
        """Student and teacher features of the train rows through the heads:
        the MLP heads see the train rows, the graph-conditioned heads the
        whole graph, whose output is then indexed."""
        if self.cfg.needs_gcd_proj():
            return (self.sproj(self.graph, feat)[tr],
                    self.tproj(self.graph, self.teacher_feat)[tr])
        return self.sproj(feat[tr]), self.tproj(self.teacher_feat[tr])

    def _aux_term(self, feat, labels, tr):
        cfg, mode, gen = self.cfg, self.cfg.training, self.generator
        if mode == "at":
            return criteria.at_term(feat[tr], self.teacher_feat[tr])
        if mode == "lpw":
            return criteria.lsp_term(self.lsp_graph, feat[tr], self.teacher_feat[tr],
                                     cfg.kernel)
        sf, tf = self._projected(feat, tr)
        if mode == "fitnet":
            return criteria.fitnet_term(sf, tf)
        if mode == "gpw":
            return criteria.gsp_term(sf, tf, cfg.kernel, generator=gen,
                                     max_samples=cfg.max_samples)
        if mode in ("nce", "gcd"):
            return criteria.nce_term(sf, tf, cfg.nce_T, generator=gen,
                                     max_samples=cfg.max_samples)
        return criteria.nce_term_structured(
            sf, tf, cfg.nce_T, generator=gen, max_samples=cfg.max_samples,
            labels=labels if "labels" in mode else None,
            graph=self.lsp_graph if "edges" in mode else None,
        )

    def _train_step(self, epoch: int):
        cfg = self.cfg
        tr = self.split_idx["train"]
        self.generator.manual_seed(_derived_seed(self.seed, epoch))
        self.modules.train()
        with span("trainer.forward"):
            logits, feat = self.model(self.graph, self.x, generator=self.generator)
        with span("trainer.criterion"):
            out, labels = logits[tr], self.y[tr]
            if cfg.training == "supervised":
                loss = criteria.cls_ce(out, labels)
                loss_cls, loss_aux = loss, loss * 0
            elif cfg.training == "kd":
                loss, loss_cls, loss_aux = criteria.kd_criterion(
                    out, labels, self.teacher_logits[tr], cfg.alpha, cfg.kd_T,
                    reduction=cfg.kd_reduction,
                )
            else:  # the representation-distillation modes
                loss_aux = self._aux_term(feat, labels, tr)
                if cfg.kd_and_aux:  # loss = KD total + beta * aux
                    kd_loss, loss_cls, _ = criteria.kd_criterion(
                        out, labels, self.teacher_logits[tr], cfg.alpha, cfg.kd_T,
                        reduction=cfg.kd_reduction,
                    )
                    loss = kd_loss + cfg.beta * loss_aux
                else:
                    loss_cls = criteria.cls_ce(out, labels)
                    loss = loss_cls + cfg.beta * loss_aux
        self.opt.zero_grad(set_to_none=True)
        with span("trainer.backward"):
            loss.backward()
        with span("trainer.optimizer"):
            self.opt.step()
        self.step += 1
        return loss.detach(), loss_cls.detach(), loss_aux.detach()

    @torch.no_grad()
    def _eval_step(self):
        self.model.eval()
        logits, _ = self.model(self.graph, self.x)
        pred = logits.argmax(-1)
        return logits, tuple(
            (pred[self.split_idx[k]] == self.y[self.split_idx[k]]).float().mean()
            for k in ("train", "valid", "test")
        )

    def run_epochs(self, start_epoch: int, k: int) -> np.ndarray:
        """Run ``k`` epochs; returns float32[k, 6] per-epoch
        (loss, loss_cls, loss_aux, acc_train, acc_valid, acc_test)."""
        rows = []
        for epoch in range(start_epoch, start_epoch + k):
            with span("trainer.epoch"):
                losses = self._train_step(epoch)
                with span("trainer.eval"):
                    rows.append(torch.stack([*losses, *self._eval_step()[1]]))
        with span("trainer.readback"):
            return torch.stack(rows).float().cpu().numpy()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One train step (the generator seeded from ``(seed, epoch)``);
        returns its ``loss``, ``loss_cls`` and ``loss_aux``, read on the host."""
        losses = self._train_step(epoch)
        return dict(zip(("loss", "loss_cls", "loss_aux"), (float(v) for v in losses)))

    def evaluate(self) -> Tuple[torch.Tensor, Tuple[float, float, float]]:
        """``(logits, (acc_train, acc_valid, acc_test))`` of a full-graph
        evaluation forward."""
        logits, accs = self._eval_step()
        return logits, tuple(float(a) for a in accs)

    def _named_modules(self) -> Dict[str, torch.nn.Module]:
        named = {"model": self.model, "sproj": self.sproj, "tproj": self.tproj}
        return {k: m for k, m in named.items() if m is not None}

    def save_checkpoint(self, path: str) -> str:
        """Write the model's and the heads' ``state_dict`` (BatchNorm running
        statistics included), the optimizer's moments by parameter name and
        the steps taken; returns ``path``."""
        named = self._named_modules()
        return checkpoint.save_checkpoint(path, {
            "step": self.step,
            "modules": {k: m.state_dict() for k, m in named.items()},
            "optimizer": checkpoint.optimizer_moments(named, self.opt),
        })

    def restore_checkpoint(self, path: str) -> int:
        """Restore what :meth:`save_checkpoint` wrote; returns the steps
        taken, i.e. the epochs already trained."""
        state = checkpoint.load_checkpoint(path, map_location="cpu")
        named = self._named_modules()
        for key, module in named.items():
            module.load_state_dict(state["modules"][key])
        checkpoint.load_optimizer_moments(named, self.opt, state["optimizer"])
        self.step = int(state["step"])
        return self.step
