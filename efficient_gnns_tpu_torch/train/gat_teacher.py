"""GAT teacher trainer (counterpart of ``efficient_gnns_tpu/train/gat_teacher.py``),
with the semantics of the reference's teacher script (``arxiv_dgl/gat.py``):

* **label reuse** (``use_labels``): one-hot train labels concatenated to the
  features, with a random ``mask_rate`` split each epoch: labels of the
  ``label_fed`` nodes are fed as input and the loss is taken on the other
  train nodes (gat.py:104-131);
* **label iterations** (``n_label_iters``): ``softmax(pred)`` re-injected as
  the label channels of the nodes not fed labels, and the model run again
  (gat.py:136-141). Only the last forward records gradients; the earlier
  ones still update the BatchNorm statistics that the next one reads;
* **log-eps loss** ``mean(log(eps + CE) - log(eps))``, ``eps = 1 - ln 2``;
* **RMSprop** as ``optax.scale_by_rms(decay=0.99, eps=1e-8)`` with a linear
  learning-rate warm-up over the first 50 steps (:class:`RMSpropWarmup`);
* **best-validation-loss selection** (gat.py:224-229) on the device, with one
  host synchronisation per :meth:`GATTeacherTrainer.run_epochs` chunk, and
  dumps of the best epoch's logits and penultimate features.

The mask split and every dropout draw from one ``torch.Generator`` on the
device, seeded from ``(seed, epoch)`` at each epoch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.models.gnns import GATTeacher
from efficient_gnns_tpu_torch.tracing import span

EPSILON = 1.0 - math.log(2.0)


def log_eps_loss(logits, labels, mask) -> torch.Tensor:
    """``mean(log(eps + CE) - log(eps))`` over the rows where ``mask`` is set
    (gat.py:98-101)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, labels.long()[:, None])[:, 0]
    y = torch.log(EPSILON + ce) - math.log(EPSILON)
    m = mask.float()
    return (y * m).sum() / m.sum().clamp_min(1.0)


@dataclasses.dataclass
class TeacherConfig:
    n_hidden: int = 250
    n_layers: int = 3
    n_heads: int = 3
    dropout: float = 0.75
    input_drop: float = 0.25
    attn_drop: float = 0.0
    edge_drop: float = 0.3
    use_labels: bool = True
    n_label_iters: int = 1
    mask_rate: float = 0.5
    no_attn_dst: bool = True
    use_norm: bool = True
    lr: float = 0.002
    wd: float = 0.0
    n_epochs: int = 2000

    def __post_init__(self):
        if self.n_label_iters > 0 and not self.use_labels:
            raise ValueError("label iterations (n_label_iters > 0) need use_labels")


class RMSpropWarmup(torch.optim.Optimizer):
    """The JAX teacher's optimizer, ``optax.chain(scale_by_rms(decay=0.99,
    eps=1e-8), add_decayed_weights(weight_decay), scale_by_schedule(-lr *
    min((step+1) / 50, 1)))`` (torch RMSprop's decay and eps, the reference's
    50-epoch warm-up), written out:

        nu = 0.99 * nu + 0.01 * g**2                    (nu starts at 0)
        p -= lr_t * (g / sqrt(nu + 1e-8) + weight_decay * p)

    ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps`` instead, which
    differs while ``nu`` is small.
    """

    DECAY, EPS, WARMUP_STEPS = 0.99, 1e-8, 50

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.num_steps = 0

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr_t = group["lr"] * min((self.num_steps + 1.0) / self.WARMUP_STEPS, 1.0)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(self.DECAY).addcmul_(g, g, value=1.0 - self.DECAY)
                update = g * torch.rsqrt(nu + self.EPS)
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.add_(update, alpha=-lr_t)
        self.num_steps += 1


def _on(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


class GATTeacherTrainer:
    """Trains one :class:`GATTeacher` on one full graph (built with
    ``gcn_norm=False``). The graph, features, labels and splits (NumPy arrays
    or tensors) are copied to ``device`` once; the model is built there from
    ``seed``."""

    def __init__(self, config: TeacherConfig, graph: Graph, x, y,
                 split_idx: Dict[str, np.ndarray], num_classes: int,
                 seed: int = 0, device="cuda"):
        cfg = self.cfg = config
        self.device = torch.device(device)
        self.seed, self.num_classes = seed, num_classes
        self.graph = graph.to(self.device)
        self.x = _on(x, torch.float32, self.device)
        self.y = _on(y, torch.long, self.device)
        n = graph.num_nodes

        def mask_of(idx):
            m = torch.zeros(n, dtype=torch.bool)
            m[torch.as_tensor(np.asarray(idx), dtype=torch.long)] = True
            return m.to(self.device)

        self.train_mask = mask_of(split_idx["train"])
        self.valid_mask = mask_of(split_idx["valid"])
        self.test_mask = mask_of(split_idx["test"])
        self.onehot = torch.nn.functional.one_hot(self.y, num_classes).float()
        in_feats = self.x.shape[1] + (num_classes if cfg.use_labels else 0)
        self.model = GATTeacher(
            in_feats, cfg.n_hidden, num_classes, cfg.n_layers, cfg.n_heads,
            dropout=cfg.dropout, input_drop=cfg.input_drop,
            attn_drop=cfg.attn_drop, edge_drop=cfg.edge_drop,
            use_attn_dst=not cfg.no_attn_dst, use_symmetric_norm=cfg.use_norm,
            seed=seed, device=self.device,
        )
        self.opt = RMSpropWarmup(self.model.parameters(), cfg.lr, weight_decay=cfg.wd)
        self.generator = torch.Generator(device=self.device)

    def _forward(self, label_mask, generator=None):
        """The model with label reuse: one-hot labels at ``label_mask``, then
        ``n_label_iters`` re-runs feeding ``softmax(pred)`` at the other nodes.
        Only the last run records gradients (the earlier logits enter the
        JAX trainer through ``stop_gradient``)."""
        if not self.cfg.use_labels:
            return self.model(self.graph, self.x, generator)
        fed = label_mask[:, None]
        chan = torch.where(fed, self.onehot, 0.0)
        with span("trainer.label_reuse"):
            for _ in range(self.cfg.n_label_iters):
                with torch.no_grad():
                    logits, _ = self.model(self.graph, torch.cat([self.x, chan], -1), generator)
                chan = torch.where(fed, self.onehot, torch.softmax(logits, -1))
        return self.model(self.graph, torch.cat([self.x, chan], -1), generator)

    def _accuracy(self, pred, mask):
        return ((pred == self.y) & mask).sum() / mask.sum().clamp_min(1)

    def _train_step(self, epoch: int):
        cfg, gen = self.cfg, self.generator
        gen.manual_seed(int(np.random.SeedSequence([self.seed, epoch]).generate_state(1)[0]))
        with span("trainer.forward"):
            coin = torch.rand(self.graph.num_nodes, generator=gen,
                              device=self.device) < cfg.mask_rate
            if cfg.use_labels:
                label_fed, pred_mask = self.train_mask & coin, self.train_mask & ~coin
            else:
                label_fed, pred_mask = torch.zeros_like(coin), self.train_mask & coin
            self.model.train()
            logits, _ = self._forward(label_fed, gen)
        with span("trainer.criterion"):
            loss = log_eps_loss(logits, self.y, pred_mask)
            train_acc = self._accuracy(logits.detach().argmax(-1), self.train_mask)
        self.opt.zero_grad(set_to_none=True)
        with span("trainer.backward"):
            loss.backward()
        with span("trainer.optimizer"):
            self.opt.step()
        return loss.detach(), train_acc

    @torch.no_grad()
    def _inference(self, label_mask):
        self.model.eval()
        return self._forward(label_mask)

    def _eval_step(self):
        logits, feats = self._inference(self.train_mask)
        pred = logits.argmax(-1)
        masks = (self.train_mask, self.valid_mask, self.test_mask)
        accs = [self._accuracy(pred, m) for m in masks]
        losses = [log_eps_loss(logits, self.y, m) for m in masks]
        return logits, feats, accs, losses

    def init_best(self) -> dict:
        """Device-resident best-validation bundle for :meth:`run_epochs`."""
        n, dev = self.graph.num_nodes, self.device
        return {
            "val_loss": torch.tensor(float("inf"), device=dev),
            "val_acc": torch.zeros((), device=dev),
            "test_acc": torch.zeros((), device=dev),
            "logits": torch.zeros((n, self.num_classes), device=dev),
            "feats": torch.zeros((n, self.cfg.n_hidden * self.cfg.n_heads), device=dev),
            "state": {k: v.detach().clone() for k, v in self.model.state_dict().items()},
        }

    @torch.no_grad()
    def _track_best(self, best, logits, feats, accs, losses) -> None:
        better = losses[1] < best["val_loss"]
        for key, new in (("val_loss", losses[1]), ("val_acc", accs[1]),
                         ("test_acc", accs[2]), ("logits", logits), ("feats", feats)):
            best[key] = torch.where(better, new, best[key])
        for name, value in self.model.state_dict().items():
            old = best["state"][name]
            old.copy_(torch.where(better, value, old))

    def run_epochs(self, start_epoch: int, k: int,
                   best: Optional[dict] = None) -> Tuple[dict, np.ndarray]:
        """Run ``k`` epochs (train step, full evaluation, best-validation-loss
        tracking); returns ``(best, hist)``, hist float32[k, 8]: (train_loss,
        train_acc, acc_tr/va/te, loss_tr/va/te). One host sync per call."""
        if best is None:
            best = self.init_best()
        rows = []
        for epoch in range(start_epoch, start_epoch + k):
            with span("trainer.epoch"):
                loss, train_acc = self._train_step(epoch)
                with span("trainer.eval"):
                    logits, feats, accs, losses = self._eval_step()
                    with span("trainer.track_best"):
                        self._track_best(best, logits, feats, accs, losses)
                    rows.append(torch.stack([loss, train_acc, *accs, *losses]).float())
        with span("trainer.readback"):
            return best, torch.stack(rows).cpu().numpy()

    def dump_outputs(self, best: dict, label_mode: str = "train"):
        """(logits, feats) of the best-validation weights under ``label_mode``:
        ``"train"`` feeds the true train labels (the reference's dump);
        ``"self"`` starts from zeroed label channels and re-injects the
        teacher's own predictions at every node (no label input anywhere)."""
        if label_mode not in ("train", "self"):
            raise ValueError(f"label_mode must be 'train' or 'self', got {label_mode!r}")
        current = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(best["state"])
        try:
            mask = self.train_mask if label_mode == "train" else torch.zeros_like(self.train_mask)
            return self._inference(mask)
        finally:
            self.model.load_state_dict(current)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One train step (the generator seeded from ``(seed, epoch)``);
        returns its ``loss`` and ``train_acc``, read on the host."""
        loss, train_acc = self._train_step(epoch)
        return {"loss": float(loss), "train_acc": float(train_acc)}

    def evaluate(self):
        """``(logits, feats, (acc_tr, acc_va, acc_te), (loss_tr, loss_va,
        loss_te))`` of a full-graph evaluation forward with the train labels
        fed."""
        logits, feats, accs, losses = self._eval_step()
        return (logits, feats, tuple(float(a) for a in accs),
                tuple(float(v) for v in losses))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())
