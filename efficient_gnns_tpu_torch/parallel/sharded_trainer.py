"""The full-graph distillation trainer with the node rows sharded over a
mesh axis (counterpart of the JAX ``NodeDistillTrainer`` with ``trainer.x``
and ``trainer.y`` under ``shard_rows``, the data-parallel GCN-KD section of
``dryrun_multichip``).

XLA partitions the JAX trainer's unchanged step by itself; here each rank
runs :class:`~efficient_gnns_tpu_torch.train.node_trainer.NodeDistillTrainer`
with the unchanged ``GCN`` on its :class:`~efficient_gnns_tpu_torch.parallel.
partition.ShardedGraph`, whose ``spmm`` is the halo SpMM on K1, and the
step states its collectives:

* BatchNorm sums its statistics over the axis (``bn_group``);
* each loss term is this rank's mean rescaled to its share of the global
  mean (``n_local / n_global``; 0, still connected to the graph, on a rank
  without train rows) and summed with ``all_reduce_replicated``;
* the replicated parameters' gradients are summed over the axis before the
  Adam step, so every rank takes the same step;
* dropout draws each whole-graph mask on every rank from the same seed and
  keeps the rank's rows (``RowBlockGenerator``): the single device's masks.

On a mesh with more axes (``("data", "model")``) the rows are replicated
over the others, and the ranks that share rows compute the same bits.
Modes: ``supervised`` and ``kd`` (``kd_reduction`` ``numel`` or
``batchmean``); the representation modes need the ring terms and a sharded
row draw (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.models.gnns import GCN
from efficient_gnns_tpu_torch.models.layers import RowBlockGenerator
from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_grads, all_reduce_replicated
from efficient_gnns_tpu_torch.parallel.mesh import Mesh, shard_rows
from efficient_gnns_tpu_torch.parallel.partition import HaloPartition, shard_graph
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer, _derived_seed

SPLITS = ("train", "valid", "test")


class ShardedNodeDistillTrainer(NodeDistillTrainer):
    """Trains a ``GCN`` (``config.hidden`` x ``config.num_layers``,
    ``config.dropout``, weights from ``seed``) in ``supervised`` or ``kd``
    mode on the rows of ``part`` that this rank owns along ``axis``.

    ``part`` is :func:`~efficient_gnns_tpu_torch.parallel.partition.
    partition_graph_halo` of the graph for the size of ``axis``; ``x``,
    ``y``, ``node_mask`` and ``teacher_logits`` are the whole graph's arrays
    and ``split_idx`` the global indices: each rank keeps its rows and the
    indices that fall in them, as local indices. Optimizer, seeds,
    ``train_epoch``, ``run_epochs`` and ``evaluate`` are
    :class:`~efficient_gnns_tpu_torch.train.node_trainer.NodeDistillTrainer`'s;
    the losses and accuracies are the global ones, the same on every rank,
    and ``evaluate``'s logits are the rank's rows.
    """

    def __init__(self, mesh: Mesh, config: DistillConfig, part: HaloPartition, x, y,
                 split_idx: Dict[str, np.ndarray], num_classes: int, node_mask=None,
                 teacher_logits=None, axis: str = "data", seed: int = 0):
        if config.training not in ("supervised", "kd"):
            raise NotImplementedError(
                f"training mode {config.training!r} on sharded rows needs the ring terms in "
                "the loss and a sharded max_samples draw (ROADMAP.md, Queue 1)")
        self.mesh, self.axis, self.group = mesh, axis, mesh.group(axis)
        rows = part.rows_per_dev
        self.lo = mesh.index(axis) * rows
        mask = np.ones(part.num_nodes, bool) if node_mask is None else node_mask

        def block(a, dtype):
            return shard_rows(mesh, torch.as_tensor(np.asarray(a)).to(dtype), axis)

        local, self.split_sizes = {}, {}
        for k, idx in split_idx.items():
            idx = np.asarray(idx, np.int64)
            local[k] = idx[(idx >= self.lo) & (idx < self.lo + rows)] - self.lo
            self.split_sizes[k] = int(idx.size)
        x = block(x, torch.float32)
        model = GCN(x.shape[1], config.hidden, num_classes, config.num_layers, config.dropout,
                    seed=seed, device=mesh.device, bn_group=self.group)
        super().__init__(
            model, config, shard_graph(mesh, part, mask, axis), x, block(y, torch.long), local,
            teacher_logits=(None if teacher_logits is None
                            else block(teacher_logits, torch.float32)),
            seed=seed, device=mesh.device)

    def _loss_terms(self, logits):
        """(loss, loss_cls, loss_aux): this rank's share of each global mean
        over the train rows, summed over the axis."""
        cfg, tr = self.cfg, self.split_idx["train"]
        out, labels = logits[tr], self.y[tr]
        if tr.numel() == 0:  # adds 0, and still joins the backward's exchanges
            terms = (logits.sum() * 0).expand(3)
        elif cfg.training == "supervised":
            loss = criteria.cls_ce(out, labels)
            terms = torch.stack([loss, loss, loss * 0])
        else:
            terms = torch.stack(criteria.kd_criterion(
                out, labels, self.teacher_logits[tr], cfg.alpha, cfg.kd_T,
                reduction=cfg.kd_reduction))
        share = tr.numel() / self.split_sizes["train"]
        return all_reduce_replicated(terms * share, self.group)

    def _train_step(self, epoch: int):
        self.generator.manual_seed(_derived_seed(self.seed, epoch))
        gen = RowBlockGenerator(self.generator, self.mesh.size(self.axis) * self.x.shape[0],
                                self.lo)
        self.model.train()
        logits, _ = self.model(self.graph, self.x, generator=gen)
        terms = self._loss_terms(logits)
        self.opt.zero_grad(set_to_none=True)
        terms[0].backward()
        all_reduce_grads(self.model.parameters(), self.group)  # replicated: sum the shares
        self.opt.step()
        self.step += 1
        return terms.detach().unbind()

    @torch.no_grad()
    def _eval_step(self):
        self.model.eval()
        logits, _ = self.model(self.graph, self.x)
        pred = logits.argmax(-1)
        hits = torch.stack([(pred[self.split_idx[k]] == self.y[self.split_idx[k]]).sum()
                            for k in SPLITS]).float()
        dist.all_reduce(hits, group=self.group)
        sizes = torch.tensor([max(self.split_sizes[k], 1) for k in SPLITS],
                             dtype=torch.float32, device=self.device)
        return logits, tuple((hits / sizes).unbind())
