"""The full-graph distillation trainer with the node rows sharded over a
mesh axis (counterpart of the JAX ``NodeDistillTrainer`` with ``trainer.x``
and ``trainer.y`` under ``shard_rows``, the data-parallel GCN-KD section of
``dryrun_multichip``), in every mode of ``train/config.py``, alone or with
``kd_and_aux``.

XLA partitions the JAX trainer's unchanged step by itself; here each rank
runs :class:`~efficient_gnns_tpu_torch.train.node_trainer.NodeDistillTrainer`
with the unchanged ``GCN`` and projection heads on its
:class:`~efficient_gnns_tpu_torch.parallel.partition.ShardedGraph`, whose
``spmm`` is the halo SpMM on K1 (the ``gcd`` heads' too), and the step
states its collectives:

* BatchNorm sums its statistics over the axis (``bn_group``: the model's
  and the heads');
* each mean over the train rows (the class and KD terms, ``fitnet``) is
  this rank's mean rescaled to its share of the global mean (``n_local /
  n_global``; 0, still connected to the graph, on a rank without train
  rows) and summed with ``all_reduce_replicated``;
* ``at`` sums its two squared norms over the axis with ``all_reduce_stat``
  before it normalises its rows (each rank's cotangent of the norm is only
  its rows' share);
* the terms over a draw of rows (``gpw``, ``nce``, ``gcd``, ``nce-*``) and
  over the train subgraph (``lpw``) are computed whole on every rank: the
  rows they read are assembled in a buffer where each rank writes its own,
  summed with ``all_reduce_replicated`` (backward the identity, so each
  owner receives the whole cotangent of its rows), and the term is added
  once. Every rank draws the single device's ``idx`` over the train
  positions in ``split_idx["train"]``'s order from the same generator
  state. ``lsp_term`` sums over the train subgraph on K1 in CSR order, with
  no float atomics, so every rank computes ``lpw``'s term with the same bits;
* the replicated parameters' gradients are summed over the axis before the
  Adam step, so every rank takes the same step;
* dropout draws each whole-graph mask on every rank from the same seed and
  keeps the rank's rows (``RowBlockGenerator``): the single device's masks.

On a mesh with more axes (``("data", "model")``) the rows are replicated
over the others, and the ranks that share rows compute the same bits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.models.gnns import GCN
from efficient_gnns_tpu_torch.models.layers import RowBlockGenerator
from efficient_gnns_tpu_torch.parallel.collectives import (
    all_reduce_grads,
    all_reduce_replicated,
    all_reduce_stat,
)
from efficient_gnns_tpu_torch.parallel.mesh import Mesh, shard_rows
from efficient_gnns_tpu_torch.parallel.partition import HaloPartition, shard_graph
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer, _derived_seed

SPLITS = ("train", "valid", "test")


def assemble_rows(rows: torch.Tensor, slots: torch.Tensor, m: int, group) -> torch.Tensor:
    """``[m, d]`` on every rank: row ``slots[i]`` is ``rows[i]`` (slot -1:
    not chosen), each slot written by the one rank that owns its row and
    summed over ``group``; the backward hands each owner the whole cotangent
    of its rows."""
    keep = slots >= 0
    buf = rows.new_zeros((m,) + tuple(rows.shape[1:]))
    return all_reduce_replicated(buf.index_add(0, slots[keep], rows[keep]), group)


class ShardedNodeDistillTrainer(NodeDistillTrainer):
    """Trains a ``GCN`` (``config.hidden`` x ``config.num_layers``,
    ``config.dropout``, weights from ``seed``) in any mode of
    ``config.training`` on the rows of ``part`` that this rank owns along
    ``axis``.

    ``part`` is :func:`~efficient_gnns_tpu_torch.parallel.partition.
    partition_graph_halo` of the graph for the size of ``axis``; ``x``,
    ``y``, ``node_mask``, ``teacher_feat`` and ``teacher_logits`` are the
    whole graph's arrays and ``split_idx`` the global indices: each rank
    keeps its rows and the indices that fall in them, as local indices, and
    the global position of each of its train rows in ``split_idx["train"]``
    (which need not be sorted). ``lsp_graph`` (the train subgraph, in train
    order) and, for ``lpw``, the teacher's train rows are replicated.
    Optimizer, seeds, projection heads (their BatchNorm over the axis),
    ``train_epoch``, ``run_epochs`` and ``evaluate`` are
    :class:`~efficient_gnns_tpu_torch.train.node_trainer.NodeDistillTrainer`'s;
    the losses and accuracies are the global ones, the same on every rank,
    and ``evaluate``'s logits are the rank's rows.
    """

    def __init__(self, mesh: Mesh, config: DistillConfig, part: HaloPartition, x, y,
                 split_idx: Dict[str, np.ndarray], num_classes: int, node_mask=None,
                 teacher_feat=None, teacher_logits=None, lsp_graph=None, axis: str = "data",
                 seed: int = 0):
        self.mesh, self.axis, self.group = mesh, axis, mesh.group(axis)
        rows = part.rows_per_dev
        self.lo = mesh.index(axis) * rows
        mask = np.ones(part.num_nodes, bool) if node_mask is None else node_mask

        def whole(a):  # a tensor on any device, or an array
            return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))

        def block(a, dtype):
            return None if a is None else shard_rows(mesh, whole(a).to(dtype), axis)

        local, self.split_sizes = {}, {}
        for k, idx in split_idx.items():
            idx = np.asarray(idx, np.int64)
            mine = (idx >= self.lo) & (idx < self.lo + rows)
            local[k] = idx[mine] - self.lo
            self.split_sizes[k] = int(idx.size)
            if k == "train":  # the global position of each of this rank's train rows
                self.train_pos = torch.as_tensor(np.flatnonzero(mine), device=mesh.device)
        # replicated: the train labels (nce-labels*) and, for lpw, the
        # teacher's train rows, both in train order
        train = torch.as_tensor(np.asarray(split_idx["train"], np.int64))
        labels = whole(y)
        self.train_y = labels[train.to(labels.device)].to(mesh.device, torch.long)
        self.train_teacher = None
        if config.training == "lpw" and teacher_feat is not None:
            tf = whole(teacher_feat)
            self.train_teacher = tf[train.to(tf.device)].to(mesh.device, torch.float32)
        x = block(x, torch.float32)
        model = GCN(x.shape[1], config.hidden, num_classes, config.num_layers, config.dropout,
                    seed=seed, device=mesh.device, bn_group=self.group)
        super().__init__(
            model, config, shard_graph(mesh, part, mask, axis), x, block(y, torch.long), local,
            teacher_feat=block(teacher_feat, torch.float32),
            teacher_logits=block(teacher_logits, torch.float32), lsp_graph=lsp_graph,
            seed=seed, device=mesh.device, bn_group=self.group)

    def _chosen(self, rows, idx):
        """The train rows at global train positions ``idx`` (this rank's
        ``rows`` are its train rows), ``[len(idx), d]`` on every rank."""
        slot = torch.full((self.split_sizes["train"],), -1, dtype=torch.long,
                          device=self.device)
        slot[idx] = torch.arange(idx.numel(), device=self.device)
        return assemble_rows(rows, slot[self.train_pos], idx.numel(), self.group)

    def _at_term(self, feat, teacher_feat):
        """``criteria.at_term`` over every rank's train rows: the per-node
        vectors normalised by their global norms, the global mean."""
        f = feat.float().square().sum(-1)
        t = teacher_feat.float().square().sum(-1)
        norms = all_reduce_stat(torch.stack([f.square().sum(), t.square().sum()]),
                                self.group).sqrt().clamp_min(1e-12)
        diff = (f / norms[0] - t / norms[1]).square().sum()
        return all_reduce_replicated(diff / self.split_sizes["train"], self.group)

    def _aux_term(self, feat, labels, tr):
        """The global auxiliary term, the same value on every rank."""
        cfg, mode = self.cfg, self.cfg.training
        n_train = self.split_sizes["train"]
        if mode == "at":
            return self._at_term(feat[tr], self.teacher_feat[tr])
        if mode == "lpw":
            every = torch.arange(n_train, device=self.device)
            return criteria.lsp_term(self.lsp_graph, self._chosen(feat[tr], every),
                                     self.train_teacher, cfg.kernel)
        sf, tf = self._projected(feat, tr)
        if mode == "fitnet":  # a row mean: this rank's share, summed
            rows = torch.ones(tr.numel(), dtype=torch.bool, device=self.device)
            share = criteria.fitnet_term(sf, tf, rows) * (tr.numel() / n_train)
            return all_reduce_replicated(share, self.group)
        # the single device's draw over the train positions: the generator
        # is in its state on every rank (RowBlockGenerator draws whole masks)
        idx, _ = criteria.subsample_rows(self.generator, n_train, cfg.max_samples, None)
        sf, tf = self._chosen(sf, idx), self._chosen(tf, idx)
        m = idx.numel()
        if mode == "gpw":
            return criteria.gsp_term(sf, tf, cfg.kernel, max_samples=m)
        if mode in ("nce", "gcd"):
            return criteria.nce_term(sf, tf, cfg.nce_T, max_samples=m)
        return criteria.nce_term_structured(
            sf, tf, cfg.nce_T, max_samples=m, idx=idx, gathered=True,
            labels=self.train_y if "labels" in mode else None,
            graph=self.lsp_graph if "edges" in mode else None)

    def _loss_terms(self, logits, feat):
        """(loss, loss_cls, loss_aux), the global values on every rank:
        each train-row mean is this rank's share summed over the axis, the
        auxiliary term is added once."""
        cfg, tr = self.cfg, self.split_idx["train"]
        out, labels = logits[tr], self.y[tr]
        if tr.numel() == 0:  # adds 0, and still joins the backward's exchanges
            terms = (logits.sum() * 0).expand(3)
        elif cfg.training == "kd" or (cfg.training != "supervised" and cfg.kd_and_aux):
            terms = torch.stack(criteria.kd_criterion(
                out, labels, self.teacher_logits[tr], cfg.alpha, cfg.kd_T,
                reduction=cfg.kd_reduction))
        else:
            loss = criteria.cls_ce(out, labels)
            terms = torch.stack([loss, loss, loss * 0])
        share = tr.numel() / self.split_sizes["train"]
        terms = all_reduce_replicated(terms * share, self.group)
        if cfg.training in ("supervised", "kd"):
            return terms
        # loss = KD total (kd_and_aux) or the class term, + beta * aux
        aux = self._aux_term(feat, labels, tr)
        return torch.stack([terms[0] + cfg.beta * aux, terms[1], aux])

    def _train_step(self, epoch: int):
        self.generator.manual_seed(_derived_seed(self.seed, epoch))
        gen = RowBlockGenerator(self.generator, self.mesh.size(self.axis) * self.x.shape[0],
                                self.lo)
        self.modules.train()
        logits, feat = self.model(self.graph, self.x, generator=gen)
        terms = self._loss_terms(logits, feat)
        self.opt.zero_grad(set_to_none=True)
        terms[0].backward()
        all_reduce_grads(self.modules.parameters(), self.group)  # replicated: sum the shares
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
