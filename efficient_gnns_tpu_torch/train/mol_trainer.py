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

A train batch is packed on the host (``mol.pack``) and moved to the device
in one ``MolBatch.to`` (``mol.upload``); the unshuffled evaluation batches
are packed once and kept on the device with their labels. The JAX trainer
reads each step's losses on the host: here they are summed on the device,
the evaluation's ROC-AUCs are computed there too (``roc_auc_device``), and
``run_epochs`` copies a chunk of epochs to the host once. Each phase is a
``tracing.span``: ``trainer.epoch`` around an epoch, ``mol.pack``,
``mol.upload`` and ``trainer.step`` (``trainer.forward``,
``trainer.criterion``, ``trainer.backward``, ``trainer.optimizer``) for each
batch, ``trainer.eval``, and ``trainer.readback`` around the chunk's copy.

On a CUDA device a supervised step of the GIN-E teacher (300 x 5) is
about 660 kernels on about a thousand atoms, and launching them one by one
costs the host several times what they cost the card. So after the first ``GRAPH_AFTER_STEPS`` steps, which
run eagerly (they make the gradients and Adam's state), each batch
signature (the shapes of its tensors) gets CUDA graphs of its forward,
criterion and backward (:class:`_StepGraphs`, in a memory pool of their
own), captured at its first batch and replayed for every later one: its
batches are packed on the host and copied into the graphs' own device
buffer in one transfer (:class:`StaticBatch`), the backward graph zeroes
the gradients the eager steps made and adds into them (a kernel more a
parameter), and Adam steps eagerly. The evaluation of the kept batches,
which are made before the first step, is one more graph, captured at the
second evaluation. The eager steps, the first evaluation and the captures
run on a side stream of their own, so that what a capture would make
lazily (cuBLAS's workspaces) exists before the first one and every capture
takes the same memory. The replays draw dropout from the same generator,
seeded as before, and run the eager step's kernels, so they compute what
the eager steps compute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.data.molhiv import (MolBatch, MolBatcher, MolDataset, roc_auc,
                                                   roc_auc_device)
from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.graphs.container import _SPLIT_PAIRS
from efficient_gnns_tpu_torch.graphs.row_split import record_pair
from efficient_gnns_tpu_torch.models.gnns import ProjectionMLP
from efficient_gnns_tpu_torch.models.mol import MolGNN
from efficient_gnns_tpu_torch.tracing import span
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.node_trainer import _derived_seed

_MODES = ("supervised", "kd", "fitnet", "at", "gpw", "nce")
SPLITS = ("train", "valid", "test")
# Eager steps before the first capture: the first makes the gradients and
# Adam's state, the second runs every kernel once more outside a capture.
GRAPH_AFTER_STEPS = 2
# Batch signatures given graphs of their own; a batch of any other signature
# steps eagerly.
MAX_STEP_GRAPHS = 8
_GRAPHED_MODES = ("supervised",)


def _leaves(obj) -> Iterator[torch.Tensor]:
    """The tensors of a batch (named tuples and dataclasses of tensors, row
    splits and sizes), in field order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for v in obj:
            yield from _leaves(v)


def _rebuild(obj, tensors: Iterator[torch.Tensor]):
    """``obj`` with its tensors, in :func:`_leaves` order, taken from
    ``tensors``; everything else kept."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), tensors)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_rebuild(v, tensors) for v in obj))
    return obj


def batch_signature(mb: MolBatch) -> tuple:
    """The shape and dtype of each tensor of ``mb``: batches with the same
    signature run the same kernels on the same sizes (the model reads no
    other size of the batch than its tensors' shapes give)."""
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(mb))


class StaticBatch:
    """A packed batch whose tensors are views of one buffer on ``device``,
    each at a 256-byte boundary, refilled from a host batch of the same
    signature with :meth:`load`: one copy into a staging buffer (pinned on
    a CUDA device, so the transfer does not wait for the card) and one
    transfer."""

    ALIGN = 256

    def __init__(self, host: MolBatch, device):
        leaves = list(_leaves(host))
        self.spans, end = [], 0
        for t in leaves:
            nbytes = t.numel() * t.element_size()
            self.spans.append((end, nbytes))
            end += -(-nbytes // self.ALIGN) * self.ALIGN
        self.buffer = torch.empty(max(end, self.ALIGN), dtype=torch.uint8, device=device)
        self.batch = _rebuild(host, iter(
            [self.buffer[lo: lo + n].view(t.dtype).view(t.shape)
             for (lo, n), t in zip(self.spans, leaves)]))
        self.load(host)

    def load(self, host: MolBatch) -> None:
        """Copy the tensors of ``host`` (on the CPU, of this signature) in."""
        cuda = self.buffer.device.type == "cuda"
        staging = torch.empty(self.buffer.shape, dtype=torch.uint8, pin_memory=cuda)
        flat = staging.numpy()
        for (lo, n), t in zip(self.spans, _leaves(host)):
            if n:
                flat[lo: lo + n] = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        self.buffer.copy_(staging, non_blocking=cuda)

    def record_pairs(self) -> None:
        """Record each row split with its offsets as they stand, so that K1
        takes them without the host check that a capture cannot hold."""
        batch = self.batch.batch
        for split, offsets in _SPLIT_PAIRS:
            if getattr(batch.graph, split) is not None:
                record_pair(getattr(batch.graph, split), getattr(batch.graph, offsets))
        record_pair(batch.graph_split, batch.graph_offsets)


@contextlib.contextmanager
def _no_collection():
    """Collect cyclic garbage now and not during a capture: a trainer that
    is gone sits in a reference cycle, and its CUDA graphs, freed by the
    collector in the middle of a capture, would destroy themselves on the
    device, which a capture does not allow (it fails)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextlib.contextmanager
def _on(stream: Optional[torch.cuda.Stream]):
    """Run on ``stream`` (``None``: the current one), in order with the
    current stream both ways."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


@dataclasses.dataclass
class _StepGraphs:
    """The CUDA graphs of a train step on one batch signature (forward,
    criterion, backward; captured at the first replay) over ``static``, and
    the criterion's ``(loss, loss_cls, loss_aux)`` they write."""

    static: StaticBatch
    forward: Optional[torch.cuda.CUDAGraph] = None
    criterion: Optional[torch.cuda.CUDAGraph] = None
    backward: Optional[torch.cuda.CUDAGraph] = None
    losses: Optional[torch.Tensor] = None


class MolTrainer:
    """Trains one :class:`MolGNN` in one mode on a :class:`MolDataset`.

    ``student`` (and ``teacher``, a module that already holds its weights,
    when the mode needs one) move to ``device``. Optimizer:
    ``torch.optim.Adam`` over the student and, in ``nce`` / ``fitnet`` /
    ``gpw``, the projection heads ``sproj`` and ``tproj``, whose update
    matches ``optax.adam``. Row subsampling (``gpw``, ``nce``) and dropout
    draw from a ``torch.Generator`` on ``device`` seeded from ``(seed,
    epoch, step)``. ``max_atoms`` sets the batches' node and edge budgets
    (``MolBatcher``). In the ``supervised`` mode on a CUDA device
    (``graphed``) the steps and the evaluation replay as CUDA graphs (the
    module's doc).
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
        self._eval_batches: Dict[str, Tuple[List[MolBatch], torch.Tensor]] = {}

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
        self.graphed = self.device.type == "cuda" and config.training in _GRAPHED_MODES
        self._eager_steps = self._evals = 0
        # the captures' stream; the eager steps and evaluation run there too,
        # so that what a capture would make lazily (cuBLAS's workspaces, 32
        # MiB a thread) is made before it, and every capture takes the same
        self._stream = torch.cuda.Stream(self.device) if self.graphed else None
        self._step_graphs: Dict[tuple, _StepGraphs] = {}
        self._graph_of: Dict[int, _StepGraphs] = {}  # id of a static batch -> its graphs
        self._eval_graph = None  # (graph, the scores of each split it writes)

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

    def _forward(self, mb: MolBatch) -> tuple:
        """The student's ``(out, feat)`` and, in a distillation mode, the
        teacher's, under ``torch.no_grad()``."""
        out, feat = self.model(mb.batch, mb.atoms, mb.bonds, generator=self.generator)
        if self.cfg.training == "supervised":
            return out, feat, None, None
        with torch.no_grad():
            t_out, t_feat = self.teacher(mb.batch, mb.atoms, mb.bonds)
        return out, feat, t_out, t_feat

    def _criterion(self, mb: MolBatch, fwd: tuple) -> Tuple[torch.Tensor, ...]:
        """``(loss, loss_cls, loss_aux)`` of the mode on :meth:`_forward`'s
        outputs."""
        cfg = self.cfg
        out, feat, t_out, t_feat = fwd
        mask = mb.batch.graph_mask
        logits = out[:, 0]
        if cfg.training == "supervised":
            loss = criteria.cls_bce(logits, mb.labels, mask)
            return loss, loss, loss * 0
        t_logits = t_out[:, 0]
        if cfg.training == "kd":
            return criteria.kd_criterion_bce(logits, mb.labels, t_logits, cfg.alpha, cfg.kd_T,
                                             mask)
        loss_aux = self._aux_term(feat, t_feat, mask)
        if cfg.kd_and_aux:  # loss = KD total + beta * aux
            kd_loss, loss_cls, _ = criteria.kd_criterion_bce(
                logits, mb.labels, t_logits, cfg.alpha, cfg.kd_T, mask)
            return kd_loss + cfg.beta * loss_aux, loss_cls, loss_aux
        loss_cls = criteria.cls_bce(logits, mb.labels, mask)
        return loss_cls + cfg.beta * loss_aux, loss_cls, loss_aux

    def _train_step(self, mb: MolBatch) -> torch.Tensor:
        """One Adam step on one batch on the device: the replay of its
        signature's graphs where :meth:`_upload` gave their static batch,
        else eagerly; returns (loss, loss_cls, loss_aux) on the device."""
        graphs = self._graph_of.get(id(mb))
        if graphs is not None:
            if graphs.forward is None:
                self._capture(graphs)
            return self._replay(graphs)
        with _on(self._stream):
            with span("trainer.forward"):
                fwd = self._forward(mb)
            with span("trainer.criterion"):
                loss, loss_cls, loss_aux = self._criterion(mb, fwd)
            # the graphs' backward writes into the gradients the eager steps made
            self.opt.zero_grad(set_to_none=not self.graphed)
            with span("trainer.backward"):
                loss.backward()
            with span("trainer.optimizer"):
                self.opt.step()
            losses = torch.stack([loss, loss_cls, loss_aux]).detach()
        self._eager_steps += 1
        return losses

    def _upload(self, host: MolBatch) -> MolBatch:
        """``host`` on the device: copied into the static batch of its
        signature's graphs once eager steps are done (the graphs made at the
        first batch of a signature, up to ``MAX_STEP_GRAPHS``), else a copy
        of its own."""
        if not self.graphed or self._eager_steps < GRAPH_AFTER_STEPS:
            return host.to(self.device)
        key = batch_signature(host)
        graphs = self._step_graphs.get(key)
        if graphs is not None:
            graphs.static.load(host)
        elif len(self._step_graphs) < MAX_STEP_GRAPHS:
            graphs = self._step_graphs[key] = _StepGraphs(StaticBatch(host, self.device))
            self._graph_of[id(graphs.static.batch)] = graphs
        else:
            return host.to(self.device)
        return graphs.static.batch

    def _capture(self, graphs: _StepGraphs) -> None:
        """Capture the step on ``graphs.static`` (nothing runs); the
        generator is left as it was, and the forward's dropout draws from
        it at each replay. The three graphs share a memory pool of their
        own, so that a signature's capture takes what the first one took."""
        mb = graphs.static.batch
        graphs.static.record_pairs()
        pool = torch.cuda.graph_pool_handle()
        state = self.generator.get_state()
        graphs.forward, graphs.criterion, graphs.backward = (
            torch.cuda.CUDAGraph() for _ in range(3))
        graphs.forward.register_generator_state(self.generator)
        with _no_collection():
            with torch.cuda.graph(graphs.forward, pool=pool, stream=self._stream):
                fwd = self._forward(mb)
            with torch.cuda.graph(graphs.criterion, pool=pool, stream=self._stream):
                loss, loss_cls, loss_aux = self._criterion(mb, fwd)
                graphs.losses = torch.stack([loss, loss_cls, loss_aux]).detach()
            with torch.cuda.graph(graphs.backward, pool=pool, stream=self._stream):
                self.opt.zero_grad(set_to_none=False)
                loss.backward()
        self.generator.set_state(state)

    def _replay(self, graphs: _StepGraphs) -> torch.Tensor:
        with span("trainer.forward"):
            graphs.forward.replay()
        with span("trainer.criterion"):
            graphs.criterion.replay()
        with span("trainer.backward"):
            graphs.backward.replay()
        with span("trainer.optimizer"):
            self.opt.step()
        return graphs.losses.clone()

    def _train_epoch(self, epoch: int) -> torch.Tensor:
        """One Adam step a batch, in the JAX trainer's order (the batcher's
        permutation of seed ``seed * 613 + epoch``, the generator seeded from
        ``(seed, epoch, step)``); returns the mean (loss, loss_cls, loss_aux)
        on the device, in float64."""
        self.modules.train()
        if self.graphed:  # kept before any capture, so every capture finds them
            for split in SPLITS:
                self.eval_batches(split)
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        chunks = self.batcher.chunks(self.seed * 613 + epoch)
        for n, idx in enumerate(chunks):
            with span("mol.pack"):
                mb = self.batcher.pack(idx)
            with span("mol.upload"):
                mb = self._upload(mb)
            self.generator.manual_seed(_derived_seed(self.seed, epoch, n))
            with span("trainer.step"):
                totals += self._train_step(mb).double()
        return totals / max(len(chunks), 1)

    @torch.no_grad()
    def _eval_step(self) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """The eval-mode scores of the real molecules of train, valid and test
        on their kept batches, in that order, and the three ROC-AUCs, all on
        the device; from the second evaluation on, with ``graphed``, the
        scores are one graph's replay."""
        self.model.eval()
        if self.graphed and self._eval_graph is None and self._evals:
            graph = torch.cuda.CUDAGraph()
            with _no_collection(), torch.cuda.graph(graph, stream=self._stream):
                kept = [self._split_scores(split)[0] for split in SPLITS]
            self._eval_graph = (graph, kept)
        self._evals += 1
        if self._eval_graph is not None:
            graph, kept = self._eval_graph
            graph.replay()
            outs = [(s, self.eval_batches(split)[1]) for split, s in zip(SPLITS, kept)]
        else:
            with _on(self._stream):
                outs = [self._split_scores(split) for split in SPLITS]
        return (torch.cat([s for s, _ in outs]),
                tuple(roc_auc_device(s, labels) for s, labels in outs))

    def run_epochs(self, start_epoch: int, k: int) -> np.ndarray:
        """Run ``k`` epochs (train, then evaluate); returns float32[k, 6] per
        epoch: the mean loss, the train, valid and test ROC-AUCs, the mean
        loss_cls and loss_aux (one host copy)."""
        rows = []
        for epoch in range(start_epoch, start_epoch + k):
            with span("trainer.epoch"):
                losses = self._train_epoch(epoch)
                with span("trainer.eval"):
                    aucs = torch.stack(self._eval_step()[1])
                rows.append(torch.cat([losses[:1], aucs, losses[1:]]))
        with span("trainer.readback"):
            return torch.stack(rows).float().cpu().numpy()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """The train part of an epoch (:meth:`_train_epoch`); returns the mean
        ``loss``, ``loss_cls`` and ``loss_aux`` (one host copy)."""
        means = self._train_epoch(epoch).tolist()
        return dict(zip(("loss", "loss_cls", "loss_aux"), means))

    def eval_batches(self, split: str) -> Tuple[List[MolBatch], torch.Tensor]:
        """The batches of ``split`` in order and the labels of its real
        molecules, on the device: packed at the first call and kept (they
        are the same every epoch)."""
        if split not in self._eval_batches:
            batches = list(self.eval_batchers[split].epoch(0))
            labels = torch.cat([mb.labels[: mb.batch.n_graph] for mb in batches])
            self._eval_batches[split] = ([mb.to(self.device) for mb in batches],
                                         labels.to(self.device))
        return self._eval_batches[split]

    def _split_scores(self, split: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The model's scores of the real molecules of ``split`` on its kept
        batches, in order, and their labels, on the device."""
        batches, labels = self.eval_batches(split)
        return torch.cat([self.model(mb.batch, mb.atoms, mb.bonds)[0][: mb.batch.n_graph, 0]
                          for mb in batches]), labels

    @torch.no_grad()
    def scores(self, split: str) -> Tuple[np.ndarray, np.ndarray]:
        """``(scores, labels)`` of the real molecules of ``split``, in order,
        on the host."""
        self.model.eval()
        out, labels = self._split_scores(split)
        return out.cpu().numpy(), labels.cpu().numpy()

    def evaluate(self, split: str) -> float:
        """ROC-AUC of ``split`` (``train``, ``valid`` or ``test``)."""
        return roc_auc(*self.scores(split))

    def evaluate_all(self) -> Tuple[float, float, float]:
        """The train, valid and test ROC-AUCs of :meth:`_eval_step` (one host
        copy)."""
        return tuple(torch.stack(self._eval_step()[1]).tolist())
