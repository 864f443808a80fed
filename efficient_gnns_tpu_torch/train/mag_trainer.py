"""ogbn-mag R-GCN trainer (counterpart of
``efficient_gnns_tpu/train/mag_trainer.py``): GraphSAINT sampling with an
online teacher.

An epoch is ``num_steps`` Adam steps, each on one GraphSAINT subgraph
(``sampling/saint.py``, static padded shapes) drawn on the host: the student
R-GCN forward, the frozen teacher R-GCN under ``torch.no_grad()`` (the
reference's online teacher, ``mag_pyg/gnn.py:199-247``: the subgraph changes
every step), the loss of the mode over the train nodes of the subgraph, and
the update. ``nce`` and ``fitnet`` project both features through MLP heads
(the teacher's 512 wide); ``at``, ``gpw`` and ``lpw`` compare the raw
features (``mag_pyg/gnn.py:404-421,222-247``).

A single background thread draws the samples in the sampler's order (the
JAX sampler's stream) and, on a GPU, uploads each on a side stream whose
event the training stream waits for, so that the host's sampling and copies
overlap the device's steps. Losses are summed on the device and copied once
an epoch. Evaluation is the layer-wise full-graph inference
(``train/layerwise.py``), or with ``layerwise=False`` the full-graph forward
on the masked path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.data.mag import MagDataset
from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
from efficient_gnns_tpu_torch.graphs.row_split import RowSplit
from efficient_gnns_tpu_torch.models.gnns import RGCN, ProjectionMLP
from efficient_gnns_tpu_torch.sampling.saint import GraphSaintRandomWalkSampler, SaintSubgraph
from efficient_gnns_tpu_torch.tracing import span
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.layerwise import RGCNLayerwiseInference
from efficient_gnns_tpu_torch.train.node_trainer import _derived_seed

_MODES = ("supervised", "kd", "fitnet", "at", "gpw", "lpw", "nce")


def rgcn_for(ds: MagDataset, hidden: int, num_layers: int, dropout: float = 0.5, *,
             seed: int = 0, device="cuda") -> RGCN:
    """The R-GCN of ``ds``: an embedding table for every node type but
    ``paper``, ``ds.num_classes`` outputs."""
    key2int = ds.grouped.key2int
    emb_sizes = tuple((key2int[nt], ds.num_nodes_dict[nt])
                      for nt in sorted(ds.num_nodes_dict) if nt != "paper")
    return RGCN(ds.x_paper.shape[1], hidden, ds.num_classes, num_layers,
                num_node_types=len(ds.num_nodes_dict), num_edge_types=ds.num_edge_types,
                dropout=dropout, emb_sizes=emb_sizes, seed=seed, device=device)


def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor of a :class:`Graph` (its row splits' included)."""
    for value in vars(obj).values():
        if isinstance(value, torch.Tensor):
            yield value
        elif isinstance(value, RowSplit):
            yield from _tensors(value)


def upload_bytes(sub: SaintSubgraph) -> int:
    """Bytes of the graphs that a step of ``sub`` needs on the device."""
    return sum(t.numel() * t.element_size() for g in (sub.graph, sub.typed_graph)
               if g is not None for t in _tensors(g))


class _SamplePrefetcher:
    """Draws the sampler's subgraphs in one background thread, ``depth``
    ahead, and moves them to the trainer's device (``upload``), counting them
    in ``samples``. ``sample()`` and the upload run in the spans
    ``sampler.sample`` and ``sampler.upload`` (``tracing.py``)."""

    def __init__(self, sampler: GraphSaintRandomWalkSampler, upload, depth: int = 2):
        self._sampler, self._upload = sampler, upload
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.samples = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            while not self._stop.is_set():
                with span("sampler.sample"):
                    sub = self._sampler.sample()
                with span("sampler.upload"):
                    item = self._upload(sub)
                self.samples += 1
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as exc:  # surfaced by get(), which would otherwise wait forever
            self._exc = exc
            self._stop.set()

    def get(self):
        while True:
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if self._exc is not None or not self._thread.is_alive():
                    raise RuntimeError("the prefetch sampler thread failed") from self._exc

    def close(self, timeout: float = 30.0):
        """Stop the thread and wait for it; raises if it is still inside
        ``sample()`` after ``timeout`` seconds, since the sampler's generator
        is then not safe to use from another thread."""
        self._stop.set()
        try:  # free a producer that waits on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"the prefetch sampler thread did not stop within {timeout} s")


class MagTrainer:
    """Trains one R-GCN in one mode on a :class:`MagDataset`.

    The student is ``rgcn_for(ds, config.hidden, config.num_layers,
    config.dropout, seed=seed)``. A mode that needs a teacher builds
    ``rgcn_for(ds, teacher_hidden, teacher_layers)`` and loads
    ``teacher_state`` (a ``state_dict``), or keeps its random weights when
    none is given. Adam (``torch.optim.Adam``, which updates as
    ``optax.adam`` does) over the student and, in ``nce`` / ``fitnet``, the
    projection heads. Dropout and row subsampling draw from a
    ``torch.Generator`` on ``device`` seeded from ``(seed, epoch, step)``.

    The sampler draws as the JAX trainer's does: once more in ``__init__``
    for a fresh teacher and once for the initial state, samples that the
    port does not need to build its modules but draws to stay on the JAX
    stream.
    """

    def __init__(
        self,
        config: DistillConfig,
        ds: MagDataset,
        batch_size: int = 20000,
        num_steps: int = 30,
        walk_length: Optional[int] = None,
        teacher_state: Optional[Mapping[str, torch.Tensor]] = None,
        teacher_hidden: int = 512,
        teacher_layers: int = 3,
        seed: int = 0,
        edge_budget: Optional[int] = None,
        typed_square: bool = True,
        prefetch: int = 2,
        device="cuda",
    ):
        cfg = self.cfg = config
        if cfg.training not in _MODES:
            raise ValueError(f"MAG training mode must be one of {_MODES}, got {cfg.training!r}")
        self.ds, self.seed, self.num_steps = ds, seed, num_steps
        self.teacher_hidden = teacher_hidden
        self.device = torch.device(device)
        g = ds.grouped
        feat_dim = ds.x_paper.shape[1]
        n_total = g.node_type.shape[0]

        paper_glob = g.local2global["paper"]
        x_global = np.zeros((n_total, feat_dim), np.float32)
        x_global[paper_glob] = ds.x_paper
        y_global = np.zeros(n_total, np.int64)
        y_global[paper_glob] = ds.y_paper
        train_mask = np.zeros(n_total, bool)
        train_mask[paper_glob[ds.split_idx["train"]]] = True

        def put(a):
            return torch.from_numpy(a).to(self.device)

        self.x_global, self.y_global = put(x_global), put(y_global)
        self.train_mask_global = put(train_mask)
        self.node_type_global = put(g.node_type.astype(np.int64))
        self.local_idx_global = put(g.local_node_idx.astype(np.int64))
        self._split_ids = {k: put(paper_glob[v].astype(np.int64))
                           for k, v in ds.split_idx.items()}

        self.sampler = GraphSaintRandomWalkSampler(
            g.edge_index[0], g.edge_index[1], n_total, batch_size=batch_size,
            walk_length=walk_length if walk_length is not None else cfg.num_layers,
            edge_type=g.edge_type, num_edge_types=ds.num_edge_types, seed=seed,
            edge_budget=edge_budget, typed_square=typed_square)
        self._valid_ids = torch.arange(self.sampler.node_budget, device=self.device)
        # the subgraph's own graph goes to the device only where a step reads it
        self._needs_graph = not typed_square or cfg.training == "lpw"
        self.layerwise = RGCNLayerwiseInference(
            g.edge_index[0], g.edge_index[1], g.edge_type, n_total, ds.num_edge_types,
            chunk_nodes=min(16384, max(256, (n_total // 8) // 256 * 256)), device=self.device)
        self._full_graph: Optional[Graph] = None

        self.model = rgcn_for(ds, cfg.hidden, cfg.num_layers, cfg.dropout, seed=seed,
                              device=self.device)
        self.teacher = None
        if cfg.needs_teacher():
            self.teacher = rgcn_for(ds, teacher_hidden, teacher_layers, seed=seed + 999,
                                    device=self.device)
            if teacher_state is None:
                self.sampler.sample()  # the JAX trainer initialises its teacher on it
            else:
                self.teacher.load_state_dict(teacher_state)
            self.teacher.eval().requires_grad_(False)
        self.sampler.sample()  # the JAX trainer's initial state is built on it

        self.sproj = self.tproj = None
        if cfg.training in ("nce", "fitnet"):
            self.sproj = ProjectionMLP(cfg.hidden, cfg.proj_dim, seed=_derived_seed(seed, 0, 1),
                                       device=self.device)
            self.tproj = ProjectionMLP(teacher_hidden, cfg.proj_dim,
                                       seed=_derived_seed(seed, 0, 2), device=self.device)
        self.modules = torch.nn.ModuleList(
            m for m in (self.model, self.sproj, self.tproj) if m is not None)
        self.opt = torch.optim.Adam(self.modules.parameters(), lr=cfg.lr)
        self.generator = torch.Generator(device=self.device)
        self._prefetch_depth = int(prefetch)
        self.prefetcher: Optional[_SamplePrefetcher] = None
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # ------------------------------------------------------------------

    def upload(self, sub: SaintSubgraph):
        """``sub`` on the device as ``(sub, event)``: the graphs a step reads
        and ``node_ids``. On a GPU the copies run on a side stream, and
        ``event`` (recorded after them) is what the training stream waits for
        (:meth:`_resident`); elsewhere ``event`` is None."""
        def move():
            return sub._replace(
                graph=sub.graph.to(self.device) if self._needs_graph else None,
                typed_graph=None if sub.typed_graph is None
                else sub.typed_graph.to(self.device),
                node_ids=torch.from_numpy(sub.node_ids).to(self.device))

        if self._stream is None:
            return move(), None
        with torch.cuda.stream(self._stream):
            moved = move()
            event = torch.cuda.Event()
            event.record(self._stream)
        return moved, event

    def _resident(self, item) -> SaintSubgraph:
        """The uploaded sample, safe for the current stream to read."""
        sub, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # allocated on the side stream: freed only after this stream's use
            for graph in (sub.graph, sub.typed_graph):
                for t in (() if graph is None else _tensors(graph)):
                    t.record_stream(stream)
            sub.node_ids.record_stream(stream)
        return sub

    def _payload(self, node_ids: torch.Tensor):
        return (self.x_global[node_ids], self.y_global[node_ids],
                self.train_mask_global[node_ids], self.node_type_global[node_ids],
                self.local_idx_global[node_ids])

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
            # edges between train nodes of the subgraph (mag_pyg/gnn.py:237)
            n = graph.num_nodes
            keep = (mask[graph.senders.long().clamp_max(n - 1)]
                    & mask[graph.receivers.long().clamp_max(n - 1)])
            return criteria.lsp_term(graph, sf, tf, cfg.kernel, keep_mask=keep)
        return criteria.nce_term(sf, tf, cfg.nce_T, generator=gen,
                                 max_samples=cfg.max_samples, mask=mask)

    def train_step(self, sub: SaintSubgraph) -> torch.Tensor:
        """One Adam step on a resident sample; returns ``(loss, loss_cls,
        loss_aux)`` on the device."""
        cfg = self.cfg
        x, y, train_mask, nt, li = self._payload(sub.node_ids)
        mask = train_mask & (self._valid_ids < sub.num_nodes)
        logits, feat = self.model(sub.graph, x, nt, li, sub.typed_graph, self.generator)
        if cfg.training == "supervised":
            loss = criteria.cls_ce(logits, y, mask)
            loss_cls, loss_aux = loss, loss * 0
        else:
            with torch.no_grad():
                t_logits, t_feat = self.teacher(sub.graph, x, nt, li, sub.typed_graph)
            if cfg.training == "kd":
                loss, loss_cls, loss_aux = criteria.kd_criterion(
                    logits, y, t_logits, cfg.alpha, cfg.kd_T, mask)
            else:
                loss_aux = self._aux_term(sub.graph, feat, t_feat, mask)
                if cfg.kd_and_aux:  # loss = KD total + beta * aux
                    kd_loss, loss_cls, _ = criteria.kd_criterion(
                        logits, y, t_logits, cfg.alpha, cfg.kd_T, mask)
                    loss = kd_loss + cfg.beta * loss_aux
                else:
                    loss_cls = criteria.cls_ce(logits, y, mask)
                    loss = loss_cls + cfg.beta * loss_aux
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return torch.stack([loss, loss_cls, loss_aux]).detach()

    def next_sample(self) -> SaintSubgraph:
        """The next subgraph in the sampler's order, resident on the device
        (from the prefetch thread when ``prefetch`` > 0)."""
        if self._prefetch_depth > 0:
            if self.prefetcher is None:
                self.prefetcher = _SamplePrefetcher(self.sampler, self.upload,
                                                    self._prefetch_depth)
            return self._resident(self.prefetcher.get())
        return self._resident(self.upload(self.sampler.sample()))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """``num_steps`` Adam steps; the mean ``loss``, ``loss_cls`` and
        ``loss_aux`` (one host copy)."""
        self.modules.train()
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        for s in range(self.num_steps):
            sub = self.next_sample()
            self.generator.manual_seed(_derived_seed(self.seed, epoch, s))
            totals += self.train_step(sub).double()
        means = (totals / self.num_steps).tolist()
        return dict(zip(("loss", "loss_cls", "loss_aux"), means))

    def device_step_ms(self, steps: int) -> float:
        """Mean ms of ``steps`` chained train steps on ONE resident subgraph
        (drawn on this thread after the prefetch thread stops), after one
        warm step, ending in one host read: the device's step time without
        the sampler and the upload. The steps update the model."""
        self.close()
        sub = self._resident(self.upload(self.sampler.sample()))
        self.modules.train()
        self.train_step(sub)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            m = self.train_step(sub)
        float(m[0])  # the one host read
        return (time.perf_counter() - t0) * 1e3 / steps

    def close(self) -> None:
        """Stop the prefetch thread (idempotent); the sampler is then free for
        the calling thread."""
        if self.prefetcher is not None:
            prefetcher, self.prefetcher = self.prefetcher, None
            prefetcher.close()

    def full_graph(self) -> Graph:
        """The whole typed graph on the device (built at first use)."""
        if self._full_graph is None:
            g = self.ds.grouped
            self._full_graph = build_graph(
                g.edge_index[0], g.edge_index[1], g.node_type.shape[0],
                edge_type=g.edge_type, num_edge_types=self.ds.num_edge_types,
            ).to(self.device)
        return self._full_graph

    @torch.no_grad()
    def logits(self, layerwise: bool = True) -> torch.Tensor:
        """Full-graph logits of the student in eval mode."""
        self.model.eval()
        args = (self.x_global, self.node_type_global, self.local_idx_global)
        if layerwise:
            return self.layerwise(self.model, *args)[0]
        return self.model(self.full_graph(), *args)[0]

    def evaluate(self, layerwise: bool = True) -> Tuple[float, float, float]:
        """Accuracy on the train, valid and test papers (one host copy);
        ``layerwise=False`` runs the full-graph forward instead."""
        pred = self.logits(layerwise).argmax(-1)
        correct = torch.stack([(pred[ids] == self.y_global[ids]).sum()
                               for ids in (self._split_ids[k] for k in ("train", "valid", "test"))])
        sizes = [len(self.ds.split_idx[k]) for k in ("train", "valid", "test")]
        return tuple(c / max(n, 1) for c, n in zip(correct.tolist(), sizes))

    def shard_embeddings(self, mesh, axis: str = "data") -> None:
        """Row-shard the student's featureless-node-type embedding tables,
        and their Adam moments, over ``mesh``'s ``axis``: each rank keeps
        its block of rows (``RGCN.shard_embeddings``) and every other
        parameter stays replicated. Every rank must then run the same steps
        on the same samples (same seed), as the JAX trainer does with a
        sharded state; a lookup sums the ranks' blocks. Without a mesh
        nothing changes."""
        swapped = self.model.shard_embeddings(mesh.group(axis), mesh.index(axis),
                                              mesh.size(axis))
        for old, new, lo in swapped.values():
            for group in self.opt.param_groups:
                group["params"] = [new if p is old else p for p in group["params"]]
            state = self.opt.state.pop(old, None)
            if state:
                self.opt.state[new] = {
                    k: v[lo:lo + new.shape[0]].clone()
                    if torch.is_tensor(v) and v.shape == old.shape else v
                    for k, v in state.items()}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())
