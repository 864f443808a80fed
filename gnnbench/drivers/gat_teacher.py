"""The GAT teacher (``train/gat_teacher.py``) as the system under test.

The program builds its graph (``build_graph`` with the hub partition and
no normalisation, as ``cli/gat_teacher.py`` does) and its trainer; the
benchmark loads its own initial state into the model. An epoch is the
trainer's ``run_epochs`` unit: a train step with label reuse, a full
evaluation and the best-validation tracking, chunked as the CLI chunks it.
The tracked best is compared with the reference's after the first steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnnbench import data, work
from gnnbench.reference.graph import arxiv_graph
from gnnbench.reference.train import follow_teacher


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> data.Inputs:
    return data.arxiv_task(cfg["graph"], seed)


class Program:
    def __init__(self, cfg: dict, traffic: dict, inputs: data.Inputs, seed: int, device):
        from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
        from efficient_gnns_tpu_torch.ops import dispatch
        from efficient_gnns_tpu_torch.train.gat_teacher import GATTeacherTrainer, TeacherConfig

        dispatch.set_hub_message_dtype(getattr(torch, cfg["hub_message_dtype"]))
        graph = build_graph(inputs.senders, inputs.receivers, inputs.num_nodes,
                            bidirected=True, self_loops=True, hub_dense=cfg["hub_dense"],
                            gcn_norm=False)
        tcfg = TeacherConfig(
            n_hidden=cfg["n_hidden"], n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
            dropout=cfg["dropout"], input_drop=cfg["input_drop"], attn_drop=cfg["attn_drop"],
            edge_drop=cfg["edge_drop"], use_labels=cfg["use_labels"],
            n_label_iters=cfg["n_label_iters"], mask_rate=cfg["mask_rate"],
            no_attn_dst=cfg["no_attn_dst"], use_norm=cfg["use_norm"], lr=cfg["lr"],
            wd=cfg["wd"])
        self.trainer = GATTeacherTrainer(tcfg, graph, inputs.x, inputs.y, inputs.split_idx,
                                         inputs.num_classes, seed=seed, device=device)
        self.modules = self.trainer.model
        self.shapes = {"n": graph.num_nodes, "e": graph.n_edge}
        self.best = None
        if cfg["no_attn_dst"] and graph.hub is None:
            raise ValueError("the hub teacher needs a graph with a hub partition")

    def start(self) -> None:
        self.best = self.trainer.init_best()

    def run_epochs(self, start: int, k: int) -> np.ndarray:
        self.best, hist = self.trainer.run_epochs(start, k, self.best)
        return hist[:, 0]

    def first_layer(self) -> torch.nn.Module:
        return self.modules.convs[0]

    def best_outputs(self) -> dict:
        """The tracked best-validation evaluation: its validation loss, and
        its logits and penultimate features copied to the host."""
        return {"val_loss": float(self.best["val_loss"]),
                "logits": self.best["logits"].detach().float().cpu(),
                "feats": self.best["feats"].detach().float().cpu()}

    def first_grad_norms(self) -> dict:
        """Each parameter's first gradient norm from the optimizer's state
        after one step: ``nu = 0.01 g^2`` (0 where it holds none)."""
        opt, decay = self.trainer.opt, self.trainer.opt.DECAY
        return {k: math.sqrt(float(opt.state[p]["nu"].sum()) / (1.0 - decay))
                if "nu" in opt.state[p] else 0.0
                for k, p in self.modules.named_parameters()}


def init_gain(cfg: dict) -> float:
    return math.sqrt(2.0)


def epoch_work(cfg: dict, traffic: dict, shapes: dict, inputs: data.Inputs) -> dict:
    in_dim = inputs.x.shape[1] + (inputs.num_classes if cfg["use_labels"] else 0)
    return work.gat_hub_epoch(shapes["n"], shapes["e"], in_dim, cfg)


def reference_graph(cfg: dict, inputs: data.Inputs, device):
    return arxiv_graph(inputs.senders, inputs.receivers, inputs.num_nodes, device,
                       hub_width=cfg["hub_dense"])


def reference(g, cfg: dict, traffic: dict, inputs: data.Inputs, init: dict, seed: int,
              steps: int, **fault) -> dict:
    dev = g.senders.device
    masks = {}
    for k, idx in inputs.split_idx.items():
        m = torch.zeros(inputs.num_nodes, dtype=torch.bool, device=dev)
        m[torch.from_numpy(idx).to(dev)] = True
        masks[k] = m
    x = torch.from_numpy(inputs.x).to(dev)
    y = torch.from_numpy(inputs.y).to(dev)
    return follow_teacher(g, x, y, masks, init, cfg, seed, steps, **fault)
