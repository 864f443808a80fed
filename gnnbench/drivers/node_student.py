"""The GCN student (``train/node_trainer.py``) as the system under test.

The program builds its graph (``build_graph`` with the GCN normalisation and
the hub partition, as the synthetic dataset of ``cli/arxiv.py`` does), a
``GCN`` and a ``NodeDistillTrainer`` in the traffic's training mode; the
benchmark loads its own initial state into the model and the projection
heads, and hands both sides the same stand-in teacher outputs. An epoch is
the trainer's ``run_epochs`` unit: a train step and a full evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnbench import data, work
from gnnbench.reference.graph import arxiv_graph
from gnnbench.reference.train import follow_student


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> data.Inputs:
    inputs = data.arxiv_task(cfg["graph"], seed)
    data.teacher_outputs(inputs, cfg["teacher_dim"], seed, device)
    return inputs


class Program:
    def __init__(self, cfg: dict, traffic: dict, inputs: data.Inputs, seed: int, device):
        from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
        from efficient_gnns_tpu_torch.models.gnns import GCN
        from efficient_gnns_tpu_torch.ops import dispatch
        from efficient_gnns_tpu_torch.train.config import DistillConfig
        from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer

        dispatch.set_message_dtype(getattr(torch, cfg["message_dtype"]))
        graph = build_graph(inputs.senders, inputs.receivers, inputs.num_nodes,
                            bidirected=True, self_loops=True, hub_dense="auto",
                            gcn_norm=True)
        keys = ("alpha", "kd_T", "beta", "nce_T", "proj_dim", "max_samples")
        dcfg = DistillConfig(
            training=traffic["training"], num_layers=cfg["num_layers"], hidden=cfg["hidden"],
            dropout=cfg["dropout"], lr=cfg["lr"], teacher_dim=cfg["teacher_dim"],
            **{k: traffic[k] for k in keys if k in traffic})
        model = GCN(inputs.x.shape[1], cfg["hidden"], inputs.num_classes, cfg["num_layers"],
                    dropout=cfg["dropout"], seed=seed, device=device)
        self.trainer = NodeDistillTrainer(
            model, dcfg, graph, inputs.x, inputs.y, inputs.split_idx,
            teacher_feat=inputs.teacher_feat, teacher_logits=inputs.teacher_logits,
            seed=seed, device=device)
        self.modules = self.trainer.modules
        self.shapes = {"n": graph.num_nodes, "e": graph.n_edge}

    def start(self) -> None:
        pass

    def run_epochs(self, start: int, k: int) -> np.ndarray:
        return self.trainer.run_epochs(start, k)[:, 0]

    def first_layer(self) -> torch.nn.Module:
        return self.modules[0].convs[0]

    def first_grad_norms(self) -> dict:
        """Each parameter's first gradient norm from Adam's state after one
        step: ``exp_avg = (1 - beta1) g`` (0 where it holds none)."""
        opt = self.trainer.opt
        b1 = opt.param_groups[0]["betas"][0]
        return {k: float(opt.state[p]["exp_avg"].norm()) / (1.0 - b1)
                if "exp_avg" in opt.state[p] else 0.0
                for k, p in self.modules.named_parameters()}


def init_gain(cfg: dict) -> float:
    return 1.0


def epoch_work(cfg: dict, traffic: dict, shapes: dict, inputs: data.Inputs) -> dict:
    dims = [inputs.x.shape[1]] + [cfg["hidden"]] * (cfg["num_layers"] - 1) + [inputs.num_classes]
    return work.gcn_epoch(shapes["n"], shapes["e"], dims, len(inputs.split_idx["train"]),
                          traffic, cfg["teacher_dim"])


def reference_graph(cfg: dict, inputs: data.Inputs, device):
    return arxiv_graph(inputs.senders, inputs.receivers, inputs.num_nodes, device,
                       gcn_norm=True)


def reference(g, cfg: dict, traffic: dict, inputs: data.Inputs, init: dict, seed: int,
              steps: int, **fault) -> dict:
    dev = g.senders.device
    x = torch.from_numpy(inputs.x).to(dev)
    y = torch.from_numpy(inputs.y).to(dev)
    train = torch.from_numpy(inputs.split_idx["train"]).to(dev)
    return follow_student(g, x, y, train, inputs.teacher_feat, inputs.teacher_logits, init,
                          cfg, traffic, seed, steps, **fault)
