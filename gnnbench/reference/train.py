"""The reference's first training steps of each configuration.

``follow_teacher`` and ``follow_student`` start from the benchmark's initial
state, run ``steps`` epochs (a train step and a full evaluation each) under
the trainers' ``(seed, epoch)`` protocol, and return what the comparison
reads: each step's loss, each parameter's first gradient norm, each
parameter's change after the last step, each evaluation's logits, the first
layer's output in the first forward, and (the teacher) the best-validation
evaluation that the trainer tracks.

``tf32`` computes every float32 matrix product in TF32, and the teacher's
``msg_dtype`` reads its hub messages in another dtype (the precision
controls). ``half_batch`` takes each loss over the first half of its rows
only, and ``frozen`` leaves the state unchanged by each step (planted
faults).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from gnnbench.reference import nn as R
from gnnbench.reference.graph import RefGraph


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matrix products in TF32 when ``tf32``, in full float32 otherwise."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _split_state(init: Dict[str, torch.Tensor]):
    P = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()
         if not k.endswith(("running_mean", "running_var"))}
    S = {k: v.detach().clone() for k, v in init.items() if k not in P}
    return P, S


def _half(mask_or_idx: torch.Tensor) -> torch.Tensor:
    """The first half of the rows that a bool mask or an index list selects."""
    idx = mask_or_idx.nonzero()[:, 0] if mask_or_idx.dtype == torch.bool else mask_or_idx
    return idx[: idx.shape[0] // 2]


def _outputs() -> dict:
    return {"loss": [], "grad": {}, "change": {}, "eval": [], "first_layer": []}


def _record(P, P0, grads, out, loss):
    out["loss"].append(float(loss.detach()))
    if not out["grad"]:
        out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
    out["change"] = {k: float((P[k].detach() - P0[k]).norm()) for k in P}


def follow_teacher(g: RefGraph, x, y, masks, init, cfg: dict, seed: int, steps: int = 3,
                   tf32: bool = False, half_batch: bool = False, frozen: bool = False,
                   msg_dtype: Optional[str] = None) -> dict:
    """The GAT teacher with label reuse (one label iteration) under
    ``RMSpropWarmup``; the evaluation feeds the train labels and the lowest
    validation loss so far is tracked (strictly lower replaces, as
    ``gat.py`` does): ``out["best"]`` holds its validation loss, logits and
    penultimate features. ``msg_dtype`` overrides the configuration's hub
    message dtype (a control)."""
    train, n = masks["train"], g.num_nodes
    onehot = F.one_hot(y, cfg["num_classes"]).float()
    P, S = _split_state(init)
    P0 = {k: v.detach().clone() for k, v in P.items()}
    opt = R.RMSpropWarmup(cfg["lr"])
    gen = torch.Generator(device=x.device)
    msg = getattr(torch, msg_dtype or cfg["hub_message_dtype"])
    out = _outputs()
    best = {"val_loss": float("inf"), "logits": None, "feats": None}
    out["val_losses"] = []

    def forward(fed, training, generator, keep=None):
        chan = torch.where(fed[:, None], onehot, 0.0)
        for _ in range(cfg["n_label_iters"]):
            with torch.no_grad():
                logits, _ = R.gat_forward(P, S, g, torch.cat([x, chan], -1), cfg, generator,
                                          training, msg, keep)
            keep = None
            chan = torch.where(fed[:, None], onehot, torch.softmax(logits, -1))
        return R.gat_forward(P, S, g, torch.cat([x, chan], -1), cfg, generator, training, msg,
                             keep)

    with matmul_precision(tf32):
        for epoch in range(steps):
            gen.manual_seed(R.epoch_seed(seed, epoch))
            coin = torch.rand(n, generator=gen, device=x.device) < cfg["mask_rate"]
            fed, pred = train & coin, train & ~coin
            logits, _ = forward(fed, True, gen, out["first_layer"] if epoch == 0 else None)
            if half_batch:
                rows = _half(pred)
                pred = torch.zeros_like(pred)
                pred[rows] = True
            loss = R.log_eps_loss(logits, y, pred)
            grads = R.grads_of(loss, P, list(P))
            if not frozen:
                opt.step(P, grads)
            _record(P, P0, grads, out, loss)
            with torch.no_grad():
                logits, feats = forward(train, False, None)
                val_loss = float(R.log_eps_loss(logits, y, masks["valid"]))
            out["eval"].append(logits)
            out["val_losses"].append(val_loss)
            if val_loss < best["val_loss"]:
                best.update(val_loss=val_loss, logits=logits, feats=feats)
    out["best"] = best
    return out


def follow_student(g: RefGraph, x, y, train_idx, teacher_feat, teacher_logits, init,
                   cfg: dict, traffic: dict, seed: int, steps: int = 3, tf32: bool = False,
                   half_batch: bool = False, frozen: bool = False) -> dict:
    """The GCN student under Adam in ``kd`` or ``nce`` (with projection
    heads ``1`` and ``2``, the student's and the teacher's)."""
    P, S = _split_state(init)
    P0 = {k: v.detach().clone() for k, v in P.items()}
    opt = R.Adam(cfg["lr"])
    gen = torch.Generator(device=x.device)
    mode, layers, drop = traffic["training"], cfg["num_layers"], cfg["dropout"]
    out = _outputs()
    with matmul_precision(tf32):
        for epoch in range(steps):
            gen.manual_seed(R.epoch_seed(seed, epoch))
            logits, feat = R.gcn_forward(P, S, g, x, layers, drop, gen, True, prefix="0.",
                                         keep=out["first_layer"] if epoch == 0 else None)
            rows = _half(train_idx) if half_batch else train_idx
            if mode == "kd":
                loss = R.kd_loss(logits[rows], y[rows], teacher_logits[rows],
                                 traffic["alpha"], traffic["kd_T"])
            elif mode == "nce":
                sf = R.projection_mlp(P, S, feat[train_idx], "1", True)
                tf = R.projection_mlp(P, S, teacher_feat[train_idx], "2", True)
                idx = R.sample_rows(gen, train_idx.shape[0], traffic["max_samples"], x.device)
                if half_batch:
                    idx = idx[: idx.shape[0] // 2]
                aux = R.info_nce(sf, tf, traffic["nce_T"], idx)
                loss = F.cross_entropy(logits[rows], y[rows]) + traffic["beta"] * aux
            else:
                raise ValueError(f"the reference has no training mode {mode!r}")
            grads = R.grads_of(loss, P, list(P))
            if not frozen:
                opt.step(P, grads)
            _record(P, P0, grads, out, loss)
            with torch.no_grad():
                logits, _ = R.gcn_forward(P, S, g, x, layers, drop, None, False, prefix="0.")
            out["eval"].append(logits)
    return out
