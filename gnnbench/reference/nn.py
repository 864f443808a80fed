"""Layers, models, losses and optimizers of the two configurations, written
out in plain PyTorch over a parameter dict.

Parameter names are the keys of the program's ``state_dict`` for the same
configuration, so that one set of initial values made by the benchmark
serves both sides. Every random draw is the documented protocol's: the
trainer seeds one generator from ``(seed, epoch)`` and every draw below is
made from it in the order the equations use it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from gnnbench.reference.graph import RefGraph, edge_keep

Params = Dict[str, torch.Tensor]
EDGE_BLOCK = 1 << 18  # edges gathered at a time, so that E x F never lives whole
F32_TINY = float(torch.finfo(torch.float32).tiny)


def epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of one epoch: ``SeedSequence((seed, epoch))``'s
    first 32-bit word."""
    return int(np.random.SeedSequence([int(seed), int(epoch)]).generate_state(1)[0])


def messages(y, msg_dtype):
    """``y`` rounded to ``msg_dtype``; float8 (e4m3) with one amax scale for
    the tensor, as float8 is used."""
    if msg_dtype == torch.float8_e4m3fn:
        scale = 448.0 / y.abs().max().clamp_min(1e-30)
        return (y * scale).to(msg_dtype).float() / scale
    return y.to(msg_dtype)


def _aggregate(y, src, dst, weight, n, msg_dtype):
    """``out[d] = sum_e w_e * msg(y)[src_e]`` over edges ``e`` into ``d``; the
    messages are read in ``msg_dtype``, products and sums in float32."""
    ym = messages(y, msg_dtype)
    out = torch.zeros(n, y.shape[1], dtype=torch.float32, device=y.device)
    for lo in range(0, src.shape[0], EDGE_BLOCK):
        rows = ym[src[lo:lo + EDGE_BLOCK]].float()
        if weight is not None:
            rows = rows * weight[lo:lo + EDGE_BLOCK, None]
        out.index_add_(0, dst[lo:lo + EDGE_BLOCK], rows)
    return out


class _SpMM(torch.autograd.Function):
    """``A_w @ y`` whose backward reads the cotangent in the message dtype as
    well: ``dy = A_w^T @ msg(g)``."""

    @staticmethod
    def forward(ctx, y, g: RefGraph, weight, msg_dtype):
        ctx.g, ctx.weight, ctx.msg_dtype = g, weight, msg_dtype
        return _aggregate(y, g.senders, g.receivers, weight, g.num_nodes, msg_dtype)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.g
        dy = _aggregate(grad, g.receivers, g.senders, ctx.weight, g.num_nodes, ctx.msg_dtype)
        return dy, None, None, None


def spmm(g: RefGraph, y, weight=None, msg_dtype=torch.float32):
    return _SpMM.apply(y, g, weight, msg_dtype)


def dropout(x, rate: float, gen):
    """Inverted dropout: keep where ``rand >= rate``, scale by ``1/(1-rate)``."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def batch_norm(x, P: Params, S: Params, name: str, training: bool,
               momentum: float = 0.9, eps: float = 1e-5):
    """BatchNorm over the rows: batch mean and biased variance in training,
    running averages ``ra = 0.9 ra + 0.1 batch`` kept in ``S``."""
    if training:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
        with torch.no_grad():
            S[f"{name}.running_mean"].mul_(momentum).add_((1 - momentum) * mean)
            S[f"{name}.running_var"].mul_(momentum).add_((1 - momentum) * var)
    else:
        mean, var = S[f"{name}.running_mean"], S[f"{name}.running_var"]
    return (x - mean) / torch.sqrt(var + eps) * P[f"{name}.scale"] + P[f"{name}.bias"]


# -- GCN student (PyG GCNConv -> BN -> ReLU -> dropout) --------------------


def gcn_forward(P: Params, S: Params, g: RefGraph, x, layers: int, drop: float,
                gen, training: bool, prefix: str = "", keep=None):
    """``keep``: a list that the first layer's output (before BatchNorm) is
    appended to."""
    h = x
    for i in range(layers - 1):
        z = spmm(g, h @ P[f"{prefix}convs.{i}.weight"], g.norm) + P[f"{prefix}convs.{i}.bias"]
        if keep is not None and i == 0:
            keep.append(z.detach())
        h = torch.relu(batch_norm(z, P, S, f"{prefix}bns.{i}", training))
        if training:
            h = dropout(h, drop, gen)
    last = layers - 1
    out = spmm(g, h @ P[f"{prefix}convs.{last}.weight"], g.norm) + P[f"{prefix}convs.{last}.bias"]
    return out, h


def projection_mlp(P: Params, S: Params, x, name: str, training: bool):
    """Linear -> BN -> ReLU."""
    return torch.relu(batch_norm(x @ P[f"{name}.weight"] + P[f"{name}.bias"], P, S,
                                 f"{name}.bn", training))


# -- GAT teacher on sender-only logits (--no-attn-dst) ----------------------


def gat_layer(P: Params, g: RefGraph, x, i: int, heads: int, width: int, gen,
              training: bool, edge_drop: float, msg_dtype):
    """One residual GAT layer with symmetric norm and sender-only logits.

    ``softmax_r(e)[s -> r] = z[s] / sum z`` with ``z = exp(max(e - m, -60))``
    and ``m`` the global per-head max (no gradient), so the layer is one SpMM
    of ``[z * x | z]`` in the message dtype; a receiver whose kept in-edges
    are all dropped gets 0. Edge drop keeps each edge by the hashed mask of
    a uint32 seed drawn from ``gen``."""
    n = g.num_nodes
    p = f"convs.{i}."
    feat = (x @ P[p + "fc_weight"]).view(n, heads, width)
    feat_src = feat * torch.rsqrt(g.out_deg.clamp_min(1.0))[:, None, None]
    el = torch.einsum("nhd,dh->nh", feat_src, P[p + "attn_l"])
    weight = None
    if training and edge_drop > 0:
        seed = torch.randint(0, 2**32, (), generator=gen, device=x.device, dtype=torch.int64)
        weight = edge_keep(g, seed, 1.0 - edge_drop)
    e = F.leaky_relu(el, 0.2)
    z = torch.exp(torch.clamp_min(e - e.detach().max(0, keepdim=True).values, -60.0))
    y = torch.cat([feat_src * z[:, :, None], z[:, :, None]], -1).reshape(n, -1)
    total = spmm(g, y, weight, msg_dtype).view(n, heads, width + 1)
    num, den = total[..., :width], total[..., width]
    full = den >= F32_TINY
    out = torch.where(full[..., None], num / torch.where(full, den, 1.0)[..., None], 0.0)
    out = out * torch.sqrt(g.in_deg.clamp_min(1.0))[:, None, None]
    return out + (x @ P[p + "res_weight"]).view(n, heads, width)


def gat_forward(P: Params, S: Params, g: RefGraph, x, cfg: dict, gen, training: bool,
                msg_dtype, keep=None):
    """Input dropout, then ``layers - 1`` of (GAT layer -> flatten -> BN ->
    ReLU -> dropout) and a one-head last layer, its head mean and a bias.
    ``keep``: a list that the first layer's flattened output is appended to."""
    layers, heads, width = cfg["n_layers"], cfg["n_heads"], cfg["n_hidden"]
    h = dropout(x, cfg["input_drop"], gen) if training else x
    feat = None
    for i in range(layers - 1):
        h = gat_layer(P, g, h, i, heads, width, gen, training, cfg["edge_drop"],
                      msg_dtype).flatten(1)
        if keep is not None and i == 0:
            keep.append(h.detach())
        h = torch.relu(batch_norm(h, P, S, f"bns.{i}", training))
        if training:
            h = dropout(h, cfg["dropout"], gen)
        feat = h
    out = gat_layer(P, g, h, layers - 1, 1, cfg["num_classes"], gen, training,
                    cfg["edge_drop"], msg_dtype).mean(1)
    return out + P["bias_last.bias"], feat


# -- losses --------------------------------------------------------------


LOG_EPS = 1.0 - math.log(2.0)


def log_eps_loss(logits, labels, mask):
    """``mean(log(eps + CE) - log(eps))`` over the masked rows, ``eps = 1 - ln 2``."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    y = torch.log(LOG_EPS + ce) - math.log(LOG_EPS)
    return y[mask].mean()


def kd_loss(out, labels, teacher, alpha: float, T: float):
    """``alpha T^2 KL(softmax(t/T) || softmax(s/T)) + (1 - alpha) CE``, the KL
    averaged over every element."""
    pt = F.softmax(teacher / T, -1)
    kl = F.kl_div(F.log_softmax(out / T, -1), pt, reduction="none").mean()
    return alpha * T * T * kl + (1 - alpha) * F.cross_entropy(out, labels)


def _unit_rows(x):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-24)


def info_nce(sf, tf, T: float, idx):
    """InfoNCE: student row i against teacher row i among the sampled rows."""
    f, t = _unit_rows(sf[idx]), _unit_rows(tf[idx])
    return -torch.diagonal(F.log_softmax(f @ t.T / T, -1)).mean()


def sample_rows(gen, n: int, m: int, device):
    """``m`` of ``n`` rows without replacement: the first ``m`` of a sort of
    ``n`` uniform scores drawn from ``gen``."""
    return torch.argsort(torch.rand(n, generator=gen, device=device))[:m]


# -- optimizers ----------------------------------------------------------


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m: Params = {}
        self.v: Params = {}

    @torch.no_grad()
    def step(self, P: Params, grads: Params) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            P[k].sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


class RMSpropWarmup:
    """``nu = 0.99 nu + 0.01 g^2``, ``p -= lr_t g / sqrt(nu + 1e-8)`` with
    ``lr_t = lr min((t + 1) / 50, 1)`` at step ``t`` (from 0)."""

    def __init__(self, lr: float):
        self.lr, self.t = lr, 0
        self.nu: Params = {}

    @torch.no_grad()
    def step(self, P: Params, grads: Params) -> None:
        lr_t = self.lr * min((self.t + 1.0) / 50.0, 1.0)
        for k, g in grads.items():
            nu = self.nu.setdefault(k, torch.zeros_like(g))
            nu.mul_(0.99).add_(0.01 * g * g)
            P[k].sub_(lr_t * g / torch.sqrt(nu + 1e-8))
        self.t += 1


def grads_of(loss, P: Params, names) -> Params:
    gs = torch.autograd.grad(loss, [P[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(P[k]) if g is None else g for k, g in zip(names, gs)}
