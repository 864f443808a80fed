"""Graph convolution layers (counterpart of
``efficient_gnns_tpu/models/layers.py``; ``GCNConv``, ``SAGEConv``,
``MaskedBatchNorm``, ``DGLGATConv``, ``PyGGATConv``, ``ElementWiseLinear``,
SIGN's ``FeedForwardNet`` and flax's ``Dense``).

Parameters are created on the CPU and initialized from an explicit
``torch.Generator``, then moved to ``device``, so one seed gives the same
initial weights on every device. A dense kernel keeps the flax layout
``[in, out]`` and is applied as ``x @ weight``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops import spmm, spmm_mean
from efficient_gnns_tpu_torch.ops.attention import gat_attention, sample_edge_masks
from efficient_gnns_tpu_torch.ops.hub_attention import hub_gat_attention, supports_hub_attention


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the node axis with padding rows masked out of the
    statistics, matching the JAX (flax) layer: sum / sum-of-squares
    statistics, biased variance, running averages
    ``ra = momentum * ra + (1 - momentum) * batch`` with ``momentum = 0.9``.
    ``nn.BatchNorm1d`` keeps an unbiased running variance and weighs the
    batch by 0.1 the other way round, so it does not match."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 device="cuda"):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if self.training:
            xf = x.float()
            if mask is not None:
                m = mask.float()[:, None]
                count = m.sum()
                s1 = (xf * m).sum(0)
                s2 = (xf * xf * m).sum(0)
            else:
                count = torch.tensor(float(x.shape[0]), device=x.device)
                s1 = xf.sum(0)
                s2 = (xf * xf).sum(0)
            count = count.clamp_min(1.0)
            mean = s1 / count
            var = (s2 / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


def xavier_uniform(in_features: int, features: int, generator: torch.Generator,
                   device, gain: float = 1.0) -> nn.Parameter:
    """A dense kernel ``[in, out]`` drawn on the CPU, then moved; ``gain``
    ``sqrt(2)`` is flax ``variance_scaling(2.0, "fan_avg", "uniform")``."""
    weight = torch.empty(in_features, features)
    nn.init.xavier_uniform_(weight, gain=gain, generator=generator)
    return nn.Parameter(weight.to(device))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ weight + bias``, the kernel ``[in, out]``
    xavier-uniform from ``generator``, the bias zero."""

    def __init__(self, in_features: int, features: int, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        self.weight = xavier_uniform(in_features, features, generator, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight + self.bias


class GCNConv(nn.Module):
    """PyG ``GCNConv`` semantics: ``out = A_hat (X W) + b`` with the symmetric
    normalization precomputed into ``graph.edge_weight``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 *, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.weight = xavier_uniform(in_features, features, generator, device)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        out = spmm(graph, x @ self.weight)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class SAGEConv(nn.Module):
    """PyG ``SAGEConv`` (mean aggregator): ``mean_{j->i}(x_j) W_l + b + x_i W_r``.
    ``weight`` / ``bias`` are flax ``Dense_0`` (on the neighbor mean),
    ``root_weight`` ``Dense_1`` (on the node itself, no bias)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        self.weight = xavier_uniform(in_features, features, generator, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.root_weight = xavier_uniform(in_features, features, generator, device)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        agg = spmm_mean(graph, x)
        return agg @ self.weight + self.bias.to(agg.dtype) + x @ self.root_weight


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout drawing its mask from ``generator`` (flax semantics:
    keep with probability ``1 - rate``, scale kept values by ``1/(1-rate)``)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def relu_gain_xavier_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax ``variance_scaling(2.0, "fan_avg", "truncated_normal")`` for a
    2-D ``[fan_in, fan_out]`` shape: a normal truncated at two standard
    deviations, scaled so the variance is ``2 / fan_avg`` (the reference's
    xavier-normal init with the ReLU gain)."""
    fan_avg = (shape[0] + shape[1]) / 2.0
    std = math.sqrt(2.0 / fan_avg) / 0.87962566103423978  # truncation correction
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return out


class DGLGATConv(nn.Module):
    """The reference's DGL GAT convolution (``arxiv_dgl/models.py:95-236``):
    LeakyReLU(``negative_slope``) attention with separate ``attn_l`` /
    ``attn_r`` score vectors and the attn-dst switch, symmetric-norm
    pre/post scaling (``deg_out^-1/2`` on the source features, ``deg_in^1/2``
    on the output), edge-drop before the softmax normalisation, attention
    dropout, a residual no-bias linear and an optional ``activation``.

    The attention takes the JAX layer's branches. Without attn-dst and
    attention dropout, on a graph with a hub partition (``build_graph(
    hub_dense=...)``; the teacher's graphs of 200k edges or more),
    :func:`~efficient_gnns_tpu_torch.ops.hub_attention.hub_gat_attention`:
    one SpMM with a global max shift, hub message dtype and hashed edge-drop
    masks, drawing one uint32 drop seed per call from ``generator`` in
    training. Everywhere else the exact edge softmax of
    :func:`~efficient_gnns_tpu_torch.ops.attention.gat_attention`. Dense
    kernels keep the flax layout ``[in, out]``: ``fc_weight`` is flax
    ``Dense_0``, ``res_weight`` ``Dense_1``.
    """

    def __init__(self, in_feats: int, out_feats: int, num_heads: int = 1,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 edge_drop: float = 0.0, negative_slope: float = 0.2,
                 use_attn_dst: bool = True, residual: bool = False,
                 use_symmetric_norm: bool = False,
                 activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None, *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        h, d = num_heads, out_feats
        self.num_heads, self.out_feats = h, d
        self.feat_drop, self.attn_drop, self.edge_drop = feat_drop, attn_drop, edge_drop
        self.negative_slope, self.activation = negative_slope, activation
        self.use_symmetric_norm = use_symmetric_norm

        def param(shape):
            return nn.Parameter(relu_gain_xavier_normal(shape, generator).to(device))

        self.fc_weight = param((in_feats, h * d))
        self.attn_l = param((d, h))
        self.attn_r = param((d, h)) if use_attn_dst else None
        self.res_weight = param((in_feats, h * d)) if residual else None

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, d = self.num_heads, self.out_feats
        if self.training:
            x = dropout(x, self.feat_drop, generator)
        feat = (x @ self.fc_weight).view(-1, h, d)
        feat_src = feat
        if self.use_symmetric_norm:
            degs = graph.out_degrees().clamp_min(1.0)
            feat_src = feat_src * torch.rsqrt(degs)[:, None, None].to(feat.dtype)
        el = torch.einsum("nhd,dh->nh", feat_src.float(), self.attn_l)
        if self.attn_r is None and self.attn_drop == 0.0 and supports_hub_attention(graph):
            drop_seed = None
            if self.training and self.edge_drop > 0:
                drop_seed = torch.randint(0, 2**32, (), generator=generator,
                                          device=x.device, dtype=torch.int64)
            rst = hub_gat_attention(graph, feat_src, el, negative_slope=self.negative_slope,
                                    edge_drop=self.edge_drop, drop_seed=drop_seed)
        else:
            er = None
            if self.attn_r is not None:
                er = torch.einsum("nhd,dh->nh", feat.float(), self.attn_r)
            keep = attn = None
            if self.training and (self.edge_drop > 0 or self.attn_drop > 0):
                keep, attn = sample_edge_masks(graph, generator, self.edge_drop,
                                               self.attn_drop, h)
            rst = gat_attention(graph, feat_src, el, er,
                                negative_slope=self.negative_slope, keep_mask=keep,
                                attn_keep=attn, attn_keep_prob=1.0 - self.attn_drop)
        if self.use_symmetric_norm:
            degs = graph.in_degrees().clamp_min(1.0)
            rst = rst * torch.sqrt(degs)[:, None, None].to(rst.dtype)
        if self.res_weight is not None:
            rst = rst + (x @ self.res_weight).view(-1, h, d)
        if self.activation is not None:
            rst = self.activation(rst)
        return rst  # [N, H, D]


class PyGGATConv(nn.Module):
    """PyG ``GATConv`` semantics (the PPI models, ``ppi_pyg/gnn.py:24-117``):
    LeakyReLU(``negative_slope``) attention with per-head source and
    destination score vectors ``att_src`` / ``att_dst`` ``[D, H]``, attention
    dropout, the heads concatenated (or their mean when ``concat=False``) and
    an output bias. ``weight`` is flax ``Dense_0`` ``[in, H*D]`` (no bias);
    every parameter but the zero bias is xavier-uniform from ``generator``.

    The attention is :func:`~efficient_gnns_tpu_torch.ops.attention.gat_attention`,
    the JAX layer's fused branch and the same function as its XLA branch
    (``sddmm_add`` -> leaky ReLU -> ``edge_softmax`` -> dropout ->
    ``spmm_heads``). Attention dropout draws its mask from the ``generator``
    passed to ``forward``. PyG adds self loops inside the conv; the PPI
    graphs carry them (``data/ppi.py``).
    """

    def __init__(self, in_feats: int, out_feats: int, num_heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, dropout: float = 0.0,
                 *, generator: torch.Generator, device="cuda"):
        super().__init__()
        h, d = num_heads, out_feats
        self.num_heads, self.out_feats, self.concat = h, d, concat
        self.negative_slope, self.dropout = negative_slope, dropout
        self.weight = xavier_uniform(in_feats, h * d, generator, device)
        self.att_src = xavier_uniform(d, h, generator, device)
        self.att_dst = xavier_uniform(d, h, generator, device)
        self.bias = nn.Parameter(torch.zeros(h * d if concat else d, device=device))

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, d = self.num_heads, self.out_feats
        feat = (x @ self.weight).view(-1, h, d)
        el = torch.einsum("nhd,dh->nh", feat.float(), self.att_src)
        er = torch.einsum("nhd,dh->nh", feat.float(), self.att_dst)
        attn = None
        if self.training and self.dropout > 0:
            _, attn = sample_edge_masks(graph, generator, 0.0, self.dropout, h)
        rst = gat_attention(graph, feat, el, er, negative_slope=self.negative_slope,
                            attn_keep=attn, attn_keep_prob=1.0 - self.dropout)
        rst = rst.reshape(-1, h * d) if self.concat else rst.mean(1)
        return rst + self.bias.to(rst.dtype)


class ElementWiseLinear(nn.Module):
    """Per-feature affine (``arxiv_dgl/models.py:11-43``); the GAT teacher's
    final bias layer has ``use_weight=False``."""

    def __init__(self, features: int, use_weight: bool = True, use_bias: bool = True,
                 *, device="cuda"):
        super().__init__()
        self.weight = (nn.Parameter(torch.ones(features, device=device))
                       if use_weight else None)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is not None:
            x = x * self.weight.to(x.dtype)
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)
        return x


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with one shared slope: ``x`` where ``x >= 0``, else ``alpha * x``."""
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


class FeedForwardNet(nn.Module):
    """SIGN's MLP block (reference ``arxiv_dgl/sign.py:105-134``):
    ``n_layers`` dense layers (``weights[i]`` ``[in, out]``, ``biases[i]``)
    with PReLU and dropout between them, xavier-uniform init with the ReLU
    gain, zero biases. One PReLU slope ``prelu_alpha`` (0.25 at init) serves
    every layer of the block and exists only when ``n_layers > 1``."""

    def __init__(self, in_feats: int, hidden: int, out_feats: int, n_layers: int,
                 dropout: float, *, generator: torch.Generator, device="cuda"):
        super().__init__()
        dims = [in_feats] + [hidden] * (n_layers - 1) + [out_feats]
        self.weights = nn.ParameterList(
            xavier_uniform(dims[i], dims[i + 1], generator, device, gain=math.sqrt(2.0))
            for i in range(n_layers))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(dims[i + 1], device=device)) for i in range(n_layers))
        self.prelu_alpha = (nn.Parameter(torch.full((1,), 0.25, device=device))
                            if n_layers > 1 else None)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w + b
            if i < last:
                x = prelu(x, self.prelu_alpha)
                if self.training:
                    x = dropout(x, self.dropout, generator)
        return x
