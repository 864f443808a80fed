"""Graph convolution layers (counterpart of
``efficient_gnns_tpu/models/layers.py``; ``GCNConv`` and ``MaskedBatchNorm``).

Parameters are created on the CPU and initialized from an explicit
``torch.Generator``, then moved to ``device``, so one seed gives the same
initial weights on every device. A dense kernel keeps the flax layout
``[in, out]`` and is applied as ``x @ weight``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops import spmm


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


class GCNConv(nn.Module):
    """PyG ``GCNConv`` semantics: ``out = A_hat (X W) + b`` with the symmetric
    normalization precomputed into ``graph.edge_weight``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 *, generator: torch.Generator, device="cuda"):
        super().__init__()
        weight = torch.empty(in_features, features)
        nn.init.xavier_uniform_(weight, generator=generator)
        self.weight = nn.Parameter(weight.to(device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        out = spmm(graph, x @ self.weight)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout drawing its mask from ``generator`` (flax semantics:
    keep with probability ``1 - rate``, scale kept values by ``1/(1-rate)``)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
