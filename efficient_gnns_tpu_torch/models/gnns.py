"""The GNN model zoo (counterpart of ``efficient_gnns_tpu/models/gnns.py``;
the GCN and SAGE students, their projection heads, the GAT teacher and the
graph-agnostic SIGN student).

Every model's ``forward`` returns ``(logits, out_feat)``, ``out_feat`` being
the representation used by feature-space distillation. Train or eval mode is
the module's ``training`` flag; dropout draws from the ``generator`` passed
to ``forward``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.models.layers import (
    DGLGATConv,
    ElementWiseLinear,
    FeedForwardNet,
    GCNConv,
    MaskedBatchNorm,
    SAGEConv,
    dropout,
    prelu,
    xavier_uniform,
)


class GCN(nn.Module):
    """PyG-style GCN student: ``GCNConv -> BN -> ReLU -> dropout`` per hidden
    layer; ``out_feat`` = activations entering the final conv.

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``.
    """

    conv_cls = GCNConv

    def __init__(self, in_feats: int, hidden: int, out_feats: int, num_layers: int,
                 dropout: float = 0.5, *, seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = [in_feats] + [hidden] * (num_layers - 1) + [out_feats]
        self.convs = nn.ModuleList(
            self.conv_cls(dims[i], dims[i + 1], generator=gen, device=device)
            for i in range(num_layers)
        )
        self.bns = nn.ModuleList(
            MaskedBatchNorm(hidden, device=device) for _ in range(num_layers - 1)
        )
        self.dropout = dropout

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h = x
        for conv, bn in zip(self.convs[:-1], self.bns):
            h = torch.relu(bn(conv(graph, h), graph.node_mask))
            if self.training:
                h = dropout(h, self.dropout, generator)
        out_feat = h
        return self.convs[-1](graph, h), out_feat


class SAGE(GCN):
    """PyG-style GraphSAGE student: :class:`GCN`'s stack with
    :class:`SAGEConv` (neighbor mean + root weight) in place of ``GCNConv``."""

    conv_cls = SAGEConv


class ProjectionLinear(nn.Module):
    """Bare linear projection (the CRD variant of the projection heads)."""

    def __init__(self, in_feats: int, proj_dim: int, *, seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.weight = xavier_uniform(in_feats, proj_dim, gen, device)
        self.bias = nn.Parameter(torch.zeros(proj_dim, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return x @ self.weight + self.bias


class ProjectionMLP(ProjectionLinear):
    """Linear -> BN -> ReLU projection head for FitNet / GSP / G-CRD; ``mask``
    removes padding rows from the BatchNorm statistics."""

    def __init__(self, in_feats: int, proj_dim: int, *, seed: int = 0, device="cuda"):
        super().__init__(in_feats, proj_dim, seed=seed, device=device)
        self.bn = MaskedBatchNorm(proj_dim, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return torch.relu(self.bn(super().forward(x), mask))


class ProjectionGCD(nn.Module):
    """Graph-conditioned projection ``Linear + GCNConv -> BN -> ReLU`` over
    the whole graph; ``use_linear=False`` drops the parallel linear (the
    variant composed with logit KD)."""

    def __init__(self, in_feats: int, proj_dim: int, use_linear: bool = True, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv = GCNConv(in_feats, proj_dim, generator=gen, device=device)
        self.lin_weight = self.lin_bias = None
        if use_linear:
            self.lin_weight = xavier_uniform(in_feats, proj_dim, gen, device)
            self.lin_bias = nn.Parameter(torch.zeros(proj_dim, device=device))
        self.bn = MaskedBatchNorm(proj_dim, device=device)

    def forward(self, graph: Graph, x: torch.Tensor):
        h = self.conv(graph, x)
        if self.lin_weight is not None:
            h = h + x @ self.lin_weight + self.lin_bias
        return torch.relu(self.bn(h, graph.node_mask))


class GATTeacher(nn.Module):
    """The ogbn-arxiv GAT teacher (reference ``arxiv_dgl/models.py:239-313``):
    ``num_layers`` :class:`DGLGATConv` (residual, optional symmetric norm),
    head-flatten + BatchNorm + ReLU + dropout between layers, a single-head
    last layer, head mean and a bias-only :class:`ElementWiseLinear`.
    ``out_feat`` is the flattened activation after the penultimate layer
    (``hidden * num_heads`` wide: the 750-d teacher dump feature).

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden: int, out_feats: int,
                 num_layers: int = 3, num_heads: int = 3, dropout: float = 0.75,
                 input_drop: float = 0.0, attn_drop: float = 0.0,
                 edge_drop: float = 0.0, use_attn_dst: bool = True,
                 use_symmetric_norm: bool = False, *, seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        convs = []
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(DGLGATConv(
                in_feats if i == 0 else hidden * num_heads,
                out_feats if last else hidden,
                num_heads=1 if last else num_heads,
                attn_drop=attn_drop, edge_drop=edge_drop,
                use_attn_dst=use_attn_dst, residual=True,
                use_symmetric_norm=use_symmetric_norm,
                generator=gen, device=device,
            ))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(
            MaskedBatchNorm(hidden * num_heads, device=device)
            for _ in range(num_layers - 1)
        )
        self.bias_last = ElementWiseLinear(out_feats, use_weight=False, device=device)
        self.dropout, self.input_drop = dropout, input_drop

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h = dropout(x, self.input_drop, generator) if self.training else x
        out_feat = None
        for conv, bn in zip(self.convs[:-1], self.bns):
            h = conv(graph, h, generator).flatten(1)
            h = torch.relu(bn(h, graph.node_mask))
            if self.training:
                h = dropout(h, self.dropout, generator)
            out_feat = h
        h = self.convs[-1](graph, h, generator).mean(1)
        return self.bias_last(h), out_feat


class SIGN(nn.Module):
    """SIGN over precomputed hop features (reference
    ``arxiv_dgl/sign.py:136-163``): one :class:`FeedForwardNet`
    ``inceptions[hop]`` per hop on its input-dropped features, then concat
    -> PReLU (its own slope) -> dropout (= ``out_feat``, ``hidden *
    num_hops`` wide) -> the ``project`` FeedForwardNet to the classes.

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden: int, out_feats: int, num_hops: int,
                 ff_layers: int = 2, dropout: float = 0.5, input_drop: float = 0.0, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.inceptions = nn.ModuleList(
            FeedForwardNet(in_feats, hidden, hidden, ff_layers, dropout,
                           generator=gen, device=device)
            for _ in range(num_hops))
        self.prelu_alpha = nn.Parameter(torch.full((1,), 0.25, device=device))
        self.project = FeedForwardNet(hidden * num_hops, hidden, out_feats, ff_layers,
                                      dropout, generator=gen, device=device)
        self.dropout, self.input_drop = dropout, input_drop

    def forward(self, feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        if len(feats) != len(self.inceptions):
            raise ValueError(f"SIGN takes {len(self.inceptions)} hop features, "
                             f"got {len(feats)}")
        hidden = []
        for ff, f in zip(self.inceptions, feats):
            if self.training:
                f = dropout(f, self.input_drop, generator)
            hidden.append(ff(f, generator))
        h = prelu(torch.cat(hidden, -1), self.prelu_alpha)
        out_feat = dropout(h, self.dropout, generator) if self.training else h
        return self.project(out_feat, generator), out_feat
