"""The GNN model zoo (counterpart of ``efficient_gnns_tpu/models/gnns.py``;
the GCN student so far).

Every model's ``forward`` returns ``(logits, out_feat)``, ``out_feat`` being
the representation used by feature-space distillation. Train or eval mode is
the module's ``training`` flag; dropout draws from the ``generator`` passed
to ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.models.layers import GCNConv, MaskedBatchNorm, dropout


class GCN(nn.Module):
    """PyG-style GCN student: ``GCNConv -> BN -> ReLU -> dropout`` per hidden
    layer; ``out_feat`` = activations entering the final conv.

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden: int, out_feats: int, num_layers: int,
                 dropout: float = 0.5, *, seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = [in_feats] + [hidden] * (num_layers - 1) + [out_feats]
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], generator=gen, device=device)
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
