"""The GNN model zoo (counterpart of ``efficient_gnns_tpu/models/gnns.py``;
the GCN and SAGE students, the DGL-style GCN baseline, their projection heads, the GAT teacher, the
graph-agnostic SIGN student, the PPI GATs and the MAG R-GCN).

Every model's ``forward`` returns ``(logits, out_feat)``, ``out_feat`` being
the representation used by feature-space distillation. Train or eval mode is
the module's ``training`` flag; dropout draws from the ``generator`` passed
to ``forward``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.models.layers import (
    Dense,
    DGLGATConv,
    ElementWiseLinear,
    FeedForwardNet,
    GCNConv,
    MaskedBatchNorm,
    PyGGATConv,
    RGCNConv,
    SAGEConv,
    dropout,
    prelu,
    xavier_uniform,
)
from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_replicated


class GCN(nn.Module):
    """PyG-style GCN student: ``GCNConv -> BN -> ReLU -> dropout`` per hidden
    layer; ``out_feat`` = activations entering the final conv.

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``. ``bn_group`` (the JAX
    ``bn_axis_name``) is the process group over which BatchNorm sums its
    statistics when the rows are sharded across ranks.
    """

    conv_cls = GCNConv

    def __init__(self, in_feats: int, hidden: int, out_feats: int, num_layers: int,
                 dropout: float = 0.5, *, seed: int = 0, device="cuda", bn_group=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = [in_feats] + [hidden] * (num_layers - 1) + [out_feats]
        self.convs = nn.ModuleList(
            self.conv_cls(dims[i], dims[i + 1], generator=gen, device=device)
            for i in range(num_layers)
        )
        self.bns = nn.ModuleList(
            MaskedBatchNorm(hidden, device=device, group=bn_group)
            for _ in range(num_layers - 1)
        )
        self.dropout = dropout

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h = x
        for conv, bn in zip(self.convs[:-1], self.bns):
            h = bn(conv(graph, h), graph.node_mask, relu=True)
            if self.training:
                h = dropout(h, self.dropout, generator)
        out_feat = h
        return self.convs[-1](graph, h), out_feat


class SAGE(GCN):
    """PyG-style GraphSAGE student: :class:`GCN`'s stack with
    :class:`SAGEConv` (neighbor mean + root weight) in place of ``GCNConv``."""

    conv_cls = SAGEConv


class DGLGCN(nn.Module):
    """DGL-style GCN baseline (reference ``arxiv_dgl/models.py:46-92``):
    symmetric-norm ``GCNConv`` with a bias on the last layer only, an
    optional bias-free parallel linear per layer (``use_linear``), input
    dropout ``min(0.1, dropout)``, then ``BN -> ReLU -> dropout`` between
    layers; ``out_feat`` = the activations entering the last layer.

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``; ``bn_group`` as in :class:`GCN`.
    """

    def __init__(self, in_feats: int, hidden: int, out_feats: int, num_layers: int,
                 dropout: float = 0.5, use_linear: bool = False, *, seed: int = 0,
                 device="cuda", bn_group=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = [in_feats] + [hidden] * (num_layers - 1) + [out_feats]
        self.convs, linears = nn.ModuleList(), []
        for i in range(num_layers):
            self.convs.append(GCNConv(dims[i], dims[i + 1], use_bias=i == num_layers - 1,
                                      generator=gen, device=device))
            if use_linear:
                linears.append(xavier_uniform(dims[i], dims[i + 1], gen, device))
        self.linear_weights = nn.ParameterList(linears) if use_linear else None
        self.bns = nn.ModuleList(
            MaskedBatchNorm(hidden, device=device, group=bn_group)
            for _ in range(num_layers - 1)
        )
        self.dropout = dropout

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h = dropout(x, min(0.1, self.dropout), generator) if self.training else x
        out_feat = None
        for i, conv in enumerate(self.convs):
            out = conv(graph, h)
            if self.linear_weights is not None:
                out = out + h @ self.linear_weights[i]
            h = out
            if i < len(self.bns):
                h = self.bns[i](h, graph.node_mask, relu=True)
                if self.training:
                    h = dropout(h, self.dropout, generator)
                out_feat = h
        return h, out_feat


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
    removes padding rows from the BatchNorm statistics; ``bn_group`` as in
    :class:`GCN`."""

    def __init__(self, in_feats: int, proj_dim: int, *, seed: int = 0, device="cuda",
                 bn_group=None):
        super().__init__(in_feats, proj_dim, seed=seed, device=device)
        self.bn = MaskedBatchNorm(proj_dim, device=device, group=bn_group)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return self.bn(super().forward(x), mask, relu=True)


class ProjectionGCD(nn.Module):
    """Graph-conditioned projection ``Linear + GCNConv -> BN -> ReLU`` over
    the whole graph; ``use_linear=False`` drops the parallel linear (the
    variant composed with logit KD); ``bn_group`` as in :class:`GCN`."""

    def __init__(self, in_feats: int, proj_dim: int, use_linear: bool = True, *,
                 seed: int = 0, device="cuda", bn_group=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv = GCNConv(in_feats, proj_dim, generator=gen, device=device)
        self.lin_weight = self.lin_bias = None
        if use_linear:
            self.lin_weight = xavier_uniform(in_feats, proj_dim, gen, device)
            self.lin_bias = nn.Parameter(torch.zeros(proj_dim, device=device))
        self.bn = MaskedBatchNorm(proj_dim, device=device, group=bn_group)

    def forward(self, graph: Graph, x: torch.Tensor):
        h = self.conv(graph, x)
        if self.lin_weight is not None:
            h = h + x @ self.lin_weight + self.lin_bias
        return self.bn(h, graph.node_mask, relu=True)


class GATTeacher(nn.Module):
    """The ogbn-arxiv GAT teacher (reference ``arxiv_dgl/models.py:239-313``):
    ``num_layers`` :class:`DGLGATConv` (residual, optional symmetric norm),
    head-flatten + BatchNorm + ReLU + dropout between layers, a single-head
    last layer, head mean and a bias-only :class:`ElementWiseLinear`.
    ``out_feat`` is the flattened activation after the penultimate layer
    (``hidden * num_heads`` wide: the 750-d teacher dump feature).

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``; ``bn_group`` as in :class:`GCN`.
    """

    def __init__(self, in_feats: int, hidden: int, out_feats: int,
                 num_layers: int = 3, num_heads: int = 3, dropout: float = 0.75,
                 input_drop: float = 0.0, attn_drop: float = 0.0,
                 edge_drop: float = 0.0, use_attn_dst: bool = True,
                 use_symmetric_norm: bool = False, *, seed: int = 0, device="cuda",
                 bn_group=None):
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
            MaskedBatchNorm(hidden * num_heads, device=device, group=bn_group)
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
            h = bn(h, graph.node_mask, relu=True)
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


class PPIGAT(nn.Module):
    """The PPI GAT with parallel skip linears (reference
    ``ppi_pyg/gnn.py:86-117``; TeacherNet and StudentNet are configurations
    of it, :func:`ppi_teacher` and :func:`ppi_student`). Each of the first
    ``num_layers - 1`` layers is ``elu(convs[i](h) + lins[i](h))``, a
    :class:`PyGGATConv` of ``heads`` heads of ``hidden`` (concatenated)
    beside a :class:`Dense` skip, then dropout; the last conv takes the mean
    over ``final_heads`` heads (default ``heads``), plus its skip. ``out_feat``
    is the last hidden activation, ``feat_dim = hidden * heads`` wide.

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden: int, out_feats: int, num_layers: int,
                 heads: int = 4, final_heads: Optional[int] = None, dropout: float = 0.0,
                 *, seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.feat_dim = hidden * heads
        dims = [in_feats] + [self.feat_dim] * (num_layers - 1)
        convs, lins = [], []
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(PyGGATConv(dims[i], out_feats if last else hidden,
                                    num_heads=(final_heads or heads) if last else heads,
                                    concat=not last, generator=gen, device=device))
            lins.append(Dense(dims[i], out_feats if last else self.feat_dim, generator=gen,
                              device=device))
        self.convs, self.lins = nn.ModuleList(convs), nn.ModuleList(lins)
        self.dropout = dropout

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h, out_feat = x, None
        for conv, lin in zip(self.convs[:-1], self.lins[:-1]):
            h = F.elu(conv(graph, h, generator) + lin(h))
            if self.training:
                h = dropout(h, self.dropout, generator)
            out_feat = h
        return self.convs[-1](graph, h, generator) + self.lins[-1](h), out_feat


def ppi_teacher(in_feats: int, num_classes: int, *, seed: int = 0, device="cuda") -> PPIGAT:
    """TeacherNet: 3 layers, 4 heads x 256, a final 6-head mean
    (``ppi_pyg/gnn.py:24-47``); ``out_feat`` is 1,024 wide."""
    return PPIGAT(in_feats, 256, num_classes, 3, heads=4, final_heads=6, seed=seed,
                  device=device)


def ppi_student(in_feats: int, num_classes: int, *, seed: int = 0, device="cuda") -> PPIGAT:
    """StudentNet: 5 layers, 2 heads x 68, a final 2-head mean
    (``ppi_pyg/gnn.py:50-83``); ``out_feat`` is 136 wide."""
    return PPIGAT(in_feats, 68, num_classes, 5, heads=2, final_heads=2, seed=seed,
                  device=device)


class RGCN(nn.Module):
    """Heterogeneous R-GCN (reference ``mag_pyg/gnn.py:70-138``): trainable
    embedding tables ``embs[str(type_id)]`` (``[size, in_feats]``) for the
    featureless node types, injected through the clipped ``local_node_idx``
    gather, then ``num_layers`` :class:`RGCNConv` with ReLU and dropout
    between them; ``out_feat`` is the last hidden layer (``hidden`` wide).
    ``emb_sizes`` holds ``(node_type_id, table_size)`` pairs.

    Weights are initialized from ``torch.Generator().manual_seed(seed)`` on
    the CPU, then moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden: int, out_feats: int, num_layers: int,
                 num_node_types: int, num_edge_types: int, dropout: float = 0.5,
                 emb_sizes: Sequence[tuple] = (), *, seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.emb_sizes = tuple((int(t), int(size)) for t, size in emb_sizes)
        self.embs = nn.ParameterDict({
            str(t): xavier_uniform(size, in_feats, gen, device) for t, size in self.emb_sizes})
        dims = [in_feats] + [hidden] * (num_layers - 1) + [out_feats]
        self.convs = nn.ModuleList(
            RGCNConv(dims[i], dims[i + 1], num_node_types, num_edge_types, generator=gen,
                     device=device)
            for i in range(num_layers))
        self.num_node_types, self.num_edge_types = num_node_types, num_edge_types
        self.feat_dim, self.dropout = hidden, dropout
        self.emb_group, self.emb_lo = None, {}

    def shard_embeddings(self, group, index: int, size: int) -> Dict[str, tuple]:
        """Keep rows ``[lo, hi)`` of every table on this rank, the block of
        rank ``index`` of ``size`` that ``P(axis, None)`` would give it
        (``ceil(rows / size)`` rows a block; JAX needs ``size`` to divide the
        rows); lookups then sum the ranks' blocks over ``group``. Returns
        ``{name: (old parameter, new parameter, lo)}``."""
        swapped = {}
        for t, n in self.emb_sizes:
            name, block = str(t), -(-n // size)
            lo = min(index * block, n)
            old = self.embs[name]
            self.embs[name] = nn.Parameter(old.detach()[lo:min(lo + block, n)].clone())
            self.emb_lo[name] = lo
            swapped[name] = (old, self.embs[name], lo)
        self.emb_group = group
        return swapped

    def _lookup(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        table = self.embs[name]
        if self.emb_group is None:
            return F.embedding(idx, table)
        # this rank's rows, zeros elsewhere; the sum over the ranks is exact
        # (one value and zeros), and every rank runs the same step on the
        # same sample, so the backward is the identity and each rank's table
        # gradient is its own rows'
        local = idx - self.emb_lo[name]
        own = (local >= 0) & (local < table.shape[0])
        if table.shape[0]:
            rows = torch.where(own[:, None],
                               F.embedding(local.clamp(0, table.shape[0] - 1), table), 0.0)
        else:
            rows = table.new_zeros((idx.shape[0], table.shape[1]))
        return all_reduce_replicated(rows, self.emb_group)

    def embed(self, x: torch.Tensor, node_type: torch.Tensor,
              local_node_idx: torch.Tensor) -> torch.Tensor:
        """``x`` with each featureless node's row taken from its type's table.

        Every node gathers a row of every table (its clipped local index, as
        in the JAX module), so most indices of a small table repeat. The
        gather is ``F.embedding``, whose CUDA backward sums repeated indices
        in parallel segments after a sort; the backward of ``table[idx]``
        walks each index's repeats in one warp, one after the other (32 ms a
        table at ogbn-mag's shape, on an H100). With the tables sharded
        (:meth:`shard_embeddings`) each rank looks up its own rows."""
        h = x
        for t, size in self.emb_sizes:
            rows = self._lookup(str(t), local_node_idx.long().clamp(0, size - 1))
            h = torch.where((node_type == t)[:, None], rows.to(h.dtype), h)
        return h

    def forward(self, graph: Optional[Graph], x: torch.Tensor, node_type: torch.Tensor,
                local_node_idx: torch.Tensor, typed_graph: Optional[Graph] = None,
                generator: Optional[torch.Generator] = None):
        h, out_feat = self.embed(x, node_type, local_node_idx), None
        for i, conv in enumerate(self.convs):
            h = conv(graph, h, node_type, typed_graph)
            if i < len(self.convs) - 1:
                h = torch.relu(h)
                if self.training:
                    h = dropout(h, self.dropout, generator)
                out_feat = h
        return h, out_feat
