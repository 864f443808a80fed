"""Graph-classification models for ogbg-molhiv (counterpart of
``efficient_gnns_tpu/models/mol.py``): the GIN-E and PNA teachers and the
GCN and GIN students, built to the OGB recipes (the reference released no
code for this workload).

A batch arrives as a packed :class:`BatchedGraphs` with integer atom and
bond feature matrices (``data/molhiv.py::MolBatch``). Every sum of the
forward and of the backward is K1 over a CSR of the batch
(``ops/sorted_segment.py``): each conv's aggregation over ``row_offsets``,
the pools over ``graph_offsets``, and the backward of each row gather (of
the senders over the transpose CSR, of PNA's receivers over the CSR, of the
virtual node over ``graph_offsets``). Padding edges lie past
``row_offsets[-1]``: no sum reads them and their messages get no gradient,
so the JAX module's ``where(edge_mask, ...)`` is left out (the same values).
Padding nodes lie past ``graph_offsets[-1]`` likewise.

Parameters are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
and moved to ``device``; dense kernels are ``[in, out]`` as in flax, and
``models/transplant.py::mol_from_jax_params`` loads a JAX ``MolGNN``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from efficient_gnns_tpu_torch.graphs.container import BatchedGraphs
from efficient_gnns_tpu_torch.models.layers import Dense, MaskedBatchNorm, dropout
from efficient_gnns_tpu_torch.ops.cuda.categorical import categorical_encode
from efficient_gnns_tpu_torch.ops.segment import segment_max, segment_min
from efficient_gnns_tpu_torch.ops.sorted_segment import csr_segment_sum_sorted, gather_rows_csr

# OGB molecular categorical feature vocabulary sizes
# (ogb.utils.features.get_atom_feature_dims / get_bond_feature_dims)
ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)


class CategoricalEncoder(nn.Module):
    """Sum of one embedding per feature column (OGB AtomEncoder /
    BondEncoder); each column is clipped into its vocabulary. Tables are
    ``N(0, 1/features)``, flax ``nn.Embed``'s default. On a CUDA device the
    lookup and sum is one kernel a direction (``ops/cuda/categorical.py``:
    the chain's bits forward; backward every table's gradient at once, by
    category in a fixed order, without float atomics); on the CPU the chain
    of ``F.embedding`` lookups and adds."""

    def __init__(self, dims: Sequence[int], features: int, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        self.embs = nn.ParameterList(
            nn.Parameter((torch.randn(v, features, generator=generator)
                          / math.sqrt(features)).to(device)) for v in dims)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return categorical_encode(feats, list(self.embs))


def atom_encoder(features: int, *, generator: torch.Generator,
                 device="cuda") -> CategoricalEncoder:
    return CategoricalEncoder(ATOM_FEATURE_DIMS, features, generator=generator, device=device)


def bond_encoder(features: int, *, generator: torch.Generator,
                 device="cuda") -> CategoricalEncoder:
    return CategoricalEncoder(BOND_FEATURE_DIMS, features, generator=generator, device=device)


def global_sum_pool(batch: BatchedGraphs, x: torch.Tensor) -> torch.Tensor:
    """Sum of the real nodes' rows of each graph -> [num_graphs, F] (K1)."""
    return csr_segment_sum_sorted(x, batch.node_graph_ids, batch.graph_offsets,
                                  batch.graph_split, batch.ident)


def global_mean_pool(batch: BatchedGraphs, x: torch.Tensor) -> torch.Tensor:
    """Mean of the real nodes' rows of each graph; 0 for an empty graph."""
    count = (batch.graph_offsets[1:] - batch.graph_offsets[:-1]).clamp_min(1)
    return global_sum_pool(batch, x) / count[:, None]


def _gather_senders(batch: BatchedGraphs, x: torch.Tensor) -> torch.Tensor:
    g = batch.graph
    return gather_rows_csr(x, g.senders, g.t_row_offsets, g.csc_perm, g.t_row_split)


def _aggregate(batch: BatchedGraphs, msg: torch.Tensor) -> torch.Tensor:
    g = batch.graph
    return csr_segment_sum_sorted(msg, g.receivers, g.row_offsets, g.row_split, batch.ident)


class GINEConv(nn.Module):
    """GIN conv with edge features: ``MLP((1 + eps) x + sum_j ReLU(x_j +
    e_ij))``, the MLP ``Dense(2F) -> MaskedBatchNorm -> ReLU -> Dense(F)``
    (``dense.0``, ``bn``, ``dense.1``)."""

    def __init__(self, features: int, *, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros((), device=device))
        self.dense = nn.ModuleList([
            Dense(features, 2 * features, generator=generator, device=device),
            Dense(2 * features, features, generator=generator, device=device)])
        self.bn = MaskedBatchNorm(2 * features, device=device)

    def forward(self, batch: BatchedGraphs, x: torch.Tensor, edge_emb: torch.Tensor):
        msg = torch.relu(_gather_senders(batch, x) + edge_emb)
        h = (1.0 + self.eps) * x + _aggregate(batch, msg)
        h = self.bn(self.dense[0](h), batch.graph.node_mask, relu=True)
        return self.dense[1](h)


class GCNMolConv(nn.Module):
    """OGB mol-GCN conv: ``h = Dense(x)`` (``dense.0``), the symmetric
    norm of ``ReLU(h_j + e_ij)`` over degrees + 1, plus the root term
    ``ReLU(h + root_emb) / deg``."""

    def __init__(self, features: int, *, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.dense = nn.ModuleList([Dense(features, features, generator=generator,
                                          device=device)])
        self.root_emb = nn.Parameter(torch.randn(features, generator=generator).to(device))

    def forward(self, batch: BatchedGraphs, x: torch.Tensor, edge_emb: torch.Tensor):
        g = batch.graph
        h = self.dense[0](x)
        deg = g.in_degrees() + 1.0
        dis = torch.rsqrt(deg)
        last = g.num_nodes - 1
        norm = (dis.index_select(0, g.senders.clamp(max=last))
                * dis.index_select(0, g.receivers.clamp(max=last)))
        msg = torch.relu(_gather_senders(batch, h) + edge_emb) * norm[:, None]
        return _aggregate(batch, msg) + torch.relu(h + self.root_emb) * (1.0 / deg)[:, None]


def _tower_xavier(towers: int, fan_in: int, fan_out: int, generator, device) -> nn.Parameter:
    """flax ``xavier_uniform`` of a ``[towers, in, out]`` kernel (fans
    ``in * towers`` and ``out * towers``)."""
    bound = math.sqrt(6.0 / (towers * (fan_in + fan_out)))
    w = (torch.rand(towers, fan_in, fan_out, generator=generator) * 2.0 - 1.0) * bound
    return nn.Parameter(w.to(device))


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation (Corso et al. 2020): per-tower
    pre-MLP on ``[x_j | x_i | edge_proj(e_ij)]``, the mean / max / min / std
    aggregators scaled by ``log(deg + 1) / delta`` (amplification) and its
    inverse (attenuation), a per-tower post-MLP and a ``mix`` Dense. Max
    and min are the plain ``segment_max`` / ``segment_min``
    (``scatter_reduce``, exact in any order), ``0`` on a node without
    in-edges.

    The variance is the mean of the squared deviations from the mean (two
    K1 sums), the JAX module's ``relu(mean(msg^2) - mean^2)`` in exact
    arithmetic. In float32 the one-pass form cancels the variance of nearly
    equal messages to rounding noise, and ``sqrt(var + 1e-5)`` scales the
    gradient of that noise by up to 158; two passes keep the gradient
    within float32 rounding of a float64 one
    (``tests/test_torch_mol_models.py::test_pna_gradient_is_closer_to_float64_than_the_jax_float32_one``)."""

    def __init__(self, features: int, towers: int = 5, delta: float = 1.0,
                 edge_features: bool = True, *, generator: torch.Generator, device="cuda"):
        super().__init__()
        if features % towers:
            raise ValueError(f"PNA: {features} features do not split into {towers} towers")
        dt = features // towers
        self.features, self.towers, self.delta = features, towers, delta
        self.edge_proj = (Dense(features, features, generator=generator, device=device)
                          if edge_features else None)
        k = 3 if edge_features else 2
        self.pre_w = _tower_xavier(towers, k * dt, dt, generator, device)
        self.pre_b = nn.Parameter(torch.zeros(towers, dt, device=device))
        self.post_w = _tower_xavier(towers, 13 * dt, dt, generator, device)
        self.post_b = nn.Parameter(torch.zeros(towers, dt, device=device))
        self.mix = Dense(features, features, generator=generator, device=device)

    def forward(self, batch: BatchedGraphs, x: torch.Tensor,
                edge_emb: Optional[torch.Tensor]):
        g = batch.graph
        f, t = self.features, self.towers
        n, e = x.shape[0], g.num_edges_padded
        dt = f // t
        src = _gather_senders(batch, x)
        dst = gather_rows_csr(x, g.receivers, g.row_offsets, batch.ident, g.row_split)
        parts = [src.reshape(e, t, dt), dst.reshape(e, t, dt)]
        if self.edge_proj is not None and edge_emb is not None:
            parts.append(self.edge_proj(edge_emb).reshape(e, t, dt))
        msg_in = torch.cat(parts, dim=-1)  # [E, t, k*dt]
        msg = torch.relu(torch.einsum("eti,tio->eto", msg_in, self.pre_w) + self.pre_b)

        raw_deg = g.in_degrees()
        deg = raw_deg.clamp_min(1.0)
        flat = msg.reshape(e, f)
        mean = _aggregate(batch, flat) / deg[:, None]
        dev = flat - gather_rows_csr(mean, g.receivers, g.row_offsets, batch.ident, g.row_split)
        var = _aggregate(batch, dev * dev) / deg[:, None]
        s_mean = mean.reshape(n, t, dt)
        has_in = (raw_deg > 0)[:, None, None]
        s_max = torch.where(has_in, segment_max(msg, g.receivers, n), 0.0)
        s_min = torch.where(has_in, segment_min(msg, g.receivers, n), 0.0)
        s_std = torch.sqrt(var.reshape(n, t, dt) + 1e-5)
        aggs = torch.cat([s_mean, s_max, s_min, s_std], dim=-1)  # [N, t, 4dt]

        logd = torch.log(deg + 1.0)[:, None, None]
        amp = logd / self.delta
        att = self.delta / logd.clamp_min(1e-6)
        scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)  # [N, t, 12dt]
        combined = torch.cat([x.reshape(n, t, dt), scaled], dim=-1)  # [N, t, 13dt]
        out = (torch.einsum("nti,tio->nto", combined, self.post_w) + self.post_b).reshape(n, f)
        return self.mix(out)


class MolGNN(nn.Module):
    """OGB-style mol GNN: the atom encoder, ``num_layers`` convs (``conv``
    is ``gine``, ``gin`` (the same conv), ``gcn`` or ``pna``), each with its
    own bond encoder, then MaskedBatchNorm, ReLU on all but the last layer,
    dropout and the optional residual; the optional virtual node (a state
    per graph, added to its nodes before each conv and updated after each
    but the last by ``relu(vn_lins[2i+1](relu(vn_lins[2i](sum pool +
    state))))`` with dropout); the mean pool and the ``graph_pred`` Dense.
    ``virtual_node_norm`` gives OGB's form (``GNN_node_Virtualnode``): two
    BatchNorms in the virtual node's MLP (``Dense(2F) -> BN -> ReLU ->
    Dense(F) -> BN -> ReLU``, as ``vn_bns[2i]`` and ``vn_bns[2i+1]``), their
    statistics over the real graphs of a batch (``graph_mask``) and taken in
    two passes (``MaskedBatchNorm(two_pass=True)``): the pooled sums' mean
    dwarfs their spread, and the JAX layer's one-pass variance cancels
    there. Off, the model is the JAX module's.
    ``forward`` returns ``(logits [num_graphs, num_tasks], graph_feat
    [num_graphs, hidden])``, the pooled embedding being the feature that
    distillation compares.
    """

    def __init__(self, conv: str, hidden: int, num_tasks: int, num_layers: int = 5,
                 dropout: float = 0.5, virtual_node: bool = False, residual: bool = False,
                 pna_delta: float = 1.0, pna_towers: int = 5, virtual_node_norm: bool = False,
                 *, seed: int = 0, device="cuda"):
        super().__init__()
        if conv not in ("gine", "gin", "gcn", "pna"):
            raise ValueError(f"MolGNN: conv must be gine, gin, gcn or pna, got {conv!r}")
        gen = torch.Generator().manual_seed(seed)
        kw = dict(generator=gen, device=device)
        self.conv, self.hidden, self.num_layers = conv, hidden, num_layers
        self.dropout, self.virtual_node, self.residual = dropout, virtual_node, residual
        self.atom_encoder = atom_encoder(hidden, **kw)
        self.bond_encoders = nn.ModuleList(bond_encoder(hidden, **kw) for _ in range(num_layers))

        def make_conv():
            if conv == "gcn":
                return GCNMolConv(hidden, **kw)
            if conv == "pna":
                return PNAConv(hidden, towers=pna_towers, delta=pna_delta, **kw)
            return GINEConv(hidden, **kw)

        self.convs = nn.ModuleList(make_conv() for _ in range(num_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(hidden, device=device)
                                 for _ in range(num_layers))
        self.virtualnode_emb = None
        self.vn_lins = nn.ModuleList()
        self.vn_bns = nn.ModuleList()
        if virtual_node:
            self.virtualnode_emb = nn.Parameter(torch.zeros(hidden, device=device))
            for _ in range(num_layers - 1):
                self.vn_lins.append(Dense(hidden, 2 * hidden, **kw))
                self.vn_lins.append(Dense(2 * hidden, hidden, **kw))
                if virtual_node_norm:
                    self.vn_bns.append(MaskedBatchNorm(2 * hidden, device=device, two_pass=True))
                    self.vn_bns.append(MaskedBatchNorm(hidden, device=device, two_pass=True))
        self.graph_pred = Dense(hidden, num_tasks, **kw)

    @property
    def feat_dim(self) -> int:
        return self.hidden

    def _vn_norm(self, j: int, v: torch.Tensor, batch: BatchedGraphs) -> torch.Tensor:
        """``relu`` of the virtual node MLP's ``j``-th BatchNorm over the real
        graphs, or of ``v`` itself without ``virtual_node_norm``."""
        return self.vn_bns[j](v, batch.graph_mask, relu=True) if self.vn_bns else torch.relu(v)

    def forward(self, batch: BatchedGraphs, atoms: torch.Tensor, bonds: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        mask = batch.graph.node_mask[:, None]
        h = torch.where(mask, self.atom_encoder(atoms), 0.0)
        if self.virtual_node:
            vstate = self.virtualnode_emb.expand(batch.num_graphs, self.hidden)
        last = self.num_layers - 1
        for i in range(self.num_layers):
            edge_emb = self.bond_encoders[i](bonds)
            if self.virtual_node:
                h = h + gather_rows_csr(vstate, batch.node_graph_ids, batch.graph_offsets,
                                        batch.ident, batch.graph_split)
                h = torch.where(mask, h, 0.0)
            h_in = h
            h = self.bns[i](self.convs[i](batch, h, edge_emb), batch.graph.node_mask,
                            relu=i < last)
            if self.training:
                h = dropout(h, self.dropout, generator)
            if self.residual:
                h = h + h_in
            if self.virtual_node and i < last:
                pooled = global_sum_pool(batch, h_in) + vstate
                v = self._vn_norm(2 * i, self.vn_lins[2 * i](pooled), batch)
                v = self._vn_norm(2 * i + 1, self.vn_lins[2 * i + 1](v), batch)
                vstate = dropout(v, self.dropout, generator) if self.training else v
        graph_feat = global_mean_pool(batch, h)
        return self.graph_pred(graph_feat), graph_feat
