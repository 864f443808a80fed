"""Receiver-sorted padded COO graph with its CSR offsets and transpose.

Counterpart of ``efficient_gnns_tpu/graphs/container.py``. The layout is the
same as the JAX container:

* ``senders`` / ``receivers`` are ``int32[E_pad]``, real edges first, sorted
  by receiver (ties by sender); padding edges carry ``receiver == num_nodes``.
* ``row_offsets`` is ``int32[N+1]`` over receivers. ``row_offsets[N]`` is the
  number of real edges, so a row walk never reaches the padding.
* The transpose (sender-sorted) order is stored once (``t_senders``,
  ``t_receivers``, ``t_row_offsets``, ``csc_perm`` with
  ``t_receivers == senders[csc_perm]``), because the gradient of an SpMM is
  an SpMM over the transposed adjacency.

Unlike the JAX container the transpose-ordered edge weight
(``t_edge_weight == edge_weight[csc_perm]``) is stored too, built once at
graph build, so the backward SpMM reads it without a per-step permutation.
There is no ``EdgeBlocking``: receiver-sorted CSR is the layout the CUDA
kernels walk directly. In its place the graph carries the chunk schedule of
its long rows in both orders (``row_split`` / ``t_row_split``,
``graphs/row_split.py``), which the CSR kernels use to split power-law hub
rows. A graph built with ``hub_dense`` also carries the hub partition of its
edges (``graphs/hub_dense.py``), which decides the edge-drop masks of the hub
attention path. A relation-typed graph (R-GCN) carries ``edge_type``.

The tall typed layout of the sampled R-GCN (``sampling/saint.py``) has
``R * nb`` rows and receivers below ``nb``: built with ``max_dst=nb`` it also
carries the row split of ``row_offsets[:nb + 1]`` (``dst_row_split``), so
that its forward aggregation writes the ``nb`` rows that can be non-zero and
not the ``R * nb`` (the counterpart of the JAX ``block_max_dst``).

:class:`BatchedGraphs` is a batch of small graphs (molecules) packed into one
such graph (``graphs/batching.py::pack_graphs``), with the CSR offsets of the
nodes of each graph, so that a pool over the graphs is a CSR segment sum too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.hub_dense import HubPartition
from efficient_gnns_tpu_torch.graphs.row_split import RowSplit, is_recorded_pair, record_pair

# (split, offsets) fields that build_graph pairs: a pair recorded before a
# move is recorded after it (see ops/cuda/segment_sum.py::check_split)
_SPLIT_PAIRS = (("row_split", "row_offsets"), ("t_row_split", "t_row_offsets"),
                ("dst_row_split", "row_offsets"))


@dataclasses.dataclass
class Graph:
    """A padded, receiver-sorted COO graph with a materialized transpose.

    Attributes:
      senders, receivers: int32[E_pad] edge endpoints in CSR order.
      t_senders, t_receivers: int32[E_pad] endpoints in transpose order.
      csc_perm: int32[E_pad] with ``t_receivers == senders[csc_perm]``.
      row_offsets, t_row_offsets: int32[N+1] CSR offsets of both orders.
      node_mask: bool[num_nodes], True for valid (non-padding) nodes.
      num_nodes: padded node count (feature matrices are [num_nodes, F]).
      n_edge: number of real edges.
      edge_weight: optional float32[E_pad] per-edge scalar in CSR order;
        padding entries are 0.
      t_edge_weight: the same weights in transpose order.
      node_scale: optional float32[num_nodes] ``d^-1/2`` of the factored
        symmetric normalization ``out = S (A (S x))`` with
        ``S = diag(node_scale)`` over the unweighted adjacency
        (``build_graph(gcn_norm="factored")``).
      row_split, t_row_split: the chunk schedules of ``row_offsets`` and
        ``t_row_offsets`` (``build_graph`` attaches both; without them K1, K2,
        K5 and K6 derive the schedule at every call, with a host copy).
      hub: optional :class:`HubPartition` (``build_graph(hub_dense=...)``).
      edge_type: optional int32[E_pad] relation id of each edge in CSR
        order; padding entries equal ``num_edge_types``.
      num_edge_types: relation count R (0 for an untyped graph).
      max_dst: optional bound below which every receiver lies
        (``build_graph(max_dst=...)``); ``dst_row_split`` is then the row
        split of ``row_offsets[:max_dst + 1]``.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    t_senders: torch.Tensor
    t_receivers: torch.Tensor
    csc_perm: torch.Tensor
    row_offsets: torch.Tensor
    t_row_offsets: torch.Tensor
    node_mask: torch.Tensor
    num_nodes: int
    n_edge: int
    edge_weight: Optional[torch.Tensor] = None
    t_edge_weight: Optional[torch.Tensor] = None
    node_scale: Optional[torch.Tensor] = None
    row_split: Optional[RowSplit] = None
    t_row_split: Optional[RowSplit] = None
    hub: Optional[HubPartition] = None
    edge_type: Optional[torch.Tensor] = None
    num_edge_types: int = 0
    max_dst: Optional[int] = None
    dst_row_split: Optional[RowSplit] = None

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @property
    def edge_mask(self) -> torch.Tensor:
        """bool[E_pad]: True for real edges (receiver in range)."""
        return self.receivers < self.num_nodes

    def in_degrees(self) -> torch.Tensor:
        """float32[num_nodes] number of real edges into each node."""
        return (self.row_offsets[1:] - self.row_offsets[:-1]).float()

    def out_degrees(self) -> torch.Tensor:
        """float32[num_nodes] number of real edges out of each node."""
        return (self.t_row_offsets[1:] - self.t_row_offsets[:-1]).float()

    def to(self, device) -> "Graph":
        """A copy with every tensor (and the row splits and the hub
        partition) on ``device``. A (split, offsets) pair that was recorded
        as built together stays recorded."""
        moved = dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), (torch.Tensor, RowSplit, HubPartition))
            },
        )
        for split, offsets in _SPLIT_PAIRS:
            old = getattr(self, split)
            if old is not None and is_recorded_pair(old, getattr(self, offsets)):
                record_pair(getattr(moved, split), getattr(moved, offsets))
        return moved

    def transpose(self) -> "Graph":
        """The transposed graph (receivers <-> senders); both edge orders
        are already materialized, only ``csc_perm`` is inverted."""
        inv = torch.empty_like(self.csc_perm)
        inv[self.csc_perm.long()] = torch.arange(
            self.csc_perm.shape[0], dtype=self.csc_perm.dtype, device=self.device
        )
        return Graph(
            senders=self.t_senders,
            receivers=self.t_receivers,
            t_senders=self.senders,
            t_receivers=self.receivers,
            csc_perm=inv,
            row_offsets=self.t_row_offsets,
            t_row_offsets=self.row_offsets,
            node_mask=self.node_mask,
            num_nodes=self.num_nodes,
            n_edge=self.n_edge,
            edge_weight=self.t_edge_weight,
            t_edge_weight=self.edge_weight,
            node_scale=self.node_scale,  # symmetric: S A S transposes to itself
            row_split=self.t_row_split,
            t_row_split=self.row_split,
            hub=None if self.hub is None else self.hub.transpose(),
            edge_type=None if self.edge_type is None else self.edge_type[self.csc_perm.long()],
            num_edge_types=self.num_edge_types,
        )


@dataclasses.dataclass
class BatchedGraphs:
    """A batch of graphs packed into one padded :class:`Graph` (pad and mask;
    counterpart of the JAX ``BatchedGraphs``).

    Node ids are offset per graph, so the nodes of graph ``k`` are the rows
    ``graph_offsets[k]:graph_offsets[k + 1]`` and ``node_graph_ids`` is
    ascending: every pool over the graphs is a sorted segment sum over
    ``graph_offsets``. What the sums need is built once on the host, when the
    batch is packed: the row split of ``graph_offsets`` (recorded with it, so
    that K1 takes it without a host copy) and an identity index.

    Attributes:
      graph: the packed graph (``n_node_valid`` = the real nodes).
      node_graph_ids: int32[N_pad] graph of each node; ``num_graphs`` on
        padding nodes.
      n_graph: number of real graphs (the first ``n_graph``).
      num_graphs: padded graph count (padded graphs are empty rows).
      graph_offsets: int32[num_graphs + 1] CSR offsets of each graph's nodes;
        ``graph_offsets[-1]`` is the number of real nodes.
      graph_split: the row split of ``graph_offsets``.
      graph_mask: bool[num_graphs], True for the first ``n_graph``.
      ident: int32[max(N_pad, E_pad)] ``0, 1, 2, ...``: K1's gather index
        for a sum over consecutive rows.
    """

    graph: Graph
    node_graph_ids: torch.Tensor
    n_graph: int
    num_graphs: int
    graph_offsets: torch.Tensor
    graph_split: RowSplit
    graph_mask: torch.Tensor
    ident: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.node_graph_ids.device

    def to(self, device) -> "BatchedGraphs":
        """A copy with every tensor (and both row splits) on ``device``; the
        recorded (split, offsets) pairs of the graph and of ``graph_offsets``
        stay recorded."""
        moved = dataclasses.replace(
            self, graph=self.graph.to(device), node_graph_ids=self.node_graph_ids.to(device),
            graph_offsets=self.graph_offsets.to(device),
            graph_split=self.graph_split.to(device), graph_mask=self.graph_mask.to(device),
            ident=self.ident.to(device))
        if is_recorded_pair(self.graph_split, self.graph_offsets):
            record_pair(moved.graph_split, moved.graph_offsets)
        return moved
