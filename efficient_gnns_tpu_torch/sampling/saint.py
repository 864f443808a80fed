"""GraphSAINT random-walk subgraph sampler (counterpart of
``efficient_gnns_tpu/sampling/saint.py``).

Replaces PyG's ``GraphSAINTRandomWalkSampler`` (reference
``mag_pyg/gnn.py:361-366``): sample ``batch_size`` roots uniformly, walk
``walk_length`` steps over the out-adjacency, take the node-induced subgraph
of every visited node and relabel. Every subgraph is padded to the same
static node budget (``batch_size * (walk_length + 1)``) and edge budget, with
the JAX sampler's sentinels, so the port's samples have the JAX samples'
shapes.

The random draws are the JAX sampler's, in its order: the roots, then the
native walker's seed (``native/host.py``) or the NumPy walk's steps, then
``rng.choice`` only when the induced edges exceed the budget. ``np.unique``,
``np.bincount`` and the relabel are the same calls, so one seed gives the
same subgraphs in both packages (on one machine: the native walker's thread
count follows the host's cores once the roots reach 8,192).

``typed_square=True`` also builds the relation-typed square graph of the
R-GCN's single-pass aggregation (``models/layers.py::RGCNConv``): senders at
row ``edge_type * node_budget + s``, receivers below ``node_budget``, static
weights ``1/deg_type[receiver]`` (the per-relation mean), built with
``max_dst = node_budget`` so that its forward writes ``node_budget`` rows.
Both graphs carry both row splits, built on the host beside the arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
from efficient_gnns_tpu_torch.native import host as _native


class SaintSubgraph(NamedTuple):
    graph: Graph  # padded, receiver-sorted, with edge_type when typed
    node_ids: np.ndarray  # int64 [node_budget] global ids (0 for padding)
    num_nodes: int  # valid node count
    dropped_edges: int  # edges over the budget (0 in practice)
    typed_graph: Optional[Graph] = None  # the typed square layout


class GraphSaintRandomWalkSampler:
    def __init__(
        self,
        senders: np.ndarray,
        receivers: np.ndarray,
        num_nodes: int,
        batch_size: int,
        walk_length: int,
        edge_budget: Optional[int] = None,
        edge_type: Optional[np.ndarray] = None,
        num_edge_types: int = 0,
        seed: int = 0,
        typed_square: bool = False,
    ):
        """``typed_square=True`` builds the typed square graph of every
        sample (needs ``edge_type``)."""
        self.num_nodes = int(num_nodes)
        self.batch_size = int(batch_size)
        self.walk_length = int(walk_length)
        self.node_budget = self.batch_size * (self.walk_length + 1)
        self.edge_type = None if edge_type is None else np.asarray(edge_type)
        self.num_edge_types = num_edge_types
        self.typed_square = bool(typed_square)
        if self.typed_square and self.edge_type is None:
            raise ValueError("typed_square requires edge_type")
        self.rng = np.random.default_rng(seed)

        # CSR over senders (out-adjacency) for the walk
        order = np.argsort(senders, kind="stable")
        self._nbr = np.asarray(receivers)[order]
        counts = np.bincount(np.asarray(senders), minlength=num_nodes)
        self._offsets = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=self._offsets[1:])
        self._deg = counts.astype(np.int64)
        # the native walker's int32 copies, made once
        self._offsets32 = self._offsets.astype(np.int32)
        self._nbr32 = self._nbr.astype(np.int32)

        # receiver CSR for the induced-subgraph extraction
        r = np.asarray(receivers)
        self._in_eid = np.argsort(r, kind="stable")
        counts_r = np.bincount(r, minlength=num_nodes)
        self._in_offsets = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts_r, out=self._in_offsets[1:])

        self._senders = np.asarray(senders)
        if edge_budget is None:
            # average degree * node budget * 2
            avg_deg = max(1.0, len(senders) / max(num_nodes, 1))
            edge_budget = int(avg_deg * self.node_budget * 2)
        self.edge_budget = ((edge_budget + 1023) // 1024) * 1024

    def _random_walk(self) -> np.ndarray:
        """The sorted distinct nodes of ``batch_size`` walks; dead ends stay
        in place. The native walker where it is built, else NumPy."""
        roots = self.rng.integers(0, self.num_nodes, size=self.batch_size)
        if _native.available():
            walks = _native.random_walks(
                self._offsets32, self._nbr32, roots.astype(np.int32), self.walk_length,
                seed=int(self.rng.integers(0, 2**63 - 1)))
            return np.unique(walks)
        cur = roots
        visited = [cur]
        for _ in range(self.walk_length):
            deg = self._deg[cur]
            r = self.rng.integers(0, np.maximum(deg, 1))
            nxt = np.where(
                deg > 0, self._nbr[self._offsets[cur] + np.minimum(r, deg - 1)], cur
            )
            visited.append(nxt)
            cur = nxt
        return np.unique(np.concatenate(visited))

    def sample(self) -> SaintSubgraph:
        """One padded subgraph on the CPU."""
        nodes = self._random_walk()
        k = len(nodes)
        # induced edges: the in-edges of sampled nodes whose sender is sampled
        starts, ends = self._in_offsets[nodes], self._in_offsets[nodes + 1]
        lens = ends - starts
        total = int(lens.sum())
        cand_dst = np.repeat(nodes, lens)
        pos = (
            np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(lens) - lens, lens)
            + np.repeat(starts, lens)
        )
        cand_eid = self._in_eid[pos]
        cand_src = self._senders[cand_eid]
        relabel = np.full(self.num_nodes, -1, dtype=np.int64)
        relabel[nodes] = np.arange(k, dtype=np.int64)
        keep = relabel[cand_src] >= 0
        eid = cand_eid[keep]
        s_loc = relabel[cand_src[keep]]
        r_loc = relabel[cand_dst[keep]]

        dropped = 0
        if len(eid) > self.edge_budget:
            dropped = len(eid) - self.edge_budget
            sel = self.rng.choice(len(eid), self.edge_budget, replace=False)
            eid, s_loc, r_loc = eid[sel], s_loc[sel], r_loc[sel]

        et = None if self.edge_type is None else self.edge_type[eid]
        nb, nr = self.node_budget, self.num_edge_types
        graph = build_graph(
            s_loc, r_loc, num_nodes=k, edge_type=et, num_edge_types=nr,
            pad_nodes_to=nb, pad_edges_to=self.edge_budget, n_node_valid=k,
        )
        typed_graph = None
        if self.typed_square:
            # per-(relation, receiver) in-degree: the mean as static weights
            # (reference mag_pyg/gnn.py:54-65, a scatter-mean per relation)
            cell = et.astype(np.int64) * nb + r_loc
            deg = np.bincount(cell, minlength=nr * nb)
            w = 1.0 / np.maximum(deg[cell], 1)
            typed_graph = build_graph(
                s_loc + et.astype(np.int64) * nb, r_loc, num_nodes=nr * nb,
                edge_weight=w, pad_edges_to=self.edge_budget, n_node_valid=k, max_dst=nb,
            )
        node_ids = np.zeros(nb, dtype=np.int64)
        node_ids[:k] = nodes
        return SaintSubgraph(graph=graph, node_ids=node_ids, num_nodes=k,
                             dropped_edges=dropped, typed_graph=typed_graph)
