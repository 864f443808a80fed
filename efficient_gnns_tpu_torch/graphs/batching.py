"""Pad-and-mask batching of small graphs (counterpart of
``efficient_gnns_tpu/graphs/batching.py``).

A batch of molecules becomes ONE padded :class:`Graph` whose node ids are
offset per graph, padded to the node, edge and graph counts the caller gives
(``data/molhiv.py::MolBatcher``'s budgets). NumPy on the host; the result
lies on the CPU and moves with ``BatchedGraphs.to``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.graphs.container import BatchedGraphs
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
from efficient_gnns_tpu_torch.graphs.row_split import build_row_split, record_pair


def pack_graphs(
    graphs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
    *,
    pad_nodes_to: int,
    pad_edges_to: int,
    pad_graphs_to: Optional[int] = None,
    edge_payloads: Optional[Sequence[np.ndarray]] = None,
    self_loops: bool = False,
) -> Tuple[BatchedGraphs, np.ndarray, Optional[np.ndarray]]:
    """Pack ``(senders, receivers, num_nodes)`` triples into one padded batch.

    Returns ``(batch, node_offsets, packed_payloads)`` as the JAX function
    does: ``node_offsets[k]`` (int64[len(graphs) + 1]) is the node-id offset
    of graph k; ``packed_payloads`` is the per-edge payload re-sorted into
    the packed graph's receiver-sorted edge order (a stable sort, so
    duplicate edges keep their order) and zero-padded to ``pad_edges_to``
    rows, or None. Raises ``ValueError`` when a budget is too small.
    """
    num_graphs = len(graphs)
    g_pad = pad_graphs_to or num_graphs
    if g_pad < num_graphs:
        raise ValueError("pad_graphs_to too small")

    sizes = np.array([n for _, _, n in graphs], dtype=np.int64)
    offsets = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    total_nodes = int(offsets[-1])
    if pad_nodes_to < total_nodes:
        raise ValueError(f"pad_nodes_to={pad_nodes_to} < total nodes {total_nodes}")

    senders = np.concatenate(
        [np.asarray(s, np.int64) + offsets[k] for k, (s, _, _) in enumerate(graphs)])
    receivers = np.concatenate(
        [np.asarray(r, np.int64) + offsets[k] for k, (_, r, _) in enumerate(graphs)])
    payload = None
    if edge_payloads is not None:
        payload = np.concatenate([np.asarray(p) for p in edge_payloads], axis=0)

    if self_loops:
        if payload is not None:
            raise ValueError("self_loops with edge payloads unsupported")
        loop = np.arange(total_nodes, dtype=np.int64)
        senders = np.concatenate([senders, loop])
        receivers = np.concatenate([receivers, loop])

    packed_payload = None
    if payload is not None:
        # build_graph's receiver-sorted order (ties by sender), stable
        order = np.lexsort((senders, receivers))
        packed_payload = np.zeros((pad_edges_to,) + payload.shape[1:], payload.dtype)
        packed_payload[: order.shape[0]] = payload[order]

    graph = build_graph(senders, receivers, total_nodes, pad_nodes_to=pad_nodes_to,
                        pad_edges_to=pad_edges_to, n_node_valid=total_nodes)

    node_graph_ids = np.full(pad_nodes_to, g_pad, dtype=np.int32)
    node_graph_ids[:total_nodes] = np.repeat(np.arange(num_graphs, dtype=np.int32), sizes)
    graph_offsets = np.full(g_pad + 1, total_nodes, dtype=np.int32)
    graph_offsets[: num_graphs + 1] = offsets
    graph_offsets = torch.from_numpy(graph_offsets)
    split = build_row_split(graph_offsets)
    record_pair(split, graph_offsets)
    batch = BatchedGraphs(
        graph=graph,
        node_graph_ids=torch.from_numpy(node_graph_ids),
        n_graph=num_graphs,
        num_graphs=g_pad,
        graph_offsets=graph_offsets,
        graph_split=split,
        graph_mask=torch.arange(g_pad) < num_graphs,
        ident=torch.arange(max(pad_nodes_to, graph.num_edges_padded), dtype=torch.int32),
    )
    return batch, offsets, packed_payload


def pack_node_features(feats: Sequence[np.ndarray], pad_nodes_to: int) -> np.ndarray:
    """Concatenate per-graph node feature matrices and zero-pad rows."""
    cat = np.concatenate([np.asarray(f) for f in feats], axis=0)
    out = np.zeros((pad_nodes_to,) + cat.shape[1:], cat.dtype)
    out[: cat.shape[0]] = cat
    return out
