"""Host-side graph construction (counterpart of
``efficient_gnns_tpu/graphs/preprocess.py``).

NumPy preprocessing that turns a raw COO edge list into a receiver-sorted,
padded :class:`Graph` with both CSR offset arrays. The sort and dedup use the
NumPy forms of the JAX package's native helpers (``np.lexsort`` and
``np.unique``), which give the identical edge order.

Not ported here: the Pallas edge blockings and the hub-dense slices (TPU
layouts; the CUDA kernels walk CSR over all edges, with the long rows cut
into chunks by ``graphs/row_split.py``). ``max_dst`` is the counterpart of
their ``block_max_dst``.
The hub partition itself is built (``hub_dense``), because it decides the
edge-drop masks of the hub attention path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.graphs.hub_dense import auto_hub_size, build_hub_partition
from efficient_gnns_tpu_torch.graphs.row_split import build_row_split, record_pair
from efficient_gnns_tpu_torch.tracing import span


def pad_length(n: int, multiple: int = 128) -> int:
    """Round ``n`` up to a multiple."""
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def to_bidirected(
    senders: np.ndarray, receivers: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Add reverse edges and deduplicate (DGL ``to_bidirected`` semantics);
    the result is sorted by (sender, receiver)."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    edges = np.unique(np.stack([s, r], axis=1), axis=0)
    return edges[:, 0], edges[:, 1]


def add_self_loops(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Remove existing self loops, then add one per node."""
    keep = senders != receivers
    loop = np.arange(num_nodes, dtype=senders.dtype)
    return (
        np.concatenate([senders[keep], loop]),
        np.concatenate([receivers[keep], loop]),
    )


def _lexsort_edges(senders: np.ndarray, receivers: np.ndarray) -> np.ndarray:
    """Stable permutation sorting edges by (receiver, sender)."""
    return np.lexsort((senders, receivers))


def _csr_offsets(sorted_rows: np.ndarray, num_rows: int) -> np.ndarray:
    """CSR offsets over an ascending row-id array (padding ids >= num_rows)."""
    sorted_rows = np.asarray(sorted_rows, dtype=np.int64)
    counts = np.bincount(sorted_rows[sorted_rows < num_rows], minlength=num_rows)
    offsets = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return offsets


def build_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    edge_type: Optional[np.ndarray] = None,
    num_edge_types: int = 0,
    bidirected: bool = False,
    self_loops: bool = False,
    pad_nodes_to: Optional[int] = None,
    pad_edges_to: Optional[int] = None,
    edge_pad_multiple: int = 1024,
    n_node_valid: Optional[int] = None,
    gcn_norm: bool = False,
    hub_dense=0,
    max_dst: Optional[int] = None,
) -> Graph:
    """Build a :class:`Graph` on the CPU from a raw COO edge list.

    Sorts edges by receiver (ties by sender), materializes the transpose
    order, both CSR offset arrays and their row splits, and pads the edge
    list to a static length with out-of-range sentinels. Move the result
    with ``.to(device)``. Each row split is recorded as the split of its
    offsets (``graphs/row_split.py::record_pair``), so the kernels take it
    without rebuilding it.

    Args:
      edge_type: optional int[E] relation id per edge, ordered with the
        edges; padding entries get ``num_edge_types``.
      pad_nodes_to: node-dimension size (defaults to ``num_nodes``).
      pad_edges_to: edge count; defaults to the edge count rounded up to
        ``edge_pad_multiple``.
      n_node_valid: number of valid nodes (defaults to ``num_nodes``).
      gcn_norm: attach the symmetric GCN normalization
        ``d_r^-1/2 * d_s^-1/2`` as ``edge_weight`` (the JAX package's fused
        mode). The string ``"factored"`` instead stores the per-node scale
        ``d^-1/2`` as ``Graph.node_scale`` and keeps the adjacency
        unweighted: ``spmm`` then computes ``S (A (S x))``, the same math.
      hub_dense: hub width of the hub partition (``graphs/hub_dense.py``),
        or 0 for none. ``"auto"`` takes the JAX package's rule
        (``graphs/preprocess.py`` there): 0 below 200k edges, else 512 for a
        graph without static weights or factored scales (an attention
        graph) and 256 otherwise, as far as the dense slices the JAX package
        builds would fit its memory budget. The JAX default ``"auto"``
        applies only with ``block=True`` there, hence 0 here; the synthetic
        dataset passes ``"auto"``.
      max_dst: every receiver lies below it (raises otherwise); the graph
        then carries ``dst_row_split``, the row split of
        ``row_offsets[:max_dst + 1]`` (the tall typed R-GCN layout).

    Spans (``tracing.py``): ``graph.build`` around the whole, and inside it
    ``graph.sort`` (bidirection, self loops, both edge orders),
    ``graph.hub_partition`` and ``graph.row_split``.
    """
    with span("graph.build"):
        senders = np.asarray(senders, dtype=np.int64)
        receivers = np.asarray(receivers, dtype=np.int64)
        with span("graph.sort"):
            if bidirected:
                if edge_weight is not None or edge_type is not None:
                    raise ValueError("bidirected=True incompatible with edge payloads")
                senders, receivers = to_bidirected(senders, receivers)
            if self_loops:
                if edge_weight is not None or edge_type is not None:
                    raise ValueError("self_loops=True incompatible with edge payloads")
                senders, receivers = add_self_loops(senders, receivers, num_nodes)

            n_pad = int(pad_nodes_to) if pad_nodes_to is not None else int(num_nodes)
            if n_pad < num_nodes:
                raise ValueError(f"pad_nodes_to={n_pad} < num_nodes={num_nodes}")
            e = senders.shape[0]
            e_pad = (
                int(pad_edges_to) if pad_edges_to is not None
                else pad_length(e, edge_pad_multiple)
            )
            if e_pad < e:
                raise ValueError(f"pad_edges_to={e_pad} < num_edges={e}")
            if e_pad >= 2**31 or n_pad >= 2**31:
                raise ValueError(f"int32 indices cannot address {e_pad} edges / {n_pad} nodes")

            csr_order = _lexsort_edges(senders, receivers)
            s_csr = senders[csr_order]
            r_csr = receivers[csr_order]
            csc_perm = _lexsort_edges(r_csr, s_csr)
            t_s = r_csr[csc_perm]
            t_r = s_csr[csc_perm]

        def _pad_idx(a: np.ndarray) -> torch.Tensor:
            out = np.full(e_pad, n_pad, dtype=np.int32)
            out[:e] = a
            return torch.from_numpy(out)

        pad_perm = np.arange(e_pad, dtype=np.int32)
        pad_perm[:e] = csc_perm

        ew = node_scale = None
        if edge_weight is not None:
            ew = np.zeros(e_pad, dtype=np.float32)
            ew[:e] = np.asarray(edge_weight, dtype=np.float32)[csr_order]
        if gcn_norm:
            if ew is not None:
                raise ValueError("gcn_norm=True incompatible with edge_weight")
            deg = np.bincount(r_csr, minlength=n_pad).astype(np.float64)
            inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
            if gcn_norm == "factored":
                node_scale = inv_sqrt.astype(np.float32)
            else:
                ew = np.zeros(e_pad, dtype=np.float32)
                ew[:e] = (inv_sqrt[s_csr] * inv_sqrt[r_csr]).astype(np.float32)

        et = None
        if edge_type is not None:
            et = np.full(e_pad, num_edge_types, dtype=np.int32)
            et[:e] = np.asarray(edge_type, dtype=np.int32)[csr_order]
        if max_dst is not None and e and int(r_csr[-1]) >= max_dst:
            raise ValueError(f"max_dst={max_dst} but a receiver is {int(r_csr[-1])}")

        h = (auto_hub_size(n_pad, e, itemsize=2 if ew is None else 4,
                           widths=(512, 256) if ew is None and node_scale is None else (256,))
             if hub_dense == "auto" else int(hub_dense))
        with span("graph.hub_partition"):
            hub = build_hub_partition(s_csr, r_csr, num_nodes, h, h) if h > 0 else None

        n_valid = num_nodes if n_node_valid is None else n_node_valid
        row_offsets = _csr_offsets(r_csr, n_pad)
        t_row_offsets = _csr_offsets(t_r, n_pad)
        with span("graph.row_split"):
            row_split = build_row_split(row_offsets)
            t_row_split = build_row_split(t_row_offsets)
            dst_row_split = (None if max_dst is None
                             else build_row_split(row_offsets[:max_dst + 1]))
        graph = Graph(
            senders=_pad_idx(s_csr),
            receivers=_pad_idx(r_csr),
            t_senders=_pad_idx(t_s),
            t_receivers=_pad_idx(t_r),
            csc_perm=torch.from_numpy(pad_perm),
            row_offsets=torch.from_numpy(row_offsets),
            t_row_offsets=torch.from_numpy(t_row_offsets),
            node_mask=torch.arange(n_pad) < n_valid,
            num_nodes=n_pad,
            n_edge=e,
            edge_weight=None if ew is None else torch.from_numpy(ew),
            t_edge_weight=None if ew is None else torch.from_numpy(ew[pad_perm]),
            node_scale=None if node_scale is None else torch.from_numpy(node_scale),
            row_split=row_split,
            t_row_split=t_row_split,
            hub=hub,
            edge_type=None if et is None else torch.from_numpy(et),
            num_edge_types=int(num_edge_types),
            max_dst=None if max_dst is None else int(max_dst),
            dst_row_split=dst_row_split,
        )
        record_pair(graph.row_split, graph.row_offsets)
        record_pair(graph.t_row_split, graph.t_row_offsets)
        if graph.dst_row_split is not None:
            record_pair(graph.dst_row_split, graph.row_offsets)
        return graph


def induced_subgraph(
    senders: np.ndarray,
    receivers: np.ndarray,
    node_ids: np.ndarray,
    **build_kwargs,
) -> Graph:
    """Node-induced subgraph with relabeled, contiguous node ids (PyG
    ``subgraph(..., relabel_nodes=True)`` semantics: the train subgraph of
    the LSP and edge-conditioned modes). The order of ``node_ids`` defines
    the new labels."""
    node_ids = np.asarray(node_ids)
    n_total = int(max(senders.max(), receivers.max())) + 1 if len(senders) else 0
    n_total = max(n_total, int(node_ids.max()) + 1 if len(node_ids) else 0)
    relabel = np.full(n_total, -1, dtype=np.int64)
    relabel[node_ids] = np.arange(len(node_ids), dtype=np.int64)
    s = relabel[senders]
    r = relabel[receivers]
    keep = (s >= 0) & (r >= 0)
    return build_graph(s[keep], r[keep], len(node_ids), **build_kwargs)


def gcn_norm_weights(graph: Graph) -> Graph:
    """A copy of ``graph`` with the symmetric GCN normalization weights
    ``d_r^-1/2 * d_s^-1/2`` attached in both edge orders (0 on padding
    edges). Assumes self loops are already present if desired."""
    deg = graph.in_degrees()
    inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp_min(1.0)), 0.0)
    s = graph.senders.long().clamp_max(graph.num_nodes - 1)
    r = graph.receivers.long().clamp_max(graph.num_nodes - 1)
    w = torch.where(graph.edge_mask, inv_sqrt[s] * inv_sqrt[r], 0.0)
    return dataclasses.replace(
        graph, edge_weight=w, t_edge_weight=w[graph.csc_perm.long()])
