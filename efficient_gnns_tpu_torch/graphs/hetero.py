"""Heterogeneous graph grouping: ogbn-mag preprocessing (counterpart of
``efficient_gnns_tpu/graphs/hetero.py``, NumPy only).

The semantics of PyG's ``group_hetero_graph`` as used by the
reference (``mag_pyg/gnn.py:346-357``): all node types are packed into one
global id space (offset per type), producing a single typed edge list plus
per-node type/local-index vectors. The reference's MAG-specific steps —
adding reverse relations for writes/affiliated_with/has_topic and making
cites undirected (``mag_pyg/gnn.py:322-334``) — live in ``mag_preprocess``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np


class GroupedHetero(NamedTuple):
    edge_index: np.ndarray  # int64 [2, E] global ids
    edge_type: np.ndarray  # int32 [E]
    node_type: np.ndarray  # int32 [N_total]
    local_node_idx: np.ndarray  # int64 [N_total]
    local2global: Dict[str, np.ndarray]  # node-type key -> global ids
    key2int: Dict  # node-type key AND edge-type key -> canonical int


def group_hetero_graph(
    edge_index_dict: Dict[Tuple[str, str, str], np.ndarray],
    num_nodes_dict: Dict[str, int],
) -> GroupedHetero:
    node_types = sorted(num_nodes_dict.keys())
    key2int: Dict = {}
    offsets: Dict[str, int] = {}
    local2global: Dict[str, np.ndarray] = {}
    cursor = 0
    for i, nt in enumerate(node_types):
        key2int[nt] = i
        offsets[nt] = cursor
        n = int(num_nodes_dict[nt])
        local2global[nt] = np.arange(cursor, cursor + n, dtype=np.int64)
        cursor += n
    total = cursor

    node_type = np.zeros(total, dtype=np.int32)
    local_node_idx = np.zeros(total, dtype=np.int64)
    for nt in node_types:
        g = local2global[nt]
        node_type[g] = key2int[nt]
        local_node_idx[g] = np.arange(len(g), dtype=np.int64)

    edge_keys = sorted(edge_index_dict.keys())
    srcs, dsts, types = [], [], []
    for j, ek in enumerate(edge_keys):
        key2int[ek] = j
        src_t, _, dst_t = ek
        ei = np.asarray(edge_index_dict[ek])
        srcs.append(ei[0] + offsets[src_t])
        dsts.append(ei[1] + offsets[dst_t])
        types.append(np.full(ei.shape[1], j, dtype=np.int32))

    edge_index = np.stack(
        [np.concatenate(srcs), np.concatenate(dsts)], axis=0
    ).astype(np.int64)
    edge_type = np.concatenate(types)
    return GroupedHetero(
        edge_index, edge_type, node_type, local_node_idx, local2global, key2int
    )


def mag_preprocess(
    edge_index_dict: Dict[Tuple[str, str, str], np.ndarray],
    num_nodes_dict: Dict[str, int],
) -> GroupedHetero:
    """Reference MAG relation augmentation (``mag_pyg/gnn.py:322-334``):
    reverse relations for affiliated_with / writes / has_topic, undirected
    cites — 7 edge types total."""
    d = dict(edge_index_dict)
    aff = np.asarray(d[("author", "affiliated_with", "institution")])
    d[("institution", "to", "author")] = aff[::-1].copy()
    wr = np.asarray(d[("author", "writes", "paper")])
    d[("paper", "to", "author")] = wr[::-1].copy()
    ht = np.asarray(d[("paper", "has_topic", "field_of_study")])
    d[("field_of_study", "to", "paper")] = ht[::-1].copy()
    cites = np.asarray(d[("paper", "cites", "paper")])
    und = np.concatenate([cites, cites[::-1]], axis=1)
    und = np.unique(und.T, axis=0).T
    d[("paper", "cites", "paper")] = und
    return group_hetero_graph(d, num_nodes_dict)
