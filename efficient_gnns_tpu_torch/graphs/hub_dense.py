"""The hub partition of a graph's edges (counterpart of
``efficient_gnns_tpu/graphs/hub_dense.py``).

The JAX package splits the adjacency ``A = R + S + D``: ``S`` the edges whose
*sender* is one of the top ``h_src`` out-degree nodes, ``D`` the remaining
edges whose *receiver* is one of the top ``h_dst`` in-degree nodes (both as
dense slices for the TPU's matrix unit), ``R`` the residual. The port keeps
the partition and none of the dense slices: on the H100 every edge runs
through the CSR kernels, whose row split already balances hub rows. What the
partition still decides is the edge-drop of the hub attention path
(``ops/hub_attention.py``): a residual edge is masked by a hash of its CSR
id, a hub edge by a hash of its cell in the hub grid. So the record holds
exactly the index arrays that ``build_hub_dense`` records, built by the same
NumPy code, and not the slices ``m_src`` / ``m_dst``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HubPartition:
    """The hub edges of a graph, by their place in its CSR edge order.

    Attributes:
      hub_src: int32[Hs] hub sender node ids (top out-degree, ties by id).
      hub_dst: int32[Hd] hub receiver node ids (top in-degree of the edges
        left after ``S``).
      src_eids, src_rows, src_cols: int32[Ehs] CSR index, receiver and
        hub-local sender column of each ``S`` edge.
      dst_eids, dst_rows, dst_cols: int32[Ehd] CSR index, hub-local receiver
        row and sender of each ``D`` edge.
      transposed: set by ``Graph.transpose()``; the hub attention path
        refuses such a graph, as the JAX path refuses ``HubDense.transposed``.
    """

    hub_src: torch.Tensor
    hub_dst: torch.Tensor
    src_eids: torch.Tensor
    src_rows: torch.Tensor
    src_cols: torch.Tensor
    dst_eids: torch.Tensor
    dst_rows: torch.Tensor
    dst_cols: torch.Tensor
    transposed: bool = False

    def to(self, device) -> "HubPartition":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "transposed"})

    def transpose(self) -> "HubPartition":
        return dataclasses.replace(self, transposed=not self.transposed)


def _top_k(counts: np.ndarray, k: int) -> np.ndarray:
    """Top-k ids by count, deterministic (ties broken by node id)."""
    k = min(k, counts.shape[0])
    idx = np.argpartition(-counts, k - 1)[:k]
    return idx[np.lexsort((idx, -counts[idx]))].astype(np.int32)


def partition_hub_edges(
    s_csr: np.ndarray,
    r_csr: np.ndarray,
    num_nodes: int,
    h_src: int = 256,
    h_dst: int = 256,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split CSR-ordered edges into (S, D, residual) by hub membership.

    Returns ``(hub_src_ids, hub_dst_ids, src_mask, dst_mask)``; the residual
    mask is ``~(src_mask | dst_mask)``.
    """
    cnt_s = np.bincount(s_csr, minlength=num_nodes)
    hub_src = _top_k(cnt_s, h_src)
    is_hs = np.zeros(num_nodes, bool)
    is_hs[hub_src] = True
    src_mask = is_hs[s_csr]
    cnt_r = np.bincount(r_csr[~src_mask], minlength=num_nodes)
    hub_dst = _top_k(cnt_r, h_dst)
    is_hd = np.zeros(num_nodes, bool)
    is_hd[hub_dst] = True
    dst_mask = ~src_mask & is_hd[r_csr]
    return hub_src, hub_dst, src_mask, dst_mask


def build_hub_partition(s_csr: np.ndarray, r_csr: np.ndarray, num_nodes: int,
                        h_src: int = 256, h_dst: int = 256) -> HubPartition:
    """The :class:`HubPartition` of host CSR-ordered edges (on the CPU), with
    the index arrays of the JAX ``build_hub_dense``."""
    hub_src, hub_dst, src_mask, dst_mask = partition_hub_edges(
        s_csr, r_csr, num_nodes, h_src, h_dst)
    hl_s = np.zeros(num_nodes, np.int64)
    hl_s[hub_src] = np.arange(hub_src.shape[0])
    hl_d = np.zeros(num_nodes, np.int64)
    hl_d[hub_dst] = np.arange(hub_dst.shape[0])
    src_eids = np.nonzero(src_mask)[0]
    dst_eids = np.nonzero(dst_mask)[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    return HubPartition(
        hub_src=t(hub_src), hub_dst=t(hub_dst),
        src_eids=t(src_eids), src_rows=t(r_csr[src_eids]), src_cols=t(hl_s[s_csr[src_eids]]),
        dst_eids=t(dst_eids), dst_rows=t(hl_d[r_csr[dst_eids]]), dst_cols=t(s_csr[dst_eids]),
    )


def auto_hub_size(
    num_nodes_padded: int,
    num_edges: int,
    budget_bytes: int = 600 * 1024 * 1024,
    min_edges: int = 200_000,
    itemsize: int = 2,
    widths=(512, 256),
) -> int:
    """The JAX package's default hub width: the widest of ``widths`` whose
    dense slices (``2 * width`` columns of ``itemsize`` bytes a node) would
    fit ``budget_bytes``, and 0 below ``min_edges`` edges. The port builds no
    slices; the width only decides which edges the hub masks cover, so it
    follows the same rule to draw the same keep sets."""
    if num_edges < min_edges:
        return 0
    for h in widths:
        if num_nodes_padded * (2 * h) * itemsize <= budget_bytes:
            return h
    return 0
