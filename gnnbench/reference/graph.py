"""The graph as the configurations define it, from the raw edge list.

``arxiv_graph`` makes the edge list bidirected, removes duplicates and self
loops, adds one self loop a node, and orders the edges by (receiver,
sender): an edge's place in that order is its CSR id, which the hub path's
edge-drop hash reads. The hub partition (``hub_partition``) is the
``--no-attn-dst`` teacher's: the top out-degree senders, then the top
in-degree receivers of the other edges (the hub-dense layout's rule),
down to NumPy's ``argpartition`` for the choice among equal counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
SALT_RESIDUAL, SALT_HUB_SRC, SALT_HUB_DST = 0x5EED, 0x51, 0xD5


@dataclasses.dataclass
class HubEdges:
    """Hub membership of each edge in CSR order: ``kind`` 0 residual, 1 hub
    sender, 2 hub receiver; ``row`` / ``col`` the cell of the hub grid that
    a hub edge hashes."""

    kind: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor


@dataclasses.dataclass
class RefGraph:
    senders: torch.Tensor  # int64[E], CSR order
    receivers: torch.Tensor  # int64[E]
    num_nodes: int
    in_deg: torch.Tensor  # float32[N]
    out_deg: torch.Tensor  # float32[N]
    norm: Optional[torch.Tensor] = None  # float32[E] d_r^-1/2 d_s^-1/2
    hub: Optional[HubEdges] = None

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])


def arxiv_graph(senders: np.ndarray, receivers: np.ndarray, num_nodes: int, device,
                gcn_norm: bool = False, hub_width=0) -> RefGraph:
    """Bidirected, deduplicated, one self loop a node, in CSR order;
    ``hub_width`` ``"auto"`` takes :func:`auto_hub_width`."""
    n = int(num_nodes)
    s = torch.as_tensor(np.asarray(senders, np.int64), device=device)
    r = torch.as_tensor(np.asarray(receivers, np.int64), device=device)
    pairs = torch.unique(torch.cat([s * n + r, r * n + s]))
    s, r = pairs // n, pairs % n
    keep = s != r
    loop = torch.arange(n, device=device)
    s, r = torch.cat([s[keep], loop]), torch.cat([r[keep], loop])
    order = torch.argsort(r * n + s)
    s, r = s[order], r[order]
    in_deg = torch.bincount(r, minlength=n)
    out_deg = torch.bincount(s, minlength=n)
    g = RefGraph(s, r, n, in_deg.float(), out_deg.float())
    if gcn_norm:
        inv = torch.where(in_deg > 0, 1.0 / torch.sqrt(in_deg.double().clamp_min(1.0)), 0.0)
        g.norm = (inv[s] * inv[r]).float()
    if hub_width == "auto":
        hub_width = auto_hub_width(n, g.num_edges)
    if hub_width:
        g.hub = hub_partition(s.cpu().numpy(), r.cpu().numpy(), n, hub_width, device)
    return g


def auto_hub_width(num_nodes: int, num_edges: int) -> int:
    """The hub width of an unweighted attention graph: 512 where dense
    slices of 2 x 512 bfloat16 columns a node fit 600 MiB, else 256 where
    those fit, and none below 200k edges."""
    if num_edges < 200_000:
        return 0
    for h in (512, 256):
        if num_nodes * 2 * h * 2 <= 600 * 1024 * 1024:
            return h
    return 0


def _top_k(counts: np.ndarray, k: int) -> np.ndarray:
    k = min(k, counts.shape[0])
    idx = np.argpartition(-counts, k - 1)[:k]
    return idx[np.lexsort((idx, -counts[idx]))]


def hub_partition(s: np.ndarray, r: np.ndarray, n: int, width: int, device) -> HubEdges:
    hub_src = _top_k(np.bincount(s, minlength=n), width)
    is_src = np.zeros(n, bool)
    is_src[hub_src] = True
    src_edge = is_src[s]
    hub_dst = _top_k(np.bincount(r[~src_edge], minlength=n), width)
    is_dst = np.zeros(n, bool)
    is_dst[hub_dst] = True
    dst_edge = ~src_edge & is_dst[r]
    local_s = np.zeros(n, np.int64)
    local_s[hub_src] = np.arange(hub_src.shape[0])
    local_d = np.zeros(n, np.int64)
    local_d[hub_dst] = np.arange(hub_dst.shape[0])
    kind = np.where(src_edge, 1, np.where(dst_edge, 2, 0))
    row = np.where(src_edge, r, np.where(dst_edge, local_d[r], 0))
    col = np.where(src_edge, local_s[s], np.where(dst_edge, s, 0))

    def t(a):
        return torch.as_tensor(a.astype(np.int64), device=device)

    return HubEdges(t(kind), t(row), t(col))


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 tensors holding uint32 values."""
    x = x & M32
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def edge_keep(g: RefGraph, seed: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """float32[E] 0/1 edge-drop weights of the hub path for the uint32
    ``seed``: a residual edge hashes its CSR id, a hub edge its grid cell,
    the row first and the column folded in with a second round."""
    thresh = min(int(keep_prob * 2.0**32), 2**32 - 1)
    eid = torch.arange(g.num_edges, device=g.senders.device)
    residual = hash_u32(eid ^ ((seed + SALT_RESIDUAL) & M32))
    hub = g.hub
    salt = torch.where(hub.kind == 1, SALT_HUB_SRC, SALT_HUB_DST)
    cell = hash_u32(hash_u32(hub.row ^ ((seed + salt) & M32)) ^ hub.col)
    return (torch.where(hub.kind == 0, residual, cell) < thresh).float()
