"""Edge-partitioned SpMM across ranks (counterpart of
``efficient_gnns_tpu/parallel/partition.py``).

Partitioning scheme, as in JAX: receiver-sorted edges are split by
destination row range. Rank ``d`` owns output rows ``[d*rows, (d+1)*rows)``
and exactly the edges pointing into them; node features are row-sharded the
same way. The host builders (:func:`partition_graph`,
:func:`partition_graph_halo`, :func:`halo_stats`) are NumPy copies of the
JAX ones and give the same arrays, bit for bit, in the same stacked
``[D, ...]`` layout with the same padding sentinels.

On the device each rank works on its own block only. :func:`local_partition`
turns the stacked arrays into this rank's CSR views, built once on the host
and moved to the rank's device: every local sum, halo sum and backward sum
of the three functions below is K1 (``ops/cuda/segment_sum.py``), one owner
per output row and no float atomics, with the view's row split attached so
that no call derives one.

* :func:`spmm_sharded`: all-gather the features, K1 into the shard's rows;
  backward K1 over the transpose CSR (senders' rows), then reduce-scatter.
* :func:`spmm_halo`: each rank gathers the boundary rows its peers read
  (``send_idx``) and exchanges them in one all-to-all, launched
  asynchronously; K1 over the local edges runs meanwhile, then K1 over the
  received halo table. The backward reverses each step: K1 over the halo
  transpose, the reverse all-to-all (asynchronous, beside K1 over the local
  transpose), and K1 over the CSR of ``send_idx``, which sums each returned
  halo gradient onto its owner row.
* :func:`spmm_halo_2level`: the same exchange over a ``(host, chip)`` mesh:
  one all-to-all within each host, then ``H - 1`` ring steps across hosts.

:class:`ShardedGraph` (:func:`shard_graph`) stands in for a ``Graph`` in the
unchanged models: ``ops.spmm`` on it is :func:`spmm_halo` over the rank's
CSRs, and its ``node_mask`` is the rank's block of the graph's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.graphs.row_split import RowSplit, build_row_split, record_pair
from efficient_gnns_tpu_torch.ops.cuda.segment_sum import csr_segment_sum
from efficient_gnns_tpu_torch.ops.sorted_segment import gather_rows_csr
from efficient_gnns_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_to_all,
    all_to_all_blocks,
    ring_shift,
)
from efficient_gnns_tpu_torch.parallel.mesh import Mesh, shard_rows

# --------------------------------------------------------------------------
# host builders (NumPy; the arrays of the JAX builders)
# --------------------------------------------------------------------------


class PartitionedGraph(NamedTuple):
    """Per-device edge partition, stacked on a leading device axis.

    senders: int32[D, E_pad] global source ids (N for padding).
    receivers_local: int32[D, E_pad] destination row *within the shard*
      (== rows_per_dev for padding).
    edge_weight: float32[D, E_pad].
    rows_per_dev, num_nodes, num_devices: statics.
    """

    senders: np.ndarray
    receivers_local: np.ndarray
    edge_weight: np.ndarray
    rows_per_dev: int
    num_nodes: int
    num_devices: int


def _effective_edge_weight(graph: Graph) -> np.ndarray:
    """Per-edge weights with a factored ``node_scale`` folded in
    (``build_graph(gcn_norm="factored")`` graphs carry the symmetric
    normalization as diagonal scales, not per-edge values)."""
    w = (graph.edge_weight.numpy() if graph.edge_weight is not None
         else graph.edge_mask.numpy().astype(np.float32))
    if graph.node_scale is not None:
        scale = graph.node_scale.numpy()
        s = np.minimum(graph.senders.numpy(), graph.num_nodes - 1)
        r = np.minimum(graph.receivers.numpy(), graph.num_nodes - 1)
        w = w * scale[s] * scale[r]
    return w


def _check_divides(n: int, d: int) -> int:
    if n % d:
        raise ValueError(f"pad num_nodes ({n}) to a multiple of the mesh size ({d})")
    return n // d


def partition_graph(graph: Graph, num_devices: int) -> PartitionedGraph:
    """Split a receiver-sorted graph (on the CPU) into ``num_devices`` row
    partitions."""
    n = graph.num_nodes
    rows = _check_divides(n, num_devices)
    senders, receivers = graph.senders.numpy(), graph.receivers.numpy()
    w = _effective_edge_weight(graph)

    valid = receivers < n
    owner = np.minimum(receivers // rows, num_devices - 1)
    counts = np.bincount(owner[valid], minlength=num_devices)
    e_pad = ((int(counts.max()) + 1023) // 1024) * 1024 if counts.max() else 1024

    s_out = np.full((num_devices, e_pad), n, dtype=np.int32)
    r_out = np.full((num_devices, e_pad), rows, dtype=np.int32)
    w_out = np.zeros((num_devices, e_pad), dtype=np.float32)
    starts = np.zeros(num_devices + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for d in range(num_devices):  # receiver-sorted: each device's edges are contiguous
        lo, hi = starts[d], starts[d + 1]
        cnt = hi - lo
        s_out[d, :cnt] = senders[lo:hi]
        r_out[d, :cnt] = receivers[lo:hi] - d * rows
        w_out[d, :cnt] = w[lo:hi]
    return PartitionedGraph(s_out, r_out, w_out, rows, n, num_devices)


class HaloPartition(NamedTuple):
    """Halo-compressed edge partition, stacked on a leading device axis.

    Device ``d`` owns output rows ``[d*rows, (d+1)*rows)``; its edges are
    split by source ownership:

    s_local: int32[D, E_loc] shard-local source row (``rows`` for padding).
    r_local: int32[D, E_loc] shard-local destination row (sorted; ``rows``
      for padding).
    w_local: float32[D, E_loc].
    s_halo: int32[D, E_halo] index into the *received halo table*
      (``owner*H + position``; ``D*H`` for padding).
    r_halo / w_halo: as above for halo edges.
    send_idx: int32[D, D, H] shard-local rows device ``d`` ships to each
      destination device (padding ``0``, a real row; the self block unused).
    rows_per_dev / halo_width / num_nodes / num_devices: statics.
    """

    s_local: np.ndarray
    r_local: np.ndarray
    w_local: np.ndarray
    s_halo: np.ndarray
    r_halo: np.ndarray
    w_halo: np.ndarray
    send_idx: np.ndarray
    rows_per_dev: int
    halo_width: int
    num_nodes: int
    num_devices: int


def _pad_to(n: int, mult: int = 1024) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def partition_graph_halo(graph: Graph, num_devices: int) -> HaloPartition:
    """Build the halo-compressed partition (host-side, once per graph).

    For every (owner o, destination d) pair the boundary set is the sorted
    unique source rows of o referenced by d's halo edges; ``halo_width`` is
    the largest boundary set rounded up to a multiple of 8, so the
    all-to-all blocks are uniform.
    """
    n = graph.num_nodes
    d_count = num_devices
    rows = _check_divides(n, d_count)
    senders, receivers = graph.senders.numpy(), graph.receivers.numpy()
    w = _effective_edge_weight(graph)
    valid = receivers < n

    owner_r = np.minimum(receivers // rows, d_count - 1)
    counts = np.bincount(owner_r[valid], minlength=d_count)
    starts = np.zeros(d_count + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    # pass 1: boundary sets and edge split sizes; need[d][o] = rows of o read by d
    need = [[None] * d_count for _ in range(d_count)]
    n_loc = np.zeros(d_count, np.int64)
    n_halo = np.zeros(d_count, np.int64)
    for d in range(d_count):
        s = senders[starts[d]:starts[d + 1]]
        owner_s = s // rows
        local = owner_s == d
        n_loc[d] = int(local.sum())
        n_halo[d] = int(s.shape[0] - n_loc[d])
        for o in range(d_count):
            if o != d:
                need[d][o] = np.unique(s[owner_s == o])
    halo_w = max([1] + [len(need[d][o]) for d in range(d_count) for o in range(d_count)
                        if o != d])
    halo_w = ((halo_w + 7) // 8) * 8
    e_loc = _pad_to(int(n_loc.max()))
    e_halo = _pad_to(int(n_halo.max()))

    s_loc = np.full((d_count, e_loc), rows, dtype=np.int32)
    r_loc = np.full((d_count, e_loc), rows, dtype=np.int32)
    w_loc = np.zeros((d_count, e_loc), dtype=np.float32)
    s_hal = np.full((d_count, e_halo), d_count * halo_w, dtype=np.int32)
    r_hal = np.full((d_count, e_halo), rows, dtype=np.int32)
    w_hal = np.zeros((d_count, e_halo), dtype=np.float32)
    send_idx = np.zeros((d_count, d_count, halo_w), dtype=np.int32)

    for d in range(d_count):
        lo, hi = starts[d], starts[d + 1]
        s = senders[lo:hi]
        r = receivers[lo:hi] - d * rows
        wv = w[lo:hi]
        owner_s = s // rows
        local = owner_s == d
        k = int(local.sum())
        s_loc[d, :k] = s[local] - d * rows
        r_loc[d, :k] = r[local]
        w_loc[d, :k] = wv[local]
        halo = ~local
        kh = int(halo.sum())
        # halo slot = owner*H + rank within the (sorted unique) boundary set
        sh = s[halo]
        oh = owner_s[halo]
        slot = np.zeros(kh, dtype=np.int64)
        for o in range(d_count):
            if o == d:
                continue
            rows_o = need[d][o]
            if rows_o is None or rows_o.size == 0:
                continue
            sel = oh == o
            slot[sel] = o * halo_w + np.searchsorted(rows_o, sh[sel])
            send_idx[o, d, :rows_o.size] = rows_o - o * rows
        s_hal[d, :kh] = slot
        r_hal[d, :kh] = r[halo]
        w_hal[d, :kh] = wv[halo]

    return HaloPartition(s_loc, r_loc, w_loc, s_hal, r_hal, w_hal, send_idx, rows, halo_w,
                         n, d_count)


def halo_stats(part: HaloPartition) -> dict:
    """Comm accounting: halo rows shipped vs the all_gather alternative."""
    d, rows = part.num_devices, part.rows_per_dev
    return {
        "halo_rows_per_device": (d - 1) * part.halo_width,
        "all_gather_rows_per_device": (d - 1) * rows,
        "compression": ((d - 1) * rows) / max(1, (d - 1) * part.halo_width),
    }


# --------------------------------------------------------------------------
# per-rank CSR views (host-built once, then on the rank's device)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Csr:
    """One K1 operand: ``out[r] = sum_e w[e] * x[src[e]]`` over
    ``e in row_offsets[r]:row_offsets[r + 1]``, with the row split of
    ``row_offsets`` (recorded as its pair). ``w`` None is an unweighted sum."""

    src: torch.Tensor
    row_offsets: torch.Tensor
    w: Optional[torch.Tensor]
    split: RowSplit

    def to(self, device) -> "Csr":
        moved = Csr(self.src.to(device), self.row_offsets.to(device),
                    None if self.w is None else self.w.to(device), self.split.to(device))
        record_pair(moved.split, moved.row_offsets)
        return moved

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return csr_segment_sum(x.contiguous(), self.src, self.row_offsets, self.w, self.split)


def _csr(row: np.ndarray, col: np.ndarray, w: Optional[np.ndarray], valid: np.ndarray,
         num_rows: int) -> Csr:
    """The CSR of the ``valid`` entries grouped by ``row`` (stable: entries
    of one row keep their order), reading ``col``."""
    row, col = row[valid].astype(np.int64), col[valid]
    order = np.argsort(row, kind="stable")
    offsets = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=num_rows), out=offsets[1:])
    offsets = offsets.astype(np.int32)
    csr = Csr(torch.from_numpy(np.ascontiguousarray(col[order], dtype=np.int32)),
              torch.from_numpy(offsets),
              None if w is None else torch.from_numpy(np.ascontiguousarray(w[valid][order])),
              build_row_split(offsets))
    record_pair(csr.split, csr.row_offsets)
    return csr


@dataclasses.dataclass
class LocalPartition:
    """This rank's block of a :class:`PartitionedGraph`: ``fwd`` (shard rows
    <- global senders) and its transpose ``bwd`` (global senders <- shard
    rows)."""

    fwd: Csr
    bwd: Csr
    rows_per_dev: int


@dataclasses.dataclass
class LocalHalo:
    """This rank's block of a :class:`HaloPartition`: the local edges
    (``local_fwd`` / ``local_bwd``), the halo edges over the received table
    of ``D * halo_width`` rows (``halo_fwd`` / ``halo_bwd``), the flat
    ``send_idx`` of the rows it ships (``[D * halo_width]``) and ``scatter``,
    the CSR that sums the returned halo gradients (``[D * halo_width, F]``,
    only the slots a peer reads) onto their owner rows."""

    local_fwd: Csr
    local_bwd: Csr
    halo_fwd: Csr
    halo_bwd: Csr
    send_idx: torch.Tensor
    scatter: Csr
    rows_per_dev: int
    halo_width: int
    num_devices: int

    @property
    def exchange_rows(self) -> int:
        """Rows this rank sends (and receives) in one exchange, the unused
        self block excluded."""
        return (self.num_devices - 1) * self.halo_width


def local_partition(mesh: Mesh, part, axis="data"):
    """This rank's CSR views of ``part`` (a :class:`PartitionedGraph` or a
    :class:`HaloPartition`) on the mesh's device; the rank is the device at
    its index along ``axis`` (a tuple such as ``("host", "chip")`` for the
    two-level exchange)."""
    d = mesh.index(axis)
    if mesh.size(axis) != part.num_devices:
        raise ValueError(f"a partition for {part.num_devices} devices on a '{axis}' axis "
                         f"of {mesh.size(axis)}")
    return _to(partition_block(part, d), mesh.device)


def partition_block(part, d: int):
    """Device ``d``'s CSR views of ``part`` on the CPU (what
    :func:`local_partition` moves to the rank's device)."""
    rows, nd = part.rows_per_dev, part.num_devices
    if isinstance(part, PartitionedGraph):
        s, r, w = part.senders[d], part.receivers_local[d], part.edge_weight[d]
        valid = r < rows
        return LocalPartition(_csr(r, s, w, valid, rows), _csr(s, r, w, valid, part.num_nodes),
                              rows)
    hw = part.halo_width
    sl, rl, wl = part.s_local[d], part.r_local[d], part.w_local[d]
    sh, rh, wh = part.s_halo[d], part.r_halo[d], part.w_halo[d]
    vl, vh = rl < rows, rh < rows
    # the slots each peer o reads of this rank's block are 0 .. count - 1
    # (its boundary set, sorted): only those get a gradient back
    slot_dest, slot_j, slot_row = [], [], []
    for o in range(nd):
        if o == d:
            continue
        read = part.s_halo[o][part.r_halo[o] < rows]
        count = int(np.unique(read[read // hw == d]).size)
        slot_dest.append(np.full(count, o))
        slot_j.append(np.arange(count))
        slot_row.append(part.send_idx[d, o, :count])
    dest = np.concatenate(slot_dest or [np.zeros(0, np.int64)])
    j = np.concatenate(slot_j or [np.zeros(0, np.int64)])
    row = np.concatenate(slot_row or [np.zeros(0, np.int32)])
    scatter = _csr(row, (dest * hw + j).astype(np.int32), None, np.ones(row.size, bool), rows)
    return LocalHalo(_csr(rl, sl, wl, vl, rows), _csr(sl, rl, wl, vl, rows),
                     _csr(rh, sh, wh, vh, rows), _csr(sh, rh, wh, vh, nd * hw),
                     torch.from_numpy(np.ascontiguousarray(part.send_idx[d].reshape(-1))),
                     scatter, rows, hw, nd)


def _to(local, device):
    for f in dataclasses.fields(local):
        v = getattr(local, f.name)
        if isinstance(v, (Csr, torch.Tensor)):
            setattr(local, f.name, v.to(device))
    return local


# --------------------------------------------------------------------------
# the differentiable SpMMs (each rank: its [rows, F] block in, float32 out)
# --------------------------------------------------------------------------


class _CsrSpMM(torch.autograd.Function):
    """``fwd(x)`` with backward ``bwd(g)``: K1 both ways."""

    @staticmethod
    def forward(ctx, x, fwd: Csr, bwd: Csr):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _check_rows(local, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != local.rows_per_dev:
        raise ValueError(f"x must be this rank's [{local.rows_per_dev}, F] block, "
                         f"got {tuple(x.shape)}")


def spmm_sharded(mesh: Mesh, local: LocalPartition, x: torch.Tensor,
                 axis: str = "data") -> torch.Tensor:
    """Distributed ``out = A @ x`` with ``x`` row-sharded over ``axis``.

    Forward: all-gather ``x`` over the axis, then K1 into the shard's rows.
    Backward: K1 over the shard's transpose CSR, then reduce-scatter of the
    senders' gradients.
    """
    _check_rows(local, x)
    full = all_gather_rows(x.float(), mesh.group(axis))
    return _CsrSpMM.apply(full, local.fwd, local.bwd)


class _SpMMHalo(torch.autograd.Function):
    """The flat halo exchange with the local sums overlapping it."""

    @staticmethod
    def forward(ctx, x, local: LocalHalo, group):
        ctx.local, ctx.group = local, group
        x = x.contiguous()
        send = x.index_select(0, local.send_idx)  # [D * H, F], block o for rank o
        table, work = all_to_all(send, group, async_op=True)
        out = local.local_fwd(x)  # no dependence on the exchange
        work.wait()
        return out + local.halo_fwd(table)

    @staticmethod
    def backward(ctx, g):
        local = ctx.local
        dtable = local.halo_bwd(g)  # [D * H, F]: the halo rows' gradients
        dsend, work = all_to_all(dtable, ctx.group, async_op=True)
        dx = local.local_bwd(g)
        work.wait()
        return dx + local.scatter(dsend), None, None


def spmm_halo(mesh: Mesh, local: LocalHalo, x: torch.Tensor,
              axis: str = "data") -> torch.Tensor:
    """Distributed ``out = A @ x`` shipping only boundary rows.

    Each rank gathers its send blocks and exchanges them in one all-to-all,
    launched before K1 over the local edges (which do not read it) and
    waited on after; then K1 over the halo edges of the received table. The
    backward reverses each step and sums the returned halo gradients onto
    their owner rows with K1 over the CSR of ``send_idx``.
    """
    _check_rows(local, x)
    return _SpMMHalo.apply(x.float(), local, mesh.group(axis))


def spmm_halo_2level(mesh: Mesh, local: LocalHalo, x: torch.Tensor,
                     host_axis: str = "host", chip_axis: str = "chip") -> torch.Tensor:
    """Two-level halo exchange over a ``(host, chip)`` mesh (the DCN x ICI
    topology of a multi-host pod; NVLink within a host and the network
    between hosts on GPUs).

    ``local`` is this rank's view of the flat :func:`partition_graph_halo`
    partition for ``H * C`` devices in host-major order ``d = host * C +
    chip`` (``local_partition(mesh, part, (host_axis, chip_axis))``). The
    boundary-row exchange is one all-to-all over ``chip_axis``, which gives
    every chip, per destination host, the blocks its whole host prepared for
    its own chip index, then ``H - 1`` ring steps over ``host_axis`` that
    carry those slabs to their hosts. Autograd reverses both (the ring steps
    shift back). The same K1 sums as :func:`spmm_halo`, so the same bits.
    """
    _check_rows(local, x)
    hosts, chips = mesh.size(host_axis), mesh.size(chip_axis)
    if hosts * chips != local.num_devices:
        raise ValueError(f"a ({hosts}, {chips}) mesh for a partition of "
                         f"{local.num_devices} devices")
    x = x.float()
    hw, f = local.halo_width, x.shape[1]
    scatter = local.scatter
    send = gather_rows_csr(x, local.send_idx, scatter.row_offsets, scatter.src, scatter.split)
    # [C, H, hw, F]: block j goes to chip j of this host; after the exchange
    # a2a[h', j] = the block (my host, chip j) prepared for (h', my chip)
    send = send.view(hosts, chips, hw, f).transpose(0, 1).contiguous()
    a2a = all_to_all_blocks(send, mesh.group(chip_axis)).transpose(0, 1)
    my_h = mesh.index(host_axis)
    recv = [None] * hosts  # recv[h] = the rows the chips of host h shipped here
    recv[my_h] = a2a[my_h]
    for k in range(1, hosts):
        # ring step k: host h sends host h + k's slab; this host gets host h - k's
        blk = a2a[(my_h + k) % hosts].contiguous()
        recv[(my_h - k) % hosts] = ring_shift(blk, mesh.group(host_axis), k)
    out = _CsrSpMM.apply(x, local.local_fwd, local.local_bwd)
    table = torch.stack(recv).reshape(local.num_devices * hw, f)
    return out + _CsrSpMM.apply(table, local.halo_fwd, local.halo_bwd)


@dataclasses.dataclass
class ShardedGraph:
    """This rank's row block of a graph partitioned by
    :func:`partition_graph_halo`, in the place of a ``Graph``: ``ops.spmm``
    on it is :func:`spmm_halo` over ``local`` along ``axis`` of ``mesh``, so
    ``GCNConv`` and ``GCN`` run unchanged on row shards (the counterpart of
    the JAX trainer's arrays under ``shard_rows``). ``node_mask`` is the
    rank's block of the graph's."""

    local: LocalHalo
    mesh: Mesh
    axis: str
    node_mask: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.local.rows_per_dev

    def to(self, device) -> "ShardedGraph":
        return ShardedGraph(_to(dataclasses.replace(self.local), device), self.mesh, self.axis,
                            self.node_mask.to(device))

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_halo(self.mesh, self.local, x, self.axis)


def shard_graph(mesh: Mesh, part: HaloPartition, node_mask, axis: str = "data") -> ShardedGraph:
    """This rank's :class:`ShardedGraph` of ``part`` (built for the size of
    ``axis``) on the mesh's device; ``node_mask`` is the whole graph's."""
    mask = torch.as_tensor(np.asarray(node_mask, dtype=bool))
    return ShardedGraph(local_partition(mesh, part, axis), mesh, axis,
                        shard_rows(mesh, mask, axis))
