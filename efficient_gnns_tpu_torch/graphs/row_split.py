"""The deterministic split of long CSR rows into fixed chunks of edges.

A power-law graph has a few rows that hold a large share of the edges (at
ogbn-arxiv shape 309 of 169,343 rows hold 41%). A kernel that gives each
output row one owner waits for the owner of the longest row. The split
keeps one owner per output element and no float atomics:

* a row with at most ``threshold`` edges is summed by its one owner;
* a longer row is cut into chunks of ``threshold`` consecutive CSR edges.
  Each chunk is summed on its own into one *partial* row, and a second pass
  sums each long row's partials in chunk order.

Which rows are long and where their chunks lie depends on ``row_offsets``
alone, so the schedule is built once per graph and direction on the host
(:func:`build_row_split`, called by ``build_graph``) and carried by the
:class:`~efficient_gnns_tpu_torch.graphs.container.Graph` as ``row_split`` /
``t_row_split``: the counterpart of the JAX container's ``blocking`` /
``t_blocking``. The kernels K1 and K2 (``ops/cuda/csrc/segment_split.cuh``),
K3 and K4 (``ops/cuda/csrc/split_sddmm.cuh``: a chunk writes its own edges'
dots, no second pass) and K5 and K6 (``ops/cuda/csrc/segment_thin.cu``) walk
it; :func:`segment_reduce_by_split` executes the same schedule in plain
PyTorch, as a sum or a max, and :func:`sddmm_by_split` as K3 and K4 do.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

# Edges per chunk, and the longest row that keeps a single owner. Measured at
# ogbn-arxiv shape on an H100 (PERF.md): 64 to 256 lie within 5% of each
# other for K1 and K2; 32 writes four times the partials and 2,048 leaves the
# units too unequal (K1 twice as slow).
ROW_SPLIT_THRESHOLD = 128


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The chunk schedule of one CSR ``row_offsets``.

    Attributes:
      long_rows: int32[L] ids of the rows with more than ``threshold`` edges,
        ascending.
      chunks: int32[C, 3] ``(row, begin, end)`` of each chunk, a range of CSR
        edges inside one long row, in (row, chunk) order. Chunk ``c`` writes
        partial slot ``c``.
      long_first: int32[L + 1] first partial slot of each long row;
        ``long_rows[l]`` owns slots ``long_first[l]:long_first[l + 1]``.
      threshold: edges per chunk.
      num_rows, num_edges: the shape of the ``row_offsets`` it was built from
        (``num_edges == row_offsets[-1]``, the real edges).
    """

    long_rows: torch.Tensor
    chunks: torch.Tensor
    long_first: torch.Tensor
    threshold: int
    num_rows: int
    num_edges: int

    @property
    def num_long(self) -> int:
        return self.long_rows.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.chunks.shape[0]

    @property
    def device(self) -> torch.device:
        return self.chunks.device

    def to(self, device) -> "RowSplit":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self, long_rows=self.long_rows.to(device), chunks=self.chunks.to(device),
            long_first=self.long_first.to(device))


def build_row_split(row_offsets, threshold: int = ROW_SPLIT_THRESHOLD) -> RowSplit:
    """The :class:`RowSplit` of ``row_offsets`` (int[N + 1], a NumPy array or
    a tensor on any device), built with NumPy on the host; the result lies on
    the CPU. ``threshold`` is for tests, which force small chunks; the kernels
    are measured at the default."""
    if isinstance(row_offsets, torch.Tensor):
        row_offsets = row_offsets.detach().cpu().numpy()
    ro = np.asarray(row_offsets, dtype=np.int64)
    if ro.ndim != 1 or ro.size < 1 or threshold < 1:
        raise ValueError("build_row_split needs row_offsets [N + 1] and threshold >= 1")
    deg = np.diff(ro)
    long_rows = np.flatnonzero(deg > threshold)
    per_row = -(-deg[long_rows] // threshold)
    long_first = np.zeros(long_rows.size + 1, dtype=np.int64)
    np.cumsum(per_row, out=long_first[1:])
    chunk_row = np.repeat(long_rows, per_row)
    k = np.arange(chunk_row.size) - np.repeat(long_first[:-1], per_row)
    begin = ro[chunk_row] + k * threshold
    end = np.minimum(begin + threshold, ro[chunk_row + 1])
    chunks = np.stack([chunk_row, begin, end], axis=1).astype(np.int32)
    return RowSplit(
        long_rows=torch.from_numpy(long_rows.astype(np.int32)),
        chunks=torch.from_numpy(chunks.reshape(-1, 3)),
        long_first=torch.from_numpy(long_first.astype(np.int32)),
        threshold=int(threshold), num_rows=int(ro.size - 1), num_edges=int(ro[-1]),
    )


# (id(split), address and version of row_offsets) -> split, for the pairs known
# to belong together: built from one host array (``build_graph``), moved
# together (``Graph.to``) or compared by ``check_split``. An entry goes when
# its split does.
_paired: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _pair_key(split: RowSplit, row_offsets: torch.Tensor):
    return id(split), row_offsets.data_ptr(), row_offsets._version


def record_pair(split: RowSplit, row_offsets: torch.Tensor) -> None:
    """Record that ``split`` is the row split of ``row_offsets`` as they stand
    (an edit of the offsets in place, or a view at another address, is not
    covered)."""
    _paired[_pair_key(split, row_offsets)] = split


def is_recorded_pair(split: RowSplit, row_offsets: torch.Tensor) -> bool:
    return _paired.get(_pair_key(split, row_offsets)) is split


def check_split(name: str, split: Optional[RowSplit], row_offsets: torch.Tensor,
                edges: torch.Tensor) -> None:
    """Raise unless ``split`` (when given) is the row split of ``row_offsets``
    on their device and fits ``edges`` (any per-edge tensor ``[E_pad, ...]``);
    ``name`` is the caller's, for the message.

    Shape and device are compared at every call. That the schedule was built
    from these very offsets (and not, say, from the other edge order's, which
    have the same shape) is checked by building it again, the first time a
    split meets a ``row_offsets`` tensor: one host copy then, none later. A
    pair that ``build_graph`` made from one host array, and moved with
    ``Graph.to``, is recorded there and taken without the copy: a sampler's
    new graph at every step does not wait for the device.
    """
    if split is None:
        return
    if (split.num_rows != row_offsets.numel() - 1 or split.num_edges > edges.shape[0]
            or split.device != row_offsets.device):
        raise ValueError(
            f"{name}: row split of {split.num_rows} rows / {split.num_edges} edges on "
            f"{split.device} does not fit row_offsets [{row_offsets.numel()}] and "
            f"[{edges.shape[0]}] edges on {row_offsets.device}")
    if is_recorded_pair(split, row_offsets):
        return
    want = build_row_split(row_offsets, split.threshold)
    if not (want.num_edges == split.num_edges
            and torch.equal(want.long_rows, split.long_rows.cpu())
            and torch.equal(want.chunks, split.chunks.cpu())
            and torch.equal(want.long_first, split.long_first.cpu())):
        raise ValueError(
            f"{name}: the row split was not built from these row_offsets "
            f"(the other edge order's, or another graph's)")
    record_pair(split, row_offsets)


def derive_split(row_offsets: torch.Tensor) -> RowSplit:
    """The row split of ``row_offsets`` on their device, for a caller that
    has none: the slow way, one copy to the host and back at every call."""
    return build_row_split(row_offsets).to(row_offsets.device)


def segment_reduce_by_split(vals: torch.Tensor, row_offsets: torch.Tensor,
                            split: RowSplit, op: str = "sum") -> torch.Tensor:
    """``out[r] = sum`` (``op="sum"``) or ``max`` (``op="max"``) of
    ``vals[row_offsets[r]:row_offsets[r + 1]]``, computed as the kernels
    compute it, in plain PyTorch: short rows from ``row_offsets``, long rows
    from the schedule alone (each chunk reduced into its partial slot, then
    each long row's slots combined). ``vals`` is ``[>= E, F]`` in edge order
    (for K1 and K2 the gathered and scaled rows of the real edges, for K5 and
    K6 the edge values); rows past the real edges (padding) are never read. Empty rows give the
    identity: 0, or float32 lowest for the max."""
    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    num_rows, dev = row_offsets.numel() - 1, vals.device
    init = 0.0 if op == "sum" else float(torch.finfo(vals.dtype).min)

    def reduce_into(out, index, src):
        if op == "sum":
            return out.index_add_(0, index, src)
        return out.scatter_reduce_(0, index[:, None].expand_as(src), src, reduce="amax",
                                   include_self=True)

    real = vals[:split.num_edges]
    deg = (row_offsets[1:] - row_offsets[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(num_rows, device=dev), deg,
                                   output_size=split.num_edges)
    short = (deg <= split.threshold)[rows]
    out = reduce_into(vals.new_full((num_rows, vals.shape[1]), init), rows[short], real[short])
    chunks = split.chunks.long()
    size = chunks[:, 2] - chunks[:, 1]
    total = int(size.sum())
    chunk_of = torch.repeat_interleave(torch.arange(split.num_chunks, device=dev), size,
                                       output_size=total)
    start = torch.cumsum(size, 0) - size  # first position of each chunk's edges
    edge = chunks[chunk_of, 1] + torch.arange(total, device=dev) - start[chunk_of]
    partials = reduce_into(vals.new_full((split.num_chunks, vals.shape[1]), init),
                           chunk_of, vals[edge])
    first = split.long_first.long()
    owner = torch.repeat_interleave(split.long_rows.long(), first[1:] - first[:-1],
                                    output_size=split.num_chunks)
    return reduce_into(out, owner, partials)  # the long rows of out still hold init


def sddmm_by_split(g: torch.Tensor, x: torch.Tensor, src: torch.Tensor,
                   row_offsets: torch.Tensor, split: RowSplit,
                   num_heads: int = 1) -> torch.Tensor:
    """``dw[e, h] = <g[r, h], x[src[e], h]>`` (float32 ``[E_pad, H]``) computed
    as K3 and K4 walk the schedule, in plain PyTorch: each short row reads
    its own row of ``g`` for its edges, each chunk the row it names in
    ``split.chunks``; an edge that no unit covers reads a NaN row. Padding
    edges get 0 and their senders are never read."""
    num_rows, dev = row_offsets.numel() - 1, g.device
    e, e_pad = split.num_edges, src.shape[0]
    deg = (row_offsets[1:] - row_offsets[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(num_rows, device=dev), deg, output_size=e)
    unit_row = torch.full((e,), num_rows, dtype=torch.long, device=dev)
    short = (deg <= split.threshold)[rows]
    unit_row[short] = rows[short]
    chunks = split.chunks.long()
    size = chunks[:, 2] - chunks[:, 1]
    total = int(size.sum())
    chunk_of = torch.repeat_interleave(torch.arange(split.num_chunks, device=dev), size,
                                       output_size=total)
    start = torch.cumsum(size, 0) - size
    edge = chunks[chunk_of, 1] + torch.arange(total, device=dev) - start[chunk_of]
    unit_row[edge] = chunks[chunk_of, 0]
    g_nan = torch.cat([g.float(), g.new_full((1, g.shape[1]), float("nan"), dtype=torch.float32)])
    d = x.shape[1] // num_heads
    prod = g_nan[unit_row] * x[src[:e].long()].float()
    out = torch.zeros((e_pad, num_heads), dtype=torch.float32, device=dev)
    out[:e] = prod.view(e, num_heads, d).sum(-1)
    return out
