"""K5, K6 and K7: thin CSR segment sum / max and the row-to-edge broadcast —
wrappers and plain versions.

    K5  s[r, h] = sum_{e in row r} v[e, h]          (0 on empty rows)
    K6  m[r, h] = max_{e in row r} v[e, h]          (float32 lowest on empty rows)
    K7  out[e, h] = vals[dst[e], h]                 (0 on padding edges)

K5 replaces ``efficient_gnns_tpu/ops/pallas/segment_thin.py::
blocked_segment_sum_thin``, K6 ``blocked_segment_max_thin`` and K7
``tile_rows_thin``. The CUDA kernels are ``csrc/segment_thin.cu``: bounded by
device-memory bytes. K5 and K6 are one template over the graph's row split
(``graphs/row_split.py``): a group of lanes owns a short row or one chunk of
a power-law hub row, a second pass combines each long row's chunks in a fixed
order (one owner per output element, no float atomics: the sum gives the same
bits at every launch and the max is exact). In K7 a thread owns four
consecutive floats of the output and writes them as one 16-byte store.
Payloads are float32 ``[E_pad, H]`` with H <= 8, indices int32.

The wrappers run the plain version for tensors on the CPU and the kernel for
tensors on a CUDA device; they never move work between them.
"""

from __future__ import annotations

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit, check_split, derive_split
from efficient_gnns_tpu_torch.ops.cuda import launch
from efficient_gnns_tpu_torch.ops.cuda.launch import FLOAT, INDEX
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids

MAX_HEADS = 8
F32_LOWEST = float(torch.finfo(torch.float32).min)
_LIB = launch.Library("segment_thin", {"egt_csr_segment_reduce_thin": "pppppppiiiiiip",
                                       "egt_csr_tile_rows_thin": "ppppiiip",
                                       "egt_empty_launch": "p"})
_SUM, _MAX, _TILE = (
    launch.Checks(name, ("values", 2, FLOAT), *((k, 1, INDEX) for k in ints))
    for name, ints in (("csr_segment_sum_thin", ("row_offsets",)),
                       ("csr_segment_max_thin", ("row_offsets",)),
                       ("csr_tile_rows_thin", ("dst", "row_offsets"))))


def _check_shapes(name, vals, row_offsets) -> None:
    if not 1 <= vals.shape[1] <= MAX_HEADS:
        raise ValueError(f"{name}: values must be float32 [*, H <= {MAX_HEADS}], "
                         f"got {vals.dtype} {tuple(vals.shape)}")
    if row_offsets.numel() < 1:
        raise ValueError(f"{name}: row_offsets must hold num_rows + 1 entries")


def csr_segment_reduce_thin_plain(v, row_offsets, op: str) -> torch.Tensor:
    """The plain PyTorch version of K5 (``op="sum"``) and K6 (``op="max"``):
    ``index_add_`` / ``scatter_reduce_("amax")`` over the real edges."""
    num_rows, e = row_offsets.numel() - 1, int(row_offsets[-1])
    rows = csr_row_ids(row_offsets, e)
    if op == "sum":
        return v.new_zeros((num_rows, v.shape[1])).index_add_(0, rows, v[:e])
    out = v.new_full((num_rows, v.shape[1]), F32_LOWEST)
    idx = rows[:, None].expand(e, v.shape[1])
    return out.scatter_reduce_(0, idx, v[:e], reduce="amax", include_self=True)


def _segment_reduce_thin(v, row_offsets, split, op: str, counter, check) -> torch.Tensor:
    name = counter.__name__
    device = check(v, row_offsets)
    _check_shapes(name, v, row_offsets)
    check_split(name, split, row_offsets, v)
    if v.is_cpu:
        return csr_segment_reduce_thin_plain(v, row_offsets, op)
    if split is None:
        split = derive_split(row_offsets)
    num_rows, h = row_offsets.numel() - 1, v.shape[1]
    out = torch.empty((num_rows, h), dtype=torch.float32, device=device)
    partial = torch.empty((split.num_chunks, h), dtype=torch.float32, device=device)
    launch.run(
        counter, _LIB, "egt_csr_segment_reduce_thin",
        v.data_ptr(), row_offsets.data_ptr(), split.chunks.data_ptr(),
        split.long_rows.data_ptr(), split.long_first.data_ptr(), out.data_ptr(),
        partial.data_ptr(), num_rows, split.num_chunks, split.num_long, h,
        split.threshold, 1 if op == "max" else 0, launch.stream(device),
    )
    return out


@launch.counted("K5")
def csr_segment_sum_thin(v, row_offsets, split: Optional[RowSplit] = None) -> torch.Tensor:
    """float32[num_rows, H] per-row sums of edge values ``v [E_pad, H]`` (K5);
    edges past ``row_offsets[-1]`` are never read. ``split`` is the row split
    of ``row_offsets`` (``Graph.row_split`` / ``Graph.t_row_split``); without
    it the split is derived here, which costs a host copy per call, and the
    result has the same bits. On a CUDA tensor this launches the kernels (one
    call counts one launch in ``csr_segment_sum_thin.launches``) or raises."""
    return _segment_reduce_thin(v, row_offsets, split, "sum", csr_segment_sum_thin, _SUM)


@launch.counted("K6")
def csr_segment_max_thin(v, row_offsets, split: Optional[RowSplit] = None) -> torch.Tensor:
    """float32[num_rows, H] per-row maxima of ``v [E_pad, H]``, float32 lowest
    on empty rows (K6); as :func:`csr_segment_sum_thin` otherwise."""
    return _segment_reduce_thin(v, row_offsets, split, "max", csr_segment_max_thin, _MAX)


def csr_tile_rows_thin_plain(vals, dst, row_offsets) -> torch.Tensor:
    """The plain PyTorch version of K7: ``index_select`` of the real edges'
    rows, zeros on padding."""
    e = int(row_offsets[-1])
    out = vals.new_zeros((dst.shape[0], vals.shape[1]))
    out[:e] = vals.index_select(0, dst[:e].long())
    return out


@launch.counted("K7")
def csr_tile_rows_thin(vals, dst, row_offsets) -> torch.Tensor:
    """float32[E_pad, H]: ``vals[dst[e]]`` for every real edge, 0 for edges
    past ``row_offsets[-1]`` (whose ``dst`` is never read) (K7). ``dst`` may
    be a contiguous view at any offset (the kernel reads it in 16-byte loads
    only at H = 1 and only where it is 16-byte aligned). On a CUDA tensor this launches the
    kernel (counted in ``csr_tile_rows_thin.launches``) or raises."""
    name = "csr_tile_rows_thin"
    device = _TILE(vals, dst, row_offsets)
    _check_shapes(name, vals, row_offsets)
    if vals.shape[0] != row_offsets.numel() - 1:
        raise ValueError(f"{name}: vals needs one row per CSR row, got "
                         f"{vals.shape[0]} for {row_offsets.numel() - 1}")
    if vals.is_cpu:
        return csr_tile_rows_thin_plain(vals, dst, row_offsets)
    out = torch.empty((dst.shape[0], vals.shape[1]), dtype=torch.float32, device=device)
    launch.run(
        csr_tile_rows_thin, _LIB, "egt_csr_tile_rows_thin",
        vals.data_ptr(), dst.data_ptr(), row_offsets.data_ptr(), out.data_ptr(),
        vals.shape[0], dst.shape[0], vals.shape[1], launch.stream(device),
    )
    return out


@launch.counted()
def empty_launch(device) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream: what
    one launch costs, the floor under the times of K5-K7 (``chip_smoke.py``
    times it)."""
    launch.run(empty_launch, _LIB, "egt_empty_launch", launch.stream(device))
