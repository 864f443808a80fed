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

import ctypes
from typing import Optional, Tuple

import torch

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit
from efficient_gnns_tpu_torch.ops.cuda import build
from efficient_gnns_tpu_torch.ops.cuda.segment_sum import check_split, derive_split
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids

MAX_HEADS = 8
F32_LOWEST = float(torch.finfo(torch.float32).min)
# ``-D`` flags for csrc/segment_thin.cu; empty in use. chip_smoke.py's group
# sweep sets them to time other lane-group widths (EGT_THIN_ROW_GROUP,
# EGT_THIN_CHUNK_GROUP, EGT_THIN_LOADS) through these same wrappers.
BUILD_DEFINES: Tuple[str, ...] = ()


def _lib() -> ctypes.CDLL:
    lib = build.load("segment_thin", BUILD_DEFINES)
    if lib.egt_csr_segment_reduce_thin.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.egt_csr_segment_reduce_thin.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.egt_csr_segment_reduce_thin.restype = i
        lib.egt_csr_tile_rows_thin.argtypes = [p, p, p, p, i, i, i, p]
        lib.egt_csr_tile_rows_thin.restype = i
        lib.egt_empty_launch.argtypes = [p]
        lib.egt_empty_launch.restype = i
        lib.egt_cuda_error_string.argtypes = [i]
        lib.egt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, vals, ints) -> None:
    # on the path of every launch: plain comparisons, no lists built
    if vals.dim() != 2 or vals.dtype != torch.float32 or not 1 <= vals.shape[1] <= MAX_HEADS:
        raise ValueError(f"{name}: values must be float32 [*, H <= {MAX_HEADS}], "
                         f"got {vals.dtype} {tuple(vals.shape)}")
    device = vals.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    for key, t in ints.items():
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name}: {key} must be 1-D int32, got {t.dtype} {tuple(t.shape)}")
    if ints["row_offsets"].numel() < 1:
        raise ValueError(f"{name}: row_offsets must hold num_rows + 1 entries")
    for t in (vals, *ints.values()):
        if t.device != device:
            raise ValueError(f"{name}: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: int32 indexing needs < 2**31 entries per tensor")


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


def _segment_reduce_thin(v, row_offsets, split, op: str, counter) -> torch.Tensor:
    name = counter.__name__
    _check(name, v, {"row_offsets": row_offsets})
    check_split(name, split, row_offsets, v)
    if v.device.type == "cpu":
        return csr_segment_reduce_thin_plain(v, row_offsets, op)
    if split is None:
        split = derive_split(row_offsets)
    lib = _lib()
    num_rows, h = row_offsets.numel() - 1, v.shape[1]
    out = torch.empty((num_rows, h), dtype=torch.float32, device=v.device)
    partial = torch.empty((split.num_chunks, h), dtype=torch.float32, device=v.device)
    rc = lib.egt_csr_segment_reduce_thin(
        v.data_ptr(), row_offsets.data_ptr(), split.chunks.data_ptr(),
        split.long_rows.data_ptr(), split.long_first.data_ptr(), out.data_ptr(),
        partial.data_ptr(), num_rows, split.num_chunks, split.num_long, h,
        split.threshold, 1 if op == "max" else 0,
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    build.raise_on_error(lib, rc, name)
    counter.launches += 1
    return out


def csr_segment_sum_thin(v, row_offsets, split: Optional[RowSplit] = None) -> torch.Tensor:
    """float32[num_rows, H] per-row sums of edge values ``v [E_pad, H]`` (K5);
    edges past ``row_offsets[-1]`` are never read. ``split`` is the row split
    of ``row_offsets`` (``Graph.row_split`` / ``Graph.t_row_split``); without
    it the split is derived here, which costs a host copy per call, and the
    result has the same bits. On a CUDA tensor this launches the kernels (one
    call counts one launch in ``csr_segment_sum_thin.launches``) or raises."""
    return _segment_reduce_thin(v, row_offsets, split, "sum", csr_segment_sum_thin)


def csr_segment_max_thin(v, row_offsets, split: Optional[RowSplit] = None) -> torch.Tensor:
    """float32[num_rows, H] per-row maxima of ``v [E_pad, H]``, float32 lowest
    on empty rows (K6); as :func:`csr_segment_sum_thin` otherwise."""
    return _segment_reduce_thin(v, row_offsets, split, "max", csr_segment_max_thin)


csr_segment_sum_thin.launches = 0
csr_segment_max_thin.launches = 0


def csr_tile_rows_thin_plain(vals, dst, row_offsets) -> torch.Tensor:
    """The plain PyTorch version of K7: ``index_select`` of the real edges'
    rows, zeros on padding."""
    e = int(row_offsets[-1])
    out = vals.new_zeros((dst.shape[0], vals.shape[1]))
    out[:e] = vals.index_select(0, dst[:e].long())
    return out


def csr_tile_rows_thin(vals, dst, row_offsets) -> torch.Tensor:
    """float32[E_pad, H]: ``vals[dst[e]]`` for every real edge, 0 for edges
    past ``row_offsets[-1]`` (whose ``dst`` is never read) (K7). ``dst`` may
    be a contiguous view at any offset (the kernel reads it in 16-byte loads
    only at H = 1 and only where it is 16-byte aligned). On a CUDA tensor this launches the
    kernel (counted in ``csr_tile_rows_thin.launches``) or raises."""
    name = "csr_tile_rows_thin"
    _check(name, vals, {"dst": dst, "row_offsets": row_offsets})
    if vals.shape[0] != row_offsets.numel() - 1:
        raise ValueError(f"{name}: vals needs one row per CSR row, got "
                         f"{vals.shape[0]} for {row_offsets.numel() - 1}")
    if vals.device.type == "cpu":
        return csr_tile_rows_thin_plain(vals, dst, row_offsets)
    lib = _lib()
    out = torch.empty((dst.shape[0], vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    rc = lib.egt_csr_tile_rows_thin(
        vals.data_ptr(), dst.data_ptr(), row_offsets.data_ptr(), out.data_ptr(),
        vals.shape[0], dst.shape[0], vals.shape[1],
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    build.raise_on_error(lib, rc, name)
    csr_tile_rows_thin.launches += 1
    return out


csr_tile_rows_thin.launches = 0


def empty_launch(device) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream: what
    one launch costs, the floor under the times of K5-K7 (``chip_smoke.py``
    times it)."""
    lib = _lib()
    rc = lib.egt_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    build.raise_on_error(lib, rc, "empty_launch")
