"""K5, K6 and K7: thin CSR segment sum / max and the row-to-edge broadcast —
wrappers and plain versions.

    K5  s[r, h] = sum_{e in row r} v[e, h]          (0 on empty rows)
    K6  m[r, h] = max_{e in row r} v[e, h]          (float32 lowest on empty rows)
    K7  out[e, h] = vals[dst[e], h]                 (0 on padding edges)

K5 replaces ``efficient_gnns_tpu/ops/pallas/segment_thin.py::
blocked_segment_sum_thin``, K6 ``blocked_segment_max_thin`` and K7
``tile_rows_thin``. The CUDA kernels are ``csrc/segment_thin.cu``: bounded by
device-memory bytes; K5 and K6 are one template with one warp per output row
(no float atomics: the sum is deterministic and the max exact), K7 one thread
per output element. Payloads are float32 ``[E_pad, H]`` with H <= 8, indices
int32.

The wrappers run the plain version for tensors on the CPU and the kernel for
tensors on a CUDA device; they never move work between them.
"""

from __future__ import annotations

import ctypes

import torch

from efficient_gnns_tpu_torch.ops.cuda import build
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids

MAX_HEADS = 8
F32_LOWEST = float(torch.finfo(torch.float32).min)


def _lib() -> ctypes.CDLL:
    lib = build.load("segment_thin")
    if lib.egt_csr_segment_reduce_thin.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.egt_csr_segment_reduce_thin.argtypes = [p, p, p, i, i, i, p]
        lib.egt_csr_segment_reduce_thin.restype = i
        lib.egt_csr_tile_rows_thin.argtypes = [p, p, p, p, i, i, i, p]
        lib.egt_csr_tile_rows_thin.restype = i
        lib.egt_cuda_error_string.argtypes = [i]
        lib.egt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, vals, ints) -> None:
    if vals.dim() != 2 or vals.dtype != torch.float32 or not 1 <= vals.shape[1] <= MAX_HEADS:
        raise ValueError(f"{name}: values must be float32 [*, H <= {MAX_HEADS}], "
                         f"got {vals.dtype} {tuple(vals.shape)}")
    for key, t in ints.items():
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name}: {key} must be 1-D int32, got {t.dtype} {tuple(t.shape)}")
    tensors = [vals, *ints.values()]
    if any(t.device != vals.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError(f"{name}: int32 indexing needs < 2**31 entries per tensor")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {vals.device}")


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


def _segment_reduce_thin(v, row_offsets, op: str, counter) -> torch.Tensor:
    name = counter.__name__
    _check(name, v, {"row_offsets": row_offsets})
    if v.device.type == "cpu":
        return csr_segment_reduce_thin_plain(v, row_offsets, op)
    lib = _lib()
    num_rows = row_offsets.numel() - 1
    out = torch.empty((num_rows, v.shape[1]), dtype=torch.float32, device=v.device)
    rc = lib.egt_csr_segment_reduce_thin(
        v.data_ptr(), row_offsets.data_ptr(), out.data_ptr(), num_rows, v.shape[1],
        1 if op == "max" else 0, torch.cuda.current_stream(v.device).cuda_stream,
    )
    build.raise_on_error(lib, rc, name)
    counter.launches += 1
    return out


def csr_segment_sum_thin(v, row_offsets) -> torch.Tensor:
    """float32[num_rows, H] per-row sums of edge values ``v [E_pad, H]`` (K5);
    edges past ``row_offsets[-1]`` are never read. On a CUDA tensor this
    launches the kernel (counted in ``csr_segment_sum_thin.launches``) or
    raises."""
    return _segment_reduce_thin(v, row_offsets, "sum", csr_segment_sum_thin)


def csr_segment_max_thin(v, row_offsets) -> torch.Tensor:
    """float32[num_rows, H] per-row maxima of ``v [E_pad, H]``, float32 lowest
    on empty rows (K6); as :func:`csr_segment_sum_thin` otherwise."""
    return _segment_reduce_thin(v, row_offsets, "max", csr_segment_max_thin)


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
    past ``row_offsets[-1]`` (whose ``dst`` is never read) (K7). On a CUDA
    tensor this launches the kernel (counted in
    ``csr_tile_rows_thin.launches``) or raises."""
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
