"""K2 and K4: multi-head CSR segment sum and per-edge head dots — wrappers and
plain versions.

    K2  out[r, h*D:(h+1)*D] = sum_{e in row r} w[e, h] * x[src[e], h*D:(h+1)*D]
    K4  dw[e, h] = <g[r_e, h*D:(h+1)*D], x[src[e], h*D:(h+1)*D]>  (r_e: the row
        of e; 0 on padding)

K2 replaces ``efficient_gnns_tpu/ops/pallas/segment_matmul.py::
blocked_segment_sum_heads`` and K4 ``blocked_sddmm_dw_heads`` (with the XLA
row gathers in front of them). The CUDA kernels are ``csrc/segment_heads.cu``:
both bounded by device-memory bytes; K2 gives each (output row, head) pair
one owner (no float atomics, deterministic) and sums a power-law hub row as
chunks into partial rows that a second kernel adds in a fixed order
(``csrc/segment_split.cuh``, ``graphs/row_split.py``). K4 walks the same
rows and chunks (``csrc/split_sddmm.cuh``): a (row or chunk, head) task
holds ``g[r, h]`` in registers and streams the ``x`` rows of its edges, so
``g`` is read once per row; each edge's dot has one owner and a fixed
order (deterministic, the same bits with any split). Features (``x``, and
``g`` for K4) are float32 or bfloat16 ``[rows, H*D]`` with the heads side by
side (no padding of D); head weights are float32 ``[E_pad, H]``, indices
int32; products, sums and outputs are float32. With bfloat16 features the
Pallas kernels also round each ``w * x`` product to bfloat16; these do not.

The wrappers run the plain version for tensors on the CPU and the kernel for
tensors on a CUDA device; they never move work between them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit
from efficient_gnns_tpu_torch.ops.cuda import build
from efficient_gnns_tpu_torch.ops.cuda.segment_sum import (
    DTYPE_CODE,
    check_split,
    derive_split,
    float_vec,
)
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids, gather

_CHUNK_ELEMENTS = 1 << 27  # plain versions gather at most this many floats at once


def _lib() -> ctypes.CDLL:
    lib = build.load("segment_heads")
    if lib.egt_csr_segment_sum_heads.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.egt_csr_segment_sum_heads.argtypes = [p, p, i, i, p, p, p, p, p, p, p, i, i, i, i, i,
                                                  i, p]
        lib.egt_csr_segment_sum_heads.restype = i
        lib.egt_csr_sddmm_heads.argtypes = [p, p, i, i, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.egt_csr_sddmm_heads.restype = i
        lib.egt_cuda_error_string.argtypes = [i]
        lib.egt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, msgs, floats, ints, num_heads) -> None:
    for key, t in msgs.items():
        if t.dim() != 2 or t.dtype not in DTYPE_CODE:
            raise ValueError(f"{name}: {key} must be 2-D float32/bfloat16, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if len({t.dtype for t in msgs.values()}) > 1:
        raise ValueError(f"{name}: {' and '.join(msgs)} must share one dtype")
    for key, t in floats.items():
        if t.dim() != 2 or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be 2-D float32, got {t.dtype} {tuple(t.shape)}")
    for key, t in ints.items():
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name}: {key} must be 1-D int32, got {t.dtype} {tuple(t.shape)}")
    tensors = [*msgs.values(), *floats.values(), *ints.values()]
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError(f"{name}: int32 indexing needs < 2**31 entries per tensor")
    if num_heads < 1:
        raise ValueError(f"{name}: needs at least one head")



def csr_segment_sum_heads_plain(x, w, src, row_offsets) -> torch.Tensor:
    """The plain PyTorch version of K2: gather, scale per head, ``index_add_``
    in float32 (from bfloat16 features too), over chunks of edges. Runs on
    any device."""
    num_rows, h = row_offsets.numel() - 1, w.shape[1]
    d = x.shape[1] // h
    e = int(row_offsets[-1])
    rows = csr_row_ids(row_offsets, e)
    out = x.new_zeros((num_rows, h * d), dtype=torch.float32)
    step = max(1, _CHUNK_ELEMENTS // max(1, h * d))
    for lo in range(0, e, step):
        hi = min(e, lo + step)
        msgs = gather(x, src[lo:hi]).float().view(-1, h, d) * w[lo:hi, :, None]
        out.index_add_(0, rows[lo:hi], msgs.view(-1, h * d))
    return out


def csr_segment_sum_heads(x, w, src, row_offsets,
                          split: Optional[RowSplit] = None) -> torch.Tensor:
    """float32[num_rows, H*D] multi-head CSR segment sums (K2).

    ``x`` is float32 or bfloat16 ``[*, H*D]`` (head ``h`` in columns
    ``h*D:(h+1)*D``), ``w`` the float32 per-edge head weights ``[E_pad, H]``
    in the order of ``src``. Edges past
    ``row_offsets[-1]`` (padding) are never read. ``split`` is the row split
    of ``row_offsets`` (``Graph.row_split`` / ``Graph.t_row_split``); without
    it the split is derived here, which costs a host copy per call. On a
    CUDA tensor this launches the kernels (one call counts one launch in
    ``csr_segment_sum_heads.launches``) or raises.
    """
    name = "csr_segment_sum_heads"
    _check(name, {"x": x}, {"w": w}, {"src": src, "row_offsets": row_offsets}, w.shape[1])
    h = w.shape[1]
    if x.shape[1] % h or w.shape[0] != src.shape[0]:
        raise ValueError(f"{name}: x [*, H*D], w [E_pad, H] and "
                         f"src [E_pad] disagree: {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(src.shape)}")
    check_split(name, split, row_offsets, src)
    if x.device.type == "cpu":
        return csr_segment_sum_heads_plain(x, w, src, row_offsets)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if split is None:
        split = derive_split(row_offsets)
    lib = _lib()
    num_rows, d = row_offsets.numel() - 1, x.shape[1] // h
    out = torch.empty((num_rows, h * d), dtype=torch.float32, device=x.device)
    partial = torch.empty((split.num_chunks, h * d), dtype=torch.float32, device=x.device)
    rc = lib.egt_csr_segment_sum_heads(
        x.data_ptr(), w.data_ptr(), DTYPE_CODE[x.dtype], float_vec(x.dtype, d, x.data_ptr()),
        src.data_ptr(), row_offsets.data_ptr(), split.chunks.data_ptr(),
        split.long_rows.data_ptr(), split.long_first.data_ptr(), out.data_ptr(),
        partial.data_ptr(), num_rows, split.num_chunks, split.num_long, h, d,
        split.threshold, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.raise_on_error(lib, rc, name)
    csr_segment_sum_heads.launches += 1
    return out


csr_segment_sum_heads.launches = 0


def csr_sddmm_heads_plain(g, x, src, row_offsets, num_heads: int) -> torch.Tensor:
    """The plain PyTorch version of K4: gather both rows, multiply, sum each
    head's columns in float32 (from bfloat16 features too), over chunks of
    edges; 0 on padding edges."""
    e_pad, e = src.shape[0], int(row_offsets[-1])
    rows = csr_row_ids(row_offsets, e)
    d = x.shape[1] // num_heads
    out = x.new_zeros((e_pad, num_heads), dtype=torch.float32)
    step = max(1, _CHUNK_ELEMENTS // max(1, x.shape[1]))
    for lo in range(0, e, step):
        hi = min(e, lo + step)
        prod = gather(g, rows[lo:hi]).float() * gather(x, src[lo:hi]).float()
        out[lo:hi] = prod.view(-1, num_heads, d).sum(-1)
    return out


def csr_sddmm_heads(g, x, src, row_offsets, num_heads: int,
                    split: Optional[RowSplit] = None) -> torch.Tensor:
    """float32[E_pad, H] per-edge head dots ``<g[r_e, h], x[src_e, h]>`` (K4).

    ``g`` is ``[num_rows, H*D]`` (rows by receiver), ``x`` ``[*, H*D]`` (rows
    by sender), both float32 or both bfloat16, ``src`` the senders in CSR
    order. Edges past
    ``row_offsets[-1]`` get 0 and their indices are never read. ``split`` is
    the row split of ``row_offsets`` (``Graph.row_split``); without it the
    split is derived here, which costs a host copy per call. On a CUDA
    tensor this launches the kernel (counted in ``csr_sddmm_heads.launches``)
    or raises.
    """
    name = "csr_sddmm_heads"
    _check(name, {"g": g, "x": x}, {}, {"src": src, "row_offsets": row_offsets}, num_heads)
    if (g.shape[1] != x.shape[1] or x.shape[1] % num_heads
            or g.shape[0] != row_offsets.numel() - 1):
        raise ValueError(f"{name}: g [num_rows, H*D], x [*, H*D] and row_offsets "
                         f"[num_rows + 1] disagree: {tuple(g.shape)}, {tuple(x.shape)}, "
                         f"{tuple(row_offsets.shape)}")
    check_split(name, split, row_offsets, src)
    if x.device.type == "cpu":
        return csr_sddmm_heads_plain(g, x, src, row_offsets, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if split is None:
        split = derive_split(row_offsets)
    lib = _lib()
    e_pad, d = src.shape[0], x.shape[1] // num_heads
    out = torch.empty((e_pad, num_heads), dtype=torch.float32, device=x.device)
    vec = min(float_vec(x.dtype, d, x.data_ptr()), float_vec(x.dtype, d, g.data_ptr()))
    rc = lib.egt_csr_sddmm_heads(
        g.data_ptr(), x.data_ptr(), DTYPE_CODE[x.dtype], vec, src.data_ptr(),
        row_offsets.data_ptr(),
        split.chunks.data_ptr(), out.data_ptr(), split.num_rows, split.num_chunks,
        num_heads, d, split.threshold, split.num_edges, e_pad,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.raise_on_error(lib, rc, name)
    csr_sddmm_heads.launches += 1
    return out


csr_sddmm_heads.launches = 0
