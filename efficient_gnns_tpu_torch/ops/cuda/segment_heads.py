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

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit, check_split, derive_split
from efficient_gnns_tpu_torch.ops.cuda import launch
from efficient_gnns_tpu_torch.ops.cuda.launch import DTYPE_CODE, FEATURES, FLOAT, INDEX
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids, gather

_CHUNK_ELEMENTS = 1 << 27  # plain versions gather at most this many floats at once
_LIB = launch.Library("segment_heads", {"egt_csr_segment_sum_heads": "ppiipppppppiiiiiip",
                                        "egt_csr_sddmm_heads": "ppiippppiiiiiiip"})
_CSR = (("src", 1, INDEX), ("row_offsets", 1, INDEX))
_SUM = launch.Checks("csr_segment_sum_heads", ("x", 2, FEATURES), ("w", 2, FLOAT), *_CSR)
_SDDMM = launch.Checks("csr_sddmm_heads", ("g", 2, FEATURES), ("x", 2, FEATURES), *_CSR)


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


@launch.counted("K2")
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
    device = _SUM(x, w, src, row_offsets)
    h = w.shape[1]
    if h < 1 or x.shape[1] % h or w.shape[0] != src.shape[0]:
        raise ValueError(f"{name}: x [*, H*D], w [E_pad, H] and "
                         f"src [E_pad] disagree: {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(src.shape)}")
    check_split(name, split, row_offsets, src)
    if x.is_cpu:
        return csr_segment_sum_heads_plain(x, w, src, row_offsets)
    if split is None:
        split = derive_split(row_offsets)
    num_rows, d = row_offsets.numel() - 1, x.shape[1] // h
    out = torch.empty((num_rows, h * d), dtype=torch.float32, device=device)
    partial = torch.empty((split.num_chunks, h * d), dtype=torch.float32, device=device)
    launch.run(
        csr_segment_sum_heads, _LIB, "egt_csr_segment_sum_heads",
        x.data_ptr(), w.data_ptr(), DTYPE_CODE[x.dtype],
        launch.float_vec(x.dtype, d, x.data_ptr()),
        src.data_ptr(), row_offsets.data_ptr(), split.chunks.data_ptr(),
        split.long_rows.data_ptr(), split.long_first.data_ptr(), out.data_ptr(),
        partial.data_ptr(), num_rows, split.num_chunks, split.num_long, h, d,
        split.threshold, launch.stream(device),
    )
    return out


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


@launch.counted("K4")
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
    device = _SDDMM(g, x, src, row_offsets)
    if g.dtype != x.dtype:
        raise ValueError(f"{name}: g and x must share one dtype")
    if (num_heads < 1 or g.shape[1] != x.shape[1] or x.shape[1] % num_heads
            or g.shape[0] != row_offsets.numel() - 1):
        raise ValueError(f"{name}: g [num_rows, H*D], x [*, H*D] and row_offsets "
                         f"[num_rows + 1] disagree: {tuple(g.shape)}, {tuple(x.shape)}, "
                         f"{tuple(row_offsets.shape)}")
    check_split(name, split, row_offsets, src)
    if g.is_cpu:
        return csr_sddmm_heads_plain(g, x, src, row_offsets, num_heads)
    if split is None:
        split = derive_split(row_offsets)
    e_pad, d = src.shape[0], x.shape[1] // num_heads
    out = torch.empty((e_pad, num_heads), dtype=torch.float32, device=device)
    vec = min(launch.float_vec(x.dtype, d, x.data_ptr()),
              launch.float_vec(x.dtype, d, g.data_ptr()))
    launch.run(
        csr_sddmm_heads, _LIB, "egt_csr_sddmm_heads",
        g.data_ptr(), x.data_ptr(), DTYPE_CODE[x.dtype], vec, src.data_ptr(),
        row_offsets.data_ptr(),
        split.chunks.data_ptr(), out.data_ptr(), split.num_rows, split.num_chunks,
        num_heads, d, split.threshold, split.num_edges, e_pad, launch.stream(device),
    )
    return out
