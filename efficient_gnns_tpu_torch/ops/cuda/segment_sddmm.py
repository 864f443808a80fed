"""K3: per-edge row dots over a CSR — wrapper and plain version.

    dw[e] = <g[r_e, :], x[src[e], :]>   (r_e: the row of e; 0 on padding edges)

Replaces ``efficient_gnns_tpu/ops/pallas/segment_matmul.py::blocked_sddmm_dw``
(with the XLA gather of ``x[src]`` in front of it and the inverse permutation
behind it, ``ops/spmm.py::_spmm_blocked_bwd``): the edge-weight gradient of
``spmm`` with per-call weights. The CUDA kernel is ``csrc/segment_sddmm.cu``
on ``csrc/split_sddmm.cuh``, the one-head case of K4: bounded by
device-memory bytes; a row of at most ``RowSplit.threshold`` edges, or a
chunk of a longer row, is one task whose lanes hold ``g[r]`` in registers
and stream the ``x`` rows of its edges, so ``g`` is read once per row. Each
edge's dot has one owner and a fixed order: no atomics, deterministic, and
the same bits with any split. ``g`` and ``x`` are float32 or bfloat16
``[rows, F]`` with F unpadded, indices int32; products, sums and the output
are float32.

:func:`csr_sddmm` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; it never moves work between them.
"""

from __future__ import annotations

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit, check_split, derive_split
from efficient_gnns_tpu_torch.ops.cuda import launch
from efficient_gnns_tpu_torch.ops.cuda.launch import DTYPE_CODE, FEATURES, INDEX
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids, gather

_CHUNK_ELEMENTS = 1 << 27  # the plain version gathers at most this many floats at once
_LIB = launch.Library("segment_sddmm", {"egt_csr_sddmm": "ppiippppiiiiiip"})
_CHECK = launch.Checks("csr_sddmm", ("g", 2, FEATURES), ("x", 2, FEATURES), ("src", 1, INDEX),
                       ("row_offsets", 1, INDEX))


def csr_sddmm_plain(g, x, src, row_offsets) -> torch.Tensor:
    """The plain PyTorch version: gather both rows, multiply and sum in
    float32, over chunks of edges; 0 on padding edges. Runs on any device
    (it is also the kernel's reference on the card)."""
    e_pad, e = src.shape[0], int(row_offsets[-1])
    rows = csr_row_ids(row_offsets, e)
    out = x.new_zeros((e_pad,), dtype=torch.float32)
    step = max(1, _CHUNK_ELEMENTS // max(1, x.shape[1]))
    for lo in range(0, e, step):
        hi = min(e, lo + step)
        out[lo:hi] = (gather(g, rows[lo:hi]).float() * gather(x, src[lo:hi]).float()).sum(-1)
    return out


@launch.counted("K3")
def csr_sddmm(g, x, src, row_offsets, split: Optional[RowSplit] = None) -> torch.Tensor:
    """float32[E_pad] per-edge dots ``<g[r_e], x[src_e]>`` (K3).

    ``g`` is ``[num_rows, F]`` (rows by receiver), ``x`` ``[*, F]`` (rows by
    sender), ``src`` the senders in CSR order. Edges past ``row_offsets[-1]``
    (padding) get 0 and their indices are never read. ``split`` is the row
    split of ``row_offsets`` (``Graph.row_split``); without it the split is
    derived here, which costs a host copy per call. On a CUDA tensor this
    launches the kernel (counted in ``csr_sddmm.launches``) or raises.
    """
    device = _CHECK(g, x, src, row_offsets)
    if (g.dtype != x.dtype or g.shape[1] != x.shape[1] or g.shape[1] < 1
            or g.shape[0] != row_offsets.numel() - 1):
        raise ValueError(
            "csr_sddmm: g [num_rows, F] and x [*, F] of one dtype disagree with "
            f"row_offsets [num_rows + 1]: {g.dtype} {tuple(g.shape)}, {x.dtype} "
            f"{tuple(x.shape)}, {tuple(row_offsets.shape)}")
    check_split("csr_sddmm", split, row_offsets, src)
    if g.is_cpu:
        return csr_sddmm_plain(g, x, src, row_offsets)
    if split is None:
        split = derive_split(row_offsets)
    e_pad, f = src.shape[0], x.shape[1]
    out = torch.empty((e_pad,), dtype=torch.float32, device=device)
    vec = min(launch.float_vec(x.dtype, f, x.data_ptr()),
              launch.float_vec(x.dtype, f, g.data_ptr()))
    launch.run(
        csr_sddmm, _LIB, "egt_csr_sddmm",
        g.data_ptr(), x.data_ptr(), DTYPE_CODE[x.dtype], vec, src.data_ptr(),
        row_offsets.data_ptr(), split.chunks.data_ptr(), out.data_ptr(),
        split.num_rows, split.num_chunks, f, split.threshold, split.num_edges, e_pad,
        launch.stream(device),
    )
    return out
