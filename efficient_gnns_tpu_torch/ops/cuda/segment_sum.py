"""K1: CSR segment sum with a fused row gather — wrapper and plain version.

    out[r, :] = sum_{e in row_offsets[r] .. row_offsets[r+1]} w[e] * x[src[e], :]

Replaces ``efficient_gnns_tpu/ops/pallas/segment_matmul.py::blocked_segment_sum``
(and the XLA row gather in front of it, ``ops/spmm.py::_blocked_scatter``).
The CUDA kernels are ``csrc/segment_sum.cu`` on ``csrc/segment_split.cuh``:
bounded by device-memory bytes; every output element has one owner, so there
are no float atomics and the result is deterministic. Rows of at most
``RowSplit.threshold`` edges are summed whole; a longer (power-law hub) row
is cut into chunks that are summed into partial rows, which a second kernel
adds in a fixed order (``graphs/row_split.py``). ``x`` is float32 or
bfloat16, ``w`` float32 or absent, indices int32; accumulation and output
are float32.

:func:`csr_segment_sum` runs the plain version for tensors on the CPU and
the kernel for tensors on a CUDA device; it never moves work between them.
"""

from __future__ import annotations

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit, check_split, derive_split
from efficient_gnns_tpu_torch.ops.cuda import launch
from efficient_gnns_tpu_torch.ops.cuda.launch import DTYPE_CODE, FEATURES, FLOAT, INDEX
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids, gather, segment_sum

_LIB = launch.Library("segment_sum", {"egt_csr_segment_sum": "piippppppppiiiiip"})
_CHECK = launch.Checks("csr_segment_sum", ("x", 2, FEATURES), ("src", 1, INDEX),
                       ("row_offsets", 1, INDEX), ("w", 1, FLOAT))


def csr_segment_sum_plain(
    x: torch.Tensor,
    src: torch.Tensor,
    row_offsets: torch.Tensor,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version: gather, scale, ``index_add_`` in float32.
    Runs on any device (it is also the kernel's reference on the card)."""
    num_rows = row_offsets.numel() - 1
    e = int(row_offsets[-1])
    rows = csr_row_ids(row_offsets, e)
    msgs = gather(x, src[:e]).float()
    if w is not None:
        msgs = msgs * w[:e, None]
    return segment_sum(msgs, rows, num_rows)


@launch.counted("K1")
def csr_segment_sum(
    x: torch.Tensor,
    src: torch.Tensor,
    row_offsets: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    split: Optional[RowSplit] = None,
) -> torch.Tensor:
    """float32[num_rows, F] CSR segment sums of gathered (scaled) rows.

    ``src[row_offsets[r]:row_offsets[r+1]]`` are the rows of ``x`` summed
    into output row ``r``, each scaled by the matching ``w``. Entries of
    ``src`` past ``row_offsets[-1]`` (padding) are never read. ``split`` is
    the row split of ``row_offsets`` (``Graph.row_split`` /
    ``Graph.t_row_split``); without it the split is derived here, which costs
    a host copy per call. On a CUDA tensor this launches the kernels (one
    call counts one launch in ``csr_segment_sum.launches``) or raises; with
    ``split`` given nothing between the call and the launches waits for the
    device, once :func:`check_split` has seen the pair.
    """
    device = _CHECK(x, src, row_offsets, w)
    if row_offsets.numel() < 1:
        raise ValueError("csr_segment_sum: row_offsets must hold num_rows + 1 entries")
    if w is not None and w.shape[0] != src.shape[0]:
        raise ValueError(f"csr_segment_sum: w must be float32[{src.shape[0]}], got "
                         f"{tuple(w.shape)}")
    check_split("csr_segment_sum", split, row_offsets, src)
    if x.is_cpu:
        return csr_segment_sum_plain(x, src, row_offsets, w)
    if split is None:
        split = derive_split(row_offsets)
    num_rows, f = row_offsets.numel() - 1, x.shape[1]
    out = torch.empty((num_rows, f), dtype=torch.float32, device=device)
    partial = torch.empty((split.num_chunks, f), dtype=torch.float32, device=device)
    launch.run(
        csr_segment_sum, _LIB, "egt_csr_segment_sum",
        x.data_ptr(), DTYPE_CODE[x.dtype], launch.float_vec(x.dtype, f, x.data_ptr()),
        src.data_ptr(), launch.ptr(w), row_offsets.data_ptr(),
        split.chunks.data_ptr(), split.long_rows.data_ptr(), split.long_first.data_ptr(),
        out.data_ptr(), partial.data_ptr(), num_rows, split.num_chunks, split.num_long,
        f, split.threshold, launch.stream(device),
    )
    return out
