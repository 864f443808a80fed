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

import ctypes
from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.row_split import (
    RowSplit,
    build_row_split,
    is_recorded_pair,
    record_pair,
)
from efficient_gnns_tpu_torch.ops.cuda import build
from efficient_gnns_tpu_torch.ops.segment import csr_row_ids, gather, segment_sum

# the C interfaces that read feature rows (csrc/row_load.cuh: K1 and K3)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in one 16-byte load


def _lib() -> ctypes.CDLL:
    lib = build.load("segment_sum")
    if lib.egt_csr_segment_sum.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.egt_csr_segment_sum.argtypes = [
            p, i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, p,
        ]
        lib.egt_csr_segment_sum.restype = ctypes.c_int
        lib.egt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.egt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, src, row_offsets, w) -> None:
    if x.dim() != 2 or x.dtype not in DTYPE_CODE:
        raise ValueError(f"x must be 2-D float32/bfloat16, got {x.dtype} {tuple(x.shape)}")
    for name, t in (("src", src), ("row_offsets", row_offsets)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} {tuple(t.shape)}")
    if row_offsets.numel() < 1:
        raise ValueError("row_offsets must hold num_rows + 1 entries")
    if w is not None and (w.dim() != 1 or w.dtype != torch.float32
                          or w.shape[0] != src.shape[0]):
        raise ValueError(f"w must be float32[{src.shape[0]}], got {w.dtype} {tuple(w.shape)}")
    tensors = [x, src, row_offsets] + ([] if w is None else [w])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, src, row_offsets and w must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("csr_segment_sum needs contiguous tensors")
    if max(x.numel(), src.numel()) >= 2**31 or row_offsets.numel() >= 2**31:
        raise ValueError("int32 indexing: x, src and row_offsets need < 2**31 entries")


def float_vec(dtype: torch.dtype, d: int, ptr: int) -> int:
    """Elements in one lane load of a row of ``d`` columns at address ``ptr``:
    the widest of 16 bytes, two elements (8 bytes of float32, 4 of bfloat16)
    or one element that divides ``d`` and to which the address is aligned."""
    if d % VEC[dtype] == 0 and ptr % 16 == 0:
        return VEC[dtype]
    if d % 2 == 0 and ptr % (2 * dtype.itemsize) == 0:
        return 2
    return 1


def check_split(name: str, split: Optional[RowSplit], row_offsets: torch.Tensor,
                edges: torch.Tensor) -> None:
    """Raise unless ``split`` (when given) is the row split of ``row_offsets``
    on their device and fits ``edges`` (any per-edge tensor ``[E_pad, ...]``).

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
    _check(x, src, row_offsets, w)
    check_split("csr_segment_sum", split, row_offsets, src)
    if x.device.type == "cpu":
        return csr_segment_sum_plain(x, src, row_offsets, w)
    if x.device.type != "cuda":
        raise ValueError(f"csr_segment_sum runs on cpu or cuda, not {x.device}")
    if split is None:
        split = derive_split(row_offsets)
    lib = _lib()
    num_rows, f = row_offsets.numel() - 1, x.shape[1]
    out = torch.empty((num_rows, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((split.num_chunks, f), dtype=torch.float32, device=x.device)
    rc = lib.egt_csr_segment_sum(
        x.data_ptr(), DTYPE_CODE[x.dtype], float_vec(x.dtype, f, x.data_ptr()),
        src.data_ptr(), None if w is None else w.data_ptr(), row_offsets.data_ptr(),
        split.chunks.data_ptr(), split.long_rows.data_ptr(), split.long_first.data_ptr(),
        out.data_ptr(), partial.data_ptr(), num_rows, split.num_chunks, split.num_long,
        f, split.threshold, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.raise_on_error(lib, rc, "csr_segment_sum")
    csr_segment_sum.launches += 1
    return out


csr_segment_sum.launches = 0
