"""Sorted segment sums and row gathers whose every sum is K1.

The packed molecule batch (``graphs/batching.py``) keeps everything it sums
in CSR order: a conv sums its edges into their receivers over
``row_offsets``, a pool sums the nodes of each graph over
``graph_offsets``. Such a sum is K1 (``ops/cuda/segment_sum.py``) with the
identity as its gather index, one owner per output row. The backward of a
row gather is such a sum too, over the transpose CSR of the gather's
indices. So these two autograd functions put the sums of a mol step, and of
its backward, on K1 and leave no float atomics (``index_add_``, and the
backward of ``index_select``) on a trainable tensor:

* :func:`csr_segment_sum_sorted`: forward K1 (``src = ident``), backward a
  row gather of the cotangent by the sorted ids;
* :func:`gather_rows_csr`: forward ``index_select``, backward K1 over the
  transpose CSR;
* :func:`csr_segment_softmax`: ``segment_softmax`` whose sum and its gather
  back to the entries are the two above.

Values equal the JAX ``segment_sum`` (sorted ids, out-of-range ids dropped)
and ``gather`` (clipped indices). On CPU tensors K1 is its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from efficient_gnns_tpu_torch.graphs.row_split import RowSplit
from efficient_gnns_tpu_torch.ops.cuda.segment_sum import csr_segment_sum
from efficient_gnns_tpu_torch.ops.segment import segment_softmax_by


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, row_offsets, split, ident):
        ctx.save_for_backward(segment_ids)
        return csr_segment_sum(data.contiguous(), ident[: data.shape[0]], row_offsets, None,
                               split)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        # the padding id (== num_rows) reads the zero row appended here
        return F.pad(g, (0, 0, 0, 1)).index_select(0, ids), None, None, None, None


def csr_segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                           row_offsets: torch.Tensor, split: Optional[RowSplit],
                           ident: torch.Tensor) -> torch.Tensor:
    """float32[num_rows, F]: ``out[r] = sum of data[e]`` over
    ``e in row_offsets[r]:row_offsets[r + 1]``.

    ``data`` is ``[E_pad, F]`` (float32 or bfloat16) in sorted order;
    ``segment_ids`` (int32 or int64, ``[E_pad]``) is the row of each entry, ascending,
    with ``num_rows`` on the padding entries past ``row_offsets[-1]`` (which
    the sum drops and whose gradient is 0); ``split`` is the row split of
    ``row_offsets``; ``ident`` an int32 ``0, 1, 2, ...`` of at least
    ``E_pad`` entries (``BatchedGraphs.ident``).
    """
    return _SortedSegmentSum.apply(data, segment_ids, row_offsets, split, ident)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, t_row_offsets, t_perm, t_split):
        ctx.save_for_backward(t_row_offsets, t_perm)
        ctx.t_split = t_split
        return x.index_select(0, idx.clamp(max=x.shape[0] - 1))

    @staticmethod
    def backward(ctx, g):
        t_row_offsets, t_perm = ctx.saved_tensors
        dx = csr_segment_sum(g.contiguous(), t_perm, t_row_offsets, None, ctx.t_split)
        return dx, None, None, None, None


def gather_rows_csr(x: torch.Tensor, idx: torch.Tensor, t_row_offsets: torch.Tensor,
                    t_perm: torch.Tensor, t_split: Optional[RowSplit]) -> torch.Tensor:
    """``x[idx]`` with out-of-range indices clipped (the JAX ``gather``),
    whose gradient is K1 over the transpose CSR of ``idx``.

    ``t_row_offsets`` (int32[x rows + 1]) groups the entries of ``idx`` by
    the row they read: ``t_perm[t_row_offsets[s]:t_row_offsets[s + 1]]``
    (int32) are the positions ``i`` with ``idx[i] == s``, and ``t_split`` is
    the row split of ``t_row_offsets``. Entries past ``t_row_offsets[-1]``
    (padding) get no gradient. For a graph's senders these are
    ``t_row_offsets``, ``csc_perm`` and ``t_row_split``; for its receivers
    ``row_offsets``, the identity and ``row_split``; for the nodes' graph ids
    ``graph_offsets``, the identity and ``graph_split``.
    """
    return _GatherRows.apply(x, idx, t_row_offsets, t_perm, t_split)


def csr_segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                        row_offsets: torch.Tensor, split: Optional[RowSplit],
                        ident: torch.Tensor, mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``ops.segment.segment_softmax`` of ``[E_pad]`` ``logits`` in sorted
    order (``segment_ids``, ``row_offsets``, ``split`` and ``ident`` as in
    :func:`csr_segment_sum_sorted`) whose segment sums and their gather back
    to the entries are :func:`csr_segment_sum_sorted` and
    :func:`gather_rows_csr`: K1 forward and backward, no float atomics."""
    return segment_softmax_by(
        logits, segment_ids, row_offsets.numel() - 1, mask,
        lambda z: csr_segment_sum_sorted(z[:, None], segment_ids, row_offsets, split,
                                         ident)[:, 0],
        lambda denom: gather_rows_csr(denom[:, None], segment_ids, row_offsets, ident,
                                      split)[:, 0])
