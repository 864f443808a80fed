"""Row gather and sorted segment reductions in plain PyTorch (counterpart of
``efficient_gnns_tpu/ops/segment.py``; the plain versions behind the kernels).

Padding convention as in the JAX package: segment ids ``>= num_segments``
are dropped, and gather indices are clipped into range.
"""

from __future__ import annotations

from typing import Optional

import torch


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with clipped out-of-range indices (padding-safe)."""
    return x.index_select(0, idx.long().clamp(0, x.shape[0] - 1))


def csr_row_ids(row_offsets: torch.Tensor, num_edges: int) -> torch.Tensor:
    """int64[num_edges]: the row of each of the first ``num_edges`` CSR edges."""
    deg = (row_offsets[1:] - row_offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(deg.numel(), device=row_offsets.device), deg, output_size=num_edges
    )


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[k] = sum of data[i] with segment_ids[i] == k``; ids out of range
    are dropped. Sums in ``data``'s dtype, in index order on the CPU."""
    ids = segment_ids.long()
    keep = ids < num_segments
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids[keep], data[keep])


def segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Mean over each segment; empty segments give 0."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(data.new_ones(segment_ids.shape), segment_ids, num_segments)
    count = count.clamp_min(1)
    return total / count.reshape((num_segments,) + (1,) * (data.dim() - 1))


def _segment_extreme(data, segment_ids, num_segments, reduce, fill):
    # out-of-range ids land in one extra row that is dropped: no boolean
    # mask, so nothing waits for the device
    ids = segment_ids.long().clamp(max=num_segments)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), fill)
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce=reduce, include_self=True)[:num_segments]


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[k] = max of data[i] with segment_ids[i] == k``; ids out of range
    are dropped and empty segments give ``-inf`` (as ``jax.ops.segment_max``)."""
    return _segment_extreme(data, segment_ids, num_segments, "amax", float("-inf"))


def segment_min(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[k] = min of data[i] with segment_ids[i] == k``; ids out of range
    are dropped and empty segments give ``+inf`` (as ``jax.ops.segment_min``)."""
    return _segment_extreme(data, segment_ids, num_segments, "amin", float("inf"))


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically stable softmax within each segment. Entries with
    out-of-range ids or ``mask == False`` get probability 0 and no gradient;
    the segment maximum is a constant shift (no gradient), so the backward is
    the softmax VJP ``p * (g - sum_seg(p * g))`` of the JAX custom VJP."""
    return segment_softmax_by(
        logits, segment_ids, num_segments, mask,
        lambda z: segment_sum(z, segment_ids, num_segments),
        lambda denom: gather(denom, segment_ids))


def segment_softmax_by(logits, segment_ids, num_segments, mask, seg_sum, seg_gather):
    """:func:`segment_softmax` with its two reductions given: ``seg_sum(z)``
    sums ``z`` over each segment and ``seg_gather(denom)`` reads each
    entry's segment sum back (``ops/sorted_segment.py`` runs both on K1)."""
    lowest = torch.finfo(logits.dtype).min
    valid = segment_ids.long() < num_segments
    valid = valid.reshape(valid.shape + (1,) * (logits.dim() - 1))
    if mask is not None:
        valid = valid & mask
    valid = valid.expand_as(logits)
    with torch.no_grad():
        seg_max = segment_max(
            torch.where(valid, logits, float("-inf")), segment_ids, num_segments
        ).clamp_min(lowest)  # empty segments
    shifted = torch.where(valid, logits - gather(seg_max, segment_ids), 0.0)
    z = torch.where(valid, torch.exp(shifted), 0.0)
    denom = seg_sum(z).clamp_min(torch.finfo(logits.dtype).tiny)
    return z / seg_gather(denom)
