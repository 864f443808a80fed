"""Row gather and sorted segment sum in plain PyTorch (counterpart of
``efficient_gnns_tpu/ops/segment.py``; the plain versions behind the kernels).

Padding convention as in the JAX package: segment ids ``>= num_segments``
are dropped, and gather indices are clipped into range.
"""

from __future__ import annotations

import torch


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with clipped out-of-range indices (padding-safe)."""
    return x.index_select(0, idx.long().clamp(0, x.shape[0] - 1))


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[k] = sum of data[i] with segment_ids[i] == k``; ids out of range
    are dropped. Sums in ``data``'s dtype, in index order on the CPU."""
    ids = segment_ids.long()
    keep = ids < num_segments
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids[keep], data[keep])
