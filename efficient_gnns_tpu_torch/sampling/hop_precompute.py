"""SIGN's hop features (counterpart of
``efficient_gnns_tpu/sampling/hop_precompute.py``).

``R`` passes of :func:`~efficient_gnns_tpu_torch.ops.spmm_mean`, each over
the previous pass's output: on the card one K1 (``csr_segment_sum``) launch
a hop. After them SIGN's training touches no graph.
"""

from __future__ import annotations

from typing import List

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops import spmm_mean


@torch.no_grad()
def neighbor_average_features(graph: Graph, x: torch.Tensor,
                              num_hops: int) -> List[torch.Tensor]:
    """``[x, A x, A^2 x, ..., A^R x]`` with ``A = spmm_mean(graph, .)`` and
    ``R = num_hops``; ``x`` lies on the graph's device."""
    feats = [x]
    for _ in range(num_hops):
        feats.append(spmm_mean(graph, feats[-1]))
    return feats
