"""Edge softmax: attention normalisation over each node's incoming edges
(counterpart of ``efficient_gnns_tpu/ops/edge_softmax.py``), with the edge
subset of GAT edge-drop: edges left out by ``keep_mask`` are removed before
the normalisation, not after it.
"""

from __future__ import annotations

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops.segment import segment_softmax


def edge_softmax(
    graph: Graph, logits: torch.Tensor, keep_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Softmax of per-edge ``logits`` (``[E_pad]`` or ``[E_pad, H]``, CSR
    order) grouped by receiver. ``keep_mask`` (bool ``[E_pad]``) drops edges
    from the normalisation (probability 0). Padding edges get 0."""
    mask = graph.edge_mask
    if keep_mask is not None:
        mask = mask & keep_mask
    mask = mask.reshape(mask.shape + (1,) * (logits.dim() - 1))
    return segment_softmax(logits, graph.receivers, graph.num_nodes, mask)
