"""SDDMM: per-edge values from node values (counterpart of
``efficient_gnns_tpu/ops/sddmm.py``; ``sddmm_add`` so far).

Plain PyTorch. The gradient of a row gather is autograd's ``index_add_``
over the same edges, the function of the JAX custom VJP's sorted segment
sums (in another summation order).
"""

from __future__ import annotations

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops.segment import gather


def sddmm_add(graph: Graph, el: torch.Tensor, er: torch.Tensor) -> torch.Tensor:
    """``out_e = el[sender_e] + er[receiver_e]`` (any trailing dims, e.g.
    heads). Padding edges get a value too (clipped gather); callers mask them
    through :func:`~efficient_gnns_tpu_torch.ops.edge_softmax.edge_softmax`."""
    return gather(el, graph.senders) + gather(er, graph.receivers)
