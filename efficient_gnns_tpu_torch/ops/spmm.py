"""Sparse x dense products over :class:`Graph` adjacency (counterpart of
``efficient_gnns_tpu/ops/spmm.py``, static-weight and unweighted cases).

The forward is K1 (``ops/cuda/segment_sum.py``) over the receiver-sorted
CSR; the gradient with respect to ``x`` is K1 over the transpose CSR with the
transpose-ordered weights, mirroring ``_spmm_blocked_static_bwd``. Messages
are read in ``dispatch.message_dtype()``; accumulation is float32 and the
result takes ``x``'s dtype, as in the JAX blocked path.
"""

from __future__ import annotations

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum


def _aggregate(values, senders, row_offsets, weight, msg_dtype, out_dtype):
    msgs = values.to(msg_dtype).contiguous()
    return csr_segment_sum(msgs, senders, row_offsets, weight).to(out_dtype)


class _SpMMStatic(torch.autograd.Function):
    """``out = A_w @ x`` with the graph's static (non-trained) weights."""

    @staticmethod
    def forward(ctx, x, graph: Graph, msg_dtype):
        ctx.graph, ctx.msg_dtype = graph, msg_dtype
        return _aggregate(x, graph.senders, graph.row_offsets, graph.edge_weight,
                          msg_dtype, x.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        graph = ctx.graph
        dx = _aggregate(g, graph.t_senders, graph.t_row_offsets,
                        graph.t_edge_weight, ctx.msg_dtype, g.dtype)
        return dx, None, None


def spmm(
    graph: Graph,
    x: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    transpose: bool = False,
) -> torch.Tensor:
    """``out[r] = sum_{e:(s->r)} w_e * x[s]`` — message passing aggregation.

    Args:
      graph: the adjacency; its ``edge_weight`` (or none: unweighted).
      x: float[num_nodes, F] node features on the graph's device.
      edge_weight: per-call (trainable) edge weights — not ported; raises.
      transpose: aggregate over the reversed edges instead.
    """
    if edge_weight is not None:
        # runtime weights need the SDDMM weight gradient (K3); refuse loudly
        # rather than silently treating them as static
        raise NotImplementedError(
            "spmm with runtime edge_weight (and its SDDMM gradient, K3) is not "
            "ported yet (ROADMAP.md, Queue 1 item 2)"
        )
    if x.dim() != 2 or x.shape[0] != graph.num_nodes:
        raise ValueError(
            f"spmm: x must be [num_nodes={graph.num_nodes}, F], got {tuple(x.shape)}"
        )
    if transpose:
        graph = graph.transpose()
    return _SpMMStatic.apply(x, graph, dispatch.message_dtype())
