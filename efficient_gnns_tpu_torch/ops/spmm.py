"""Sparse x dense products over :class:`Graph` adjacency (counterpart of
``efficient_gnns_tpu/ops/spmm.py``: ``spmm`` with no, static or per-call
trainable edge weights and the factored norm, ``spmm_mean``, and the
multi-head ``spmm_heads`` with per-call head weights).

``spmm``'s forward is K1 (``ops/cuda/segment_sum.py``) over the
receiver-sorted CSR, with the graph's row split (``Graph.row_split``, the
transpose's for the backward) handed to the kernels; the gradient with
respect to ``x`` is K1 over the transpose CSR with the transpose-ordered
weights, mirroring ``_spmm_blocked_static_bwd``; with per-call weights their
gradient is K3 (``ops/cuda/segment_sddmm.py``), mirroring
``_spmm_blocked_bwd``. Messages are read in ``dispatch.message_dtype()``
(or the caller's ``message_dtype``); accumulation is float32 and the result
takes ``x``'s dtype, as in the JAX blocked path.

``spmm_heads`` mirrors ``_spmm_heads_blocked``: the forward is K2
(``ops/cuda/segment_heads.py``) over the CSR, ``dx`` is K2 over the
transpose CSR with the weights permuted by ``csc_perm``, and ``dw`` is K4.
K2 and K4 read ``x`` and the cotangent in ``dispatch.message_dtype()``; the
head weights stay float32, sums are float32 and ``out`` / ``dx`` take
``x``'s dtype.

On a rank's row block of a sharded graph
(``parallel.partition.ShardedGraph``) ``spmm`` is the halo SpMM over the
rank's CSRs (``parallel.partition.spmm_halo``), K1 as well, on float32
messages only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.ops.cuda import (
    csr_sddmm,
    csr_sddmm_heads,
    csr_segment_sum,
    csr_segment_sum_heads,
)


def _aggregate(values, senders, row_offsets, weight, split, msg_dtype, out_dtype):
    msgs = values.to(msg_dtype).contiguous()
    return csr_segment_sum(msgs, senders, row_offsets, weight, split).to(out_dtype)


class _SpMMStatic(torch.autograd.Function):
    """``out = A_w @ x`` with the graph's static (non-trained) weights; with
    ``dst_rows`` only the first ``graph.max_dst`` rows of it (the others are
    empty), over ``row_offsets[:max_dst + 1]``: the backward is the same K1
    over the transpose CSR, whose senders all lie below ``max_dst``."""

    @staticmethod
    def forward(ctx, x, graph: Graph, msg_dtype, dst_rows: bool):
        ctx.graph, ctx.msg_dtype = graph, msg_dtype
        if dst_rows:
            return _aggregate(x, graph.senders, graph.row_offsets[:graph.max_dst + 1],
                              graph.edge_weight, graph.dst_row_split, msg_dtype, x.dtype)
        return _aggregate(x, graph.senders, graph.row_offsets, graph.edge_weight,
                          graph.row_split, msg_dtype, x.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        graph = ctx.graph
        dx = _aggregate(g, graph.t_senders, graph.t_row_offsets,
                        graph.t_edge_weight, graph.t_row_split, ctx.msg_dtype, g.dtype)
        return dx, None, None, None


class _SpMMRuntime(torch.autograd.Function):
    """``out = A_w @ x`` with per-call edge weights ``w`` in CSR order:
    ``dx`` is K1 over the transpose CSR with ``w[csc_perm]``, ``dw`` the
    per-edge dots of K3 (zeros when ``weight_grad`` is off, and then ``x``
    is not kept for the backward)."""

    @staticmethod
    def forward(ctx, x, w, graph: Graph, msg_dtype, weight_grad: bool):
        wf = w.float().contiguous()
        ctx.save_for_backward(x if weight_grad else None, wf)
        ctx.graph, ctx.msg_dtype, ctx.weight_grad = graph, msg_dtype, weight_grad
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        return _aggregate(x, graph.senders, graph.row_offsets, wf, graph.row_split,
                          msg_dtype, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, wf = ctx.saved_tensors
        graph, msg_dtype = ctx.graph, ctx.msg_dtype
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_t = wf[graph.csc_perm.long()].contiguous()
            dx = _aggregate(g, graph.t_senders, graph.t_row_offsets, w_t,
                            graph.t_row_split, msg_dtype, ctx.x_dtype)
        if ctx.needs_input_grad[1] and ctx.weight_grad:
            dw = csr_sddmm(
                g.to(msg_dtype).contiguous(), x.to(msg_dtype).contiguous(),
                graph.senders, graph.row_offsets, graph.row_split,
            ).to(ctx.w_dtype)
        elif ctx.needs_input_grad[1]:
            dw = torch.zeros_like(wf, dtype=ctx.w_dtype)
        return dx, dw, None, None, None


def spmm(
    graph: Graph,
    x: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    transpose: bool = False,
    weight_grad: bool = True,
    message_dtype: Optional[torch.dtype] = None,
    dst_rows: bool = False,
) -> torch.Tensor:
    """``out[r] = sum_{e:(s->r)} w_e * x[s]`` — message passing aggregation.

    Args:
      graph: the adjacency; its ``edge_weight`` (or none: unweighted).
      x: float[num_nodes, F] node features on the graph's device.
      edge_weight: optional float[E_pad] per-call edge scalars in
        receiver-sorted order; overrides ``graph.edge_weight``. Trainable:
        its gradient is K3's per-edge dots.
      transpose: aggregate over the reversed edges instead.
      weight_grad: set False when ``edge_weight`` carries no gradient, to
        skip K3 in the backward (its gradient is then 0).
      message_dtype: dtype in which K1 reads the messages (and the
        backward the cotangent); None takes ``dispatch.message_dtype()``.
        The hub attention path passes ``dispatch.hub_message_dtype()``.
      dst_rows: return only the first ``graph.max_dst`` rows, the ones a
        graph built with ``max_dst`` can fill (static weights only); equal
        to ``spmm(graph, x)[:graph.max_dst]`` without writing the rest.
    """
    if x.dim() != 2 or x.shape[0] != graph.num_nodes:
        raise ValueError(
            f"spmm: x must be [num_nodes={graph.num_nodes}, F], got {tuple(x.shape)}"
        )
    if not isinstance(graph, Graph):
        # a rank's row block (parallel.partition.ShardedGraph): the halo SpMM
        # over its CSRs, with the graph's static weights
        if edge_weight is not None or transpose or message_dtype is not None or dst_rows:
            raise ValueError("spmm: a sharded graph takes its static weights only")
        if dispatch.message_dtype() != torch.float32:
            raise ValueError("spmm: a sharded graph reads float32 messages only, not "
                             f"dispatch.message_dtype() {dispatch.message_dtype()}")
        return graph.spmm(x)
    if dst_rows and (graph.max_dst is None or edge_weight is not None or transpose
                     or graph.node_scale is not None):
        raise ValueError("spmm: dst_rows needs a graph built with max_dst, its static "
                         "weights and no transpose")
    if transpose:
        graph = graph.transpose()
    if graph.node_scale is not None and edge_weight is not None:
        # S A_w S is not the GCN normalization of the weighted adjacency
        raise ValueError(
            "spmm: runtime edge_weight on a gcn_norm='factored' graph is "
            "undefined — build the graph with gcn_norm=False (or True) when "
            "per-call edge weights are used"
        )
    if graph.node_scale is not None:
        # factored symmetric normalization over the unweighted structure
        scale = graph.node_scale[:, None]
        inner = dataclasses.replace(graph, node_scale=None)
        out = spmm(inner, (x * scale).to(x.dtype), message_dtype=message_dtype)
        return (out * scale).to(x.dtype)
    msg_dtype = dispatch.message_dtype() if message_dtype is None else message_dtype
    if edge_weight is not None:
        if tuple(edge_weight.shape) != (graph.num_edges_padded,):
            raise ValueError(
                f"spmm: edge_weight must be [E_pad={graph.num_edges_padded}], got "
                f"{tuple(edge_weight.shape)}"
            )
        return _SpMMRuntime.apply(x, edge_weight, graph, msg_dtype, weight_grad)
    return _SpMMStatic.apply(x, graph, msg_dtype, dst_rows)


def spmm_mean(
    graph: Graph,
    x: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean-aggregated SpMM (the SAGE neighbor mean): the weighted sum over
    each node's in-edges divided by its in-degree (at least 1)."""
    if graph.node_scale is not None:
        # S A S x / deg is neither a neighbor mean nor the GCN norm
        raise ValueError(
            "spmm_mean on a gcn_norm='factored' graph is undefined — build "
            "mean-aggregating graphs (SAGE) with gcn_norm=False"
        )
    total = spmm(graph, x, edge_weight)
    deg = graph.in_degrees().to(total.dtype)
    return total / deg.clamp_min(1.0)[:, None]


class _SpMMHeads(torch.autograd.Function):
    """``out[r, h] = sum_e w[e, h] * x[s_e, h]`` with trainable ``w``; K2 and
    K4 read ``x`` and the cotangent in ``msg_dtype``."""

    @staticmethod
    def forward(ctx, x, w, graph: Graph, msg_dtype):
        n, h, d = x.shape
        xm = x.reshape(n, h * d).to(msg_dtype).contiguous()
        wf = w.float().contiguous()
        ctx.save_for_backward(xm, wf)
        ctx.graph, ctx.msg_dtype, ctx.x_dtype, ctx.w_dtype = graph, msg_dtype, x.dtype, w.dtype
        out = csr_segment_sum_heads(xm, wf, graph.senders, graph.row_offsets,
                                    graph.row_split)
        return out.view(n, h, d).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xm, wf = ctx.saved_tensors
        graph = ctx.graph
        n, h = xm.shape[0], wf.shape[1]
        gm = g.reshape(n, -1).to(ctx.msg_dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_t = wf[graph.csc_perm.long()].contiguous()
            dx = csr_segment_sum_heads(gm, w_t, graph.t_senders, graph.t_row_offsets,
                                       graph.t_row_split)
            dx = dx.view(n, h, -1).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = csr_sddmm_heads(gm, xm, graph.senders, graph.row_offsets, h,
                                 graph.row_split).to(ctx.w_dtype)
        return dx, dw, None, None


def spmm_heads(graph: Graph, x: torch.Tensor, edge_weight: torch.Tensor) -> torch.Tensor:
    """Multi-head weighted SpMM: ``out[r, h] = sum_e w[e, h] * x[s_e, h]``.

    Args:
      graph: the adjacency (its own ``edge_weight`` is not used).
      x: float[num_nodes, H, D] node features on the graph's device, read by
        K2 (and K4 in the backward) in ``dispatch.message_dtype()``.
      edge_weight: float[E_pad, H] per-edge head weights in CSR order
        (trainable: its gradient is K4's per-edge head dots).
    """
    if (x.dim() != 3 or x.shape[0] != graph.num_nodes
            or tuple(edge_weight.shape) != (graph.num_edges_padded, x.shape[1])):
        raise ValueError(
            f"spmm_heads: x must be [num_nodes={graph.num_nodes}, H, D] and "
            f"edge_weight [E_pad={graph.num_edges_padded}, H], got "
            f"{tuple(x.shape)} and {tuple(edge_weight.shape)}"
        )
    return _SpMMHeads.apply(x, edge_weight, graph, dispatch.message_dtype())
