"""SDDMM: per-edge values from node values (counterpart of
``efficient_gnns_tpu/ops/sddmm.py``).

``sddmm_add`` is plain PyTorch: the gradient of a row gather is autograd's
``index_add_`` over the same edges, the function of the JAX custom VJP's
sorted segment sums (in another summation order).

``sddmm_dot``'s forward is K3 (``ops/cuda/segment_sddmm.py``) over the
receiver-sorted CSR with the graph's row split; its backward is two K1 sums
(``ops/cuda/segment_sum.py``), as the JAX ``_sddmm_dot_bwd`` computes them:
``da`` over the CSR weighted by the cotangent, ``db`` over the transpose CSR
weighted by the cotangent in ``csc_perm`` order. Products and sums are
float32; outputs take the inputs' dtype.
"""

from __future__ import annotations

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops.cuda import csr_sddmm, csr_segment_sum
from efficient_gnns_tpu_torch.ops.segment import gather


def sddmm_add(graph: Graph, el: torch.Tensor, er: torch.Tensor) -> torch.Tensor:
    """``out_e = el[sender_e] + er[receiver_e]`` (any trailing dims, e.g.
    heads). Padding edges get a value too (clipped gather); callers mask them
    through :func:`~efficient_gnns_tpu_torch.ops.edge_softmax.edge_softmax`."""
    return gather(el, graph.senders) + gather(er, graph.receivers)


class _SDDMMDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, graph: Graph):
        a, b = a.contiguous(), b.contiguous()
        ctx.save_for_backward(a, b)
        ctx.graph = graph
        return csr_sddmm(a, b, graph.senders, graph.row_offsets, graph.row_split).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        graph = ctx.graph
        gf = g.float().contiguous()  # padding edges lie past row_offsets[N]: never read
        da = db = None
        if ctx.needs_input_grad[0]:
            da = csr_segment_sum(b, graph.senders, graph.row_offsets, gf,
                                 graph.row_split).to(a.dtype)
        if ctx.needs_input_grad[1]:
            g_t = gf[graph.csc_perm.long()].contiguous()
            db = csr_segment_sum(a, graph.t_senders, graph.t_row_offsets, g_t,
                                 graph.t_row_split).to(b.dtype)
        return da, db, None


def sddmm_dot(graph: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out_e = <a[receiver_e], b[sender_e]>`` — per-edge dot product.

    ``a`` and ``b`` are ``[num_nodes, F]`` of one dtype (float32 or
    bfloat16) on the graph's device; ``out`` is ``[E_pad]`` in CSR order and
    ``a``'s dtype, 0 on padding edges.
    """
    n = graph.num_nodes
    if a.dim() != 2 or a.shape[0] != n or b.shape != a.shape:
        raise ValueError(f"sddmm_dot: a and b must both be [num_nodes={n}, F], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return _SDDMMDot.apply(a, b, graph)
