"""GAT attention: SDDMM -> edge softmax -> weighted SpMM (counterpart of
``efficient_gnns_tpu/ops/attention.py``).

The JAX package runs this pipeline in the TPU's blocked edge order; the port
runs the same function over the receiver-sorted CSR, launching a kernel
wherever the JAX forward and backward call a Pallas function (K2, K4, K5 and
K6 with the graph's row split of the edge order they walk):

* forward: K7 reads ``er`` onto the edges, K6 takes each row's maximum, K7
  broadcasts it back, K5 sums the exponentials, K7 broadcasts the
  reciprocal sums, K2 aggregates the features with the probabilities;
* backward: K4 gives the probabilities' cotangent, K5 and K7 the softmax
  VJP, K5 the receiver-side logit gradient, then the edge values move to
  the transpose order (``csc_perm``) for K5 (sender-side logit gradient) and
  K2 (feature gradient over the transpose CSR).

K2 and K4 read the features and the cotangent in
``dispatch.message_dtype()`` (bfloat16 halves their gathered bytes), as the
JAX ``_pad_heads`` casts them; the logits, probabilities and every sum stay
float32, and the output and ``dfeat`` take ``feat_src``'s dtype.

Masked edges (edge-drop ``keep_mask`` and padding) are set to float32 lowest
before the maximum and removed with ``torch.where`` after the exponential,
which may be ``inf`` there: a multiply by the mask would give ``inf * 0 =
NaN``. Attention dropout (``attn_keep``) scales kept probabilities by
``1 / attn_keep_prob`` as ``nn.Dropout`` does. Both masks are in CSR edge
order (:func:`sample_edge_masks`).
"""

from __future__ import annotations

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.ops.cuda import (
    csr_sddmm_heads,
    csr_segment_max_thin,
    csr_segment_sum_heads,
    csr_segment_sum_thin,
    csr_tile_rows_thin,
)
from efficient_gnns_tpu_torch.ops.segment import gather

_F32_LOWEST = float(torch.finfo(torch.float32).min)
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _softmax(e, graph: Graph, slot_mask):
    """Per-receiver softmax of edge logits ``e [E_pad, H]``; 0 where
    ``slot_mask`` is False, which leaves those edges out of the sums."""
    ro, recv, split = graph.row_offsets, graph.receivers, graph.row_split
    keep = slot_mask[:, None]
    m = csr_segment_max_thin(torch.where(keep, e, _F32_LOWEST), ro, split)
    z = torch.where(keep, torch.exp(e - csr_tile_rows_thin(m, recv, ro)), 0.0)
    r = 1.0 / csr_segment_sum_thin(z, ro, split).clamp_min(_F32_TINY)
    return z * csr_tile_rows_thin(r, recv, ro)


class _GATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, el, er, keep_mask, attn_keep, graph: Graph,
                negative_slope: float, attn_keep_prob: float, msg_dtype):
        n, h, d = feat.shape
        xm = feat.reshape(n, h * d).to(msg_dtype).contiguous()
        e = gather(el.float(), graph.senders)
        if er is not None:
            e = e + csr_tile_rows_thin(er.float().contiguous(), graph.receivers,
                                       graph.row_offsets)
        lrelu_g = torch.where(e >= 0, 1.0, negative_slope)
        e = e * lrelu_g
        slot_mask = graph.edge_mask
        if keep_mask is not None:
            slot_mask = slot_mask & keep_mask
        a = _softmax(e, graph, slot_mask)
        a_drop = a
        if attn_keep is not None:
            a_drop = torch.where(attn_keep, a / attn_keep_prob, 0.0)
        out = csr_segment_sum_heads(xm, a_drop, graph.senders, graph.row_offsets,
                                    graph.row_split)
        ctx.save_for_backward(xm, a, a_drop, lrelu_g, attn_keep)
        ctx.graph, ctx.has_er, ctx.msg_dtype = graph, er is not None, msg_dtype
        ctx.attn_keep_prob, ctx.dtypes = attn_keep_prob, (feat.dtype, el.dtype)
        return out.view(n, h, d).to(feat.dtype)

    @staticmethod
    def backward(ctx, g):
        xm, a, a_drop, lrelu_g, attn_keep = ctx.saved_tensors
        graph = ctx.graph
        ro, recv = graph.row_offsets, graph.receivers
        n, h = xm.shape[0], a.shape[1]
        gm = g.reshape(n, -1).to(ctx.msg_dtype).contiguous()

        da = csr_sddmm_heads(gm, xm, graph.senders, ro, h, graph.row_split)
        if attn_keep is not None:
            da = torch.where(attn_keep, da / ctx.attn_keep_prob, 0.0)
        # softmax VJP per receiver: de = a * (da - sum_row(a * da))
        inner = csr_segment_sum_thin((a * da).contiguous(), ro, graph.row_split)
        de = a * (da - csr_tile_rows_thin(inner, recv, ro)) * lrelu_g
        der = (csr_segment_sum_thin(de, ro, graph.row_split).to(ctx.dtypes[1])
               if ctx.has_er else None)
        # sender side: the edge values move to the transpose order
        perm = graph.csc_perm.long()
        del_ = csr_segment_sum_thin(de[perm], graph.t_row_offsets,
                                    graph.t_row_split).to(ctx.dtypes[1])
        dx = csr_segment_sum_heads(gm, a_drop[perm], graph.t_senders,
                                   graph.t_row_offsets, graph.t_row_split)
        return (dx.view(n, h, -1).to(ctx.dtypes[0]), del_, der,
                None, None, None, None, None, None)


def gat_attention(
    graph: Graph,
    feat_src: torch.Tensor,
    el: torch.Tensor,
    er: Optional[torch.Tensor] = None,
    *,
    negative_slope: float = 0.2,
    keep_mask: Optional[torch.Tensor] = None,
    attn_keep: Optional[torch.Tensor] = None,
    attn_keep_prob: float = 1.0,
) -> torch.Tensor:
    """``out[r, h] = sum_e softmax_r(leaky_relu(el[s_e,h] + er[r,h])) * feat_src[s_e, h]``.

    Args:
      feat_src: float[N, H, D] source-side (message) features, read by K2
        (and K4 in the backward) in ``dispatch.message_dtype()``.
      el: float32[N, H] sender attention logits; er: receiver logits or None.
      keep_mask: bool[E_pad] edge-drop keep mask in CSR order (dropped edges
        leave the normalisation).
      attn_keep: bool[E_pad, H] attention-dropout keep mask in CSR order.
    """
    n, h = graph.num_nodes, el.shape[-1]
    if feat_src.dim() != 3 or feat_src.shape[:2] != (n, h) or h > 8:
        raise ValueError(f"gat_attention: feat_src must be [N={n}, H <= 8, D] and "
                         f"el [N, H], got {tuple(feat_src.shape)} and {tuple(el.shape)}")
    return _GATAttention.apply(feat_src, el, er, keep_mask, attn_keep, graph,
                               float(negative_slope), float(attn_keep_prob),
                               dispatch.message_dtype())


def sample_edge_masks(graph: Graph, generator: Optional[torch.Generator],
                      edge_drop: float = 0.0, attn_drop: float = 0.0,
                      num_heads: int = 1):
    """``(keep_mask [E_pad], attn_keep [E_pad, H])`` for :func:`gat_attention`,
    in CSR edge order, drawn from ``generator`` on the graph's device; an
    entry is None when its rate is 0. Each edge (and head) is kept with
    probability ``1 - rate``, the distribution of the JAX masks (whose bits
    differ)."""
    e_pad, device = graph.num_edges_padded, graph.device
    keep = attn = None
    if edge_drop > 0:
        keep = torch.rand(e_pad, generator=generator, device=device) < 1.0 - edge_drop
    if attn_drop > 0:
        attn = (torch.rand(e_pad, num_heads, generator=generator, device=device)
                < 1.0 - attn_drop)
    return keep, attn
