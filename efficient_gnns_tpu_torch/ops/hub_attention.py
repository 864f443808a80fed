"""GAT attention with sender-only logits as one SpMM (counterpart of
``efficient_gnns_tpu/ops/hub_attention.py``).

With ``--no-attn-dst`` the logit of an edge ``s -> r`` is ``leaky_relu(el[s])``
and depends on the sender alone, so

    softmax_r(e)[s -> r] = z[s] / sum_{s' -> r} z[s'],   z = exp(e - m)

and the whole attention collapses to ``out[r] = (A @ (z * x))[r] / (A @ z)[r]``.
The JAX package computes this over its hub-dense decomposition (dense hub
slices on the TPU's matrix unit, the residual edges on a Pallas scatter).
The port computes the same function as ONE segment sum over the full CSR of
``y = [z * x | z]``: K1 forward, K1 over the transpose CSR backward, whose
row split already handles the hub rows. Around K1 the layer is one
autograd function (:class:`_HubLayer`) whose elementwise passes are fused
kernels (``ops/cuda/hub_fused.py``): the messages before K1, the
normalisation with the layer's ``sqrt(deg_in)`` scale and residual after it,
and their two backward passes around the transpose launch. It keeps
everything that makes the JAX path another function than the exact edge
softmax:

* a global per-head max shift ``m`` (no gradient) instead of the per-receiver
  max, with ``z = exp(max(e - m, -60))``: the floor keeps every ``z`` a
  normal float32, so a receiver whose senders all lie more than 60 nats
  below the global max gets weights flattened toward uniform;
* messages in ``dispatch.hub_message_dtype()`` (bfloat16 by default) with
  float32 accumulation; the backward reads the cotangent in that dtype too;
* ``num / den`` by the rule of :class:`_Normalize` (``hub_fused.normalize``
  and ``normalize_grads``): the backward reciprocates ``den`` once, and an
  empty row gives 0 with zero gradient;
* edge-drop as hashed Bernoulli keep weights fixed per edge by ``drop_seed``
  (:func:`hub_keep_weights`), bit for bit the JAX masks: a residual edge
  hashes its CSR id, a hub edge its cell of the hub grid (the graph's
  :class:`~efficient_gnns_tpu_torch.graphs.hub_dense.HubPartition` says
  which).

``y`` is laid out as the JAX z-fold lays it out: each head's block padded to
``dp = ceil(d / 128) * 128`` columns, ``z`` in column ``d`` of the block when
``d < dp``, else in a trailing block. At the teacher's ``d = 250`` that is 256
columns a head and 768 in all, so K1 takes 16-byte loads.
"""

from __future__ import annotations

from typing import Optional

import torch

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum
from efficient_gnns_tpu_torch.ops.cuda.hub_fused import (
    hub_cotangent,
    hub_epilogue,
    hub_message_grad,
    hub_messages,
    normalize,
    normalize_grads,
)

_M32 = 0xFFFFFFFF
SALT_RESIDUAL, SALT_HUB_SRC, SALT_HUB_DST = 0x5EED, 0x51, 0xD5


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the constant is
    split in 16-bit halves so that no product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's avalanche hash (lowbias32) on int64 tensors that
    hold uint32 values."""
    x = x & _M32
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _keep_thresh(keep_prob: float) -> int:
    return min(int(keep_prob * 2.0**32), 2**32 - 1)


def _salted(seed, salt: int):
    """``seed + salt`` as uint32 (wrapping), for an int or an int64 tensor."""
    return (seed + salt) & _M32


def edge_keep_mask(eids: torch.Tensor, seed, keep_prob: float, salt: int = 0) -> torch.Tensor:
    """bool mask, iid Bernoulli(keep_prob) per edge id: the JAX
    ``edge_keep_mask`` bit for bit. ``seed`` is an int or an int64 scalar
    tensor holding a uint32."""
    h = _hash_u32(eids.long() ^ _salted(seed, salt))
    return h < _keep_thresh(keep_prob)


def _grid_keep_mask(rows: torch.Tensor, cols: torch.Tensor, seed, keep_prob: float,
                    salt: int) -> torch.Tensor:
    """The JAX ``_grid_keep_mask`` read at the cells ``(rows, cols)``: the
    row hashed first, then the column folded in with a second round."""
    hrow = _hash_u32(rows.long() ^ _salted(seed, salt))
    return _hash_u32(hrow ^ cols.long()) < _keep_thresh(keep_prob)


def hub_keep_weights(graph: Graph, seed, keep_prob: float) -> torch.Tensor:
    """float32[E_pad] 0/1 edge-drop weights in CSR order (0 on padding): for
    each edge the JAX hub path's keep decision. Residual edges hash their
    CSR id (salt ``0x5EED``: the JAX residual blocking's ``csr_perm`` is the
    full CSR id); hub-S edges the cell (receiver, hub-local sender column)
    of the ``[N, Hs]`` grid (salt ``0x51``); hub-D edges the cell (hub-local
    receiver row, sender) of the ``[Hd, N]`` grid (salt ``0xD5``)."""
    hub, dev = graph.hub, graph.device
    keep = torch.zeros(graph.num_edges_padded, dtype=torch.float32, device=dev)
    eids = torch.arange(graph.n_edge, device=dev)
    keep[: graph.n_edge] = edge_keep_mask(eids, seed, keep_prob, SALT_RESIDUAL).float()
    keep[hub.src_eids.long()] = _grid_keep_mask(hub.src_rows, hub.src_cols, seed,
                                                keep_prob, SALT_HUB_SRC).float()
    keep[hub.dst_eids.long()] = _grid_keep_mask(hub.dst_rows, hub.dst_cols, seed,
                                                keep_prob, SALT_HUB_DST).float()
    return keep


def supports_hub_attention(graph: Graph) -> bool:
    """True when :func:`hub_gat_attention` takes ``graph``: it carries a hub
    partition, no static edge weights and no factored scales (the softmax
    treats the adjacency as structure), and is not a transpose."""
    return (graph.hub is not None and not graph.hub.transposed
            and graph.edge_weight is None and graph.node_scale is None)


class _Normalize(torch.autograd.Function):
    """``num / den`` per (node, head), 0 where the row is empty, with the JAX
    ``_normalize`` backward: ``dden = -(g . out) / den`` reciprocates ``den``
    once, where autograd of a division would form ``den**2``, which
    underflows for ``den < ~1e-19`` and sends inf or NaN into the
    parameters. A denominator below the smallest normal float32 counts as
    empty (0 out, 0 gradient): the reference's XLA flushes subnormal floats
    to zero, and ``1 / den`` of a subnormal ``den`` overflows to inf. On the
    hub path it never arises, since every kept edge adds ``z >= e**-60``.
    The rule alone, as a function of ``(num, den)``: the layer runs it inside
    :class:`_HubLayer`'s fused epilogue and cotangent passes."""

    @staticmethod
    def forward(ctx, num, den):
        out = normalize(num, den)
        ctx.save_for_backward(out, den)
        return out

    @staticmethod
    def backward(ctx, g):
        out, den = ctx.saved_tensors
        return normalize_grads(g, out, den)


class _HubLayer(torch.autograd.Function):
    """``normalize(A_w @ [z * x | z]) * scale + res`` as K1 between fused
    passes: :func:`hub_messages`, K1, :func:`hub_epilogue` forward;
    :func:`hub_cotangent`, K1 over the transpose CSR (with the keep weights
    in transpose order), :func:`hub_message_grad` backward. The residual's
    gradient is the output's. Saves ``x``, ``z``, K1's sums and the scale
    when an input needs a gradient, nothing otherwise (``no_grad``)."""

    @staticmethod
    def forward(ctx, x, z, scale, res, graph: Graph, weight, msg_dtype):
        _, h, d = x.shape
        y = hub_messages(x, z, msg_dtype)
        total = csr_segment_sum(y, graph.senders, graph.row_offsets, weight, graph.row_split)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, z, total, scale, weight)
            ctx.graph, ctx.msg_dtype = graph, msg_dtype
        return hub_epilogue(total, h, d, scale, res)

    @staticmethod
    def backward(ctx, g):
        x, z, total, scale, weight = ctx.saved_tensors
        graph = ctx.graph
        ct = hub_cotangent(g.contiguous(), total, scale, ctx.msg_dtype)
        w_t = None if weight is None else weight[graph.csc_perm.long()].contiguous()
        dy = csr_segment_sum(ct, graph.t_senders, graph.t_row_offsets, w_t,
                             graph.t_row_split)
        dx, dz = hub_message_grad(dy, x, z)
        return dx, dz, None, g if ctx.needs_input_grad[3] else None, None, None, None


def hub_gat_attention(
    graph: Graph,
    feat_src: torch.Tensor,
    el: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    edge_drop: float = 0.0,
    drop_seed: Optional[torch.Tensor] = None,
    dst_scale: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[r, h] = sum_e softmax_r(leaky_relu(el[s_e, h])) * feat_src[s_e, h]``
    over the kept edges: sender-only logits, the function of the JAX
    ``hub_gat_attention``; then ``out * dst_scale[:, None, None] +
    residual`` where given (the GAT layer's ``sqrt(deg_in)`` scale and
    residual, fused into the same pass).

    Args:
      graph: a graph that :func:`supports_hub_attention`.
      feat_src: float[N, H, D] source-side (message) features.
      el: float[N, H] sender attention logits.
      edge_drop: drop rate; with ``drop_seed`` (an int64 scalar tensor, or
        an int, holding a uint32) each edge is kept with probability
        ``1 - edge_drop`` by :func:`hub_keep_weights`. ``drop_seed=None``
        keeps every edge.
      dst_scale: optional float[N] per-receiver scale (no gradient).
      residual: optional float[N, H, D] added to the output.

    The attention, scale and residual are computed in float32; the result
    takes ``feat_src``'s dtype.
    """
    if not supports_hub_attention(graph):
        raise ValueError(
            "hub_gat_attention: the graph needs a hub partition, no static edge "
            "weights, no factored scales and not to be a transpose (build it with "
            "hub_dense > 0 and gcn_norm=False; see supports_hub_attention)")
    n, h, _ = feat_src.shape
    if n != graph.num_nodes or tuple(el.shape) != (n, h):
        raise ValueError(f"hub_gat_attention: feat_src must be [N={graph.num_nodes}, H, D] "
                         f"and el [N, H], got {tuple(feat_src.shape)} and {tuple(el.shape)}")

    e = torch.nn.functional.leaky_relu(el.float(), negative_slope)
    m = e.detach().max(0, keepdim=True).values
    z = torch.exp(torch.clamp_min(e - m, -60.0)).contiguous()  # [N, H]

    weight = None
    if drop_seed is not None and edge_drop > 0.0:
        weight = hub_keep_weights(graph, drop_seed, 1.0 - float(edge_drop))

    def f32(t):
        return None if t is None else t.float().contiguous()

    out = _HubLayer.apply(f32(feat_src), z, f32(dst_scale), f32(residual), graph, weight,
                          dispatch.hub_message_dtype())
    return out.to(feat_src.dtype)
