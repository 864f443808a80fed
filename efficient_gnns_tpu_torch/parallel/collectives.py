"""Differentiable collectives over a process group.

JAX differentiates ``lax.all_gather``, ``all_to_all``, ``ppermute`` and
``psum`` by itself; ``torch.distributed`` does not, so each collective the
parallel layer differentiates through is a ``torch.autograd.Function`` here,
and each states its backward. Two all-reduce sums differ in their backward
only, and choosing the wrong one multiplies gradients by the group's size:

* :func:`all_reduce_stat` (backward: all-reduce sum) for a statistic summed
  across ranks and then consumed by rank-local rows (BatchNorm's sums):
  each rank's cotangent of the sum is only its own rows' share;
* :func:`all_reduce_replicated` (backward: identity) for a value that every
  rank computes and backpropagates identically (a loss's final sum over the
  ring terms, a sharded table's lookup): each rank's cotangent is already
  the whole one.

``torch.distributed.nn.functional.all_reduce`` (deprecated) has the first
backward and is not used. Every collective runs on the group's backend with
the tensors where they lie: NCCL on CUDA tensors, gloo on CPU tensors, and
gloo on CUDA tensors as well (it copies through the host itself; it took
every collective here on an H100, PERF.md). Nothing switches backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# all_gather_single / reduce_scatter_single replace the *_tensor names in
# newer PyTorch; the older names remain where they are the only ones
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` overwritten in place with global rank ``src``'s values."""
    dist.broadcast(t, src, group=group)
    return t


def all_to_all(x: torch.Tensor, group, out_splits=None, in_splits=None, async_op=False):
    """``dist.all_to_all_single`` along dim 0 into a new tensor: block ``o``
    of the output is what rank ``o`` of ``group`` sent here. Returns the
    output, and the work handle when ``async_op``."""
    x = x.contiguous()
    rows = x.shape[0] if out_splits is None else sum(out_splits)
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    work = dist.all_to_all_single(out, x, out_splits, in_splits, group=group,
                                  async_op=async_op)
    return (out, work) if async_op else out


class _AllGatherRows(torch.autograd.Function):
    """Forward: the group's ``[rows, ...]`` blocks stacked in group-rank
    order. Backward: reduce-scatter (sum) of the cotangent, each rank keeping
    its own block's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        d, _ = _size_rank(group)
        x = x.contiguous()
        out = x.new_empty((d * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        d, _ = _size_rank(ctx.group)
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // d,) + tuple(g.shape[1:]))
        _reduce_scatter(out, g, group=ctx.group)
        return out, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather(x, axis, tiled=True)``: every rank's rows, in
    group-rank order; the gradient is reduce-scattered back."""
    return _AllGatherRows.apply(x, group)


class _AllGatherCols(torch.autograd.Function):
    """Forward: the group's ``[rows, c]`` blocks side by side along the last
    dim, in group-rank order. Backward: reduce-scatter (sum) of the
    cotangent, each rank keeping its own block's columns (each rank's
    cotangent of the whole width is only its share: the input gradient of
    its column block of the next layer, or its part of a loss summed over
    the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        d, _ = _size_rank(group)
        # rows-major gather of the transposed blocks: block o is rank o's columns
        out = x.new_empty((d * x.shape[-1],) + tuple(x.shape[:-1]))
        _all_gather(out, x.movedim(-1, 0).contiguous(), group=group)
        return out.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        d, _ = _size_rank(ctx.group)
        g = g.movedim(-1, 0).contiguous()
        out = g.new_empty((g.shape[0] // d,) + tuple(g.shape[1:]))
        _reduce_scatter(out, g, group=ctx.group)
        return out.movedim(0, -1).contiguous(), None


def all_gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=-1, tiled=True)``: every rank's
    ``[rows, c]`` block stacked along the last dim, in group-rank order; the
    gradient is summed over the group and each rank keeps its own columns."""
    return _AllGatherCols.apply(x, group)


class _AllToAllBlocks(torch.autograd.Function):
    """Forward: block ``o`` of ``x`` (leading dim = group size) goes to rank
    ``o``; block ``o`` of the output came from rank ``o``. Backward: the
    same exchange of the cotangent, which is its reverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def all_to_all_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)`` with ``x`` of leading
    dim = the group's size."""
    return _AllToAllBlocks.apply(x, group)


def _shift(x: torch.Tensor, group, k: int) -> torch.Tensor:
    d, me = _size_rank(group)
    k %= d
    if k == 0:
        return x.clone()
    # all_to_all with every split but the peer's empty: gloo and NCCL take
    # the same path, and no point-to-point send / recv is needed
    ins, outs = [0] * d, [0] * d
    ins[(me + k) % d] = outs[(me - k) % d] = x.shape[0]
    return all_to_all(x, group, outs, ins)


class _RingShift(torch.autograd.Function):
    """Forward: rank ``i`` of the group receives rank ``i - k``'s ``x``
    (``lax.ppermute`` with ``perm=[(i, i + k)]``; equal shapes on every
    rank). Backward: the cotangent shifted by ``-k``."""

    @staticmethod
    def forward(ctx, x, group, k):
        ctx.group, ctx.k = group, k
        return _shift(x, group, k)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -ctx.k), None, None


def ring_shift(x: torch.Tensor, group, k: int = 1) -> torch.Tensor:
    """Send ``x`` ``k`` ranks up the group's ring and receive from ``k``
    ranks down it."""
    return _RingShift.apply(x, group, k)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceStat(torch.autograd.Function):
    """Forward: sum over the group. Backward: sum of the cotangents over the
    group (each rank's is only its own rows' share of the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_stat(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group of a statistic consumed by rank-local rows
    (BatchNorm's count and sums); backward an all-reduce sum."""
    return _AllReduceStat.apply(x, group)


class _AllReduceReplicated(torch.autograd.Function):
    """Forward: sum over the group. Backward: the cotangent unchanged (every
    rank backpropagates the same replicated value, so its cotangent is
    already the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group of terms that end in a value every rank computes
    and backpropagates identically; backward the identity."""
    return _AllReduceReplicated.apply(x, group)


def all_reduce_grads(params, group) -> None:
    """Each parameter's ``.grad`` replaced by its sum over the group, in one
    all-reduce of the gradients laid end to end (a rank without one adds
    zeros; a parameter without one on every rank keeps ``None``, as an
    optimizer skips it on one device). Every rank ends with the same bits."""
    params = list(params)
    if not params:
        return
    g0 = next((p.grad for p in params if p.grad is not None), params[0])
    has = torch.tensor([p.grad is not None for p in params], dtype=g0.dtype, device=g0.device)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [has])
    dist.all_reduce(flat, group=group)
    grads, has = flat.split([flat.numel() - len(params), len(params)])
    for p, g, h in zip(params, grads.split([p.numel() for p in params]), has.tolist()):
        p.grad = g.view_as(p) if h else None
