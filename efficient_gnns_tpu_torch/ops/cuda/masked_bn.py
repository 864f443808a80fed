"""MaskedBatchNorm's statistics, normalisation, affine and optional ReLU as
CUDA kernels — the wrappers, the autograd function and the plain version.

    training   y = act((x - mean) * rsqrt(var + eps) * scale + bias), the
               biased mean and variance over the rows of ``mask`` (every row
               without one); running = running * momentum + (1 - momentum) * stat
    eval       the same with the running statistics
    backward   dx, dscale, dbias; the rows outside ``mask`` take only the
               direct term ``dy * act' * scale * rstd``

They replace no TPU kernel: they fuse the chain of PyTorch passes of
``models/layers.py::MaskedBatchNorm`` (the JAX layer's XLA elementwise work
and reductions), about 26 kernels forward and 30 backward. The kernels are
``csrc/masked_bn.cu``. The row count picks the design: up to
:data:`SMALL_ROWS` rows one kernel a direction (:func:`bn_fused`,
:func:`bn_grad_fused`; the molhiv batches), above it two
(:func:`bn_partials` then :func:`bn_apply`, :func:`bn_grad_partials` then
:func:`bn_grad_apply`; ogbn-arxiv), and one eval-mode pass (:func:`bn_eval`)
for every size. The variance is the mean squared deviation, merged from
per-tile partials by Chan's formula in a fixed order, so the kernels repeat
their bits; the backward recomputes the ReLU's mask from ``x`` and the saved
``mean`` and ``rstd``, so only ``x`` is kept of the ``[N, F]`` tensors.

:func:`masked_batch_norm` runs the plain version (:func:`masked_batch_norm_plain`,
the layer's chain of PyTorch ops) for tensors on the CPU and the kernels for
tensors on a CUDA device, where it takes float32 only and never falls back.
Each kernel's wrapper counts its launches in its ``launches``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from efficient_gnns_tpu_torch.ops.cuda import launch
from efficient_gnns_tpu_torch.ops.cuda.launch import FLOAT, MASK, ptr, stream

SMALL_ROWS = 2048  # egt_masked_bn_small_rows(): the one-kernel path's rows at most
LANES = 32  # egt_masked_bn_lanes(): threads along the columns in a CTA of the other kernels
CHUNK_CTAS = 256  # CTAs the chunks of rows aim at, over all column slices
Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_LIB = launch.Library("masked_bn", {
    "egt_masked_bn_fused": "p" * 9 + "iifffip",
    "egt_masked_bn_grad_fused": "p" * 10 + "iiiip",
    "egt_masked_bn_partials": "p" * 5 + "i" * 5 + "p",
    "egt_masked_bn_apply": "p" * 11 + "i" * 5 + "fffip",
    "egt_masked_bn_grad_partials": "p" * 10 + "i" * 7 + "p",
    "egt_masked_bn_grad_apply": "p" * 13 + "i" * 7 + "p",
    "egt_masked_bn_eval": "p" * 8 + "i" * 5 + "fip",
}, constants={"egt_masked_bn_small_rows": SMALL_ROWS, "egt_masked_bn_lanes": LANES})
_CHECK = launch.Checks("masked_batch_norm", ("x", 2, FLOAT), ("mask", 1, MASK),
                       ("scale", 1, FLOAT), ("bias", 1, FLOAT), ("running_mean", 1, FLOAT),
                       ("running_var", 1, FLOAT))


def batch_stats(x: torch.Tensor, mask: Optional[torch.Tensor], two_pass: bool = False,
                reduce: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean and the biased variance over the rows (those of ``mask``),
    ``E[x^2] - E[x]^2`` or, ``two_pass``, the mean squared deviation;
    ``reduce(count, s1, s2)`` sums the count and both sums over a process
    group (one pass only)."""
    xf = x.float()
    if mask is not None:
        m = mask.float()[:, None]
        count, rows = m.sum(), (lambda t: t * m)
    else:
        count, rows = torch.tensor(float(x.shape[0]), device=x.device), (lambda t: t)
    s1 = rows(xf).sum(0)
    if two_pass:
        count = count.clamp_min(1.0)
        mean = s1 / count
        dev = xf - mean
        return mean, rows(dev * dev).sum(0) / count
    s2 = rows(xf * xf).sum(0)
    if reduce is not None:
        count, s1, s2 = reduce(count, s1, s2)
    count = count.clamp_min(1.0)
    mean = s1 / count
    return mean, (s2 / count - mean * mean).clamp_min(0.0)


def masked_batch_norm_plain(x: torch.Tensor, mask: Optional[torch.Tensor], scale: torch.Tensor,
                            bias: torch.Tensor, running_mean: torch.Tensor,
                            running_var: torch.Tensor, *, training: bool, momentum: float,
                            epsilon: float, relu: bool = False, two_pass: bool = False,
                            reduce: Optional[Callable] = None) -> torch.Tensor:
    """The layer as a chain of PyTorch ops: :func:`batch_stats` and the
    running statistics' step in training, the running statistics in eval,
    then the normalisation, the affine and the optional ReLU."""
    if training:
        mean, var = batch_stats(x, mask, two_pass, reduce)
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1 - momentum) * mean)
            running_var.mul_(momentum).add_((1 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    y = (x.float() - mean) * torch.rsqrt(var + epsilon)
    y = (y * scale + bias).to(x.dtype)
    return torch.relu(y) if relu else y


def vec_for(*tensors: torch.Tensor) -> int:
    """Columns a thread of the two-kernel and eval kernels loads at once: 4,
    2 or 1, the most that the width and every tensor's address allow."""
    f = tensors[0].shape[1]
    for vec in (4, 2):
        if f % vec == 0 and all(t.data_ptr() % (4 * vec) == 0 for t in tensors):
            return vec
    return 1


def chunks_for(n: int, f: int, vec: int = 1) -> Tuple[int, int]:
    """``(chunks, rows_per_chunk)`` of the two-kernel and eval kernels: at
    most one chunk a 128 rows, and about :data:`CHUNK_CTAS` CTAs over the
    ``ceil(f / (32 vec))`` column slices. A function of the shape alone."""
    slices = max(1, -(-f // (LANES * vec)))
    chunks = max(1, min(-(-n // 128), -(-CHUNK_CTAS // slices)))
    rows = max(1, -(-n // chunks))
    return max(1, -(-n // rows)), rows


def _columns(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape[1], dtype=torch.float32, device=x.device)


@launch.counted()
def bn_fused(x, mask, scale, bias, running_mean, running_var, momentum: float, epsilon: float,
             relu: bool):
    """The training forward in one kernel (``n <= SMALL_ROWS``): ``(y, mean,
    rstd)``; steps the running statistics in place."""
    y, mean, rstd = torch.empty_like(x), _columns(x), _columns(x)
    n, f = x.shape
    launch.run(bn_fused, _LIB, "egt_masked_bn_fused",
               x.data_ptr(), ptr(mask), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
               mean.data_ptr(), rstd.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
               n, f, momentum, 1 - momentum, epsilon, int(relu), stream(x.device))
    return y, mean, rstd


@launch.counted()
def bn_partials(x, mask) -> Stats:
    """Per chunk of rows and column, the masked rows' ``(mean, M2)`` ``[chunks,
    F]`` and count ``[chunks]``."""
    n, f = x.shape
    vec = vec_for(x)
    chunks, rows = chunks_for(n, f, vec)
    pmean = torch.empty((chunks, f), dtype=torch.float32, device=x.device)
    pm2, pcount = torch.empty_like(pmean), torch.empty(chunks, dtype=torch.float32,
                                                         device=x.device)
    launch.run(bn_partials, _LIB, "egt_masked_bn_partials",
               x.data_ptr(), ptr(mask), pmean.data_ptr(), pm2.data_ptr(), pcount.data_ptr(), n, f,
               vec, chunks, rows, stream(x.device))
    return pmean, pm2, pcount


@launch.counted()
def bn_apply(x, partials: Stats, scale, bias, running_mean, running_var, momentum: float,
             epsilon: float, relu: bool):
    """The training forward's second kernel: merges :func:`bn_partials`'
    partials and normalises; ``(y, mean, rstd)``, the running statistics
    stepped in place."""
    n, f = x.shape
    vec = vec_for(x)  # as bn_partials took it
    chunks, rows = chunks_for(n, f, vec)
    y, mean, rstd = torch.empty_like(x), _columns(x), _columns(x)
    pmean, pm2, pcount = partials
    launch.run(bn_apply, _LIB, "egt_masked_bn_apply",
               x.data_ptr(), pmean.data_ptr(), pm2.data_ptr(), pcount.data_ptr(), scale.data_ptr(),
               bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
               running_mean.data_ptr(), running_var.data_ptr(), n, f, vec, chunks, rows, momentum,
               1 - momentum, epsilon, int(relu), stream(x.device))
    return y, mean, rstd


@launch.counted()
def bn_eval(x, scale, bias, running_mean, running_var, epsilon: float, relu: bool):
    """The eval-mode forward, one pass with the running statistics: ``(y,
    mean, rstd)``."""
    n, f = x.shape
    vec = vec_for(x)
    chunks, rows = chunks_for(n, f, vec)
    y, mean, rstd = torch.empty_like(x), _columns(x), _columns(x)
    launch.run(bn_eval, _LIB, "egt_masked_bn_eval",
               x.data_ptr(), scale.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
               running_var.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, f, vec,
               chunks, rows, epsilon, int(relu), stream(x.device))
    return y, mean, rstd


def _grads(x):
    return torch.empty_like(x), _columns(x), _columns(x)


@launch.counted()
def bn_grad_fused(dy, x, mask, mean, rstd, scale, bias, relu: bool, frozen: bool):
    """The backward in one kernel (``n <= SMALL_ROWS``): ``(dx, dscale,
    dbias)``; ``frozen`` (eval mode) keeps every row out of the statistics."""
    dx, dscale, dbias = _grads(x)
    n, f = x.shape
    launch.run(bn_grad_fused, _LIB, "egt_masked_bn_grad_fused",
               dy.data_ptr(), x.data_ptr(), ptr(mask), mean.data_ptr(), rstd.data_ptr(),
               scale.data_ptr(), bias.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
               dbias.data_ptr(), n, f, int(relu), int(frozen), stream(x.device))
    return dx, dscale, dbias


@launch.counted()
def bn_grad_partials(dy, x, mask, mean, rstd, scale, bias, relu: bool, frozen: bool) -> Stats:
    """Per chunk of rows and column, ``sum dz`` and ``sum dz * xh`` over every
    row ``[chunks, F]``, and the count of the statistics' rows ``[chunks]``."""
    n, f = x.shape
    vec = vec_for(x, dy)
    chunks, rows = chunks_for(n, f, vec)
    pdz = torch.empty((chunks, f), dtype=torch.float32, device=x.device)
    pdzx, pcount = torch.empty_like(pdz), torch.empty(chunks, dtype=torch.float32,
                                                       device=x.device)
    launch.run(bn_grad_partials, _LIB, "egt_masked_bn_grad_partials",
               dy.data_ptr(), x.data_ptr(), ptr(mask), mean.data_ptr(), rstd.data_ptr(),
               scale.data_ptr(), bias.data_ptr(), pdz.data_ptr(), pdzx.data_ptr(),
               pcount.data_ptr(), n, f, vec, chunks, rows, int(relu), int(frozen), stream(x.device))
    return pdz, pdzx, pcount


@launch.counted()
def bn_grad_apply(dy, x, mask, partials: Stats, mean, rstd, scale, bias, relu: bool,
                  frozen: bool):
    """The backward's second kernel: merges :func:`bn_grad_partials`' sums
    and writes ``(dx, dscale, dbias)``."""
    n, f = x.shape
    vec = vec_for(x, dy)  # as bn_grad_partials took it
    chunks, rows = chunks_for(n, f, vec)
    dx, dscale, dbias = _grads(x)
    pdz, pdzx, pcount = partials
    launch.run(bn_grad_apply, _LIB, "egt_masked_bn_grad_apply",
               dy.data_ptr(), x.data_ptr(), ptr(mask), mean.data_ptr(), rstd.data_ptr(),
               scale.data_ptr(), bias.data_ptr(), pdz.data_ptr(), pdzx.data_ptr(),
               pcount.data_ptr(), dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), n, f, vec,
               chunks, rows, int(relu), int(frozen), stream(x.device))
    return dx, dscale, dbias


KERNELS = (bn_fused, bn_partials, bn_apply, bn_eval, bn_grad_fused, bn_grad_partials,
           bn_grad_apply)


class _MaskedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, mask, running_mean, running_var, training, momentum,
                epsilon, relu):
        if not training:
            y, mean, rstd = bn_eval(x, scale, bias, running_mean, running_var, epsilon, relu)
        elif x.shape[0] <= SMALL_ROWS:
            y, mean, rstd = bn_fused(x, mask, scale, bias, running_mean, running_var, momentum,
                                     epsilon, relu)
        else:
            y, mean, rstd = bn_apply(x, bn_partials(x, mask), scale, bias, running_mean,
                                     running_var, momentum, epsilon, relu)
        ctx.save_for_backward(x, mask, mean, rstd, scale, bias)
        ctx.relu, ctx.frozen = relu, not training
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mask, mean, rstd, scale, bias = ctx.saved_tensors
        dy = dy.contiguous()
        args = (dy, x, mask, mean, rstd, scale, bias, ctx.relu, ctx.frozen)
        if x.shape[0] <= SMALL_ROWS:
            dx, dscale, dbias = bn_grad_fused(*args)
        else:
            dx, dscale, dbias = bn_grad_apply(dy, x, mask, bn_grad_partials(*args),
                                              *args[3:])
        return dx, dscale, dbias, None, None, None, None, None, None, None


def _check(x, mask, scale, bias, running_mean, running_var) -> None:
    """Raise unless ``x`` is float32 ``[N, F]``, ``mask`` None or bool
    ``[N]``, and the others float32 ``[F]``, all contiguous on one CUDA
    device, with fewer than 2**31 entries each."""
    _CHECK(x, mask, scale, bias, running_mean, running_var)
    n, f = x.shape
    if ((mask is not None and mask.shape[0] != n) or scale.shape[0] != f
            or bias.shape[0] != f or running_mean.shape[0] != f or running_var.shape[0] != f):
        raise ValueError("masked_batch_norm: mask [N] and scale, bias, running_mean, "
                         f"running_var [F] disagree with x [N, F] = {list(x.shape)}")


def masked_batch_norm(x: torch.Tensor, mask: Optional[torch.Tensor], scale: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor,
                      running_var: torch.Tensor, *, training: bool, momentum: float,
                      epsilon: float, relu: bool = False,
                      two_pass: bool = False) -> torch.Tensor:
    """``act(BatchNorm(x))`` over the rows of ``mask``, differentiable in
    ``x``, ``scale`` and ``bias``; the running statistics stepped in place in
    training. On the CPU the plain version (``two_pass`` picks its variance);
    on a CUDA device the kernels, whose variance is always the mean squared
    deviation."""
    if x.is_cpu:
        return masked_batch_norm_plain(x, mask, scale, bias, running_mean, running_var,
                                       training=training, momentum=momentum, epsilon=epsilon,
                                       relu=relu, two_pass=two_pass)
    _check(x, mask, scale, bias, running_mean, running_var)
    return _MaskedBatchNorm.apply(x, scale, bias, mask, running_mean, running_var,
                                  bool(training), float(momentum), float(epsilon), bool(relu))
