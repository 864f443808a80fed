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

import ctypes
from typing import Callable, Optional, Tuple

import torch

from efficient_gnns_tpu_torch.ops.cuda import build

SMALL_ROWS = 2048  # egt_masked_bn_small_rows(): the one-kernel path's rows at most
LANES = 32  # egt_masked_bn_lanes(): threads along the columns in a CTA of the other kernels
CHUNK_CTAS = 256  # CTAs the chunks of rows aim at, over all column slices
Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def _lib() -> ctypes.CDLL:
    lib = build.load("masked_bn")
    if lib.egt_masked_bn_fused.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.egt_masked_bn_small_rows.argtypes = lib.egt_masked_bn_lanes.argtypes = []
        lib.egt_masked_bn_fused.argtypes = [p] * 9 + [i, i, f, f, f, i, p]
        lib.egt_masked_bn_grad_fused.argtypes = [p] * 10 + [i, i, i, i, p]
        lib.egt_masked_bn_partials.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.egt_masked_bn_apply.argtypes = [p] * 11 + [i] * 5 + [f, f, f, i, p]
        lib.egt_masked_bn_grad_partials.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.egt_masked_bn_grad_apply.argtypes = [p] * 13 + [i] * 7 + [p]
        lib.egt_masked_bn_eval.argtypes = [p] * 8 + [i] * 5 + [f, i, p]
        for fn in (lib.egt_masked_bn_small_rows, lib.egt_masked_bn_lanes, lib.egt_masked_bn_fused,
                   lib.egt_masked_bn_grad_fused, lib.egt_masked_bn_partials,
                   lib.egt_masked_bn_apply, lib.egt_masked_bn_grad_partials,
                   lib.egt_masked_bn_grad_apply, lib.egt_masked_bn_eval):
            fn.restype = i
        lib.egt_cuda_error_string.argtypes = [i]
        lib.egt_cuda_error_string.restype = ctypes.c_char_p
        if (lib.egt_masked_bn_small_rows(), lib.egt_masked_bn_lanes()) != (SMALL_ROWS, LANES):
            raise RuntimeError("masked_bn: the library's constants are not SMALL_ROWS, LANES")
    return lib


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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _columns(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape[1], dtype=torch.float32, device=x.device)


def _launch(fn, name: str, *args) -> None:
    lib = _lib()
    build.raise_on_error(lib, getattr(lib, f"egt_masked_bn_{name}")(*args), f"masked_bn {name}")
    fn.launches += 1


def bn_fused(x, mask, scale, bias, running_mean, running_var, momentum: float, epsilon: float,
             relu: bool):
    """The training forward in one kernel (``n <= SMALL_ROWS``): ``(y, mean,
    rstd)``; steps the running statistics in place."""
    y, mean, rstd = torch.empty_like(x), _columns(x), _columns(x)
    n, f = x.shape
    _launch(bn_fused, "fused", x.data_ptr(), _ptr(mask), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), n, f, momentum, 1 - momentum, epsilon, int(relu),
            _stream(x.device))
    return y, mean, rstd


def bn_partials(x, mask) -> Stats:
    """Per chunk of rows and column, the masked rows' ``(mean, M2)`` ``[chunks,
    F]`` and count ``[chunks]``."""
    n, f = x.shape
    vec = vec_for(x)
    chunks, rows = chunks_for(n, f, vec)
    pmean = torch.empty((chunks, f), dtype=torch.float32, device=x.device)
    pm2, pcount = torch.empty_like(pmean), torch.empty(chunks, dtype=torch.float32,
                                                         device=x.device)
    _launch(bn_partials, "partials", x.data_ptr(), _ptr(mask), pmean.data_ptr(),
            pm2.data_ptr(), pcount.data_ptr(), n, f, vec, chunks, rows, _stream(x.device))
    return pmean, pm2, pcount


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
    _launch(bn_apply, "apply", x.data_ptr(), pmean.data_ptr(), pm2.data_ptr(),
            pcount.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            n, f, vec, chunks, rows, momentum, 1 - momentum, epsilon, int(relu),
            _stream(x.device))
    return y, mean, rstd


def bn_eval(x, scale, bias, running_mean, running_var, epsilon: float, relu: bool):
    """The eval-mode forward, one pass with the running statistics: ``(y,
    mean, rstd)``."""
    n, f = x.shape
    vec = vec_for(x)
    chunks, rows = chunks_for(n, f, vec)
    y, mean, rstd = torch.empty_like(x), _columns(x), _columns(x)
    _launch(bn_eval, "eval", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), n, f, vec, chunks, rows, epsilon, int(relu), _stream(x.device))
    return y, mean, rstd


def _grads(x):
    return torch.empty_like(x), _columns(x), _columns(x)


def bn_grad_fused(dy, x, mask, mean, rstd, scale, bias, relu: bool, frozen: bool):
    """The backward in one kernel (``n <= SMALL_ROWS``): ``(dx, dscale,
    dbias)``; ``frozen`` (eval mode) keeps every row out of the statistics."""
    dx, dscale, dbias = _grads(x)
    n, f = x.shape
    _launch(bn_grad_fused, "grad_fused", dy.data_ptr(), x.data_ptr(), _ptr(mask),
            mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), n, f, int(relu), int(frozen),
            _stream(x.device))
    return dx, dscale, dbias


def bn_grad_partials(dy, x, mask, mean, rstd, scale, bias, relu: bool, frozen: bool) -> Stats:
    """Per chunk of rows and column, ``sum dz`` and ``sum dz * xh`` over every
    row ``[chunks, F]``, and the count of the statistics' rows ``[chunks]``."""
    n, f = x.shape
    vec = vec_for(x, dy)
    chunks, rows = chunks_for(n, f, vec)
    pdz = torch.empty((chunks, f), dtype=torch.float32, device=x.device)
    pdzx, pcount = torch.empty_like(pdz), torch.empty(chunks, dtype=torch.float32,
                                                       device=x.device)
    _launch(bn_grad_partials, "grad_partials", dy.data_ptr(), x.data_ptr(), _ptr(mask),
            mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            pdz.data_ptr(), pdzx.data_ptr(), pcount.data_ptr(), n, f, vec, chunks, rows,
            int(relu), int(frozen), _stream(x.device))
    return pdz, pdzx, pcount


def bn_grad_apply(dy, x, mask, partials: Stats, mean, rstd, scale, bias, relu: bool,
                  frozen: bool):
    """The backward's second kernel: merges :func:`bn_grad_partials`' sums
    and writes ``(dx, dscale, dbias)``."""
    n, f = x.shape
    vec = vec_for(x, dy)  # as bn_grad_partials took it
    chunks, rows = chunks_for(n, f, vec)
    dx, dscale, dbias = _grads(x)
    pdz, pdzx, pcount = partials
    _launch(bn_grad_apply, "grad_apply", dy.data_ptr(), x.data_ptr(), _ptr(mask),
            mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            pdz.data_ptr(), pdzx.data_ptr(), pcount.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), n, f, vec, chunks, rows, int(relu),
            int(frozen), _stream(x.device))
    return dx, dscale, dbias


KERNELS = (bn_fused, bn_partials, bn_apply, bn_eval, bn_grad_fused, bn_grad_partials,
           bn_grad_apply)
for _fn in KERNELS:
    _fn.launches = 0


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
    """Raise unless ``x`` is a contiguous float32 ``[N, F]`` CUDA tensor with
    fewer than 2**31 entries, ``mask`` None or bool ``[N]``, and the others
    float32 ``[F]``, all contiguous on ``x``'s device."""
    name = "masked_batch_norm"
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32 [N, F], got {x.dtype} "
                         f"{list(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: int32 indexing needs < 2**31 entries")
    n, f = x.shape
    if mask is not None and (mask.shape != (n,) or mask.dtype != torch.bool
                             or mask.device != x.device or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be a contiguous bool [{n}] on {x.device}")
    for key, t in (("scale", scale), ("bias", bias), ("running_mean", running_mean),
                   ("running_var", running_var)):
        if (t.shape != (f,) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous float32 [{f}] on {x.device}")


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
    if x.device.type == "cpu":
        return masked_batch_norm_plain(x, mask, scale, bias, running_mean, running_var,
                                       training=training, momentum=momentum, epsilon=epsilon,
                                       relu=relu, two_pass=two_pass)
    if x.device.type != "cuda":
        raise ValueError(f"masked_batch_norm runs on cpu or cuda, not {x.device}")
    _check(x, mask, scale, bias, running_mean, running_var)
    return _MaskedBatchNorm.apply(x, scale, bias, mask, running_mean, running_var,
                                  bool(training), float(momentum), float(epsilon), bool(relu))
