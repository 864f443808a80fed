"""The hub attention layer's elementwise passes around K1, fused — wrappers
and plain versions.

    hub_messages       y     = [z * x | z], the z-fold layout, in the message dtype
    hub_epilogue       out   = num / den * s + res
    hub_cotangent      ct    = [g*s/den | -sum_d(g*s*out)/den], in the message dtype
    hub_message_grad   dx    = dy * z,  dz = sum_d dy * x + dy[z column]

They replace no TPU kernel: they fuse the elementwise chain of the JAX
``hub_gat_attention`` (and the DGL GAT layer's ``sqrt(deg_in)`` scale and
residual) that PyTorch would run as separate passes over ``[N, H*dp]``
float32 tensors. The CUDA kernels are ``csrc/hub_fused.cu``, bound by
device-memory bytes: each touches each element once (at the teacher's
hidden layers 0.77, 1.54, 1.29 and 1.54 GB against about 6.4 GB forward and
12 GB backward for the chain). Forward outputs are the chain's bits; the
backward's two sums over D run in another order.

Layout (:func:`hub_layout`): ``y``, ``total``, ``ct`` and ``dy`` are
``[N, H*dp + hp]``, each head's block ``dp = ceil(D / 128) * 128`` wide with
the per-head scalar in column ``D`` when ``D < dp`` (``hp = 0``), else in a
trailing block of ``hp = ceil(H / 128) * 128`` columns. ``x``, ``res``,
``out``, ``g``, ``dx`` are ``[N, H, D]``; ``z``, ``dz`` ``[N, H]``; the scale
``s`` ``[N]`` or None. Everything but the messages and the cotangent is
float32.

Each wrapper runs its plain version (the chain of PyTorch ops it replaces)
for tensors on the CPU and launches the kernel for tensors on a CUDA
device, counting the launch in its ``launches``; it never moves work
between them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from efficient_gnns_tpu_torch.ops.cuda import launch
from efficient_gnns_tpu_torch.ops.cuda.launch import DTYPE_CODE, FLOAT

F32_TINY = float(torch.finfo(torch.float32).tiny)
_LIB = launch.Library("hub_fused", {"egt_hub_messages": "pppiiiiiip",
                                    "egt_hub_epilogue": "ppppiiiiip",
                                    "egt_hub_cotangent": "ppppiiiiiip",
                                    "egt_hub_message_grad": "pppppiiiiip"})
_MESSAGES = launch.Checks("hub_messages", ("x", 3, FLOAT), ("z", 2, FLOAT))
_EPILOGUE = launch.Checks("hub_epilogue", ("total", 2, FLOAT), ("scale", 1, FLOAT),
                          ("res", 3, FLOAT))
_COTANGENT = launch.Checks("hub_cotangent", ("g", 3, FLOAT), ("total", 2, FLOAT),
                           ("scale", 1, FLOAT))
_MESSAGE_GRAD = launch.Checks("hub_message_grad", ("dy", 2, FLOAT), ("x", 3, FLOAT),
                              ("z", 2, FLOAT))


def hub_layout(heads: int, d: int) -> Tuple[int, int]:
    """``(dp, hp)``: the width of a head's block, and of the trailing block
    that holds the per-head scalars when ``d`` fills its block (else 0)."""
    dp = -(-d // 128) * 128
    return dp, (0 if d < dp else -(-heads // 128) * 128)


def _fold(body: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``[N, H, D]`` block values and ``[N, H]`` per-head scalars into the
    ``[N, W]`` layout, zeros elsewhere."""
    n, h, d = body.shape
    dp, hp = hub_layout(h, d)
    if hp == 0:
        return torch.cat([body, col[:, :, None], body.new_zeros(n, h, dp - d - 1)],
                         -1).reshape(n, h * dp)
    return torch.cat([body.reshape(n, h * dp), torch.nn.functional.pad(col, (0, hp - h))], -1)


def _unfold(t: torch.Tensor, heads: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Views ``(body [N, H, D], col [N, H])`` of an ``[N, W]`` layout."""
    n = t.shape[0]
    dp, hp = hub_layout(heads, d)
    if hp == 0:
        blocks = t.view(n, heads, dp)
        return blocks[:, :, :d], blocks[:, :, d]
    return t[:, : heads * dp].view(n, heads, dp), t[:, heads * dp: heads * dp + heads]


def normalize(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` per (node, head), 0 where ``den`` is below the smallest
    normal float32 (an empty row divides its zeros by inf)."""
    return num / torch.where(den >= F32_TINY, den, float("inf"))[:, :, None]


def normalize_grads(g: torch.Tensor, out: torch.Tensor, den: torch.Tensor):
    """The cotangents of :func:`normalize`'s ``num`` and ``den`` from ``g``
    and its output ``out``: ``1 / den`` formed once (``den**2`` underflows
    for ``den < ~1e-19``), and 0 for an empty row."""
    pos = (den >= F32_TINY)[:, :, None]
    inv = torch.where(pos, 1.0, 0.0) / torch.where(pos, den[:, :, None], 1.0)
    return g * inv, -(g * out).sum(-1) * inv[:, :, 0]


def _check_shape(name: str, key: str, t: Optional[torch.Tensor],
                 shape: Tuple[int, ...]) -> None:
    if t is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: {key} must be {list(shape)}, got {list(t.shape)}")


def _msg_code(name: str, msg_dtype: torch.dtype) -> int:
    if msg_dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: message dtype must be float32 or bfloat16, got {msg_dtype}")
    return DTYPE_CODE[msg_dtype]


def hub_messages_plain(x: torch.Tensor, z: torch.Tensor, msg_dtype: torch.dtype) -> torch.Tensor:
    """``[z * x | z]`` in the layout, cast to the message dtype."""
    return _fold(x * z[:, :, None], z).to(msg_dtype)


@launch.counted()
def hub_messages(x: torch.Tensor, z: torch.Tensor, msg_dtype: torch.dtype) -> torch.Tensor:
    """The messages ``y [N, W]`` that K1 sums: ``x [N, H, D] * z [N, H]``
    per head, ``z`` in the scalar column, zeros elsewhere, in ``msg_dtype``
    (float32 or bfloat16), each entry rounded once from the float32
    product."""
    name = "hub_messages"
    code = _msg_code(name, msg_dtype)
    device = _MESSAGES(x, z)
    n, h, d = x.shape
    _check_shape(name, "z", z, (n, h))
    if x.is_cpu:
        return hub_messages_plain(x, z, msg_dtype)
    dp, hp = hub_layout(h, d)
    y = torch.empty((n, h * dp + hp), dtype=msg_dtype, device=device)
    launch.run(hub_messages, _LIB, "egt_hub_messages", x.data_ptr(), z.data_ptr(),
               y.data_ptr(), code, n, h, d, dp, hp, launch.stream(device))
    return y


def hub_epilogue_plain(total: torch.Tensor, heads: int, d: int,
                       scale: Optional[torch.Tensor] = None,
                       res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`normalize`, then ``* scale``, then ``+ res``."""
    num, den = _unfold(total, heads, d)
    out = normalize(num, den)
    if scale is not None:
        out = out * scale[:, None, None]
    if res is not None:
        out = out + res
    return out


@launch.counted()
def hub_epilogue(total: torch.Tensor, heads: int, d: int,
                 scale: Optional[torch.Tensor] = None,
                 res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer output ``[N, H, D]`` from K1's sums ``total [N, W]``:
    ``num / den``, 0 for a denominator below the smallest normal float32,
    times ``scale [N]`` and plus ``res [N, H, D]`` where given."""
    name = "hub_epilogue"
    device = _EPILOGUE(total, scale, res)
    n = total.shape[0]
    dp, hp = hub_layout(heads, d)
    _check_shape(name, "total", total, (n, heads * dp + hp))
    _check_shape(name, "scale", scale, (n,))
    _check_shape(name, "res", res, (n, heads, d))
    if total.is_cpu:
        return hub_epilogue_plain(total, heads, d, scale, res)
    out = torch.empty((n, heads, d), dtype=torch.float32, device=device)
    launch.run(hub_epilogue, _LIB, "egt_hub_epilogue", total.data_ptr(), launch.ptr(scale),
               launch.ptr(res), out.data_ptr(), n, heads, d, dp, hp, launch.stream(device))
    return out


def hub_cotangent_plain(g: torch.Tensor, total: torch.Tensor,
                        scale: Optional[torch.Tensor], msg_dtype: torch.dtype) -> torch.Tensor:
    """``g * scale``, then :func:`normalize_grads` against the recomputed
    output, folded into the layout and cast to the message dtype."""
    n, h, d = g.shape
    num, den = _unfold(total, h, d)
    if scale is not None:
        g = g * scale[:, None, None]
    dnum, dden = normalize_grads(g, normalize(num, den), den)
    return _fold(dnum, dden).to(msg_dtype)


@launch.counted()
def hub_cotangent(g: torch.Tensor, total: torch.Tensor, scale: Optional[torch.Tensor],
                  msg_dtype: torch.dtype) -> torch.Tensor:
    """The cotangent of ``y``'s sums ``ct [N, W]`` in ``msg_dtype``, which
    K1 carries back over the transpose: from the layer output's cotangent
    ``g [N, H, D]``, ``g * scale / den`` in the message columns and
    ``-sum_d(g * scale * out) / den`` in the scalar column (0 for an empty
    row), zeros elsewhere."""
    name = "hub_cotangent"
    code = _msg_code(name, msg_dtype)
    device = _COTANGENT(g, total, scale)
    n, h, d = g.shape
    dp, hp = hub_layout(h, d)
    _check_shape(name, "total", total, (n, h * dp + hp))
    _check_shape(name, "scale", scale, (n,))
    if g.is_cpu:
        return hub_cotangent_plain(g, total, scale, msg_dtype)
    ct = torch.empty((n, h * dp + hp), dtype=msg_dtype, device=device)
    launch.run(hub_cotangent, _LIB, "egt_hub_cotangent", g.data_ptr(), total.data_ptr(),
               launch.ptr(scale), ct.data_ptr(), code, n, h, d, dp, hp,
               launch.stream(device))
    return ct


def hub_message_grad_plain(dy: torch.Tensor, x: torch.Tensor, z: torch.Tensor):
    """The product's and the scalar column's cotangents of ``[z * x | z]``."""
    dzx, dcol = _unfold(dy, x.shape[1], x.shape[2])
    return dzx * z[:, :, None], (dzx * x).sum(-1) + dcol


@launch.counted()
def hub_message_grad(dy: torch.Tensor, x: torch.Tensor,
                     z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx [N, H, D], dz [N, H])`` from the messages' cotangent ``dy
    [N, W]`` (float32, K1's output over the transpose): ``dx = dy * z`` and
    ``dz = sum_d dy * x + dy[scalar column]``."""
    name = "hub_message_grad"
    device = _MESSAGE_GRAD(dy, x, z)
    n, h, d = x.shape
    dp, hp = hub_layout(h, d)
    _check_shape(name, "dy", dy, (n, h * dp + hp))
    _check_shape(name, "z", z, (n, h))
    if dy.is_cpu:
        return hub_message_grad_plain(dy, x, z)
    dx = torch.empty((n, h, d), dtype=torch.float32, device=device)
    dz = torch.empty((n, h), dtype=torch.float32, device=device)
    launch.run(hub_message_grad, _LIB, "egt_hub_message_grad", dy.data_ptr(), x.data_ptr(),
               z.data_ptr(), dx.data_ptr(), dz.data_ptr(), n, h, d, dp, hp,
               launch.stream(device))
    return dx, dz
