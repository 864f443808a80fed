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

import ctypes
from typing import Dict, Optional, Tuple

import torch

from efficient_gnns_tpu_torch.ops.cuda import build
from efficient_gnns_tpu_torch.ops.cuda.segment_sum import DTYPE_CODE

F32_TINY = float(torch.finfo(torch.float32).tiny)


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


def _lib() -> ctypes.CDLL:
    lib = build.load("hub_fused")
    if lib.egt_hub_messages.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.egt_hub_messages.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.egt_hub_epilogue.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.egt_hub_cotangent.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.egt_hub_message_grad.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.egt_hub_messages, lib.egt_hub_epilogue, lib.egt_hub_cotangent,
                   lib.egt_hub_message_grad):
            fn.restype = i
        lib.egt_cuda_error_string.argtypes = [i]
        lib.egt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, shapes: Dict[str, Tuple[int, ...]],
           tensors: Dict[str, Optional[torch.Tensor]]) -> torch.device:
    """Raise unless every given tensor has its shape in ``shapes``, is
    float32, contiguous and on one cpu or cuda device, with fewer than 2**31
    entries. Returns the device."""
    given = {k: t for k, t in tensors.items() if t is not None}
    device = next(iter(given.values())).device
    for key, t in given.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must be {list(shapes[key])}, got {list(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: all tensors must be on one device, got {key} on "
                             f"{t.device} and others on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors ({key} is not)")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: int32 indexing needs < 2**31 entries ({key})")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    return device


def _layout_shapes(n: int, heads: int, d: int) -> Dict[str, Tuple[int, ...]]:
    dp, hp = hub_layout(heads, d)
    wide = (n, heads * dp + hp)
    return {"x": (n, heads, d), "z": (n, heads), "scale": (n,), "res": (n, heads, d),
            "g": (n, heads, d), "total": wide, "dy": wide}


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _msg_code(name: str, msg_dtype: torch.dtype) -> int:
    if msg_dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: message dtype must be float32 or bfloat16, got {msg_dtype}")
    return DTYPE_CODE[msg_dtype]


def hub_messages_plain(x: torch.Tensor, z: torch.Tensor, msg_dtype: torch.dtype) -> torch.Tensor:
    """``[z * x | z]`` in the layout, cast to the message dtype."""
    return _fold(x * z[:, :, None], z).to(msg_dtype)


def hub_messages(x: torch.Tensor, z: torch.Tensor, msg_dtype: torch.dtype) -> torch.Tensor:
    """The messages ``y [N, W]`` that K1 sums: ``x [N, H, D] * z [N, H]``
    per head, ``z`` in the scalar column, zeros elsewhere, in ``msg_dtype``
    (float32 or bfloat16), each entry rounded once from the float32
    product."""
    name = "hub_messages"
    code = _msg_code(name, msg_dtype)
    n, h, d = x.shape if x.dim() == 3 else (-1, -1, -1)
    device = _check(name, _layout_shapes(n, h, d), {"x": x, "z": z})
    if device.type == "cpu":
        return hub_messages_plain(x, z, msg_dtype)
    dp, hp = hub_layout(h, d)
    y = torch.empty((n, h * dp + hp), dtype=msg_dtype, device=device)
    lib = _lib()
    rc = lib.egt_hub_messages(x.data_ptr(), z.data_ptr(), y.data_ptr(), code, n, h, d, dp, hp,
                              _stream(device))
    build.raise_on_error(lib, rc, name)
    hub_messages.launches += 1
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


def hub_epilogue(total: torch.Tensor, heads: int, d: int,
                 scale: Optional[torch.Tensor] = None,
                 res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer output ``[N, H, D]`` from K1's sums ``total [N, W]``:
    ``num / den``, 0 for a denominator below the smallest normal float32,
    times ``scale [N]`` and plus ``res [N, H, D]`` where given."""
    name = "hub_epilogue"
    if total.dim() != 2:
        raise ValueError(f"{name}: total must be [N, W], got {list(total.shape)}")
    device = _check(name, _layout_shapes(total.shape[0], heads, d),
                    {"total": total, "scale": scale, "res": res})
    if device.type == "cpu":
        return hub_epilogue_plain(total, heads, d, scale, res)
    n = total.shape[0]
    dp, hp = hub_layout(heads, d)
    out = torch.empty((n, heads, d), dtype=torch.float32, device=device)
    lib = _lib()
    rc = lib.egt_hub_epilogue(total.data_ptr(), None if scale is None else scale.data_ptr(),
                              None if res is None else res.data_ptr(), out.data_ptr(),
                              n, heads, d, dp, hp, _stream(device))
    build.raise_on_error(lib, rc, name)
    hub_epilogue.launches += 1
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


def hub_cotangent(g: torch.Tensor, total: torch.Tensor, scale: Optional[torch.Tensor],
                  msg_dtype: torch.dtype) -> torch.Tensor:
    """The cotangent of ``y``'s sums ``ct [N, W]`` in ``msg_dtype``, which
    K1 carries back over the transpose: from the layer output's cotangent
    ``g [N, H, D]``, ``g * scale / den`` in the message columns and
    ``-sum_d(g * scale * out) / den`` in the scalar column (0 for an empty
    row), zeros elsewhere."""
    name = "hub_cotangent"
    code = _msg_code(name, msg_dtype)
    n, h, d = g.shape if g.dim() == 3 else (-1, -1, -1)
    device = _check(name, _layout_shapes(n, h, d), {"g": g, "total": total, "scale": scale})
    if device.type == "cpu":
        return hub_cotangent_plain(g, total, scale, msg_dtype)
    dp, hp = hub_layout(h, d)
    ct = torch.empty((n, h * dp + hp), dtype=msg_dtype, device=device)
    lib = _lib()
    rc = lib.egt_hub_cotangent(g.data_ptr(), total.data_ptr(),
                               None if scale is None else scale.data_ptr(), ct.data_ptr(),
                               code, n, h, d, dp, hp, _stream(device))
    build.raise_on_error(lib, rc, name)
    hub_cotangent.launches += 1
    return ct


def hub_message_grad_plain(dy: torch.Tensor, x: torch.Tensor, z: torch.Tensor):
    """The product's and the scalar column's cotangents of ``[z * x | z]``."""
    dzx, dcol = _unfold(dy, x.shape[1], x.shape[2])
    return dzx * z[:, :, None], (dzx * x).sum(-1) + dcol


def hub_message_grad(dy: torch.Tensor, x: torch.Tensor,
                     z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx [N, H, D], dz [N, H])`` from the messages' cotangent ``dy
    [N, W]`` (float32, K1's output over the transpose): ``dx = dy * z`` and
    ``dz = sum_d dy * x + dy[scalar column]``."""
    name = "hub_message_grad"
    n, h, d = x.shape if x.dim() == 3 else (-1, -1, -1)
    device = _check(name, _layout_shapes(n, h, d), {"dy": dy, "x": x, "z": z})
    if device.type == "cpu":
        return hub_message_grad_plain(dy, x, z)
    dp, hp = hub_layout(h, d)
    dx = torch.empty((n, h, d), dtype=torch.float32, device=device)
    dz = torch.empty((n, h), dtype=torch.float32, device=device)
    lib = _lib()
    rc = lib.egt_hub_message_grad(dy.data_ptr(), x.data_ptr(), z.data_ptr(), dx.data_ptr(),
                                  dz.data_ptr(), n, h, d, dp, hp, _stream(device))
    build.raise_on_error(lib, rc, name)
    hub_message_grad.launches += 1
    return dx, dz


hub_messages.launches = 0
hub_epilogue.launches = 0
hub_cotangent.launches = 0
hub_message_grad.launches = 0
