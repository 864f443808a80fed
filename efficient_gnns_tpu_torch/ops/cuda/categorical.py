"""OGB's AtomEncoder and BondEncoder as CUDA kernels — the wrappers, the
autograd function and the plain version.

    forward    out[r] = W_0[k(r, 0)] + ... + W_{T-1}[k(r, T-1)],
               k(r, t) = min(max(ids[r, t], 0), V_t - 1), added left to right
    backward   dW_t[v] = sum of dy[r] over the rows r with k(r, t) == v, every
               table's gradient from the one cotangent

They replace no TPU kernel: the JAX encoder
(``efficient_gnns_tpu/models/mol.py::CategoricalEncoder``) is XLA's gathers
and adds. The kernels are ``csrc/categorical.cu``, one a direction: the
forward has the bits of the chain of ``F.embedding`` and adds
(:func:`categorical_encode_plain`); the backward bins the rows by category
in shared memory, one owner an element and a fixed order (no sort, no float
atomics, no host synchronisation), so it repeats its bits. The gradients
are views of one ``[sum V_t, F]`` buffer.

:func:`categorical_encode` runs the plain version for tensors on the CPU and
the kernels for tensors on a CUDA device, where it takes int32 ids
``[R, T]`` and float32 tables of the two encoders' table counts (``T`` = 9
atom tables or 3 bond tables, :data:`TABLE_COUNTS`) and never falls back. Each kernel's wrapper
counts its launches in its ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from efficient_gnns_tpu_torch.ops.cuda import launch
from efficient_gnns_tpu_torch.ops.cuda.launch import FLOAT, INDEX, float_vec, stream

# the bond and the atom encoders' (models/mol.py): the kernels are built for these alone
TABLE_COUNTS = (3, 9)
MAX_BINS = 256  # egt_categorical_max_bins(): the tables' rows together at most
_LIB = launch.Library("categorical", {
    "egt_categorical_encode": "pppp" + "iiii" + "p",
    "egt_categorical_grad": "pppp" + "iii" + "p",
}, constants={"egt_categorical_max_bins": MAX_BINS})
_CHECK = launch.Checks("categorical_encode", ("feats", 2, INDEX),
                       *((f"tables[{i}]", 2, FLOAT) for i in range(max(TABLE_COUNTS))))


def categorical_encode_plain(feats: torch.Tensor,
                             tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """The encoder as a chain of PyTorch ops: each column clipped into its
    table's rows, one ``F.embedding`` a column, the lookups added left to
    right."""
    max_index = torch.tensor([w.shape[0] - 1 for w in tables], dtype=feats.dtype,
                             device=feats.device)
    idx = torch.minimum(feats.clamp_min(0), max_index)
    out = F.embedding(idx[..., 0], tables[0])
    for i in range(1, len(tables)):
        out = out + F.embedding(idx[..., i], tables[i])
    return out


def _ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


@launch.counted()
def categorical_fwd(feats: torch.Tensor, tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """The lookup and sum in one kernel: ``[R, F]``."""
    rows, t = feats.shape
    f = tables[0].shape[1]
    out = torch.empty((rows, f), dtype=torch.float32, device=feats.device)
    ptrs = [w.data_ptr() for w in tables]
    vec = min(float_vec(torch.float32, f, p) for p in (*ptrs, out.data_ptr()))
    launch.run(categorical_fwd, _LIB, "egt_categorical_encode",
               feats.data_ptr(), (ctypes.c_void_p * t)(*ptrs), _ints([w.shape[0] for w in tables]),
               out.data_ptr(), rows, t, f, vec, stream(feats.device))
    return out


@launch.counted()
def categorical_bwd(dy: torch.Tensor, feats: torch.Tensor,
                    vocab: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
    """Every table's gradient in one kernel: views ``[V_t, F]`` of one
    ``[sum V_t, F]`` buffer."""
    rows, t = feats.shape
    f = dy.shape[1]
    dw = torch.empty((sum(vocab), f), dtype=torch.float32, device=dy.device)
    launch.run(categorical_bwd, _LIB, "egt_categorical_grad",
               dy.data_ptr(), feats.data_ptr(), _ints(vocab), dw.data_ptr(), rows, t, f,
               stream(dy.device))
    return dw.split(vocab)


KERNELS = (categorical_fwd, categorical_bwd)


class _CategoricalEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, *tables):
        ctx.save_for_backward(feats)
        ctx.vocab = tuple(w.shape[0] for w in tables)
        return categorical_fwd(feats, tables)

    @staticmethod
    def backward(ctx, dy):
        (feats,) = ctx.saved_tensors
        return (None, *categorical_bwd(dy.contiguous(), feats, ctx.vocab))


def _check(feats: torch.Tensor, tables: Sequence[torch.Tensor]) -> None:
    """Raise unless ``feats`` is int32 ``[R, T]`` and the ``T`` tables float32
    ``[V_t, F]`` of one ``F`` (T in TABLE_COUNTS, V_t >= 1, sum V_t <=
    MAX_BINS), all contiguous on one CUDA device, with fewer than 2**31
    entries each."""
    if len(tables) not in TABLE_COUNTS:
        raise ValueError(f"categorical_encode takes {' or '.join(map(str, TABLE_COUNTS))} "
                         f"tables (the bond and atom encoders'), got {len(tables)}")
    _CHECK(feats, *tables)
    f = tables[0].shape[1]
    if (feats.shape[1] != len(tables) or any(w.shape[1] != f or w.shape[0] < 1 for w in tables)
            or feats.shape[0] * f >= 2**31):
        raise ValueError("categorical_encode: feats [R, T] and T tables [V_t, F] disagree: "
                         f"{list(feats.shape)}, {[list(w.shape) for w in tables]}")
    if sum(w.shape[0] for w in tables) > MAX_BINS:
        raise ValueError(f"categorical_encode: the tables' rows together exceed {MAX_BINS}")


def categorical_encode(feats: torch.Tensor, tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over columns ``t`` of ``tables[t]``'s row ``feats[..., t]``
    clipped into the table, differentiable in the tables. On the CPU the
    plain version; on a CUDA device the kernels, for ``feats`` ``[R, T]``."""
    if feats.is_cpu:
        return categorical_encode_plain(feats, tables)
    _check(feats, tables)
    return _CategoricalEncode.apply(feats, *tables)
