"""The seam between the CUDA libraries of ``csrc/`` and their wrappers.

Every wrapper under ``ops/cuda/`` goes through this module, and through no
other, to reach its kernels:

* :class:`Library` binds a source's loaded library once: each symbol's
  ``argtypes`` from a string of argument kinds, ``restype`` int (a CUDA
  error code), and ``egt_cuda_error_string``;
* :func:`run` launches one symbol, raises on its error code and counts the
  launch in the wrapper's ``launches``;
* :func:`counted` gives a wrapper its ``launches`` counter and enters it in
  :data:`COUNTED`, the registry by which callers read every counter;
* :class:`Checks` refuses what no kernel takes (rank, dtype, one device,
  contiguity, a device other than cpu or cuda, 2**31 entries); each wrapper
  adds only its own shape rules;
* :func:`stream`, :func:`ptr` and the feature-row constants
  (:data:`DTYPE_CODE`, :func:`float_vec`) that the C interfaces share.

The code here is on the path of every launch: it builds no dict, list or
closure per call.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from efficient_gnns_tpu_torch.ops.cuda import build

# the C interfaces that read feature rows (csrc/row_load.cuh: K1-K4)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in one 16-byte load
FEATURES = (torch.float32, torch.bfloat16)
FLOAT = (torch.float32,)
INDEX = (torch.int32,)
MASK = (torch.bool,)

# argument kinds of a symbol's C interface, one letter each
_KINDS = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

COUNTED: Dict[str, Callable] = {}  # label -> wrapper; K1-K7 by number, the rest by name


def counted(label: Optional[str] = None) -> Callable[[Callable], Callable]:
    """Decorator: the wrapper counts its launches in ``fn.launches`` and is
    entered in :data:`COUNTED` under ``label`` (default: its name)."""
    def register(fn: Callable) -> Callable:
        fn.launches = 0
        COUNTED[label or fn.__name__] = fn
        return fn
    return register


def float_vec(dtype: torch.dtype, d: int, ptr: int) -> int:
    """Elements in one lane load of a row of ``d`` columns at address ``ptr``:
    the widest of 16 bytes, two elements (8 bytes of float32, 4 of bfloat16)
    or one element that divides ``d`` and to which the address is aligned."""
    if d % VEC[dtype] == 0 and ptr % 16 == 0:
        return VEC[dtype]
    if d % 2 == 0 and ptr % (2 * dtype.itemsize) == 0:
        return 2
    return 1


class Library:
    """``csrc/<source>.cu``'s library, built and bound at first use.

    ``symbols`` maps each C symbol to its argument kinds, one letter an
    argument (``p`` pointer, ``i`` int, ``f`` float); every symbol returns an
    int. ``constants`` maps symbols without arguments to the values the
    wrapper assumes, checked once at binding."""

    def __init__(self, source: str, symbols: Dict[str, str],
                 constants: Optional[Dict[str, int]] = None):
        self.source, self.symbols, self.constants = source, symbols, constants or {}
        self.cdll: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        if self.cdll is None:
            lib = build.load(self.source)
            for symbol, kinds in {**self.symbols, **dict.fromkeys(self.constants, "")}.items():
                fn = getattr(lib, symbol)
                fn.argtypes = [_KINDS[k] for k in kinds]
                fn.restype = ctypes.c_int
            lib.egt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.egt_cuda_error_string.restype = ctypes.c_char_p
            for symbol, want in self.constants.items():
                if getattr(lib, symbol)() != want:
                    raise RuntimeError(f"{self.source}: {symbol}() is not {want}")
            self.cdll = lib
        return self.cdll


def run(fn: Callable, library: Library, symbol: str, *args) -> None:
    """Launch ``symbol`` of ``library`` with ``args``, raise if the launch
    returned a CUDA error code (its ``cudaGetLastError()``: a refused launch
    never runs, and no later synchronisation reports it), and count it in
    ``fn.launches``."""
    lib = library.cdll if library.cdll is not None else library.load()
    rc = getattr(lib, symbol)(*args)
    if rc != 0:
        raise RuntimeError(
            f"{fn.__name__} launch failed: {lib.egt_cuda_error_string(rc).decode()}")
    fn.launches += 1


def stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, the last argument of every
    launch."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """``t``'s device address, None (a null pointer) for an absent tensor."""
    return None if t is None else t.data_ptr()


class Checks:
    """The refusals that every wrapper shares, for one wrapper's tensors.

    ``specs`` are ``(key, rank, dtypes)`` in the order :meth:`__call__`
    takes the tensors; a None tensor (an optional input) is skipped. A
    tensor is refused unless it has its rank and one of its dtypes, lies on
    the first tensor's device, is contiguous and has fewer than 2**31
    entries; then a device other than cpu or cuda is refused. Returns that
    device."""

    def __init__(self, name: str, *specs: Tuple[str, int, Tuple[torch.dtype, ...]]):
        self.name = name
        self.specs = tuple((key, rank, dtypes, f"{rank}-D " + "/".join(str(d)[6:] for d in dtypes))
                           for key, rank, dtypes in specs)

    def __call__(self, *tensors: Optional[torch.Tensor]) -> torch.device:
        name, first = self.name, tensors[0]
        device = first.device
        for (key, rank, dtypes, kind), t in zip(self.specs, tensors):
            if t is None:
                continue
            if t.dim() != rank or t.dtype not in dtypes:
                raise ValueError(f"{name}: {key} must be {kind}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if t is not first and t.device != device:
                raise ValueError(f"{name}: all tensors must be on one device, got {key} on "
                                 f"{t.device} and others on {device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} needs contiguous tensors ({key} is not)")
            if t.numel() >= 2**31:
                raise ValueError(f"{name}: int32 indexing needs < 2**31 entries ({key})")
        if not (first.is_cuda or first.is_cpu):
            raise ValueError(f"{name} runs on cpu or cuda, not {device}")
        return device
