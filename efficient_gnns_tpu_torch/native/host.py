"""The port's ctypes loader of the repository's host library
(``native/libgnns_host.so``, built from ``native/gnns_host.cc`` with
``make -C native``; counterpart of ``efficient_gnns_tpu/native/host.py``,
which imports JAX through its package).

The port needs one entry point of it: ``random_walks``, the GraphSAINT
walker of ``sampling/saint.py`` (mt19937_64 per thread, seeded from the
sampler's NumPy generator), so that the port's sampler draws the subgraphs
the JAX sampler draws. The library is built at first use where ``make`` and
a C++ compiler exist; where none can be built, :func:`available` is False
and the sampler takes its NumPy walk, the JAX sampler's own behaviour (host
code, not a device kernel).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgnns_host.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    """The library, built with ``make`` the first time it is missing; None
    where it cannot be built or loaded (asked once a process)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                               timeout=300)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.random_walks.argtypes = [p32, p32, i64, p32, i64, i64, ctypes.c_uint64, p32]
        lib.random_walks.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True where the native walker runs; False where the sampler takes its
    NumPy walk."""
    return _load() is not None


def walker() -> str:
    """``"native"`` or ``"numpy"``: which GraphSAINT walker this process runs."""
    return "native" if available() else "numpy"


def random_walks(offsets: np.ndarray, nbrs: np.ndarray, roots: np.ndarray,
                 walk_length: int, seed: int) -> np.ndarray:
    """int32 ``[num_roots, walk_length + 1]`` node ids (root first) of walks
    over the out-edges of the CSR ``offsets`` / ``nbrs``; a dead end stays
    in place. Needs the library (:func:`available`)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native walker is not built ({_LIB_PATH})")
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    nbrs = np.ascontiguousarray(nbrs, dtype=np.int32)
    roots = np.ascontiguousarray(roots, dtype=np.int32)
    out = np.empty(len(roots) * (walk_length + 1), dtype=np.int32)
    lib.random_walks(offsets, nbrs, len(offsets) - 1, roots, len(roots), walk_length,
                     seed, out)
    return out.reshape(len(roots), walk_length + 1)
