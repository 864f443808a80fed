"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` (plain C
interface, no PyTorch headers, so a build takes seconds), compiled for
Hopper (``sm_90a``) at first use. The hash covers the sources and the flags,
so an edited source is rebuilt. ``build()`` starts one ``nvcc`` per source,
all at once, and waits for them; the first ``load()`` that finds a source
missing builds every missing one so. ``SOURCES`` are the ``.cu`` files of
``csrc/``: a new kernel's source is built without an edit here. Binding and
launching are ``launch.py``'s.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build",
)
SOURCES = tuple(sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(_CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(_CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources, all at once. Returns the compiler's output
    (``-Xptxas -v`` register and spill report) by name; raises if a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        lib = library_path(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (lib, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed: a
    missing source is built together with every other one missing, all at
    once, so that a run's first kernels cost one build and not one each."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([n for n in SOURCES if not os.path.exists(library_path(n))])
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
