"""Inference timing, device memory and profiler traces (counterpart of
``efficient_gnns_tpu/analysis/timing.py``) on ``torch.cuda`` and
``torch.profiler``.

PyTorch returns before the card finishes, so every timed call is closed by
``torch.cuda.synchronize`` on a CUDA device; on the CPU the calls are
synchronous and nothing is a device metric (``device_memory_stats`` is
empty there, as it is for the JAX package on its CPU backend). ``device``
defaults to the current CUDA device, and the functions raise without one:
the CPU is timed only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Mapping

import torch
from torch import nn

# chrome-trace categories of work on the card (kernels, copies, fills)
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _device(device=None) -> torch.device:
    """``device``; ``None`` is the current CUDA device, and raises where
    there is no card (the CPU is measured only when asked for)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to time on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_memory_stats(device=None) -> Dict[str, int]:
    """Device memory counters in bytes: ``bytes_in_use`` and
    ``peak_bytes_in_use`` of PyTorch's caching allocator
    (``torch.cuda.memory_stats``) and ``bytes_limit``, the card's total
    (``torch.cuda.mem_get_info``) of ``device`` (the current CUDA device by
    default). Empty for a CPU device."""
    dev = _device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def time_inference(fn: Callable, *args, runs: int = 10, warmup: int = 2,
                   device=None) -> Dict[str, float]:
    """Mean, least and largest host-clock time of ``fn(*args)`` over ``runs``
    calls after ``warmup`` calls, each closed by a synchronisation of
    ``device`` (the current CUDA device by default), and the memory
    counters of :func:`device_memory_stats`."""
    dev = _device(device)
    for _ in range(warmup):
        fn(*args)
        _sync(dev)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    out = {"mean_s": sum(times) / len(times), "min_s": min(times), "max_s": max(times),
           "runs": runs}
    out.update({f"mem_{k}": v for k, v in device_memory_stats(dev).items()})
    return out


def count_params(params) -> int:
    """Parameter count of an ``nn.Module`` (its parameters) or of a (nested)
    dict or sequence of tensors."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, Mapping):
        return sum(count_params(v) for v in params.values())
    return sum(count_params(v) for v in params)


def capture_trace(fn: Callable, *args, trace_dir: str = "logs/traces", steps: int = 3,
                  warmup: int = 1, device=None) -> str:
    """Record ``steps`` calls of ``fn(*args)`` under ``torch.profiler`` (the
    card's activity where there is one) after ``warmup`` calls, and write the
    chrome trace to ``<trace_dir>/trace.json`` (Perfetto or
    ``chrome://tracing`` open it). Returns ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = _device(device)
    for _ in range(warmup):
        fn(*args)
        _sync(dev)
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for i in range(steps):
            with record_function(f"step {i}"):
                fn(*args)
        _sync(dev)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return trace_dir


def summarize_trace(trace_dir: str, top: int = 30) -> Dict[str, float]:
    """Device time in ms by kernel name over the chrome traces under
    ``trace_dir`` (``*.json`` or ``*.json.gz``, as :func:`capture_trace`
    writes them): the complete events of the card's kernels, copies and
    fills. Returns ``{name: ms, "__total__": ms}`` (only ``__total__``, 0, on
    a trace without device work) and prints the ``top`` heaviest."""
    by_name: Dict[str, float] = defaultdict(float)
    total = 0.0
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
                   + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"), recursive=True))
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f).get("traceEvents", [])
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATEGORIES:
                ms = ev.get("dur", 0) / 1e3  # us -> ms
                by_name[ev.get("name", "?")] += ms
                total += ms
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:8.2f} ms  {name[:110]}", flush=True)
    out = dict(by_name)
    out["__total__"] = total
    return out
