"""A profiled chunk of epochs, read from ``torch.profiler``'s chrome trace.

The window is the ``record_function`` span around the chunk, which ends in a
device synchronisation. Device activity is every kernel, copy and fill
inside it; busy time is the length of their union, so that overlapping
streams count once. An idle gap is named by the innermost host event that
covers its middle: what the host was doing while the card waited.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Callable, List, Tuple

WINDOW = "gnnbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
                   "cuda_driver")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]  # (name, seconds) of each kernel launch
    device_ops: List[Tuple[str, float]]  # (name, seconds) summed by name, largest first
    idle_gaps: List[Tuple[str, float]]  # (host event, seconds), longest first

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(s for name, s in self.kernels if match(name))


def capture(warm: Callable[[], None], chunk: Callable[[], None], path: str) -> None:
    """Run ``warm`` and then ``chunk`` under the profiler, the window around
    ``chunk`` alone (the profiler's first launches are slow), and write the
    chrome trace to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda.synchronize()
        with record_function(WINDOW):
            chunk()
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def read(path: str, top: int = 10) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"{path}: no {WINDOW} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    device, kernels = [], []
    by_name = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        lo, hi = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if hi <= lo:
            continue
        device.append((lo, hi))
        by_name[e["name"]] += (hi - lo) / 1e6
        if e["cat"] == "kernel":
            kernels.append((e["name"], (hi - lo) / 1e6))
    merged = _union(device)
    busy = sum(hi - lo for lo, hi in merged) / 1e6
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES and e.get("name") != WINDOW]
    named = []
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        around = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        inner = min(around, key=lambda e: float(e["dur"]), default=None)
        named.append((inner["name"] if inner else "(no host event)", (hi - lo) / 1e6))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return Trace((w1 - w0) / 1e6, busy, kernels, ops, named)
