"""The steps of a traced chunk of a trainer that takes many steps an epoch
(the molecule cell): the host's seconds inside named spans, and the kernels
launched inside ``trainer.step`` spans.

A kernel belongs to a step when the ``trainer.step`` span that covers its
launch lies on the launching thread, or, where that thread holds no
``trainer.*`` span (autograd's engine thread runs the backward), on the
thread that holds ``trainer.epoch``, as ``phases.py`` places the
backward's launches. Host spans are ``user_annotation`` events clipped to
the window. A trace without ``trainer.step`` spans reads as no steps.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from collections import defaultdict
from typing import Dict, Optional, Tuple

from gnnbench import trace
from gnnbench.phases import EPOCH, LAUNCH_CATEGORIES, _Intervals, _span
from gnnbench.spec import HERE

STEP = "trainer.step"


@dataclasses.dataclass
class Steps:
    steps: int  # trainer.step spans that start in the window
    step_kernels: int  # kernels in the window launched inside them
    kernels: int  # kernels in the window
    window_s: float
    host_s: Dict[str, float]  # seconds inside the spans of each name, clipped to the window


def read(path: str) -> Steps:
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events
               if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"{path}: no {trace.WINDOW} span")
    w0, w1 = _span(windows[0])
    spans, launches, host = defaultdict(list), {}, defaultdict(float)
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name != trace.WINDOW:
            t0, t1 = _span(e)
            host[name] += max(0.0, min(t1, w1) - max(t0, w0)) / 1e6
            if name.startswith("trainer."):
                spans[e["tid"]].append((t0, t1, name))
        elif cat in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], float(e["ts"]))
    epoch_tids = [t for t, s in spans.items() if any(n == EPOCH for *_, n in s)]
    steps = sum(1 for s in spans.values() for t0, _, n in s if n == STEP and w0 <= t0 <= w1)
    spans = {t: _Intervals(s) for t, s in spans.items()}
    n_kernels = in_step = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t0, t1 = _span(e)
        if min(t1, w1) <= max(t0, w0):
            continue
        n_kernels += 1
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        tid, ts = launch
        around = spans[tid].covering(ts) if tid in spans else []
        if not around:
            around = [x for t in epoch_tids for x in spans[t].covering(ts)]
        in_step += any(n == STEP for *_, n in around)
    return Steps(steps, in_step, n_kernels, (w1 - w0) / 1e6, dict(host))


_read_cache: Dict[Tuple[str, float], Steps] = {}


def for_context(ctx) -> Optional[Steps]:
    """The steps of the traced chunk that ``ctx.trace`` was read from (the
    newest ``out/trace-*.json``, checked against it), or ``None``."""
    if ctx.trace is None:
        return None
    found = glob.glob(os.path.join(HERE, "out", "trace-*.json"))
    if not found:
        return None
    path = max(found, key=os.path.getmtime)
    key = (path, os.path.getmtime(path))
    if key not in _read_cache:
        _read_cache.clear()
        _read_cache[key] = read(path)
    st = _read_cache[key]
    if st.kernels != len(ctx.trace.kernels) or abs(st.window_s - ctx.trace.window_s) > 1e-9:
        return None
    return st


def host_ms(ctx, name: str) -> Optional[float]:
    """Host ms a traced epoch inside the spans named ``name``; ``None``
    where the trace has none."""
    st = for_context(ctx)
    if st is None or name not in st.host_s:
        return None
    return st.host_s[name] * 1e3 / ctx.trace_epochs
