"""Device time of a traced chunk by the program's phases, from the chrome
trace that ``trace.capture`` wrote.

The program's trainers name their phases with ``trainer.*`` spans
(``efficient_gnns_tpu_torch/tracing.py``), which enter the profiler's trace
as ``user_annotation`` events whenever the profiler runs. Each kernel in the
window gets one owner:

* its launch is the ``cuda_runtime`` / ``cuda_driver`` event with the same
  ``correlation`` argument;
* the ``trainer.*`` spans that cover the launch are looked for on the
  launching thread, and where that thread has none (autograd's engine
  thread), on the thread that holds ``trainer.epoch``, which places the
  backward's launches in ``trainer.backward``;
* the owner is the one of ``PHASES`` among them, else ``other`` (no launch
  event, or no phase around it).

So the phases and ``other`` add up to the window's kernel time. The
criterion's backward is counted apart: the kernels launched under an
``autograd::engine::evaluate_function: ...`` op whose ``Sequence number`` is
that of a forward op inside ``trainer.criterion``. ``launch_idle_s`` is the
device's idle time in gaps whose middle lies inside a ``trainer.epoch`` span
and outside ``trainer.readback``: the host was issuing the epoch and the
card waited for it.

A metric reader gets the harness's ``Context``, which holds the parsed trace
but not its file: :func:`for_context` takes the newest ``out/trace-*.json``
and uses it only if its window and kernel count are the context's. A trace
without ``trainer.epoch`` spans (a program that records none) reads as
``None``.

    python -m gnnbench.phases gnnbench/out/trace-<cell>.json

prints the breakdown: each phase (split into ``gemm_ms``'s kernels, the
port's own and ``elementwise_ms``'s) and each nested span below it,
``other``, the criterion's backward and the launch idle, in ms an epoch.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from gnnbench import trace
from gnnbench.metrics.elementwise_ms import PORT_KERNELS
from gnnbench.metrics.gemm_ms import is_gemm
from gnnbench.spec import HERE

PHASES = ("trainer.forward", "trainer.criterion", "trainer.backward", "trainer.optimizer",
          "trainer.eval")
EPOCH, READBACK, CRITERION = "trainer.epoch", "trainer.readback", "trainer.criterion"
OTHER = "other"
KINDS = ("gemm", "port", "elementwise")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function: "


@dataclasses.dataclass
class Phases:
    window_s: float
    kernels: int  # kernels in the window
    kernel_s: float  # their time
    epochs: int  # trainer.epoch spans that start in the window
    owned_s: Dict[str, float]  # by each of PHASES and OTHER
    paths_s: Dict[str, float]  # by the chain of spans around the launch ("a/b")
    kinds_s: Dict[Tuple[str, str], float]  # by (owner, one of KINDS)
    criterion_backward_s: float
    launch_idle_s: float
    unlaunched: int  # kernels with no launch event


def _kind(name: str) -> str:
    """The kernel classes of ``gemm_ms`` and ``elementwise_ms``, and the
    port's own kernels."""
    if is_gemm(name):
        return "gemm"
    return "port" if any(k in name for k in PORT_KERNELS) else "elementwise"


def _seq(e) -> Optional[int]:
    v = e.get("args", {}).get("Sequence number")
    return None if v is None else int(v)


class _Intervals:
    """Intervals ``(t0, t1, payload)`` of one thread that nest or are
    disjoint; ``covering(t)`` lists those around ``t``, outermost first."""

    def __init__(self, items: List[Tuple[float, float, object]]):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.items]

    def covering(self, t: float) -> list:
        hi = bisect.bisect_right(self.starts, t)
        return [x for x in self.items[:hi] if x[1] >= t]

    def innermost(self, t: float):
        hi = bisect.bisect_right(self.starts, t)
        if hi and self.items[hi - 1][1] >= t:  # the latest to start covers t
            return self.items[hi - 1]
        found = self.covering(t)
        return found[-1] if found else None


def _span(e) -> Tuple[float, float]:
    t0 = float(e["ts"])
    return t0, t0 + float(e["dur"])


def read(path: str) -> Optional[Phases]:
    """The phases of the traced chunk in ``path``; ``None`` where the trace
    holds no ``trainer.epoch`` span."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events
               if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"{path}: no {trace.WINDOW} span")
    w0, w1 = _span(windows[0])

    spans = defaultdict(list)  # tid -> (t0, t1, name) of the trainer's spans
    launches, backward_ops, forward_ops = {}, defaultdict(list), []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name.startswith("trainer."):
            spans[e["tid"]].append((*_span(e), name))
        elif cat in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], float(e["ts"]))
        elif cat == "cpu_op" and _seq(e) is not None:
            if name.startswith(BACKWARD_OP):
                backward_ops[e["tid"]].append((*_span(e), _seq(e)))
            else:
                forward_ops.append(e)
    epoch_tids = [t for t, s in spans.items() if any(n == EPOCH for *_, n in s)]
    if not epoch_tids:
        return None
    spans = {t: _Intervals(s) for t, s in spans.items()}
    backward_ops = {t: _Intervals(s) for t, s in backward_ops.items()}

    criterion_seqs = set()
    for e in forward_ops:
        around = spans.get(e["tid"])
        if around and any(n == CRITERION for *_, n in around.covering(float(e["ts"]))):
            criterion_seqs.add(_seq(e))

    owned = dict.fromkeys(PHASES + (OTHER,), 0.0)
    paths, kinds, device = defaultdict(float), defaultdict(float), []
    kernel_s = crit_bwd = 0.0
    n_kernels = unlaunched = 0
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATEGORIES:
            continue
        t0, t1 = _span(e)
        lo, hi = max(t0, w0), min(t1, w1)
        if hi <= lo:
            continue
        device.append((lo, hi))
        if e["cat"] != "kernel":
            continue
        d = (hi - lo) / 1e6
        n_kernels += 1
        kernel_s += d
        launch = launches.get(e.get("args", {}).get("correlation"))
        tid, ts = launch if launch is not None else (None, None)
        unlaunched += launch is None
        around = spans[tid].covering(ts) if tid in spans else []
        if not around and launch is not None:
            around = [x for t in epoch_tids for x in spans[t].covering(ts)]
        names = [n for *_, n in around if n != EPOCH]
        phase = next((n for n in names if n in PHASES), OTHER)
        owned[phase] += d
        paths["/".join(names) or OTHER] += d
        kinds[phase, _kind(e["name"])] += d
        op = backward_ops[tid].innermost(ts) if tid in backward_ops else None
        if op is not None and op[2] in criterion_seqs:
            crit_bwd += d

    epochs = [s for t in epoch_tids for s in spans[t].items if s[2] == EPOCH]
    readbacks = [s for t in epoch_tids for s in spans[t].items if s[2] == READBACK]
    merged = trace._union(device)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    idle = 0.0
    for lo, hi in zip(edges[::2], edges[1::2]):
        mid = (lo + hi) / 2
        if (hi > lo and any(a <= mid <= b for a, b, _ in epochs)
                and not any(a <= mid <= b for a, b, _ in readbacks)):
            idle += (hi - lo) / 1e6
    return Phases((w1 - w0) / 1e6, n_kernels, kernel_s, sum(a >= w0 for a, *_ in epochs),
                  owned, dict(paths), dict(kinds), crit_bwd, idle, unlaunched)


_read_cache: Dict[Tuple[str, float], Optional[Phases]] = {}


def for_context(ctx) -> Optional[Phases]:
    """The phases of the traced chunk that ``ctx.trace`` was read from (the
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
    ph = _read_cache[key]
    if (ph is None or ph.kernels != len(ctx.trace.kernels)
            or abs(ph.window_s - ctx.trace.window_s) > 1e-9):
        return None
    return ph


def phase_ms(ctx, name: str) -> Optional[float]:
    """Device ms a traced epoch owned by phase ``name``."""
    ph = for_context(ctx)
    return None if ph is None else ph.owned_s[name] * 1e3 / ctx.trace_epochs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the phase breakdown of a traced chunk")
    p.add_argument("path")
    args = p.parse_args(argv)
    ph = read(args.path)
    if ph is None:
        print(f"{args.path}: no {EPOCH} span")
        return 1
    n = max(ph.epochs, 1)
    print(f"{ph.epochs} epochs, {ph.kernels / n:.1f} kernels and {ph.kernel_s * 1e3 / n:.3f} "
          f"device ms an epoch in kernels; {ph.unlaunched} kernels without a launch event")
    for name in PHASES + (OTHER,):
        ms = ph.owned_s[name] * 1e3 / n
        kinds = ", ".join(f"{k} {ph.kinds_s.get((name, k), 0.0) * 1e3 / n:.3f}" for k in KINDS)
        print(f"  {name:<20} {ms:9.3f} ms  {100 * ph.owned_s[name] / ph.kernel_s:6.2f}%  "
              f"({kinds})")
        for path, s in sorted(ph.paths_s.items()):
            head = path.split("/")[0]
            if path != name and (head == name or name == OTHER and head not in PHASES):
                print(f"    {path:<40} {s * 1e3 / n:9.3f} ms")
    total = sum(ph.owned_s.values())
    print(f"  phases + other {total * 1e3 / n:.3f} ms of {ph.kernel_s * 1e3 / n:.3f} "
          f"({100 * (total / ph.kernel_s - 1):+.2e}%)")
    print(f"  criterion backward {ph.criterion_backward_s * 1e3 / n:.3f} ms (inside "
          f"trainer.backward); launch idle {ph.launch_idle_s * 1e3 / n:.3f} ms of "
          f"{ph.window_s * 1e3 / n:.3f} ms an epoch")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
