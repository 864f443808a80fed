"""Named spans inside the port: the trainers' phases, the graph build and the
MAG prefetch thread.

``span(name)`` is a context manager with two sinks:

* **The recorder**, off by default. ``enable()`` turns it on; each span then
  records ``(id, parent, thread, name, t0_ns, t1_ns)`` from
  ``time.perf_counter_ns()``, its parent taken from a stack of open spans
  kept per thread, so spans opened on another thread (the MAG prefetch
  thread) nest among themselves. Records stay in memory until ``records()``
  reads them or ``export(path)`` writes them.
* **The profiler.** While ``torch.profiler`` runs, a span also enters
  ``torch.profiler.record_function(name)``, whether the recorder is on or
  not, so it lands in the same chrome trace as the kernels launched inside
  it, on the profiler's clock.

With the recorder off and no profiler running, ``span`` reads two flags and
returns one shared no-op context: no clock is read and nothing is
allocated.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler


class Record(NamedTuple):
    id: int
    parent: Optional[int]
    thread: int
    name: str
    t0_ns: int
    t1_ns: int


_on = False
_records: List[Record] = []
_ids = itertools.count()
_local = threading.local()
_NOOP = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn the recorder on (or off with ``on=False``); records are kept."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def records() -> List[Record]:
    """The spans closed since the last ``reset()``, in the order they closed."""
    return list(_records)


def reset() -> None:
    """Drop every record (spans still open record when they close)."""
    _records.clear()


def export(path: str) -> str:
    """Write the records to ``path`` as JSON (``{"spans": [{field: value}]}``,
    times in ns of ``time.perf_counter_ns()``); returns ``path``."""
    with open(path, "w") as f:
        json.dump({"spans": [r._asdict() for r in records()]}, f)
    return path


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "profiled")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.profiled = None
        if _profiler._is_profiler_enabled:
            self.profiled = _profiler.record_function(self.name)
            self.profiled.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.profiled is not None:
            self.profiled.__exit__(*exc)
        _local.stack.pop()
        _records.append(Record(self.id, self.parent, threading.get_ident(), self.name,
                               self.t0, t1))
        return False


def span(name: str):
    """A context manager around the work it names (see the module's doc)."""
    if _on:
        return _Span(name)
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NOOP
