"""One run of one cell: set-up, the measured window, the traced chunk, the
comparison with the reference, and the result.

Set-up makes the inputs from the seed, builds the program, loads the
benchmark's initial state and drives the program through its first
``check_steps`` epochs with the window's own ``run_epochs`` call; those
steps warm up every shape the window uses, and what they produce is kept
for the comparison. The window then runs chunks of ``epoch_chunk`` epochs,
the last one cut so that it ends within an epoch of ``seconds``. With
``trace`` a chunk of ``trace_epochs`` epochs runs under the profiler after
the window, behind one epoch that warms the profiler up. The reference runs
last, after the memory peak has been read and the program's state freed.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import time
from typing import List, Optional

import torch

from gnnbench import check, data, trace
from gnnbench.spec import HERE, Spec


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    epochs: int
    epoch_durations_s: List[float]
    peak_bytes: int
    work: dict
    trace: Optional[trace.Trace] = None
    trace_epochs: int = 0

    @property
    def epoch_ms(self) -> float:
        return self.window_s * 1e3 / self.epochs


class _EpochClock:
    """Marks each epoch's start on the device's stream (CUDA events; the
    host clock on the CPU, where nothing is a device metric)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def durations_s(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_steps(prog, steps: int, init: dict) -> tuple:
    """The program's first ``steps`` epochs through ``run_epochs``: each
    step's loss, the first gradient's norms, the change of every parameter
    after the last step, every evaluation's logits, the first layer's output
    in the first forward (flattened) and, where the program tracks one, its
    best-validation evaluation (tensors copied to the host). Returns them
    with the seconds an epoch took in the last call."""
    trainer, evals, first = prog.trainer, [], []
    plain_eval = trainer._eval_step

    def kept_eval():
        out = plain_eval()
        evals.append(out[0].detach().float().cpu())
        return out

    def kept_first(module, args, out):
        first.append(out.detach().flatten(1).float().cpu())
        hook.remove()

    trainer._eval_step = kept_eval
    hook = prog.first_layer().register_forward_hook(kept_first)
    try:
        losses = list(prog.run_epochs(0, 1))
        grad = prog.first_grad_norms()
        t0 = time.perf_counter()
        losses += list(prog.run_epochs(1, steps - 1))
        est = (time.perf_counter() - t0) / (steps - 1)
    finally:
        del trainer._eval_step
        hook.remove()
    with torch.no_grad():
        change = {k: float((p.detach() - init[k]).norm())
                  for k, p in prog.modules.named_parameters()}
    got = {"loss": [float(v) for v in losses], "grad": grad, "change": change,
           "eval": evals, "first_layer": first}
    if hasattr(prog, "best_outputs"):
        got["best"] = prog.best_outputs()
    return got, est


def window(prog, start: int, seconds: float, est: float, chunk: int, device):
    """Chunks of ``run_epochs`` for ``seconds``, each epoch's start marked on
    the stream; returns (epochs, window seconds, durations, losses)."""
    trainer, clock = prog.trainer, _EpochClock(device)
    plain_step = trainer._train_step

    def marked_step(epoch):
        clock.mark()
        return plain_step(epoch)

    trainer._train_step = marked_step
    losses, done = [], 0
    try:
        _sync(device)
        t0 = time.perf_counter()
        while True:
            remaining = seconds - (time.perf_counter() - t0)
            if remaining < 0.5 * est:
                break
            k = max(1, min(chunk, round(remaining / est)))
            losses.extend(float(v) for v in prog.run_epochs(start + done, k))
            done += k
            est = (time.perf_counter() - t0) / done
        clock.mark()
        _sync(device)
        elapsed = time.perf_counter() - t0
    finally:
        del trainer._train_step
    return done, elapsed, clock.durations_s(), losses


@dataclasses.dataclass
class Setup:
    cell: dict
    cfg: dict
    traffic: dict
    driver: object
    inputs: data.Inputs
    init: dict
    prog: object
    got: dict  # the program's first steps
    est: float  # seconds an epoch took in the last of them
    phases: dict  # seconds of each part of the set-up


def prepare(spec: Spec, name: str, seed: int, device) -> Setup:
    """Set-up of a run of cell ``name``: inputs, the program with the
    benchmark's initial state, and its first steps."""
    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    driver = spec.driver(cfg)
    t = [time.perf_counter()]
    inputs = driver.make_inputs(cfg, traffic, seed, device)
    t.append(time.perf_counter())
    prog = driver.Program(cfg, traffic, inputs, seed, device)
    shapes = {k: tuple(v.shape) for k, v in prog.modules.state_dict().items()}
    init = data.initial_state(shapes, seed, device, driver.init_gain(cfg))
    prog.modules.load_state_dict(init)
    prog.start()
    _sync(device)
    t.append(time.perf_counter())
    got, est = first_steps(prog, traffic["check_steps"], init)
    t.append(time.perf_counter())
    phases = dict(zip(("inputs", "program", "first_steps"), (b - a for a, b in zip(t, t[1:]))))
    return Setup(cell, cfg, traffic, driver, inputs, init, prog, got, est, phases)


def reference(s: Setup, seed: int, device, **fault) -> dict:
    """The reference's first steps of the same run; ``fault``: a control or
    a planted fault of ``reference/train.py`` (``tf32``, ``msg_dtype``,
    ``half_batch``, ``frozen``)."""
    g = s.driver.reference_graph(s.cfg, s.inputs, device)
    return s.driver.reference(g, s.cfg, s.traffic, s.inputs, s.init, seed,
                              s.traffic["check_steps"], **fault)


def free(s: Setup, device) -> None:
    """Drop the program's state, so that the reference runs in its room."""
    s.prog = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(spec: Spec, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, trace_path: Optional[str] = None) -> dict:
    """One run of cell ``name``: the result line's object, with the check
    lines under ``"_lines"`` and both sides' readings under ``"_numbers"``."""
    device = torch.device(device)
    s = prepare(spec, name, seed, device)
    prog, traffic, limits = s.prog, s.traffic, spec.limits(s.cell)
    steps = traffic["check_steps"]
    setup_s = time.perf_counter() - t_start

    epochs, window_s, durations, losses = window(prog, steps, seconds, s.est,
                                                 traffic["epoch_chunk"], device)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    ctx = Context(setup_s, window_s, epochs, durations, peak,
                  s.driver.epoch_work(s.cfg, traffic, prog.shapes, s.inputs))
    if traced:
        ctx.trace_epochs = traffic["trace_epochs"]
        path = trace_path or os.path.join(HERE, "out", f"trace-{name}.json")
        start = steps + epochs
        trace.capture(lambda: prog.run_epochs(start, 1),
                      lambda: prog.run_epochs(start + 1, ctx.trace_epochs), path)
        ctx.trace = trace.read(path)

    del prog
    free(s, device)
    ref = reference(s, seed, device)
    values = check.numbers(s.got, ref)
    failed = sum(not math.isfinite(v) for v in losses)
    correct, lines = check.judge(values, limits)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics(kind, s.cell):
        v = spec.reader(m)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct and failed == 0),
        "attempted": epochs,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in ctx.trace.device_ops],
                               "idle_gaps": [list(x) for x in ctx.trace.idle_gaps]}
    shown = {k: values.get(k, math.inf) for k in check.NAMES if k in limits}
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": limits[k]}
                        for k, v in shown.items()}
    result["_lines"] = [
        "set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in s.phases.items()),
        f"window losses not finite: {failed} of {epochs}"] + lines
    result["_numbers"] = {"got": s.got, "ref": ref, "values": values}
    return result
