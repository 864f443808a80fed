"""The phase reader (``gnnbench/phases.py``) on a hand-written chrome trace,
the six phase metrics, and the harness's untraced path, which never turns
the program's recorder on.

The trace has a warm epoch before the window and one epoch inside it on the
main thread (tid 1), the backward's launches on autograd's engine thread
(tid 2), a kernel without a launch event, one under ``trainer.readback``
and one that the window's end cuts. Times are in µs.
"""

import json
import time

import pytest

from gnnbench import harness, phases, trace
from gnnbench.spec import Spec
from gnnbench.tests.conftest import small_spec

NEW = ("forward_ms", "criterion_ms", "backward_ms", "optimizer_ms", "eval_ms", "launch_idle_ms")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _launch(corr, ts, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 3, tid, correlation=corr)


def _kernel(corr, ts, dur, name="k"):
    return _x("kernel", name, ts, dur, tid=7, correlation=corr)


def _events(spans=True):
    ann = "user_annotation"
    ev = [_x(ann, trace.WINDOW, 1000, 1000)]
    if spans:
        ev += [_x(ann, "trainer.epoch", 200, 600), _x(ann, "trainer.forward", 210, 100),
               _x(ann, "trainer.epoch", 1100, 500),
               _x(ann, "trainer.forward", 1110, 90), _x(ann, "trainer.criterion", 1200, 100),
               _x(ann, "trainer.backward", 1300, 150), _x(ann, "trainer.optimizer", 1450, 50),
               _x(ann, "trainer.eval", 1500, 90), _x(ann, "trainer.track_best", 1550, 30),
               _x(ann, "trainer.readback", 1610, 90)]
    ev += [
        # forward ops with autograd sequence numbers: one in the forward, one in the criterion
        _x("cpu_op", "aten::mm", 1120, 20, **{"Sequence number": 5}),
        _x("cpu_op", "aten::log_softmax", 1210, 20, **{"Sequence number": 7}),
        # their backward on the engine thread
        _x("cpu_op", "autograd::engine::evaluate_function: LogSoftmaxBackward0", 1310, 30,
           tid=2, **{"Sequence number": 7}),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 1350, 50, tid=2,
           **{"Sequence number": 5}),
        _launch(0, 220), _kernel(0, 300, 10),  # the warm epoch, before the window
        _launch(1, 1130), _kernel(1, 1135, 30, "sgemm"),  # forward
        _launch(2, 1220), _kernel(2, 1225, 20),  # criterion
        _launch(3, 1320, tid=2), _kernel(3, 1320, 10),  # criterion's backward
        _launch(4, 1360, tid=2), _kernel(4, 1365, 40),  # forward's backward
        _launch(5, 1460), _kernel(5, 1460, 20),  # optimizer
        _launch(6, 1510), _kernel(6, 1510, 20),  # eval
        _launch(7, 1560), _kernel(7, 1560, 10),  # best tracking, inside eval
        _kernel(99, 1580, 5),  # no launch event
        _launch(8, 1620), _kernel(8, 1650, 10),  # readback
        _x("gpu_memcpy", "Memcpy DtoH", 1690, 10, tid=7),
        _launch(9, 1990), _kernel(9, 1995, 15),  # cut by the window's end, in no span
    ]
    return ev


def _write(path, spans=True):
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    return str(path)


def test_phases_and_other_add_up_to_the_kernel_time(tmp_path):
    ph = phases.read(_write(tmp_path / "t.json"))
    assert ph.epochs == 1 and ph.kernels == 10 and ph.unlaunched == 1
    assert ph.kernel_s == pytest.approx(170e-6)
    want = {"trainer.forward": 30, "trainer.criterion": 20, "trainer.backward": 50,
            "trainer.optimizer": 20, "trainer.eval": 30, "other": 20}
    assert ph.owned_s == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(ph.owned_s.values()) == pytest.approx(ph.kernel_s, rel=1e-12)
    assert ph.paths_s == pytest.approx({
        "trainer.forward": 30e-6, "trainer.criterion": 20e-6, "trainer.backward": 50e-6,
        "trainer.optimizer": 20e-6, "trainer.eval": 20e-6,
        "trainer.eval/trainer.track_best": 10e-6, "trainer.readback": 10e-6, "other": 10e-6})
    assert ph.window_s == trace.read(str(tmp_path / "t.json")).window_s
    # by kernel class: the forward's one kernel is a matrix product
    assert ph.kinds_s[("trainer.forward", "gemm")] == pytest.approx(30e-6)
    assert ("trainer.forward", "elementwise") not in ph.kinds_s
    assert sum(ph.kinds_s.values()) == pytest.approx(ph.kernel_s, rel=1e-12)


def test_the_breakdown_prints_every_phase(tmp_path, capsys):
    assert phases.main([_write(tmp_path / "t.json")]) == 0
    out = capsys.readouterr().out
    for name in phases.PHASES + ("other", "trainer.eval/trainer.track_best", "launch idle"):
        assert name in out
    assert phases.main([_write(tmp_path / "t.json", spans=False)]) == 1


def test_the_criterions_backward_is_linked_by_sequence_number(tmp_path):
    ph = phases.read(_write(tmp_path / "t.json"))
    assert ph.criterion_backward_s == pytest.approx(10e-6)  # kernel 3, not kernel 4


def test_launch_idle_leaves_out_gaps_outside_the_epoch_and_under_readback(tmp_path):
    ph = phases.read(_write(tmp_path / "t.json"))
    # gaps in the epoch: 1165-1225, 1245-1320, 1330-1365, 1405-1460, 1480-1510,
    # 1530-1560, 1570-1580; not 1000-1135 (before it) nor 1585-1650, 1660-1690
    # (readback) nor 1700-1995 (after it)
    assert ph.launch_idle_s == pytest.approx((60 + 75 + 35 + 55 + 30 + 30 + 10) * 1e-6)


def test_a_trace_without_trainer_spans_reads_none(tmp_path):
    assert phases.read(_write(tmp_path / "t.json", spans=False)) is None


def _context(path):
    t = trace.read(path)
    return harness.Context(1.0, 1.0, 1, [], 0, {"spmm_calls": 0}, t, 1)


def test_the_six_metrics_read_the_newest_trace_that_matches(tmp_path, monkeypatch):
    monkeypatch.setattr(phases, "HERE", str(tmp_path))
    (tmp_path / "out").mkdir()
    path = _write(tmp_path / "out" / "trace-cell.json")
    spec = Spec()
    read = {m["name"]: spec.reader(m) for m in spec.doc["per_layer"] if m["name"] in NEW}
    assert set(read) == set(NEW)
    ctx = _context(path)
    got = {k: f(ctx) for k, f in read.items()}
    assert got == pytest.approx({"forward_ms": 0.03, "criterion_ms": 0.03, "backward_ms": 0.05,
                                 "optimizer_ms": 0.02, "eval_ms": 0.03,
                                 "launch_idle_ms": 0.295})
    # a context read from another trace finds nothing to read
    ev = _events()
    ev.append(_kernel(3, 1980, 2))
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"traceEvents": ev}))
    assert all(f(_context(str(other))) is None for f in read.values())
    # the parent program: no trainer spans, every new metric reads None
    _write(tmp_path / "out" / "trace-cell.json", spans=False)
    assert all(f(_context(path)) is None for f in read.values())


def test_the_new_metrics_are_declared_for_every_cell():
    spec = Spec()
    for name in NEW:
        [m] = [m for m in spec.doc["per_layer"] if m["name"] == name]
        assert m["moves"] == "epoch_ms" and m["source"] == "device_trace"
        assert m["workloads"] == list(spec.cells)


def test_an_untraced_run_never_turns_the_recorder_on(monkeypatch):
    from efficient_gnns_tpu_torch import tracing

    def refuse(on=True):
        raise AssertionError("the harness turned the recorder on")

    tracing.reset()
    monkeypatch.setattr(tracing, "enable", refuse)
    spec = small_spec("student-kd-arxiv")
    out = harness.run_cell(spec, "student-kd-arxiv", 2**31 + 11, 0.3, False, "cpu",
                           time.perf_counter())
    assert out["correct"] is True
    assert not tracing.enabled() and tracing.records() == []
