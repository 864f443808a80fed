"""The molecule cell on the CPU: its drawn molecules, a whole run at a small
size (the program against the plain reference), the work count against a
hand count, the step reader, the three new metrics and the accepted
``idle_pct`` and ``mfu`` on a hand-written chrome trace, and what a run of
it imports.

The trace has one epoch inside the window on the main thread (tid 1) with
two steps, the backward's launches on autograd's engine thread (tid 2), and
a warm epoch before the window. Times are in µs.
"""

import json
import time

import numpy as np
import pytest
import torch

from gnnbench import check, harness, steps, trace, work
from gnnbench.drivers import mol_graph
from gnnbench.spec import Spec
from gnnbench.tests.test_gnnbench_harness import FORBIDDEN, _top_level_loaded
from gnnbench.tests.test_gnnbench_phases import _kernel, _launch, _x

CELL = "molhiv-gine"
NEW = ("pack_ms", "upload_ms", "kernels_per_step")
# the accepted metrics that the cell reports as well
SHARED = ("kernels_per_epoch", "gemm_ms", "elementwise_ms", "spmm_roofline", "idle_pct", "mfu",
          "forward_ms", "criterion_ms", "backward_ms", "optimizer_ms", "eval_ms",
          "launch_idle_ms")


def _small_spec(**cfg_changes) -> Spec:
    spec = Spec()
    cell = spec.cell(CELL)
    cfg = dict(spec.config(cell), hidden=16, num_layers=3, train_molecules=96,
               valid_molecules=40, test_molecules=40, **cfg_changes)
    traffic = dict(spec.traffic(cell))
    spec.config = lambda c: cfg
    spec.traffic = lambda c: traffic
    return spec


def test_drawn_molecules_follow_the_published_statistics():
    spec = Spec()
    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    inputs = mol_graph.make_inputs(cfg, traffic, 2**31 + 99, "cpu")
    mols = inputs.train + inputs.valid + inputs.test
    assert [len(inputs.train), len(inputs.valid), len(inputs.test)] == [2048, 256, 256]
    atoms = np.array([m[2] for m in mols])
    bonds = np.array([len(m[0]) // 2 for m in mols])
    assert 24.5 < atoms.mean() < 26.5 and 2 <= atoms.min() and atoms.max() <= 222
    assert 1.0 < bonds.sum() / atoms.sum() < 1.15
    assert np.mean([m[5] for m in mols]) == pytest.approx(0.035, abs=0.002)
    for s, r, n, a, b, _ in mols[:50]:
        e = len(s) // 2
        np.testing.assert_array_equal(s[:e], r[e:])  # every bond both ways
        np.testing.assert_array_equal(b[:e], b[e:])
        assert a.shape == (n, 9) and b.shape == (2 * e, 3) and s.max() < n
        assert (a < np.array(mol_graph.ATOM_DIMS)).all() and (a >= 0).all()
        assert (b < np.array(mol_graph.BOND_DIMS)).all() and (b >= 0).all()
    again = mol_graph.make_inputs(cfg, traffic, 2**31 + 99, "cpu")
    np.testing.assert_array_equal(again.valid[3][3], inputs.valid[3][3])


def test_a_small_run_is_correct_and_reports_its_end_to_end_metrics():
    spec = _small_spec()
    out = harness.run_cell(spec, CELL, 2**31 + 13, 2.0, False, "cpu", time.perf_counter())
    lines = out.pop("_lines")
    numbers = out.pop("_numbers")
    assert out["correct"] is True, lines
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"epoch_ms", "setup_s"}  # no peak on the CPU
    assert set(out["checks"]) == set(spec.limits(spec.cell(CELL)))
    # the first layer is compared over the real atoms of the first batch
    [first] = numbers["got"]["first_layer"]
    assert first.shape[1] == 16 and first.shape[0] < 32 * 40


def test_a_planted_fault_is_caught():
    spec, cpu = _small_spec(), torch.device("cpu")
    s = harness.prepare(spec, CELL, 2**31 + 17, cpu)
    harness.free(s, cpu)
    ref = harness.reference(s, 2**31 + 17, cpu)
    for fault in ({"half_batch": True}, {"frozen": True}):
        bad = harness.reference(s, 2**31 + 17, cpu, **fault)
        ok, _ = check.judge(check.numbers(bad, ref), spec.limits(spec.cell(CELL)))
        assert not ok, fault


def test_epoch_work_against_a_hand_count():
    cfg = {"hidden": 2, "num_layers": 2, "num_tasks": 1, "batch_size": 2}
    # train: 2 molecules (3 + 2 atoms, 4 + 2 edges); valid, test: 1 each
    mk = lambda n, e: (np.zeros(e), np.zeros(e), n, None, None, 0.0)  # noqa: E731
    inputs = mol_graph.MolInputs([mk(3, 4), mk(2, 2)], [mk(2, 2)], [mk(4, 6)])
    got = mol_graph.epoch_work(cfg, {}, {}, inputs)
    f = 2

    def fwd(n, e, g):  # conv MLP 2 layers, vn MLP after the first, the head
        mm = 2 * (2 * n * f * 2 * f * 2) + 2 * g * f * 2 * f * 2 + 2 * g * f * 1
        sp = 2 * (2 * e * f) + 2 * n * f + 2 * n * f  # sums, one vn pool, the mean pool
        return mm, sp

    mm, sp = fwd(5, 6, 2)
    train = 3 * mm + sp + 2 * (2 * 6 * f + 2 * 5 * f)  # the backward's gathers
    evals = [fwd(5, 6, 2), fwd(2, 2, 1), fwd(4, 6, 1)]
    assert got["flops"] == train + sum(a + b for a, b in evals)
    # the train step (1 + 2) + (1 + 2) + 1 + 1 = 8, each split's evaluation 1 + 1 + 1 + 1
    assert got["spmm_calls"] == 8 + 3 * 4
    # a call's bytes: 4 (f + 1) a float32 entry and its index, 4 a row
    # offset (rows + batches), 4 f an output row: 12 e + 4 (r + 1) + 8 r here
    k1 = lambda r, e: 12 * e + 4 * (r + 1) + 8 * r  # noqa: E731
    train = 4 * k1(5, 6) + 4 * k1(2, 5)
    evals = 2 * (k1(5, 6) + k1(2, 5)) + 2 * (k1(2, 2) + k1(1, 2)) + 2 * (k1(4, 6) + k1(1, 4))
    assert got["k1_bytes"] == train + evals == 1904
    # at F = 2 every call is bound by its bytes
    assert got["spmm_least_s"] == pytest.approx(1904 / work.HBM_BYTES_PER_S, rel=1e-12)


def _events(spans=True):
    ann = "user_annotation"
    ev = [_x(ann, trace.WINDOW, 1000, 1000)]
    if spans:
        ev += [_x(ann, "trainer.epoch", 100, 300), _x(ann, "trainer.step", 120, 100),
               _x(ann, "trainer.epoch", 1100, 800),
               _x(ann, "mol.pack", 1100, 40), _x(ann, "mol.upload", 1140, 10),
               _x(ann, "trainer.step", 1150, 200),
               _x(ann, "mol.pack", 1350, 30), _x(ann, "mol.upload", 1380, 20),
               _x(ann, "trainer.step", 1400, 200),
               _x(ann, "trainer.eval", 1600, 200), _x(ann, "trainer.readback", 1900, 50)]
    ev += [
        _launch(0, 130), _kernel(0, 140, 10),  # the warm epoch's step, before the window
        _launch(1, 1160), _kernel(1, 1165, 20),  # step 1 forward
        _launch(2, 1200, tid=2), _kernel(2, 1205, 20),  # step 1 backward, engine thread
        _launch(3, 1410), _kernel(3, 1415, 20),  # step 2
        _launch(4, 1450, tid=2), _kernel(4, 1455, 20),  # step 2 backward
        _launch(5, 1470), _kernel(5, 1475, 10),  # step 2 optimizer
        _launch(6, 1610), _kernel(6, 1615, 30),  # eval
    ]
    return ev


def _context(tmp_path, monkeypatch, spans=True):
    monkeypatch.setattr(steps, "HERE", str(tmp_path))
    (tmp_path / "out").mkdir(exist_ok=True)
    path = tmp_path / "out" / "trace-cell.json"
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    steps._read_cache.clear()
    work = {"flops": 67e12 * 0.5 * 0.01}
    return harness.Context(1.0, 1.0, 2, [], 0, work, trace.read(str(path)), 1)


def test_the_new_metrics_read_the_steps_of_the_trace(tmp_path, monkeypatch):
    ctx = _context(tmp_path, monkeypatch)
    st = steps.for_context(ctx)
    assert (st.steps, st.step_kernels, st.kernels) == (2, 5, 6)
    spec = Spec()
    names = NEW + ("idle_pct", "mfu")
    read = {m["name"]: spec.reader(m) for m in spec.doc["per_layer"] if m["name"] in names}
    assert set(read) == set(names)
    got = {k: f(ctx) for k, f in read.items()}
    assert got == pytest.approx({"pack_ms": 0.07, "upload_ms": 0.03, "kernels_per_step": 2.5,
                                 "idle_pct": 88.0, "mfu": 1.0})


def test_the_parent_program_reads_none(tmp_path, monkeypatch):
    # a program without the step and batching spans: nothing to read
    ctx = _context(tmp_path, monkeypatch, spans=False)
    spec = Spec()
    for m in spec.doc["per_layer"]:
        if m["name"] in ("pack_ms", "upload_ms", "kernels_per_step"):
            assert spec.reader(m)(ctx) is None


def test_the_new_entries_name_only_the_new_cell():
    spec = Spec()
    for m in spec.doc["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "epoch_ms"
        elif m["name"] in SHARED:  # the new cell appended to the accepted list
            assert m["workloads"] == ["teacher-arxiv", "student-nce-arxiv", "student-kd-arxiv",
                                      CELL]
        else:
            assert CELL not in m.get("workloads", [])
    assert {m["name"] for m in spec.metrics("end_to_end", spec.cell(CELL))} == {
        "epoch_ms", "peak_mem_gib", "setup_s"}


def test_a_run_of_the_cell_loads_no_jax_and_no_jax_package():
    loaded = _top_level_loaded(["gnnbench.run", "gnnbench.drivers.mol_graph", "gnnbench.steps",
                                "efficient_gnns_tpu_torch.train.mol_trainer",
                                "efficient_gnns_tpu_torch.models.mol"])
    assert "efficient_gnns_tpu_torch" in loaded and not loaded & FORBIDDEN
    assert not _top_level_loaded(["gnnbench.reference.mol"]) & (
        FORBIDDEN | {"efficient_gnns_tpu_torch"})
