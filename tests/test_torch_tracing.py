"""The port's span recorder (``efficient_gnns_tpu_torch/tracing.py``) and the
spans of the trainers and the graph build, on the CPU.

Off, ``span`` hands out one shared no-op context and records nothing; on,
spans nest per thread. Either way a span enters the profiler's trace while
the profiler runs, and only then. The trainers emit each phase once an
epoch and the same losses with the recorder on as off.
"""

import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch import tracing
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
from efficient_gnns_tpu_torch.models import GCN
from efficient_gnns_tpu_torch.train import DistillConfig, NodeDistillTrainer
from efficient_gnns_tpu_torch.train.gat_teacher import GATTeacherTrainer, TeacherConfig

DATA = dict(num_nodes=300, num_edges=1200, feat_dim=10, num_classes=4, seed=2, signal=0.6)
STUDENT_PHASES = ("trainer.epoch", "trainer.forward", "trainer.criterion", "trainer.backward",
                  "trainer.optimizer", "trainer.eval")


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _names(records):
    return Counter(r.name for r in records)


def test_off_records_nothing_and_hands_out_one_noop():
    assert not tracing.enabled()
    first, second = tracing.span("a"), tracing.span("b")
    assert first is second
    with first:
        with second:
            pass
    assert tracing.records() == []


def test_spans_nest_with_parent_ids_and_a_stack_per_thread():
    tracing.enable()
    seen = {}

    def other():
        with tracing.span("thread.outer"):
            with tracing.span("thread.inner"):
                seen["ident"] = threading.get_ident()

    with tracing.span("main.outer"):
        with tracing.span("main.inner"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    by = {r.name: r for r in tracing.records()}
    assert set(by) == {"main.outer", "main.inner", "thread.outer", "thread.inner"}
    assert by["main.outer"].parent is None and by["main.inner"].parent == by["main.outer"].id
    assert by["thread.outer"].parent is None  # the main thread's open spans are not its parents
    assert by["thread.inner"].parent == by["thread.outer"].id
    assert by["thread.inner"].thread == seen["ident"] != by["main.inner"].thread
    for r in by.values():
        assert r.t0_ns <= r.t1_ns
    assert by["main.outer"].t0_ns <= by["main.inner"].t0_ns <= by["main.inner"].t1_ns \
        <= by["main.outer"].t1_ns
    assert len({r.id for r in by.values()}) == 4


def test_a_span_that_raises_still_closes():
    tracing.enable()
    with pytest.raises(KeyError):
        with tracing.span("outer"):
            with tracing.span("raises"):
                raise KeyError("x")
    with tracing.span("after"):
        pass
    by = {r.name: r for r in tracing.records()}
    assert by["raises"].parent == by["outer"].id and by["after"].parent is None


def test_export_and_reset(tmp_path):
    tracing.enable()
    with tracing.span("x"):
        pass
    path = tracing.export(str(tmp_path / "spans.json"))
    [row] = json.load(open(path))["spans"]
    assert row["name"] == "x" and set(row) == {"id", "parent", "thread", "name", "t0_ns",
                                               "t1_ns"}
    tracing.reset()
    assert tracing.records() == []


def _user_annotations(prof_path):
    with open(prof_path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


@pytest.mark.parametrize("recorder", [False, True])
def test_a_span_enters_the_profiler_only_while_it_runs(tmp_path, recorder):
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(recorder)
    with tracing.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("inside"):
            torch.ones(4).sum()
    if not recorder:  # the shared no-op again once the profiler stopped
        assert tracing.span("after") is tracing.span("again")
    with tracing.span("after"):
        pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    names = _user_annotations(path)
    assert "inside" in names and not names & {"before", "after"}
    want = {"before", "inside", "after"} if recorder else set()
    assert set(_names(tracing.records())) == want


def _student(mode):
    ds = synthetic_node_dataset(**DATA)
    rng = np.random.default_rng(0)
    teacher_logits = rng.normal(size=(ds.graph.num_nodes, 4)).astype(np.float32)
    teacher_feat = rng.normal(size=(ds.graph.num_nodes, 12)).astype(np.float32)
    cfg = DistillConfig(training=mode, hidden=16, num_layers=2, dropout=0.5, lr=0.01,
                        beta=0.5, max_samples=64, proj_dim=8, teacher_dim=12)
    model = GCN(10, 16, 4, 2, dropout=0.5, seed=0, device="cpu")
    return NodeDistillTrainer(model, cfg, ds.graph, ds.x, ds.y, ds.split_idx,
                              teacher_feat=teacher_feat, teacher_logits=teacher_logits,
                              seed=0, device="cpu")


def _teacher():
    ds = synthetic_node_dataset(**dict(DATA, gcn_norm=False))
    cfg = TeacherConfig(n_hidden=6, n_layers=2, n_heads=2, dropout=0.2, input_drop=0.1,
                        edge_drop=0.1, use_labels=True, n_label_iters=1, no_attn_dst=False)
    return GATTeacherTrainer(cfg, ds.graph, ds.x, ds.y, ds.split_idx, 4, seed=0, device="cpu")


def _run(trainer, epochs):
    if isinstance(trainer, GATTeacherTrainer):
        return trainer.run_epochs(0, epochs)[1]
    return trainer.run_epochs(0, epochs)


def _parents(records):
    by_id = {r.id: r for r in records}
    return Counter((r.name, by_id[r.parent].name if r.parent is not None else None)
                   for r in records)


@pytest.mark.parametrize("mode", ["kd", "nce"])
def test_student_trainer_emits_each_phase_once_an_epoch(mode):
    tr = _student(mode)
    tracing.enable()
    _run(tr, 3)
    records = tracing.records()
    assert _names(records) == dict(dict.fromkeys(STUDENT_PHASES, 3), **{"trainer.readback": 1})
    parents = _parents(records)
    for name in STUDENT_PHASES[1:]:
        assert parents[(name, "trainer.epoch")] == 3, name
    assert parents[("trainer.epoch", None)] == 3 and parents[("trainer.readback", None)] == 1


def test_teacher_trainer_emits_each_phase_once_an_epoch():
    tr = _teacher()
    tracing.enable()
    _run(tr, 2)
    records = tracing.records()
    want = dict.fromkeys(STUDENT_PHASES + ("trainer.track_best",), 2)
    want.update({"trainer.label_reuse": 4, "trainer.readback": 1})
    assert _names(records) == want
    parents = _parents(records)
    # label reuse runs in the train forward and again in the evaluation
    assert parents[("trainer.label_reuse", "trainer.forward")] == 2
    assert parents[("trainer.label_reuse", "trainer.eval")] == 2
    assert parents[("trainer.track_best", "trainer.eval")] == 2


@pytest.mark.parametrize("which", ["kd", "nce", "teacher"])
def test_losses_are_bitwise_equal_with_the_recorder_on_and_off(which):
    make = _teacher if which == "teacher" else (lambda: _student(which))
    off = _run(make(), 3)
    tracing.enable()
    on = _run(make(), 3)
    assert tracing.records()
    assert np.array_equal(on, off)


@pytest.mark.parametrize("which", ["kd", "teacher"])
def test_trainer_phases_land_in_a_profile_with_the_recorder_off(tmp_path, which):
    from torch.profiler import ProfilerActivity, profile

    tr = _teacher() if which == "teacher" else _student(which)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(tr, 1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    names = _user_annotations(path)
    assert set(STUDENT_PHASES) | {"trainer.readback"} <= names
    assert tracing.records() == []


def test_build_graph_emits_its_span_and_three_children():
    rng = np.random.default_rng(0)
    n = 400
    s = rng.integers(0, n, 3000)
    r = np.where(rng.random(3000) < 0.5, 0, rng.integers(0, n, 3000))  # node 0: a hub
    tracing.enable()
    g = build_graph(s, r, n, bidirected=True, self_loops=True, hub_dense=64)
    assert g.hub is not None
    records = tracing.records()
    [root] = [x for x in records if x.name == "graph.build"]
    children = {x.name: x for x in records if x.parent == root.id}
    assert set(children) == {"graph.sort", "graph.hub_partition", "graph.row_split"}
    for c in children.values():
        assert root.t0_ns <= c.t0_ns <= c.t1_ns <= root.t1_ns
    assert children["graph.sort"].t1_ns <= children["graph.hub_partition"].t0_ns \
        <= children["graph.row_split"].t0_ns
    assert root.parent is None and len(records) == 4


MOL_STEP_PHASES = ("trainer.forward", "trainer.criterion", "trainer.backward",
                   "trainer.optimizer")


def _mol_trainer():
    from efficient_gnns_tpu_torch.data import molhiv
    from efficient_gnns_tpu_torch.models.mol import MolGNN
    from efficient_gnns_tpu_torch.train import MolTrainer

    ds = molhiv.synthetic_molhiv_dataset(n_train=128, n_valid=4, n_test=4, min_atoms=4,
                                         max_atoms=8, seed=1)
    model = MolGNN("gine", 8, 1, 2, dropout=0.5, virtual_node=True, virtual_node_norm=True,
                   seed=0, device="cpu")
    return MolTrainer(DistillConfig(lr=0.001), ds, model, batch_size=2, max_atoms=8, seed=0,
                      device="cpu")


def test_mol_trainer_spans_nest_and_an_epoch_holds_64_steps():
    off = _mol_trainer().run_epochs(0, 1)
    tr = _mol_trainer()
    tracing.enable()
    on = tr.run_epochs(0, 1)
    np.testing.assert_array_equal(on, off)  # the recorder changes no number
    records = tracing.records()
    names = _names(r for r in records if not r.name.startswith("graph."))
    steps = dict.fromkeys(("trainer.step", "mol.pack", "mol.upload") + MOL_STEP_PHASES, 64)
    assert names == dict(steps, **{"trainer.epoch": 1, "trainer.eval": 1,
                                   "trainer.readback": 1})
    parents = _parents(records)
    # packing builds each batch's graph: the train batches' under mol.pack,
    # the evaluation's (packed once, at the first evaluation) under trainer.eval
    assert parents[("graph.build", "mol.pack")] == 64
    assert parents[("graph.build", "trainer.eval")] == 64 + 2 + 2
    for name in ("mol.pack", "mol.upload", "trainer.step", "trainer.eval"):
        assert parents[(name, "trainer.epoch")] == _names(records)[name], name
    for name in MOL_STEP_PHASES:
        assert parents[(name, "trainer.step")] == 64, name
    assert parents[("trainer.epoch", None)] == 1 and parents[("trainer.readback", None)] == 1
    # each batch is packed, then uploaded, then stepped
    order = [r.name for r in sorted(records, key=lambda r: r.t0_ns)
             if r.name in ("mol.pack", "mol.upload", "trainer.step")]
    assert order == ["mol.pack", "mol.upload", "trainer.step"] * 64
