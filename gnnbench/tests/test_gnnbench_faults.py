"""A run with the timed path broken underneath comes out not correct.

Each cell at a CPU test's size (``conftest.small_spec``; the teacher with
float32 hub messages, so that the unbroken run sits far inside the cell's
limits), driven through ``harness.run_cell`` with the program broken in one
way: a step that leaves the state unchanged, a loss taken over half of its
rows, and an answer altered where it is produced (the loss, 1% off); and the
teacher with its best-validation tracking left out. The unbroken run is
correct."""

import time

import pytest
import torch

from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.train import gat_teacher as teacher_mod
from gnnbench import harness
from gnnbench.drivers import gat_teacher, node_student
from gnnbench.tests.conftest import small_spec

CELLS = ("teacher-arxiv", "student-nce-arxiv", "student-kd-arxiv")


def _spec(name):
    if name == "teacher-arxiv":
        return small_spec(name, hub_message_dtype="float32")
    return small_spec(name)


def _driver(name):
    return gat_teacher if name == "teacher-arxiv" else node_student


def _state_unchanged(monkeypatch, name):
    program = _driver(name).Program
    plain = program.__init__

    def init(self, *args, **kwargs):
        plain(self, *args, **kwargs)
        self.trainer.opt.step = lambda *a, **k: None

    monkeypatch.setattr(program, "__init__", init)


def _half_rows(x):
    return x[: x.shape[0] // 2]


def _half_batch(monkeypatch, name):
    if name == "teacher-arxiv":
        plain = teacher_mod.log_eps_loss

        def loss(logits, labels, mask):
            rows = mask.nonzero()[:, 0]
            half = torch.zeros_like(mask)
            half[_half_rows(rows)] = True
            return plain(logits, labels, half)

        monkeypatch.setattr(teacher_mod, "log_eps_loss", loss)
        return
    plain_kd, plain_ce = criteria.kd_criterion, criteria.cls_ce
    monkeypatch.setattr(criteria, "kd_criterion", lambda out, labels, t, *a, **k: plain_kd(
        _half_rows(out), _half_rows(labels), _half_rows(t), *a, **k))
    monkeypatch.setattr(criteria, "cls_ce", lambda out, labels, *a, **k: plain_ce(
        _half_rows(out), _half_rows(labels), *a, **k))


def _answer_altered(monkeypatch, name):
    if name == "teacher-arxiv":
        plain = teacher_mod.log_eps_loss
        monkeypatch.setattr(teacher_mod, "log_eps_loss", lambda *a: plain(*a) * 1.01)
        return
    plain_kd, plain_ce = criteria.kd_criterion, criteria.cls_ce
    monkeypatch.setattr(criteria, "kd_criterion", lambda *a, **k: tuple(
        v * 1.01 for v in plain_kd(*a, **k)))
    monkeypatch.setattr(criteria, "cls_ce", lambda *a, **k: plain_ce(*a, **k) * 1.01)


def _run(name):
    return harness.run_cell(_spec(name), name, 2**31 + 99, 0.2, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["_lines"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    out = _run(name)
    assert not out["correct"], out["_lines"]


def test_a_teacher_that_tracks_no_best_is_not_correct(monkeypatch):
    monkeypatch.setattr(teacher_mod.GATTeacherTrainer, "_track_best", lambda self, *a: None)
    out = _run("teacher-arxiv")
    assert not out["correct"], out["_lines"]
    assert out["checks"]["best"]["value"] == "inf"
