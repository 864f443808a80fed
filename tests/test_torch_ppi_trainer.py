"""Port vs JAX: the PPI trainer (``train/ppi_trainer.py``) in every mode, the
PPI CLI, and a JAX teacher checkpoint read by the port.

Both trainers start from the same (transplanted) student, teacher and, in
``nce`` / ``fitnet``, projection heads, on the same synthetic graphs (the
modes and sizes of ``tests/test_ppi.py``), and take the same steps in the
same graph order. ``max_samples`` is at the padded node count, so the
sampled terms see every valid row on both sides (each draws another order
of the rows, which these terms do not depend on). Per-epoch losses agree to
rtol 1e-4 over 3 epochs: the step-1 losses agree to float32 rounding and
Adam carries each gradient's rounding into the next step. Micro-F1 agrees
to 0.02 (a logit near 0 may flip).
"""

import json
import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data import ppi as jax_ppi
from efficient_gnns_tpu.models import PPIGAT as JaxPPIGAT
from efficient_gnns_tpu.models import ppi_teacher as jax_ppi_teacher
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train.checkpoint import save_pytree
from efficient_gnns_tpu.train.ppi_trainer import PPITrainer as JaxPPITrainer
from efficient_gnns_tpu_torch.cli import ppi as cli
from efficient_gnns_tpu_torch.data import synthetic_ppi_dataset
from efficient_gnns_tpu_torch.models import PPIGAT, from_jax_params, ppi_student, ppi_teacher
from efficient_gnns_tpu_torch.train import DistillConfig, PPITrainer
from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

to_np = partial(jax.tree_util.tree_map, np.asarray)
DATA = dict(n_train=3, n_valid=1, n_test=1, min_nodes=40, max_nodes=80, avg_deg=5,
            feat_dim=16, num_labels=12, seed=0)
MODES = [("supervised", False), ("kd", False), ("nce", False), ("lpw", True),
         ("gpw", False), ("at", True), ("fitnet", True)]


def _state(params, stats=None):
    return from_jax_params(to_np(params), to_np(stats or {}))


@pytest.mark.parametrize("mode,kd_aux", MODES)
def test_ppi_trainer_tracks_jax(mode, kd_aux):
    jds, tds = jax_ppi.synthetic_ppi_dataset(**DATA), synthetic_ppi_dataset(**DATA)
    n_pad = tds.train[0].graph.num_nodes
    cfg = dict(training=mode, kd_and_aux=kd_aux, lr=0.005, alpha=0.5, kd_T=1.0,
               beta=1.0 if mode in ("gpw", "nce") else 100.0, max_samples=n_pad,
               proj_dim=8)
    jtr = JaxPPITrainer(JaxConfig(**cfg), jds,
                        JaxPPIGAT(hidden=8, out_feats=12, num_layers=2, heads=2),
                        teacher=JaxPPIGAT(hidden=12, out_feats=12, num_layers=2, heads=2),
                        teacher_feat_dim=24, seed=0)
    student = PPIGAT(16, 8, 12, 2, heads=2, seed=9, device="cpu")
    student.load_state_dict(_state(jtr.state.params["model"]))
    teacher = None
    if jtr.teacher_vars is not None:
        teacher = PPIGAT(16, 12, 12, 2, heads=2, seed=9, device="cpu")
        teacher.load_state_dict(_state(jtr.teacher_vars["params"]))
    ttr = PPITrainer(DistillConfig(**cfg), tds, student, teacher=teacher,
                     teacher_feat_dim=24, seed=0, device="cpu")
    assert (ttr.sproj is not None) == ("sproj" in jtr.state.params) == (
        mode in ("nce", "fitnet"))
    if ttr.sproj is not None:
        for part in ("sproj", "tproj"):
            getattr(ttr, part).load_state_dict(
                _state(jtr.state.params[part], jtr.state.batch_stats[part]))
    losses = []
    for epoch in (1, 2, 3):
        want, got = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert set(got) == set(want) == {"loss", "loss_cls", "loss_aux"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"epoch {epoch} {k}")
        losses.append(got["loss"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    f1 = ttr.evaluate_all()
    np.testing.assert_allclose(f1, jtr.evaluate_all(), atol=0.02)
    assert ttr.evaluate(ttr.valid_graphs) == f1[1]


def test_trainer_masks_padding_nodes():
    # padding nodes have no edge and no label: features there that drive
    # their logits far from 0 change neither the loss nor micro-F1
    ds = synthetic_ppi_dataset(**DATA)
    model = PPIGAT(16, 8, 12, 2, heads=2, device="cpu")
    tr = PPITrainer(DistillConfig(lr=0.0), ds, model, seed=0, device="cpu")
    base_f1, base = tr.evaluate_all(), tr.train_epoch(1)
    for g, x, _ in tr.train_graphs + tr.valid_graphs + tr.test_graphs:
        x[~g.node_mask] = 1e3
    with torch.no_grad():
        logits, _ = model(*tr.train_graphs[0][:2])
    assert float(logits[~tr.train_graphs[0][0].node_mask].abs().max()) > 100
    assert tr.evaluate_all() == base_f1
    assert tr.train_epoch(1) == base


def test_trainer_refuses_a_missing_teacher_and_other_modes():
    ds = synthetic_ppi_dataset(**DATA)
    model = PPIGAT(16, 8, 12, 2, heads=2, device="cpu")
    with pytest.raises(ValueError, match="needs a teacher"):
        PPITrainer(DistillConfig(training="kd"), ds, model, device="cpu")
    with pytest.raises(ValueError, match="PPI training mode"):
        PPITrainer(DistillConfig(training="gcd"), ds, model, device="cpu")


def _run(tmp_path, *argv):
    return cli.main(["--device", "cpu", "--epochs", "1", "--runs", "1",
                     "--out_dir", str(tmp_path), *argv])


def test_cli_trains_a_teacher_and_a_kd_student_from_its_checkpoint(tmp_path):
    summary = _run(tmp_path, "--train_teacher", "--expt_name", "t")
    path = cli.teacher_checkpoint_path(str(tmp_path), "t", 0)
    assert os.path.exists(path)
    with open(tmp_path / "ppi-t-teacher.json") as f:
        written = json.load(f)
    assert written["statistics"] == summary["statistics"]
    assert set(written["statistics"]) >= {"highest_valid_mean", "final_test_mean"}
    assert len(summary["runs"][0]["losses"]) == 1

    student = _run(tmp_path, "--training", "kd", "--teacher_path",
                   str(tmp_path / "ppi_teacher" / "t"))
    assert os.path.exists(tmp_path / "ppi-debug-student-kd.json")
    # the student's first epoch is the one a trainer built by hand from the
    # checkpoint takes (the CLI's teacher seed gives other random weights)
    ds = synthetic_ppi_dataset(seed=42)
    teacher = ppi_teacher(50, 121, seed=1, device="cpu")
    teacher.load_state_dict(load_checkpoint(path))
    tr = PPITrainer(DistillConfig(training="kd", lr=0.005, alpha=0.5, kd_T=1.0), ds,
                    ppi_student(50, 121, seed=0, device="cpu"), teacher=teacher,
                    seed=0, device="cpu")
    np.testing.assert_allclose(tr.train_epoch(1)["loss"], student["runs"][0]["losses"][0],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="--platform"):
        _run(tmp_path, "--platform", "cpu")


def test_jax_teacher_checkpoint_gives_the_jax_logits(tmp_path):
    # the JAX CLI's --train_teacher file (flax msgpack of {"params": ...}),
    # converted to the port's checkpoint.pt here: the port itself does not
    # read flax files (flax imports JAX)
    from flax import serialization

    jds, tds = jax_ppi.synthetic_ppi_dataset(seed=42), synthetic_ppi_dataset(seed=42)
    g0 = jds.train[0]
    jm = jax_ppi_teacher(121)
    params = jm.init({"params": jax.random.PRNGKey(5)}, g0.graph, g0.x)["params"]
    src = save_pytree(str(tmp_path / "jax" / "seed0" / "checkpoint.msgpack"),
                      {"params": params})
    with open(src, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    save_checkpoint(str(tmp_path / "port" / "seed0" / "checkpoint.pt"),
                    from_jax_params(restored["params"], {}))
    teacher = ppi_teacher(50, 121, device="cpu")
    teacher.load_state_dict(load_checkpoint(str(tmp_path / "port" / "seed0" /
                                                "checkpoint.pt")))
    teacher.eval()
    for jg, tg in zip(jds.valid + jds.test, tds.valid + tds.test):
        want, want_feat = jm.apply({"params": params}, jg.graph, jg.x)
        with torch.no_grad():
            got, feat = teacher(tg.graph, torch.from_numpy(tg.x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=1e-4, atol=1e-5)
