"""Port vs JAX: the MAG trainer (``train/mag_trainer.py``) in every mode, the
MAG CLI, a JAX teacher checkpoint read by the port, and the prefetcher.

Both trainers draw the same GraphSAINT subgraphs (the samplers' streams are
equal, ``tests/test_torch_mag_sampler.py``) and start from the same student,
teacher and, in ``nce`` / ``fitnet``, projection heads (transplanted from
JAX). Dropout is 0 and ``max_samples`` is above the node budget, so the
sampled terms see every train row on both sides. Per-epoch losses agree to
rtol 1e-4 over 2 epochs of 3 steps, and so do the layer-wise and full-graph
accuracies.
"""

import json
import os
import threading
from functools import partial

import jax
import numpy as np
import pytest

from efficient_gnns_tpu.data.mag import synthetic_mag_dataset as jax_mag_dataset
from efficient_gnns_tpu.train.config import DistillConfig as JaxConfig
from efficient_gnns_tpu.train.mag_trainer import MagTrainer as JaxMagTrainer
from efficient_gnns_tpu_torch import tracing
from efficient_gnns_tpu_torch.cli import mag as cli
from efficient_gnns_tpu_torch.data import synthetic_mag_dataset
from efficient_gnns_tpu_torch.models import from_jax_params
from efficient_gnns_tpu_torch.train import DistillConfig, MagTrainer, rgcn_for
from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from efficient_gnns_tpu_torch.train.mag_trainer import _SamplePrefetcher

to_np = partial(jax.tree_util.tree_map, np.asarray)
MAG = dict(n_paper=300, n_author=150, n_inst=10, n_field=30, feat_dim=16, num_classes=4, seed=3)
TRAINER = dict(batch_size=48, num_steps=3, seed=0, teacher_hidden=12, teacher_layers=2)


def _pair(mode, kd_and_aux=False, typed=True):
    cfg = dict(training=mode, kd_and_aux=kd_and_aux, hidden=8, num_layers=2, dropout=0.0,
               lr=0.01, beta=1.0, max_samples=4096, proj_dim=8)
    jtr = JaxMagTrainer(JaxConfig(**cfg), jax_mag_dataset(**MAG), typed_square=typed,
                        **TRAINER)
    ttr = MagTrainer(DistillConfig(**cfg), synthetic_mag_dataset(**MAG), typed_square=typed,
                     device="cpu", **TRAINER)
    ttr.model.load_state_dict(from_jax_params(to_np(jtr.state.params["model"]), {}))
    assert (ttr.teacher is None) == (jtr.teacher_vars is None)
    if ttr.teacher is not None:
        ttr.teacher.load_state_dict(from_jax_params(to_np(jtr.teacher_vars["params"]), {}))
    assert (ttr.sproj is not None) == ("sproj" in jtr.state.params)
    if ttr.sproj is not None:
        for part in ("sproj", "tproj"):
            getattr(ttr, part).load_state_dict(from_jax_params(
                to_np(jtr.state.params[part]), to_np(jtr.state.batch_stats[part])))
    return jtr, ttr


@pytest.mark.parametrize("mode,kd_and_aux,typed", [
    ("supervised", False, True), ("kd", False, True), ("nce", False, True),
    ("nce", True, True), ("lpw", True, True), ("gpw", False, True), ("at", True, True),
    ("fitnet", False, True), ("supervised", False, False), ("lpw", False, False)])
def test_mag_trainer_tracks_jax(mode, kd_and_aux, typed):
    jtr, ttr = _pair(mode, kd_and_aux, typed)
    try:
        losses = []
        for epoch in (1, 2):
            want, got = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
            assert set(got) == set(want) == {"loss", "loss_cls", "loss_aux"}
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                           err_msg=f"epoch {epoch} {k}")
            losses.append(got["loss"])
        assert np.isfinite(losses).all()
        np.testing.assert_allclose(ttr.evaluate(), jtr.evaluate(), atol=1e-6)
        np.testing.assert_allclose(ttr.evaluate(layerwise=False), jtr.evaluate(layerwise=False),
                                   atol=1e-6)
    finally:
        jtr.close()
        ttr.close()


def test_trainer_refuses_modes_the_jax_trainer_has_not():
    with pytest.raises(ValueError, match="MAG training mode"):
        MagTrainer(DistillConfig(training="gcd"), synthetic_mag_dataset(**MAG), device="cpu")


class _Sampler:
    def __init__(self, fail_at=None, block=None):
        self.n, self.fail_at, self.block = 0, fail_at, block

    def sample(self):
        self.n += 1
        if self.n == self.fail_at:
            raise KeyError("boom")
        if self.block is not None:
            self.block.wait()
        return self.n


def test_prefetcher_keeps_the_order_and_surfaces_a_failure():
    tracing.reset()
    tracing.enable()
    try:
        p = _SamplePrefetcher(_Sampler(fail_at=4), lambda s: s, depth=2)
        assert [p.get() for _ in range(3)] == [1, 2, 3]
        with pytest.raises(RuntimeError, match="failed") as info:
            p.get()
        assert isinstance(info.value.__cause__, KeyError)
        p.close()
    finally:
        tracing.enable(False)
    spans = [r for r in tracing.records() if r.name.startswith("sampler.")]
    tracing.reset()
    assert p.samples == 3
    # three samples drawn and uploaded on the prefetch thread, the fourth raised
    assert [r.name for r in spans] == ["sampler.sample", "sampler.upload"] * 3 + ["sampler.sample"]
    assert {r.thread for r in spans} == {p._thread.ident}
    assert all(r.t0_ns <= r.t1_ns for r in spans)


def test_prefetcher_close_raises_while_the_thread_is_inside_sample():
    release = threading.Event()
    p = _SamplePrefetcher(_Sampler(block=release), lambda s: s, depth=1)
    with pytest.raises(RuntimeError, match="did not stop"):
        p.close(timeout=0.2)
    release.set()
    p.close()  # now it stops


def _run(tmp_path, *argv):
    return cli.main(["--device", "cpu", "--n_paper", "300", "--batch_size", "64",
                     "--num_steps", "2", "--epochs", "2", "--runs", "1",
                     "--out_dir", str(tmp_path), *argv])


def test_cli_trains_a_teacher_and_a_kd_student_from_its_checkpoint(tmp_path, capsys):
    teacher = _run(tmp_path, "--num_layers", "3", "--hidden_channels", "16",
                   "--expt_name", "t", "--save_ckpt", str(tmp_path / "ckpt"),
                   "--time_steps", "2")
    first = capsys.readouterr().out.splitlines()[0]
    assert "walker=native" in first or "walker=numpy" in first
    with open(tmp_path / "mag-t-supervised.json") as f:
        written = json.load(f)
    assert set(written) == {"args", "statistics", "epoch_seconds"}
    assert written["statistics"] == teacher["statistics"]
    assert len(teacher["losses"]["run0"]) == 2
    assert "device_step_ms" in written["epoch_seconds"]["run0"][-1]
    ckpt = cli.checkpoint_path(str(tmp_path / "ckpt"), 0)
    state = load_checkpoint(ckpt)
    assert state["convs.2.rel_weights.6"].shape == (16, 16)  # 3 layers, 16 wide

    student = _run(tmp_path, "--training", "kd", "--teacher_path", str(tmp_path / "ckpt"),
                   "--teacher_hidden", "16", "--no_typed_square")
    assert os.path.exists(tmp_path / "mag-debug-kd.json")
    # the student's first epoch is the one a trainer built by hand from the
    # checkpoint takes
    ds = synthetic_mag_dataset(n_paper=300, seed=42)
    tr = MagTrainer(DistillConfig(training="kd", num_layers=2, hidden=32), ds, batch_size=64,
                    num_steps=2, teacher_state=state, teacher_hidden=16, typed_square=False,
                    device="cpu")
    try:
        np.testing.assert_allclose(tr.train_epoch(1)["loss"], student["losses"]["run0"][0],
                                   rtol=1e-6)
    finally:
        tr.close()
    with pytest.raises(ValueError, match="--platform"):
        _run(tmp_path, "--platform", "cpu")
    with pytest.raises(ValueError, match="--dataset"):
        _run(tmp_path, "--dataset", "ogbn-arxiv")


def test_cli_reads_the_ogbn_mag_raw_cache(tmp_path):
    from test_torch_mag_data import write_mag_cache

    ds = synthetic_mag_dataset(n_paper=200, n_author=100, n_inst=8, n_field=20, seed=1)
    g = ds.grouped
    rel = {}
    for (src, name, dst), j in ((k, v) for k, v in g.key2int.items() if isinstance(k, tuple)):
        if name != "to":
            m = g.edge_type == j
            off = {t: int(g.local2global[t][0]) for t in (src, dst)}
            rel[(src, name, dst)] = g.edge_index[:, m] - np.array([[off[src]], [off[dst]]])
    write_mag_cache(str(tmp_path / "data"), rel, ds.num_nodes_dict, ds.x_paper, ds.y_paper,
                    ds.split_idx)
    out = _run(tmp_path, "--dataset", "ogbn-mag", "--data_root", str(tmp_path / "data"),
               "--epochs", "1")
    assert np.isfinite(out["losses"]["run0"]).all()


def test_jax_teacher_checkpoint_gives_the_jax_logits(tmp_path):
    # the JAX CLI's --save_ckpt file (flax msgpack of {"params": ...}),
    # converted to the port's seed<k>.pt here: the port itself does not read
    # flax files (flax imports JAX)
    from flax import serialization

    from efficient_gnns_tpu.train.checkpoint import save_pytree

    jtr, ttr = _pair("kd")
    try:
        src = save_pytree(str(tmp_path / "jax" / "seed0.msgpack"),
                          {"params": jtr.teacher_vars["params"]})
        with open(src, "rb") as f:
            restored = serialization.msgpack_restore(f.read())
        save_checkpoint(cli.checkpoint_path(str(tmp_path / "port"), 0),
                        from_jax_params(restored["params"], {}))
        teacher = rgcn_for(ttr.ds, 12, 2, device="cpu")
        teacher.load_state_dict(load_checkpoint(cli.checkpoint_path(str(tmp_path / "port"), 0)))
        want, want_feat = jtr.layerwise(
            jtr.teacher_vars, jtr.x_global, jtr.node_type_global, jtr.local_idx_global,
            num_layers=2, num_node_types=4, emb_sizes=jtr.teacher.emb_sizes)
        got, feat = ttr.layerwise(teacher, ttr.x_global, ttr.node_type_global,
                                  ttr.local_idx_global)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=1e-4, atol=1e-4)
    finally:
        jtr.close()
        ttr.close()
