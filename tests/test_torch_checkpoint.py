"""Checkpoints and ``--resume`` in the port, and JAX checkpoints read by it.

A run stopped after epoch 2 and restored from its checkpoint must give the
same per-epoch losses as the unbroken run, bit for bit: the generators are
seeded from ``(seed, epoch)``, and the checkpoint holds the parameters, the
BatchNorm statistics and the optimizer's moments. A JAX trainer's flax
msgpack checkpoint, converted to the port's format by
``flax_to_port_checkpoint`` below (the port itself cannot read flax files:
flax imports JAX), must give the port's trainer the JAX trainer's next-epoch
loss within rtol 1e-4 (dropout 0).
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data import synthetic_node_dataset as jax_synthetic
from efficient_gnns_tpu.models import GCN as JaxGCN
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train import NodeDistillTrainer as JaxTrainer
from efficient_gnns_tpu_torch.cli import arxiv as cli
from efficient_gnns_tpu_torch.cli import gat_teacher as teacher_cli
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.distill import load_teacher_dump
from efficient_gnns_tpu_torch.models import GCN, GATTeacher, from_jax_params
from efficient_gnns_tpu_torch.train import DistillConfig, GATTeacherTrainer, NodeDistillTrainer
from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from efficient_gnns_tpu_torch.train.gat_teacher import TeacherConfig

DATA = dict(num_nodes=500, num_edges=2500, feat_dim=16, num_classes=5, seed=1, signal=0.5)
# the representation modes sample 64 of the 270 train rows, so the restored
# generator's draws matter too
MODES = {
    "supervised": {},
    "kd": {},
    "nce": {"beta": 0.5, "max_samples": 64, "proj_dim": 8},
    "nce+kd": {"training": "nce", "kd_and_aux": True, "beta": 0.5, "max_samples": 64,
               "proj_dim": 8},
    "adamw": {"training": "supervised", "weight_decay": 5e-4},
}


def _trainer(ds, mode, seed=0):
    kw = dict(MODES[mode])
    cfg = DistillConfig(**{"training": mode, "hidden": 32, **kw})
    teacher = {}
    if cfg.needs_teacher():
        teacher = dict(teacher_feat=cli.oracle_teacher_features(ds.y, ds.num_classes),
                       teacher_logits=cli.oracle_teacher_logits(ds.y, ds.num_classes))
    model = GCN(ds.x.shape[1], 32, ds.num_classes, 2, dropout=0.5, seed=seed, device="cpu")
    return NodeDistillTrainer(model, cfg, ds.graph, ds.x, ds.y, ds.split_idx, seed=seed,
                              device="cpu", **teacher)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_restored_run_matches_the_unbroken_run(tmp_path, mode):
    ds = synthetic_node_dataset(**DATA)
    unbroken = _trainer(ds, mode).run_epochs(1, 5)
    first = _trainer(ds, mode)
    first.run_epochs(1, 2)
    path = first.save_checkpoint(str(tmp_path / "run" / "checkpoint.pt"))
    assert os.path.exists(path)
    resumed = _trainer(ds, mode, seed=0)
    assert resumed.restore_checkpoint(path) == 2
    np.testing.assert_array_equal(resumed.run_epochs(3, 3), unbroken[2:])
    assert resumed.step == 5


def test_checkpoint_holds_heads_batchnorm_and_optimizer(tmp_path):
    ds = synthetic_node_dataset(**DATA)
    tr = _trainer(ds, "nce")
    tr.run_epochs(1, 2)
    state = load_checkpoint(tr.save_checkpoint(str(tmp_path / "c.pt")))
    assert state["step"] == 2 and set(state["modules"]) == {"model", "sproj", "tproj"}
    assert "bns.0.running_mean" in state["modules"]["model"]
    assert "bn.running_var" in state["modules"]["sproj"]
    np.testing.assert_array_equal(state["modules"]["model"]["bns.0.running_mean"].numpy(),
                                  tr.model.bns[0].running_mean.numpy())
    moments = state["optimizer"]
    assert set(moments) == {f"{k}.{n}" for k, m in tr._named_modules().items()
                            for n, _ in m.named_parameters()}
    assert all(float(s["step"]) == 2 for s in moments.values())
    np.testing.assert_array_equal(moments["model.convs.0.weight"]["exp_avg"].numpy(),
                                  tr.opt.state[tr.model.convs[0].weight]["exp_avg"].numpy())


def test_save_checkpoint_creates_its_directory(tmp_path):
    path = str(tmp_path / "a" / "b" / "x.pt")
    assert save_checkpoint(path, {"w": torch.arange(3), "n": 4}) == path
    got = load_checkpoint(path)
    assert got["n"] == 4 and torch.equal(got["w"], torch.arange(3))


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state tree as flax serialises it (chains become ``{"0": ..., "1": ...}``,
    empty states vanish)."""
    if isinstance(opt_state, dict):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        for value in opt_state.values():
            found = _adam_state(value)
            if found is not None:
                return found
    return None


def flax_to_port_checkpoint(src, dst):
    """Convert a JAX ``NodeDistillTrainer`` msgpack checkpoint into the
    port's ``torch.save`` format: ``params`` / ``batch_stats`` through
    ``from_jax_params``, and the optax Adam (or AdamW) moments ``mu`` /
    ``nu`` / ``count`` onto torch's ``exp_avg`` / ``exp_avg_sq`` / ``step``,
    keyed by ``<module>.<parameter>``."""
    from flax import serialization

    with open(src, "rb") as f:
        state = serialization.msgpack_restore(f.read())
    params, stats = state["params"], state.get("batch_stats", {})
    adam = _adam_state(state["opt_state"])
    step = torch.tensor(float(adam["count"]))
    modules, moments = {}, {}
    for key in params:
        modules[key] = from_jax_params(params[key], stats.get(key, {}))
        mu = from_jax_params(adam["mu"][key], {})
        nu = from_jax_params(adam["nu"][key], {})
        moments.update({f"{key}.{name}": {"step": step.clone(), "exp_avg": mu[name],
                                          "exp_avg_sq": nu[name]} for name in mu})
    return save_checkpoint(dst, {"step": int(state["step"]), "modules": modules,
                                 "optimizer": moments})


def _jax_trainer(jd, cfg):
    teacher = {}
    if cfg["training"] != "supervised":
        teacher = dict(
            teacher_feat=jnp.asarray(cli.oracle_teacher_features(jd.y, jd.num_classes)),
            teacher_logits=jnp.asarray(cli.oracle_teacher_logits(jd.y, jd.num_classes)))
    return JaxTrainer(JaxGCN(hidden=32, out_feats=5, num_layers=2, dropout=0.0),
                      JaxConfig(**cfg), jd.graph, jd.x, jd.y, jd.split_idx, seed=0,
                      **teacher)


@pytest.mark.parametrize("mode", ["supervised", "adamw", "nce"])
def test_flax_checkpoint_continues_the_jax_run(tmp_path, mode):
    pytest.importorskip("flax")
    cfg = {"training": mode, "hidden": 32, "dropout": 0.0, "lr": 0.01, **MODES[mode]}
    if mode == "nce":  # above the 270 train rows: neither side samples rows
        cfg["max_samples"] = 512
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    jtr = _jax_trainer(jd, cfg)
    jtr.train_epoch(1)
    jtr.train_epoch(2)
    path = flax_to_port_checkpoint(jtr.save_checkpoint(str(tmp_path / "checkpoint.msgpack")),
                                   str(tmp_path / "checkpoint.pt"))

    model = GCN(16, 32, 5, 2, dropout=0.0, seed=7, device="cpu")  # other weights
    teacher = {}
    if cfg["training"] != "supervised":
        teacher = dict(teacher_feat=cli.oracle_teacher_features(td.y, td.num_classes),
                       teacher_logits=cli.oracle_teacher_logits(td.y, td.num_classes))
    ttr = NodeDistillTrainer(model, DistillConfig(**cfg), td.graph, td.x, td.y,
                             td.split_idx, seed=0, device="cpu", **teacher)
    assert ttr.restore_checkpoint(path) == 2
    to_np = partial(jax.tree_util.tree_map, np.asarray)
    want = from_jax_params(to_np(jtr.state.params["model"]),
                           to_np(jtr.state.batch_stats["model"]))
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
    for p in ttr.modules.parameters():
        assert float(ttr.opt.state[p]["step"]) == 2
    want3, got3 = jtr.train_epoch(3), ttr.train_epoch(3)
    for k in want3:
        np.testing.assert_allclose(got3[k], want3[k], rtol=1e-4, atol=1e-7, err_msg=k)


def _cli(tmp_path, expt, *extra):
    argv = ["--device", "cpu", "--num_nodes", "400", "--num_edges", "2000", "--runs", "1",
            "--hidden_channels", "16", "--out_dir", str(tmp_path), "--expt_name", expt,
            "--log_steps", "1", *extra]
    cli.main(argv)
    with open(os.path.join(tmp_path, expt, "gcn-supervised", "seed0", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_resume_reproduces_the_unbroken_run(tmp_path, capsys):
    unbroken = _cli(tmp_path, "a", "--epochs", "5")
    first = _cli(tmp_path, "b", "--epochs", "3", "--checkpoint_every", "3")
    ckpt = os.path.join(tmp_path, "b", "gcn-supervised", "seed0", "checkpoint.pt")
    assert load_checkpoint(ckpt)["step"] == 3
    capsys.readouterr()
    both = _cli(tmp_path, "b", "--epochs", "5", "--resume", "--checkpoint_every", "3")
    assert f"Run 01: resumed from {ckpt} at epoch 4" in capsys.readouterr().out
    assert [r["step"] for r in both] == [1, 2, 3, 4, 5]  # appended after epoch 3
    assert [r["loss/train"] for r in both[3:]] == [r["loss/train"] for r in unbroken[3:]]
    assert [r["loss/train"] for r in first] == [r["loss/train"] for r in unbroken[:3]]
    assert load_checkpoint(ckpt)["step"] == 5


@pytest.mark.parametrize("chunk,every,saved_after", [
    ("2", "3", [4]),  # chunks end at 2, 4, 5: the one ending at 4 crosses 3
    ("5", "2", [5]),  # one chunk crosses 2 and 4
    ("1", "2", [2, 4]),
])
def test_cli_saves_when_a_chunk_crosses_a_multiple(tmp_path, monkeypatch, chunk, every,
                                                   saved_after):
    saved = []
    real = NodeDistillTrainer.save_checkpoint

    def spy(self, path):
        saved.append(self.step)
        return real(self, path)

    monkeypatch.setattr(NodeDistillTrainer, "save_checkpoint", spy)
    _cli(tmp_path, "c", "--epochs", "5", "--epoch_chunk", chunk, "--checkpoint_every", every)
    assert saved == saved_after + [5]  # and once at the end


def test_cli_resume_without_a_checkpoint_starts_at_epoch_1(tmp_path):
    records = _cli(tmp_path, "d", "--epochs", "2", "--resume")
    assert [r["step"] for r in records] == [1, 2]


def test_teacher_checkpoint_reproduces_the_dump(tmp_path):
    out = str(tmp_path)
    teacher_cli.main(["--device", "cpu", "--num-nodes", "300", "--num-edges", "1500",
                      "--n-hidden", "8", "--n-heads", "2", "--n-epochs", "3",
                      "--n-runs", "1", "--seed", "3", "--use-labels", "--n-label-iters", "1",
                      "--save-pred", "--expt-name", "t", "--out-dir", out])
    state = load_checkpoint(os.path.join(out, "checkpoints", "t", "3.pt"))
    _, logits = load_teacher_dump(os.path.join(out, "teacher_dumps", "t"), 3)
    ds = synthetic_node_dataset(num_nodes=300, num_edges=1500, seed=42, hub_dense="auto",
                                gcn_norm=False)
    # the CLI's architecture flags: attn-dst on, no symmetric norm
    cfg = TeacherConfig(n_hidden=8, n_heads=2, use_labels=True, n_label_iters=1,
                        no_attn_dst=False, use_norm=False)
    trainer = GATTeacherTrainer(cfg, ds.graph, ds.x, ds.y, ds.split_idx, ds.num_classes,
                                seed=11, device="cpu")
    assert isinstance(trainer.model, GATTeacher)
    trainer.model.load_state_dict(state)
    got, *_ = trainer.evaluate()
    np.testing.assert_allclose(got.numpy(), logits, rtol=1e-6, atol=1e-6)
