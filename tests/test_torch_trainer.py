"""Port vs JAX: the student trainer as a whole, and the port's CLI.

Both trainers start from the same (transplanted) parameters of the model and,
in the modes that have them, of the two projection heads, with dropout
0 and run 5 epochs (3 in the representation-distillation modes) on the same
synthetic dataset. The per-epoch losses must
agree to rtol 1e-4: the step-1 losses agree to float32 rounding, and Adam
carries the rounding of each gradient into the next step's parameters. The
final parameters must agree to 1e-5, except the first conv's bias and the
running mean behind it: that bias feeds a BatchNorm, so its true gradient is
0, and Adam, which normalises each gradient by its own size, moves it by
about lr per step in the direction of each side's rounding noise. Through
the eval-mode running mean this flips a few near-tied predictions, so the
accuracies must agree to 0.05.
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
from efficient_gnns_tpu.distill import criteria as jax_criteria
from efficient_gnns_tpu.graphs.preprocess import induced_subgraph as jax_induced_subgraph
from efficient_gnns_tpu.models import GCN as JaxGCN
from efficient_gnns_tpu.models import SAGE as JaxSAGE
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train import NodeDistillTrainer as JaxTrainer
from efficient_gnns_tpu_torch.cli import arxiv as cli
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.distill import criteria, save_teacher_dump
from efficient_gnns_tpu_torch.graphs import induced_subgraph
from efficient_gnns_tpu_torch.models import GCN, SAGE, from_jax_params
from efficient_gnns_tpu_torch.train import DistillConfig, NodeDistillTrainer

DATA = dict(num_nodes=500, num_edges=2500, feat_dim=16, num_classes=5, seed=1,
            signal=0.5)


def _jax_state(trainer, part="model"):
    to_np = partial(jax.tree_util.tree_map, np.asarray)
    return from_jax_params(to_np(trainer.state.params[part]),
                           to_np(trainer.state.batch_stats[part]))


@pytest.mark.parametrize("mode,kw", [
    ("supervised", {}),
    ("supervised", {"weight_decay": 5e-4}),
    ("kd", {}),
    ("kd", {"kd_reduction": "batchmean", "kd_T": 2.0, "alpha": 0.5}),
])
def test_trainer_tracks_jax(mode, kw):
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    tl = cli.oracle_teacher_logits(td.y, td.num_classes)
    cfg = dict(training=mode, hidden=32, num_layers=2, dropout=0.0, lr=0.01, **kw)
    jtr = JaxTrainer(
        JaxGCN(hidden=32, out_feats=5, num_layers=2, dropout=0.0), JaxConfig(**cfg),
        jd.graph, jd.x, jd.y, jd.split_idx,
        teacher_logits=jnp.asarray(tl) if mode == "kd" else None, seed=0,
    )
    model = GCN(16, 32, 5, 2, dropout=0.0, device="cpu")
    model.load_state_dict(_jax_state(jtr))
    ttr = NodeDistillTrainer(
        model, DistillConfig(**cfg), td.graph, td.x, td.y, td.split_idx,
        teacher_logits=tl if mode == "kd" else None, seed=0, device="cpu",
    )
    want = jtr.run_epochs(1, 5)
    got = ttr.run_epochs(1, 5)
    assert got.shape == want.shape == (5, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=0.05)
    assert got[-1, 0] < got[0, 0]
    final = _jax_state(jtr)
    for name, value in model.state_dict().items():
        if name not in ("convs.0.bias", "bns.0.running_mean"):
            np.testing.assert_allclose(value.numpy(), final[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["supervised", "kd"])
def test_train_epoch_and_evaluate_match_jax(mode):
    # the JAX trainer's step-by-step API: train_epoch(epoch) -> {"loss",
    # "loss_cls", "loss_aux"}; evaluate() -> (logits, (acc_train, acc_valid,
    # acc_test))
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    tl = cli.oracle_teacher_logits(td.y, td.num_classes)
    cfg = dict(training=mode, hidden=32, num_layers=2, dropout=0.0, lr=0.01)
    jtr = JaxTrainer(
        JaxGCN(hidden=32, out_feats=5, num_layers=2, dropout=0.0), JaxConfig(**cfg),
        jd.graph, jd.x, jd.y, jd.split_idx,
        teacher_logits=jnp.asarray(tl) if mode == "kd" else None, seed=0,
    )
    model = GCN(16, 32, 5, 2, dropout=0.0, device="cpu")
    model.load_state_dict(_jax_state(jtr))
    ttr = NodeDistillTrainer(
        model, DistillConfig(**cfg), td.graph, td.x, td.y, td.split_idx,
        teacher_logits=tl if mode == "kd" else None, seed=0, device="cpu",
    )
    for epoch in (1, 2, 3):
        want, got = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert set(got) == set(want) == {"loss", "loss_cls", "loss_aux"}
        assert all(isinstance(v, float) for v in got.values())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    jlogits, jaccs = jtr.evaluate()
    tlogits, taccs = ttr.evaluate()
    assert len(taccs) == 3 and all(isinstance(a, float) for a in taccs)
    # the evaluation reads the running mean behind the first conv's bias,
    # which Adam moves by each side's rounding noise (module docstring)
    assert tlogits.shape == tuple(np.asarray(jlogits).shape)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=0.1)
    np.testing.assert_allclose(taccs, jaccs, atol=0.05)


# max_samples exceeds the 270 train rows, so neither side subsamples (the two
# draw their rows from different generators: ROADMAP.md Queue 3)
AUX_MODES = [
    ("gcn", "fitnet", {}),
    ("gcn", "at", {}),
    ("gcn", "gpw", {"kernel": "rbf", "beta": 1.0}),
    ("gcn", "lpw", {"beta": 100.0}),
    ("gcn", "nce", {"beta": 0.5}),
    ("gcn", "gcd", {"beta": 0.5}),
    ("gcn", "nce-labels-edges", {"beta": 0.5}),
    ("gcn", "nce", {"beta": 0.5, "kd_and_aux": True}),
    ("gcn", "gcd", {"beta": 0.5, "kd_and_aux": True, "weight_decay": 5e-4}),
    ("sage", "supervised", {}),
    ("sage", "nce-edges", {"beta": 0.5}),
]


@pytest.mark.parametrize("gnn,mode,kw", AUX_MODES,
                         ids=[f"{g}-{m}" + ("-kd" if k.get("kd_and_aux") else "")
                              for g, m, k in AUX_MODES])
def test_trainer_tracks_jax_in_every_mode(gnn, mode, kw):
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    tl = cli.oracle_teacher_logits(td.y, td.num_classes)
    tf = cli.oracle_teacher_features(td.y, td.num_classes)
    cfg = dict(training=mode, hidden=32, num_layers=2, dropout=0.0, lr=0.01,
               proj_dim=16, max_samples=512, **kw)
    jcfg, tcfg = JaxConfig(**cfg), DistillConfig(**cfg)
    jlsp = tlsp = None
    if tcfg.needs_train_subgraph():
        jlsp = jax_induced_subgraph(jd.senders, jd.receivers, jd.split_idx["train"])
        tlsp = induced_subgraph(td.senders, td.receivers, td.split_idx["train"])
    jmodel_cls, tmodel_cls = (JaxGCN, GCN) if gnn == "gcn" else (JaxSAGE, SAGE)
    jtr = JaxTrainer(
        jmodel_cls(hidden=32, out_feats=5, num_layers=2, dropout=0.0), jcfg,
        jd.graph, jd.x, jd.y, jd.split_idx, teacher_feat=jnp.asarray(tf),
        teacher_logits=jnp.asarray(tl), lsp_graph=jlsp, seed=0,
    )
    model = tmodel_cls(16, 32, 5, 2, dropout=0.0, device="cpu")
    model.load_state_dict(_jax_state(jtr))
    ttr = NodeDistillTrainer(
        model, tcfg, td.graph, td.x, td.y, td.split_idx, teacher_feat=tf,
        teacher_logits=tl, lsp_graph=tlsp, seed=0, device="cpu",
    )
    heads = tcfg.needs_mlp_proj() or tcfg.needs_gcd_proj()
    assert (ttr.sproj is not None) == heads == ("sproj" in jtr.state.params)
    if heads:
        ttr.sproj.load_state_dict(_jax_state(jtr, "sproj"))
        ttr.tproj.load_state_dict(_jax_state(jtr, "tproj"))
    want = jtr.run_epochs(1, 3)
    got = ttr.run_epochs(1, 3)
    assert got.shape == want.shape == (3, 6) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=0.05)
    assert got[-1, 0] < got[0, 0]
    if heads:  # the heads train with the model under the one optimizer
        final = _jax_state(jtr, "sproj")
        for name, value in ttr.sproj.state_dict().items():
            if not name.endswith(("bias", "running_mean")):  # see the module docstring
                np.testing.assert_allclose(value.numpy(), final[name].numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reduction", ["numel", "batchmean"])
def test_criteria_match_jax(rng, reduction, masked):
    logits = rng.normal(size=(30, 7)).astype(np.float32) * 3
    teacher = rng.normal(size=(30, 7)).astype(np.float32) * 3
    teacher[0] = [-1e4, 1e4, 0, 0, 0, 0, 0]  # a one-hot teacher row: 0 * log 0
    labels = rng.integers(0, 7, size=30)
    mask = (rng.random(30) < 0.7) if masked else None
    want = jax_criteria.kd_criterion(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(teacher), 0.8, 3.0,
        mask=None if mask is None else jnp.asarray(mask), reduction=reduction)
    got = criteria.kd_criterion(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(teacher),
        0.8, 3.0, mask=None if mask is None else torch.from_numpy(mask),
        reduction=reduction)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


def test_unported_modes_name_the_roadmap(tmp_path):
    # every mode and flag of the JAX CLI is ported (the checkpoint flags and
    # the OGB loader: tests/test_torch_checkpoint.py, tests/test_torch_ogb.py);
    # a missing OGB cache raises a RuntimeError, an unknown dataset or mode a
    # ValueError
    with pytest.raises(RuntimeError, match="no ogbn-arxiv raw cache"):
        cli.main(["--device", "cpu", "--dataset", "ogbn-arxiv", "--data_root", str(tmp_path)])
    with pytest.raises(ValueError, match="synthetic or ogbn-arxiv"):
        cli.main(["--device", "cpu", "--dataset", "ogbn-products"])
    with pytest.raises(ValueError, match="unknown training mode"):
        DistillConfig(training="nce-nodes")


@pytest.mark.parametrize("training", ["supervised", "kd"])
def test_cli_runs_and_writes_json(tmp_path, training):
    out_dir = str(tmp_path)
    summary = cli.main([
        "--device", "cpu", "--epochs", "3", "--runs", "2", "--training", training,
        "--num_nodes", "400", "--num_edges", "2000", "--hidden_channels", "16",
        "--epoch_chunk", "2", "--out_dir", out_dir,
    ])
    with open(os.path.join(out_dir, f"debug-gcn-{training}.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(summary))
    assert written["args"]["device"] == "cpu"
    assert [r["run"] for r in written["runs"]] == [0, 1]
    assert 0.0 <= written["statistics"]["final_test_mean"] <= 1.0
    with open(os.path.join(out_dir, "debug", f"gcn-{training}", "seed1",
                           "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert set(records[0]) == {"step", "loss/train", "loss/cls", "loss/aux",
                               "acc/train", "acc/valid", "acc/test"}
    assert all(np.isfinite(r["loss/train"]) for r in records)


@pytest.mark.parametrize("gnn,training,extra", [
    ("sage", "supervised", []),
    ("sage", "kd", []),
    ("gcn", "fitnet", []),
    ("gcn", "at", ["--kd_and_aux"]),
    ("gcn", "gpw", ["--max_samples", "64", "--kernel", "poly"]),
    ("gcn", "lpw", []),
    ("gcn", "nce", ["--max_samples", "64", "--teacher_dump"]),
    ("sage", "gcd", ["--kd_and_aux"]),
    ("gcn", "nce-labels", []),
    ("gcn", "nce-edges", ["--max_samples", "64"]),
])
def test_cli_runs_every_mode(tmp_path, gnn, training, extra):
    out_dir = str(tmp_path)
    argv = ["--device", "cpu", "--epochs", "2", "--runs", "1", "--gnn", gnn,
            "--training", training, "--num_nodes", "300", "--num_edges", "1500",
            "--hidden_channels", "16", "--proj_dim", "8", "--out_dir", out_dir]
    extra = list(extra)
    if "--teacher_dump" in extra:  # the dump's features feed the aux term
        extra.remove("--teacher_dump")
        rng = np.random.default_rng(0)
        save_teacher_dump(out_dir, 0, rng.normal(size=(300, 24)),
                          rng.normal(size=(300, 40)))
        extra += ["--teacher_dir", out_dir]
    summary = cli.main(argv + extra)
    mode = ("kd+" if "--kd_and_aux" in extra else "") + training
    assert os.path.exists(os.path.join(out_dir, f"debug-{gnn}-{mode}.json"))
    with open(os.path.join(out_dir, "debug", f"{gnn}-{mode}", "seed0",
                           "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss/train"]) for r in records)
    if training not in ("supervised", "kd"):
        assert all(r["loss/aux"] > 0 for r in records)
    assert summary["args"]["gnn"] == gnn


def test_oracle_teacher_follows_the_jax_cli_stream():
    # efficient_gnns_tpu/cli/arxiv.py draws its oracle features inline from
    # default_rng(7): prototypes first, then the noise
    y = np.random.default_rng(1).integers(0, 5, size=50)
    rng = np.random.default_rng(7)
    protos = rng.normal(size=(5, 64)).astype(np.float32)
    want = protos[y] + 0.2 * rng.normal(size=(50, 64)).astype(np.float32)
    got = cli.oracle_teacher_features(y, 5)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_trainer_places_tensors_and_needs_teacher():
    ds = synthetic_node_dataset(num_nodes=200, num_edges=800, feat_dim=8,
                                num_classes=3, seed=0)
    tr = NodeDistillTrainer(GCN(8, 8, 3, 2, device="cpu"),
                            DistillConfig(hidden=8), ds.graph, ds.x, ds.y,
                            ds.split_idx, device="cpu")
    assert tr.graph.senders.device == tr.x.device == torch.device("cpu")
    with pytest.raises(ValueError, match="teacher"):
        NodeDistillTrainer(GCN(8, 8, 3, 2, device="cpu"),
                           DistillConfig(training="kd"), ds.graph, ds.x, ds.y,
                           ds.split_idx, device="cpu")
    tl = cli.oracle_teacher_logits(ds.y, 3)
    with pytest.raises(ValueError, match="teacher features"):
        NodeDistillTrainer(GCN(8, 8, 3, 2, device="cpu"),
                           DistillConfig(training="nce"), ds.graph, ds.x, ds.y,
                           ds.split_idx, teacher_logits=tl, device="cpu")
    with pytest.raises(ValueError, match="train subgraph"):
        NodeDistillTrainer(GCN(8, 8, 3, 2, device="cpu"),
                           DistillConfig(training="lpw"), ds.graph, ds.x, ds.y,
                           ds.split_idx, teacher_logits=tl,
                           teacher_feat=cli.oracle_teacher_features(ds.y, 3), device="cpu")
