"""Port vs JAX: the student trainer as a whole, and the port's CLI.

Both trainers start from the same (transplanted) GCN parameters with dropout
0 and run 5 epochs on the same synthetic dataset. The per-epoch losses must
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
from efficient_gnns_tpu.models import GCN as JaxGCN
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train import NodeDistillTrainer as JaxTrainer
from efficient_gnns_tpu_torch.cli import arxiv as cli
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.models import GCN, from_jax_params
from efficient_gnns_tpu_torch.train import DistillConfig, NodeDistillTrainer

DATA = dict(num_nodes=500, num_edges=2500, feat_dim=16, num_classes=5, seed=1,
            signal=0.5)


def _jax_state(trainer):
    to_np = partial(jax.tree_util.tree_map, np.asarray)
    return from_jax_params(to_np(trainer.state.params["model"]),
                           to_np(trainer.state.batch_stats["model"]))


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


def test_unported_modes_name_the_roadmap():
    for mode in ("fitnet", "at", "gpw", "lpw", "nce", "gcd"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DistillConfig(training=mode)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DistillConfig(training="kd", kd_and_aux=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--device", "cpu", "--gnn", "sage"])


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
