"""Port vs JAX: the SIGN student (hop precompute, minibatches, model,
trainer, CLI).

The hop features run the JAX side's Pallas K1 in interpret mode, as
``tests/test_torch_spmm.py`` does, against the port's K1 plain version:
rtol 1e-5 / atol 1e-6 (summation order). The model runs on transplanted
parameters: rtol 1e-5. The trainers start from the same transplanted
parameters of the model and heads, with dropout 0 and ``max_samples`` at or
above the batch rows (so neither side's row sampling, whose draws differ,
selects a subset), on the same hop features; their per-epoch losses must
agree to rtol 1e-4 over 3 epochs whose last batch is padded.
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
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models.gnns import SIGN as JaxSIGN
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.sampling import NodeBatcher as JaxBatcher
from efficient_gnns_tpu.sampling import neighbor_average_features as jax_hops
from efficient_gnns_tpu.train.config import DistillConfig as JaxConfig
from efficient_gnns_tpu.train.sign_trainer import SIGNTrainer as JaxSIGNTrainer
from efficient_gnns_tpu_torch.cli import sign as cli
from efficient_gnns_tpu_torch.cli.arxiv import oracle_teacher_logits
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import SIGN, from_jax_params
from efficient_gnns_tpu_torch.sampling import NodeBatcher, neighbor_average_features
from efficient_gnns_tpu_torch.train import DistillConfig, SIGNTrainer

DATA = dict(num_nodes=300, num_edges=1200, feat_dim=12, num_classes=4, seed=1,
            signal=0.5)
_to_np = partial(jax.tree_util.tree_map, np.asarray)


@pytest.fixture
def pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n,batch", [(10, 4), (12, 4), (7, 10), (162, 64)])
def test_node_batcher_matches_jax(n, batch, shuffle):
    ids = np.random.default_rng(n).permutation(1000)[:n].astype(np.int32)
    ours, theirs = NodeBatcher(ids, batch, shuffle), JaxBatcher(ids, batch, shuffle)
    assert len(ours) == len(theirs) == -(-n // batch)
    for seed in (0, 3):
        got, want = list(ours.epoch(seed)), list(theirs.epoch(seed))
        assert len(got) == len(want)
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.dtype == np.int32 and gi.shape == (batch,) and gm.dtype == bool
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
        last_ids, last_mask = got[-1]
        assert (last_ids[~last_mask] == got[0][0][0]).all()  # padding repeats ids[0]


@pytest.mark.parametrize("gcn_norm", [True, False])
def test_hop_features_match_jax(pallas_interpret, gcn_norm):
    jd = jax_synthetic(**DATA, gcn_norm=gcn_norm)
    td = synthetic_node_dataset(**DATA, gcn_norm=gcn_norm)
    want = jax_hops(jd.graph, jnp.asarray(jd.x), 3)
    got = neighbor_average_features(td.graph, torch.from_numpy(td.x), 3)
    assert len(got) == len(want) == 4
    assert not got[-1].requires_grad
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_cli_hop_features_are_not_the_neighbour_mean(pallas_interpret):
    # the JAX SIGN CLI builds its dataset with gcn_norm=True, and spmm_mean
    # then divides the GCN-normalised sum by the in-degree: not the
    # reference's copy_u + mean. The port reproduces the JAX CLI.
    data = dict(num_nodes=300, num_edges=1200, seed=1)
    jd, td = jax_synthetic(**data), synthetic_node_dataset(**data)
    jax_cli = np.asarray(jax_hops(jd.graph, jnp.asarray(jd.x), 1)[1])
    port_cli = neighbor_average_features(td.graph, torch.from_numpy(td.x), 1)[1].numpy()
    np.testing.assert_allclose(port_cli, jax_cli, rtol=1e-5, atol=1e-6)
    # the neighbour mean over the same bidirected, self-looped edge set
    plain = jax_build_graph(jd.senders, jd.receivers, jd.num_nodes, bidirected=True,
                            self_loops=True)
    e = int(plain.n_edge)
    s, r = np.asarray(plain.senders)[:e], np.asarray(plain.receivers)[:e]
    total = np.zeros_like(jd.x, dtype=np.float64)
    np.add.at(total, r, jd.x[s])
    mean = total / np.maximum(np.bincount(r, minlength=jd.num_nodes), 1)[:, None]
    gap = np.abs(jax_cli - mean).max()
    assert 2.0 < gap < 3.5, gap  # 2.68 on entries up to 4.84 (ROADMAP.md Queue 3)
    assert np.abs(mean).max() < 6.0


@pytest.mark.parametrize("ff_layers", [1, 2, 3])
def test_sign_forward_matches_jax(rng, ff_layers):
    hops, n, f = 3, 40, 12
    feats = [rng.normal(size=(n, f)).astype(np.float32) for _ in range(hops)]
    jmodel = JaxSIGN(hidden=16, out_feats=5, num_hops=hops, ff_layers=ff_layers)
    params = jmodel.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in feats])["params"]
    want_logits, want_feat = jmodel.apply({"params": params}, [jnp.asarray(x) for x in feats])
    model = SIGN(f, 16, 5, hops, ff_layers, seed=3, device="cpu")
    state = from_jax_params(_to_np(params), {})
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    model.eval()
    logits, feat = model([torch.from_numpy(x) for x in feats])
    assert (model.inceptions[0].prelu_alpha is None) == (ff_layers == 1)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(want_feat),
                               rtol=1e-5, atol=1e-6)


def test_sign_init_follows_the_jax_rules():
    model = SIGN(128, 512, 40, 6, 2, seed=0, device="cpu")
    w = model.inceptions[0].weights[0].detach()
    limit = np.sqrt(12.0 / (128 + 512))  # variance_scaling(2.0, "fan_avg", "uniform")
    assert w.shape == (128, 512) and float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit
    assert float(model.prelu_alpha) == 0.25 and all(
        float(ff.prelu_alpha) == 0.25 for ff in model.inceptions)
    assert all(float(b.abs().sum()) == 0 for b in model.project.biases)
    assert model.project.weights[0].shape == (6 * 512, 512)


def _datasets():
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    feats = [np.asarray(f) for f in jax_hops(jd.graph, jnp.asarray(jd.x), 2)]
    rng = np.random.default_rng(2)
    t_feat = (np.eye(4, 16, dtype=np.float32)[td.y]
              + 0.1 * rng.normal(size=(len(td.y), 16)).astype(np.float32))
    return jd, td, feats, t_feat, oracle_teacher_logits(td.y, td.num_classes)


@pytest.mark.parametrize("mode,kd_and_aux,kw", [
    ("supervised", False, {}),
    ("supervised", False, {"weight_decay": 5e-3}),
    ("kd", False, {}),
    ("fitnet", False, {}),
    ("fitnet", True, {}),
    ("at", False, {}),
    ("at", True, {}),
    ("gpw", False, {}),
    ("gpw", True, {}),
    ("nce", False, {}),
    ("nce", True, {"weight_decay": 5e-3}),
])
def test_sign_trainer_tracks_jax(mode, kd_and_aux, kw):
    jd, td, feats, t_feat, t_logits = _datasets()
    assert len(td.split_idx["train"]) == 162  # batches of 64, 64 and 34 + 30 padding
    cfg = dict(training=mode, kd_and_aux=kd_and_aux, hidden=16, dropout=0.0, lr=0.01,
               beta=1.0, max_samples=64, proj_dim=8, **kw)
    common = dict(batch_size=64, eval_batch_size=128, teacher_feat=t_feat,
                  teacher_logits=t_logits, seed=0)
    jtr = JaxSIGNTrainer(JaxConfig(**cfg), [jnp.asarray(f) for f in feats], jd.y,
                         jd.split_idx, 4, **{**common, "teacher_feat": jnp.asarray(t_feat),
                                             "teacher_logits": jnp.asarray(t_logits)})
    ttr = SIGNTrainer(DistillConfig(**cfg), feats, td.y, td.split_idx, 4, device="cpu",
                      **common)
    params, stats = _to_np(jtr.state.params), _to_np(jtr.state.batch_stats)
    ttr.model.load_state_dict(from_jax_params(params["model"], {}))
    if ttr.sproj is not None:
        ttr.sproj.load_state_dict(from_jax_params(params["sproj"], stats["sproj"]))
        ttr.tproj.load_state_dict(from_jax_params(params["tproj"], stats["tproj"]))
    for epoch in (1, 2, 3):
        want, got = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert set(got) == set(want) == {"loss", "loss_cls", "loss_aux"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"epoch {epoch} {k}")
    want_accs, got_accs = jtr.evaluate(), ttr.evaluate()
    assert len(got_accs) == 3 and all(isinstance(a, float) for a in got_accs)
    np.testing.assert_allclose(got_accs, want_accs, atol=0.02)


@pytest.mark.parametrize("mode", ["lpw", "gcd", "nce-labels"])
def test_graph_modes_raise(mode):
    _, td, feats, t_feat, t_logits = _datasets()
    with pytest.raises(NotImplementedError, match="graph-agnostic"):
        SIGNTrainer(DistillConfig(training=mode), feats, td.y, td.split_idx, 4,
                    teacher_feat=t_feat, teacher_logits=t_logits, device="cpu")


def test_trainer_needs_its_teacher():
    _, td, feats, t_feat, t_logits = _datasets()
    with pytest.raises(ValueError, match="teacher logits"):
        SIGNTrainer(DistillConfig(training="kd"), feats, td.y, td.split_idx, 4, device="cpu")
    with pytest.raises(ValueError, match="teacher features"):
        SIGNTrainer(DistillConfig(training="at"), feats, td.y, td.split_idx, 4,
                    teacher_logits=t_logits, device="cpu")


def test_optimizer_is_coupled_l2_adam():
    _, td, feats, _, _ = _datasets()
    tr = SIGNTrainer(DistillConfig(weight_decay=1e-3), feats, td.y, td.split_idx, 4,
                     device="cpu")
    assert type(tr.opt) is torch.optim.Adam
    assert tr.opt.param_groups[0]["weight_decay"] == 1e-3


def test_oracle_prototypes_follow_the_jax_cli_stream():
    y = np.array([0, 3, 1, 3])
    protos = np.random.default_rng(7).normal(size=(5, 64)).astype(np.float32)
    np.testing.assert_array_equal(cli.oracle_teacher_prototypes(y, 5), protos[y])


@pytest.mark.parametrize("training,extra", [
    ("supervised", []),
    ("kd", []),
    ("nce", ["--kd_and_aux", "--max_samples", "64"]),
])
def test_cli_runs_on_cpu(tmp_path, training, extra):
    summary = cli.main([
        "--device", "cpu", "--num_nodes", "300", "--num_edges", "1200", "--R", "2",
        "--num_hidden", "16", "--num_epochs", "3", "--num_runs", "1", "--eval_every", "2",
        "--batch_size", "64", "--eval_batch_size", "128", "--training", training,
        "--proj_dim", "8", "--out_dir", str(tmp_path), "--expt_name", "t", *extra])
    with open(os.path.join(tmp_path, f"sign-t-{training}.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(summary))
    run = summary["runs"][0]
    assert run["seconds"] > 0 and len(run["losses"]) == 3
    assert all(np.isfinite(run["losses"]))
    assert summary["precompute_seconds"] > 0
    assert summary["statistics"]["final_test_mean"] >= 0


def test_cli_refuses_platform_and_unknown_datasets():
    with pytest.raises(ValueError, match="--device"):
        cli.main(["--platform", "cpu"])
    with pytest.raises(ValueError, match="ogbn-arxiv"):
        cli.main(["--dataset", "ogbn-products"])


def test_hop_features_on_a_graph_without_weights(rng):
    # K1's plain version behind spmm_mean: the true neighbour mean
    n, e = 30, 120
    s, r = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
    g = build_graph(s, r, n, edge_pad_multiple=16)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    feats = neighbor_average_features(g, torch.from_numpy(x), 2)
    a = np.zeros((n, n))
    np.add.at(a, (r, s), 1.0)  # a multi-edge counts as often as it is drawn
    deg = np.maximum(a.sum(1, keepdims=True), 1.0)
    cur = x.astype(np.float64)
    for hop in (1, 2):
        cur = a @ cur / deg
        np.testing.assert_allclose(feats[hop].numpy(), cur, rtol=1e-5, atol=1e-6)
