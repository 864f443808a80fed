"""Port vs JAX: the GAT teacher slice (``DGLGATConv``, ``GATTeacher``, the
RMSprop update, ``GATTeacherTrainer``, teacher dumps and the teacher CLI).

Models are compared with transplanted flax parameters and dropout 0. The JAX
layers run their fused attention in interpret mode over an edge-blocked
graph, the port its kernels' plain versions. Forward values, BatchNorm
statistics and gradients agree to rtol 2e-4 / atol 2e-5 (forward) and
rtol 1e-3 / atol 1e-4 times the largest gradient (gradients): the bounds of
the attention itself (``tests/test_torch_attention.py``), through layers
whose matmuls and sums round in another order.

The trainers are compared over 3 epochs from the same start with every
dropout 0 and a mask split that draws nothing (``mask_rate`` 0 with label
reuse: no labels fed, the loss on every train node, label iterations still
re-injecting predictions). The JAX trainer runs its XLA attention there
(the same function); per-epoch losses agree to rtol 1e-4, because RMSprop
divides each gradient by its own running size and carries the rounding of
one step into the next.
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from efficient_gnns_tpu.data import synthetic_node_dataset as jax_synthetic
from efficient_gnns_tpu.distill import artifacts as jax_artifacts
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models import GCN as JaxGCN
from efficient_gnns_tpu.models.gnns import GATTeacher as JaxTeacher
from efficient_gnns_tpu.models.layers import DGLGATConv as JaxConv
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train import NodeDistillTrainer as JaxStudentTrainer
from efficient_gnns_tpu.train.gat_teacher import GATTeacherTrainer as JaxTrainer
from efficient_gnns_tpu.train.gat_teacher import TeacherConfig as JaxTeacherConfig
from efficient_gnns_tpu.train.gat_teacher import log_eps_loss as jax_log_eps_loss
from efficient_gnns_tpu_torch.cli import arxiv as student_cli
from efficient_gnns_tpu_torch.cli import gat_teacher as teacher_cli
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.distill import load_teacher_dump, save_teacher_dump
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import (
    GCN,
    DGLGATConv,
    GATTeacher,
    from_jax_params,
)
from efficient_gnns_tpu_torch.train import (
    DistillConfig,
    GATTeacherTrainer,
    NodeDistillTrainer,
    TeacherConfig,
)
from efficient_gnns_tpu_torch.train.gat_teacher import RMSpropWarmup, log_eps_loss

to_np = partial(jax.tree_util.tree_map, np.asarray)


@pytest.fixture
def pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False)


def _graphs(rng, n=66, n_pad=70, e=300):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    r[: e // 5] = 2  # a receiver of high degree
    kw = dict(bidirected=True, self_loops=True, pad_nodes_to=n_pad, edge_pad_multiple=64)
    jg = jax_build_graph(s, r, n, block=True, block_tm=32, block_eb=16, **kw)
    assert jg.blocking is not None and jg.hub is None
    return jg, build_graph(s, r, n, **kw)


def _close(got, want, rtol=2e-4, atol=2e-5, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


def _close_grads(got: dict, want: dict):
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        _close(got[name], w, rtol=1e-3, atol=1e-4 * scale, name=name)


@pytest.mark.parametrize("attn_dst,norm", [(True, True), (False, True), (True, False)])
def test_dgl_gat_conv_matches_flax(rng, pallas_interpret, attn_dst, norm):
    jg, tg = _graphs(rng)
    n, f, h, d = tg.num_nodes, 9, 3, 4
    x = rng.normal(size=(n, f)).astype(np.float32)
    cot = rng.normal(size=(n, h, d)).astype(np.float32)
    jconv = JaxConv(out_feats=d, num_heads=h, use_attn_dst=attn_dst, residual=True,
                    use_symmetric_norm=norm)
    params = jconv.init({"params": jax.random.PRNGKey(3)}, jg, jnp.asarray(x))["params"]

    def jloss(p, x_):
        out = jconv.apply({"params": p}, jg, x_, training=True)
        return jnp.sum(out * cot), out

    (_, jout), (jgrads, jdx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    conv = DGLGATConv(f, d, h, use_attn_dst=attn_dst, residual=True,
                      use_symmetric_norm=norm, generator=torch.Generator(), device="cpu")
    names = {"fc_weight": ("Dense_0", "kernel"), "res_weight": ("Dense_1", "kernel"),
             "attn_l": ("attn_l",), "attn_r": ("attn_r",)}

    def pick(tree, path):
        for key in path:
            tree = tree[key]
        return np.asarray(tree)

    conv.load_state_dict({k: torch.tensor(pick(params, names[k]))
                          for k in conv.state_dict()})
    conv.train()
    xt = torch.tensor(x, requires_grad=True)
    out = conv(tg, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout)
    _close(xt.grad, jdx, rtol=1e-3, atol=1e-4, name="dx")
    _close_grads({k: p.grad.numpy() for k, p in conv.named_parameters()},
                 {k: pick(jgrads, names[k]) for k in conv.state_dict()})


@pytest.mark.parametrize("attn_dst", [True, False])
def test_dgl_gat_conv_slope_and_activation_match_flax(rng, pallas_interpret, attn_dst):
    # the edge-softmax branch with another LeakyReLU slope and an output
    # activation (the JAX layer's negative_slope= and activation=)
    jg, tg = _graphs(rng)
    n, f, h, d = tg.num_nodes, 9, 3, 4
    x = rng.normal(size=(n, f)).astype(np.float32)
    cot = rng.normal(size=(n, h, d)).astype(np.float32)
    jconv = JaxConv(out_feats=d, num_heads=h, use_attn_dst=attn_dst, negative_slope=0.05,
                    activation=jax.nn.elu)
    params = jconv.init({"params": jax.random.PRNGKey(4)}, jg, jnp.asarray(x))["params"]

    def jloss(p, x_):
        out = jconv.apply({"params": p}, jg, x_, training=True)
        return jnp.sum(out * cot), out

    (_, jout), (jgrads, jdx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    conv = DGLGATConv(f, d, h, use_attn_dst=attn_dst, negative_slope=0.05,
                      activation=torch.nn.functional.elu, generator=torch.Generator(),
                      device="cpu")
    assert conv.negative_slope == 0.05 and conv.activation is torch.nn.functional.elu
    names = {"fc_weight": ("Dense_0",), "attn_l": (), "attn_r": ()}
    conv.load_state_dict({k: torch.tensor(np.asarray(
        params[names[k][0]]["kernel"] if names[k] else params[k])) for k in conv.state_dict()})
    conv.train()
    xt = torch.tensor(x, requires_grad=True)
    out = conv(tg, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout)
    assert -1 < float(out.detach().min()) < 0  # elu's floor, not relu's
    _close(xt.grad, jdx, rtol=1e-3, atol=1e-4, name="dx")
    _close_grads({k: p.grad.numpy() for k, p in conv.named_parameters()},
                 {k: np.asarray(jgrads[names[k][0]]["kernel"] if names[k] else jgrads[k])
                  for k in conv.state_dict()})


def _teachers(rng, jg, f, attn_dst=True):
    jt = JaxTeacher(hidden=4, out_feats=5, num_layers=3, num_heads=3, dropout=0.0,
                    use_attn_dst=attn_dst, use_symmetric_norm=True)
    x = rng.normal(size=(jg.num_nodes, f)).astype(np.float32)
    variables = jt.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(1)},
                        jg, jnp.asarray(x))
    tt = GATTeacher(f, 4, 5, 3, 3, dropout=0.0, use_attn_dst=attn_dst,
                    use_symmetric_norm=True, device="cpu")
    tt.load_state_dict(from_jax_params(to_np(variables["params"]),
                                       to_np(variables["batch_stats"])))
    return jt, variables, tt, x


@pytest.mark.parametrize("attn_dst", [True, False])
def test_gat_teacher_train_mode_matches_flax(rng, pallas_interpret, attn_dst):
    jg, tg = _graphs(rng)
    jt, variables, tt, x = _teachers(rng, jg, 7, attn_dst)
    c_logits = rng.normal(size=(tg.num_nodes, 5)).astype(np.float32)
    c_feat = rng.normal(size=(tg.num_nodes, 12)).astype(np.float32)

    def jloss(params):
        (logits, feat), mut = jt.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jg,
            jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jnp.sum(logits * c_logits) + jnp.sum(feat * c_feat), (logits, feat, mut)

    (_, (jl, jf, mut)), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tt.train()
    tl, tf = tt(tg, torch.from_numpy(x))
    ((tl * torch.from_numpy(c_logits)).sum() + (tf * torch.from_numpy(c_feat)).sum()).backward()
    _close(tl.detach(), jl)
    _close(tf.detach(), jf)
    buffers = dict(tt.named_buffers())
    for name, want in from_jax_params({}, to_np(mut["batch_stats"])).items():
        _close(buffers[name], want, name=name)
    _close_grads({k: p.grad.numpy() for k, p in tt.named_parameters()},
                 {k: v.numpy() for k, v in from_jax_params(to_np(jgrads), {}).items()})


def test_gat_teacher_eval_mode_matches_flax(rng, pallas_interpret):
    jg, tg = _graphs(rng)
    jt, variables, tt, x = _teachers(rng, jg, 7)
    # running statistics away from their (0, 1) init, as after training
    bs = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
        variables["batch_stats"])
    jl, jf = jt.apply({"params": variables["params"], "batch_stats": bs}, jg,
                      jnp.asarray(x), training=False)
    tt.load_state_dict(from_jax_params(to_np(variables["params"]), to_np(bs)))
    tt.eval()
    with torch.no_grad():
        tl, tf = tt(tg, torch.from_numpy(x))
    _close(tl, jl)
    _close(tf, jf)


def test_teacher_param_count_matches_reference_config():
    # the 3L x 250 x 3h teacher at arxiv dims, without attn_r (--no-attn-dst):
    # the reference's published 1,441,580 (arxiv_dgl/gat.py:382,389)
    model = GATTeacher(128 + 40, 250, 40, use_attn_dst=False, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 1_441_580


@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_rmsprop_warmup_matches_optax(rng, wd):
    shapes = [(4, 3), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.chain(
        optax.scale_by_rms(decay=0.99, eps=1e-8),
        optax.add_decayed_weights(wd) if wd else optax.identity(),
        optax.scale_by_schedule(lambda s: -0.01 * jnp.minimum((s + 1.0) / 50.0, 1.0)),
    )
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = RMSpropWarmup(tp, 0.01, weight_decay=wd)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_log_eps_loss_matches_jax(rng):
    logits = rng.normal(size=(20, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, size=20)
    mask = rng.random(20) < 0.6
    want = jax_log_eps_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    got = log_eps_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


DATA = dict(num_nodes=300, num_edges=1200, feat_dim=10, num_classes=4, seed=2,
            signal=0.6, gcn_norm=False)


@pytest.mark.parametrize("kw", [
    dict(use_labels=True, n_label_iters=1, mask_rate=0.0, no_attn_dst=False),
    dict(use_labels=False, n_label_iters=0, mask_rate=1.0, no_attn_dst=True),
])
def test_teacher_trainer_tracks_jax(kw):
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    cfg = dict(n_hidden=6, n_layers=3, n_heads=2, dropout=0.0, input_drop=0.0,
               attn_drop=0.0, edge_drop=0.0, use_norm=True, lr=0.05, **kw)
    jtr = JaxTrainer(JaxTeacherConfig(**cfg), jd.graph, jd.x, jd.y, jd.split_idx, 4)
    ttr = GATTeacherTrainer(TeacherConfig(**cfg), td.graph, td.x, td.y, td.split_idx, 4,
                            device="cpu")
    ttr.model.load_state_dict(from_jax_params(to_np(jtr.state.params),
                                              to_np(jtr.state.batch_stats)))
    jbest, want = jtr.run_epochs(1, 3)
    tbest, got = ttr.run_epochs(1, 3)
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 8) and np.isfinite(got).all()
    losses = [0, 5, 6, 7]
    np.testing.assert_allclose(got[:, losses], want[:, losses], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], atol=0.02)
    assert got[-1, 0] != got[0, 0]
    _close(tbest["logits"], jbest["logits"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(tbest["val_loss"]), float(jbest["val_loss"]), rtol=1e-4)


@pytest.mark.parametrize("no_attn_dst", [False, True])
def test_teacher_train_epoch_and_evaluate_match_jax(no_attn_dst):
    # the JAX trainer's step-by-step API: train_epoch(epoch) -> {"loss",
    # "train_acc"}; evaluate() -> (logits, feats, accs, losses)
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    cfg = dict(n_hidden=6, n_layers=3, n_heads=2, dropout=0.0, input_drop=0.0,
               attn_drop=0.0, edge_drop=0.0, use_norm=True, lr=0.05, use_labels=True,
               n_label_iters=1, mask_rate=0.0, no_attn_dst=no_attn_dst)
    jtr = JaxTrainer(JaxTeacherConfig(**cfg), jd.graph, jd.x, jd.y, jd.split_idx, 4)
    ttr = GATTeacherTrainer(TeacherConfig(**cfg), td.graph, td.x, td.y, td.split_idx, 4,
                            device="cpu")
    ttr.model.load_state_dict(from_jax_params(to_np(jtr.state.params),
                                              to_np(jtr.state.batch_stats)))
    for epoch in (1, 2):
        want, got = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert set(got) == set(want) == {"loss", "train_acc"}
        assert all(isinstance(v, float) for v in got.values())
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["train_acc"], want["train_acc"], atol=0.02)
    jl, jf, jaccs, jlosses = jtr.evaluate()
    tl, tf, taccs, tlosses = ttr.evaluate()
    assert tl.shape == jl.shape and tf.shape == jf.shape
    assert len(taccs) == len(tlosses) == 3 and all(isinstance(v, float) for v in taccs + tlosses)
    _close(tl, jl, rtol=1e-3, atol=1e-3)
    _close(tf, jf, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(taccs, jaccs, atol=0.02)


def test_dump_outputs_label_modes():
    td = synthetic_node_dataset(**DATA)
    cfg = TeacherConfig(n_hidden=6, n_layers=2, n_heads=2, dropout=0.2, input_drop=0.0,
                        edge_drop=0.1, use_labels=True, n_label_iters=1, no_attn_dst=False)
    tr = GATTeacherTrainer(cfg, td.graph, td.x, td.y, td.split_idx, 4, device="cpu")
    best, hist = tr.run_epochs(1, 4)
    best, _ = tr.run_epochs(5, 2, best)
    assert int(np.argmin(hist[:, 6])) >= 0
    lt, ft = tr.dump_outputs(best, "train")
    torch.testing.assert_close(lt, best["logits"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ft, best["feats"], atol=1e-5, rtol=1e-5)
    ls, fs = tr.dump_outputs(best, "self")
    assert ls.shape == lt.shape and fs.shape == ft.shape == (td.graph.num_nodes, 12)
    assert float((ls - lt).abs().max()) > 1e-5
    # the dump forward leaves the trained weights in place
    state = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.dump_outputs(best, "self")
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_dumps_read_by_both_packages(tmp_path, rng):
    feats = rng.normal(size=(30, 12)).astype(np.float32)
    logits = rng.normal(size=(30, 4)).astype(np.float32)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_teacher_dump(port_dir, 3, feats, logits, logits * 0.5)
    jax_artifacts.save_teacher_dump(jax_dir, 3, feats, logits)
    for f, l in (jax_artifacts.load_teacher_dump(port_dir, 3), load_teacher_dump(jax_dir, 3)):
        np.testing.assert_array_equal(f, feats)
        np.testing.assert_array_equal(l, logits)
    with np.load(os.path.join(port_dir, "teacher_seed3.npz")) as z:
        assert sorted(z.files) == ["features", "logits", "output"]


def test_student_kd_on_jax_teacher_dump_tracks_jax(tmp_path):
    data = dict(DATA, gcn_norm=True)
    jd, td = jax_synthetic(**data), synthetic_node_dataset(**data)
    jteacher = JaxTrainer(JaxTeacherConfig(n_hidden=6, n_layers=2, n_heads=2, no_attn_dst=False),
                          jd.graph, jd.x, jd.y, jd.split_idx, 4)
    best, _ = jteacher.run_epochs(1, 2)
    jax_artifacts.save_teacher_dump(str(tmp_path), 0, np.asarray(best["feats"]),
                                    np.asarray(best["logits"]))
    _, logits = load_teacher_dump(str(tmp_path), 0)
    cfg = dict(training="kd", hidden=16, num_layers=2, dropout=0.0, lr=0.01)
    jtr = JaxStudentTrainer(JaxGCN(hidden=16, out_feats=4, num_layers=2, dropout=0.0),
                            JaxConfig(**cfg), jd.graph, jd.x, jd.y, jd.split_idx,
                            teacher_logits=jnp.asarray(logits), seed=0)
    model = GCN(10, 16, 4, 2, dropout=0.0, device="cpu")
    model.load_state_dict(from_jax_params(to_np(jtr.state.params["model"]),
                                          to_np(jtr.state.batch_stats["model"])))
    ttr = NodeDistillTrainer(model, DistillConfig(**cfg), td.graph, td.x, td.y,
                             td.split_idx, teacher_logits=logits, device="cpu")
    want, got = jtr.run_epochs(1, 4), ttr.run_epochs(1, 4)
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-4, atol=1e-7)


def test_teacher_cli_dump_feeds_student_cli(tmp_path):
    out = str(tmp_path)
    summary = teacher_cli.main([
        "--device", "cpu", "--num-nodes", "300", "--num-edges", "1200", "--n-hidden", "5",
        "--n-runs", "2", "--n-epochs", "3", "--epoch-chunk", "2", "--use-labels",
        "--n-label-iters", "1", "--use-norm", "--edge-drop", "0.3", "--input-drop", "0.25",
        "--attn-drop", "0.1", "--save-pred", "--dump-labels", "self", "--out-dir", out,
        "--expt-name", "t",
    ])
    with open(os.path.join(out, "gat_teacher_t.json")) as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert [len(r["losses"]) for r in summary["runs"]] == [3, 3]
    assert all(np.isfinite(r["losses"]).all() for r in summary["runs"])
    dump_dir = os.path.join(out, "teacher_dumps", "t")
    feats, logits = jax_artifacts.load_teacher_dump(dump_dir, 1)  # the JAX reader
    assert feats.shape == (300, 15) and logits.shape == (300, 40)
    student = student_cli.main([
        "--device", "cpu", "--num_nodes", "300", "--num_edges", "1200", "--training", "kd",
        "--teacher_dir", dump_dir, "--runs", "2", "--epochs", "3", "--hidden_channels", "8",
        "--out_dir", out,
    ])
    assert len(student["runs"]) == 2
    with pytest.raises(FileNotFoundError):
        student_cli.main(["--device", "cpu", "--num_nodes", "300", "--num_edges", "1200",
                          "--training", "kd", "--teacher_dir", dump_dir, "--seed", "5",
                          "--runs", "1", "--epochs", "1", "--out_dir", out])


def test_teacher_cli_refuses_unported_choices():
    # ogbn-arxiv is ported (tests/test_torch_ogb.py); other datasets are not
    with pytest.raises(ValueError, match="synthetic or ogbn-arxiv"):
        teacher_cli.main(["--device", "cpu", "--dataset", "ogbn-products"])
    with pytest.raises(ValueError, match="use-labels"):
        teacher_cli.main(["--device", "cpu", "--n-label-iters", "1"])
    with pytest.raises(ValueError, match="need use_labels"):
        TeacherConfig(use_labels=False, n_label_iters=1)
