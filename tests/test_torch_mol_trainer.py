"""Port vs JAX: the molhiv trainer (``train/mol_trainer.py``) in every mode,
the molhiv CLI, and a JAX checkpoint read by the port.

Both trainers start from the same (transplanted) student, teacher (a 2 x 24
GIN-E with the virtual node) and, in ``nce`` / ``fitnet`` / ``gpw``,
projection heads, on the same synthetic molecules (``tests/test_mol.py``'s
sizes), and take the same steps in the same batch order; dropout is 0.
``max_samples`` is at the batch size, so the sampled terms see every row of
a batch on both sides (each draws another order of them, which these terms
do not depend on). Per-epoch losses agree to rtol 1e-4 over 3 epochs (2 for
PNA, whose float32 gradient is ill-conditioned in the JAX form:
``models/mol.py``, ``PNAConv``): the step-1 losses agree to float32
rounding and Adam carries each gradient's rounding into the next step.
ROC-AUC agrees to 0.05 (a score near another may swap ranks).
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data import molhiv as jax_mol
from efficient_gnns_tpu.models.mol import MolGNN as JaxMolGNN
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train.checkpoint import save_pytree
from efficient_gnns_tpu.train.mol_trainer import MolTrainer as JaxMolTrainer
from efficient_gnns_tpu_torch.cli import mol as cli
from efficient_gnns_tpu_torch.data import molhiv as mol
from efficient_gnns_tpu_torch.models import MolGNN, from_jax_params, mol_from_jax_params
from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer
from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

to_np = partial(jax.tree_util.tree_map, np.asarray)
DATA = dict(n_train=48, n_valid=16, n_test=16, seed=2)
MODES = [("supervised", False, "gcn"), ("kd", False, "gin"), ("fitnet", False, "gcn"),
         ("at", False, "gin"), ("gpw", False, "gcn"), ("nce", False, "gcn"),
         ("gpw", True, "gin"), ("nce", True, "gcn"), ("supervised", False, "pna")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small, and
    parallel test workers that each start a thread a core run many times
    slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _trainers(mode, kd_aux, conv, dropout=0.0):
    jds, tds = jax_mol.synthetic_molhiv_dataset(**DATA), mol.synthetic_molhiv_dataset(**DATA)
    cfg = dict(training=mode, kd_and_aux=kd_aux, lr=0.003, alpha=0.5, kd_T=1.0, beta=0.5,
               max_samples=16, proj_dim=8)
    vn = conv == "gine"
    kw = dict(virtual_node=vn, pna_towers=4, pna_delta=tds.mean_log_degree)
    jtr = JaxMolTrainer(
        JaxConfig(**cfg), jds, JaxMolGNN(conv=conv, hidden=16, num_tasks=1, num_layers=2,
                                         dropout=dropout, **kw),
        teacher=JaxMolGNN(conv="gine", hidden=24, num_tasks=1, num_layers=2, virtual_node=True),
        batch_size=16, max_atoms=24, seed=0)
    student = MolGNN(conv, 16, 1, 2, dropout=dropout, device="cpu", **kw)
    student.load_state_dict(mol_from_jax_params(to_np(jtr.state.params["model"]),
                                                to_np(jtr.state.batch_stats["model"])))
    teacher = None
    if jtr.teacher_vars is not None:
        teacher = MolGNN("gine", 24, 1, 2, virtual_node=True, device="cpu")
        teacher.load_state_dict(mol_from_jax_params(to_np(jtr.teacher_vars["params"]),
                                                    to_np(jtr.teacher_vars["batch_stats"])))
    ttr = MolTrainer(DistillConfig(**cfg), tds, student, teacher=teacher, batch_size=16,
                     max_atoms=24, seed=0, device="cpu")
    assert (ttr.sproj is not None) == ("sproj" in jtr.state.params)
    if ttr.sproj is not None:
        for part in ("sproj", "tproj"):
            getattr(ttr, part).load_state_dict(
                from_jax_params(to_np(jtr.state.params[part]),
                                to_np(jtr.state.batch_stats[part])))
    return jtr, ttr


@pytest.mark.parametrize("mode,kd_aux,conv", MODES)
def test_mol_trainer_tracks_jax(mode, kd_aux, conv):
    jtr, ttr = _trainers(mode, kd_aux, conv)
    losses = []
    for epoch in (1, 2) if conv == "pna" else (1, 2, 3):
        want, got = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert set(got) == set(want) == {"loss", "loss_cls", "loss_aux"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"epoch {epoch} {k}")
        losses.append(got["loss"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    aucs = ttr.evaluate_all()
    np.testing.assert_allclose(aucs, jtr.evaluate_all(), atol=0.05)
    # the evaluation batches are packed once and kept: the same AUCs again,
    # and the same as from freshly packed batches
    assert ttr.evaluate_all() == aucs
    ttr.model.eval()
    with torch.no_grad():
        fresh = [(ttr.model(mb.batch, mb.atoms, mb.bonds)[0][:mb.batch.n_graph, 0], mb)
                 for mb in mol.MolBatcher(ttr.ds.valid, 16, 24, shuffle=False).epoch(3)]
    scores = torch.cat([s for s, _ in fresh]).numpy()
    labels = np.concatenate([mb.labels[:mb.batch.n_graph].numpy() for _, mb in fresh])
    assert mol.roc_auc(scores, labels) == aucs[1]


def test_trainer_refuses_a_missing_teacher_and_other_modes():
    ds = mol.synthetic_molhiv_dataset(**DATA)
    model = MolGNN("gcn", 16, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="needs a teacher"):
        MolTrainer(DistillConfig(training="kd"), ds, model, device="cpu")
    with pytest.raises(ValueError, match="mol training mode"):
        MolTrainer(DistillConfig(training="lpw"), ds, model, device="cpu")


def test_trainer_dropout_steps_are_reproducible():
    ds = mol.synthetic_molhiv_dataset(**DATA)
    runs = []
    for _ in range(2):
        tr = MolTrainer(DistillConfig(lr=0.003), ds,
                        MolGNN("gine", 16, 1, 2, dropout=0.5, virtual_node=True, device="cpu"),
                        batch_size=16, max_atoms=24, seed=1, device="cpu")
        runs.append([tr.train_epoch(e)["loss"] for e in (1, 2)])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()


def _run(tmp_path, *argv):
    return cli.main(["--device", "cpu", "--epochs", "2", "--runs", "1", "--n_train", "64",
                     "--n_valid", "32", "--n_test", "32", "--out_dir", str(tmp_path), *argv])


def test_cli_trains_a_teacher_and_students_from_its_checkpoint(tmp_path):
    teacher_args = ("--gnn", "gine", "--hidden_channels", "24", "--num_layers", "2",
                    "--expt_name", "t")
    summary = _run(tmp_path, *teacher_args)
    path = cli.checkpoint_path(str(tmp_path), "t", "gine", 0)
    assert os.path.exists(path)
    with open(tmp_path / "mol-t-gine-supervised.json") as f:
        written = json.load(f)
    assert written["statistics"] == summary["statistics"]
    assert len(summary["losses"]["run0"]) == len(summary["aucs"]["run0"]) == 2
    assert set(summary["seconds"]["run0"][0]) == {"epoch"}

    student_args = ("--teacher_path", str(tmp_path / "mol_ckpt" / "t" / "gine"),
                    "--teacher_hidden", "24", "--teacher_layers", "2")
    kd = _run(tmp_path, "--training", "kd", *student_args)
    nce = _run(tmp_path, "--training", "nce", "--kd_and_aux", *student_args)
    assert os.path.exists(tmp_path / "mol-debug-gcn-kd-from-gine.json")
    assert os.path.exists(tmp_path / "mol-debug-gcn-kd+nce-from-gine.json")
    assert np.isfinite(nce["losses"]["run0"]).all()
    # the student's first epoch is the one a trainer built by hand from the
    # checkpoint takes (the CLI's teacher seed gives other random weights)
    ds = mol.synthetic_molhiv_dataset(n_train=64, n_valid=32, n_test=32, seed=42)
    teacher = MolGNN("gine", 24, 1, 2, virtual_node=True, device="cpu")
    teacher.load_state_dict(load_checkpoint(path))
    tr = MolTrainer(DistillConfig(training="kd", hidden=64, num_layers=2, lr=0.001, alpha=0.5,
                                  kd_T=1.0),
                    ds, MolGNN("gcn", 64, 1, 2, pna_delta=ds.mean_log_degree, pna_towers=4,
                               device="cpu"), teacher=teacher, seed=0, device="cpu")
    np.testing.assert_allclose(tr.train_epoch(1)["loss"], kd["losses"]["run0"][0], rtol=1e-6)
    with pytest.raises(ValueError, match="--platform"):
        _run(tmp_path, "--platform", "cpu")


def test_cli_trains_ogb_gin_virtual_at_a_batch_budget_of_its_own(tmp_path, capsys):
    summary = _run(tmp_path, "--gnn", "gine", "--hidden_channels", "16", "--num_layers", "2",
                   "--virtual_node_norm", "--max_atoms", "40", "--expt_name", "v")
    assert "batches of 32: 1280 nodes, 4096 edges" in capsys.readouterr().out
    state = load_checkpoint(cli.checkpoint_path(str(tmp_path), "v", "gine", 0))
    assert {k for k in state if k.startswith("vn_bns.")} >= {
        "vn_bns.0.scale", "vn_bns.1.running_var"}
    with open(tmp_path / "mol-v-gine-supervised.json") as f:
        assert json.load(f)["args"]["max_atoms"] == 40
    assert np.isfinite(summary["losses"]["run0"]).all()


def test_cli_tags_match_jax():
    for argv, tag in ((["--gnn", "pna"], "pna-supervised"),
                      (["--training", "kd", "--teacher_gnn", "pna"], "gcn-kd-from-pna"),
                      (["--training", "gpw", "--kd_and_aux"], "gcn-kd+gpw-from-gine"),
                      (["--kd_and_aux"], "gcn-kd+supervised-from-gine")):
        assert cli.result_tag(cli.build_parser().parse_args(argv)) == tag


def test_jax_checkpoint_gives_the_jax_logits(tmp_path):
    # the JAX CLI's best-validation file (flax msgpack of {"params",
    # "batch_stats"}), converted to the port's checkpoint here: the port
    # itself does not read flax files (flax imports JAX)
    from flax import serialization

    jds, tds = jax_mol.synthetic_molhiv_dataset(**DATA), mol.synthetic_molhiv_dataset(**DATA)
    jb, atoms, bonds, _ = next(jax_mol.MolBatcher(jds.valid, 16, 24, shuffle=False).epoch(0))
    jm = JaxMolGNN(conv="gine", hidden=24, num_tasks=1, num_layers=2, virtual_node=True)
    v = jm.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)}, jb,
                jnp.asarray(atoms), jnp.asarray(bonds))
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: a + 0.25, v["batch_stats"])}  # running statistics that are not the init's
    src = save_pytree(str(tmp_path / "jax" / "seed0.msgpack"), v)
    with open(src, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    dst = save_checkpoint(str(tmp_path / "port" / "seed0.pt"),
                          mol_from_jax_params(restored["params"], restored["batch_stats"]))
    model = MolGNN("gine", 24, 1, 2, virtual_node=True, device="cpu")
    model.load_state_dict(load_checkpoint(dst))
    model.eval()
    tb = next(mol.MolBatcher(tds.valid, 16, 24, shuffle=False).epoch(0))
    want, want_feat = jm.apply(v, jb, jnp.asarray(atoms), jnp.asarray(bonds))
    with torch.no_grad():
        got, feat = model(tb.batch, tb.atoms, tb.bonds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=1e-5, atol=1e-5)
