"""The port's OGB ``gin-virtual`` (``MolGNN`` with ``virtual_node_norm``)
against the benchmark's plain reference (``gnnbench/reference/mol.py``: the
same equations as dense float32 products, no kernel and no code of the
port), on the CPU at 2 layers x 16 on a few synthetic molecules.

Tolerances: the two sides sum in other orders (K1's CSR order against a 0/1
matrix product) and pad differently (the program's BatchNorms and products
run over padded rows), so values agree to float32 rounding carried through
two layers: logits, loss and eval logits to 1e-5 of the largest, every
gradient to 1e-4 of the largest entry of its leaf (or of the median leaf,
for a bias that a BatchNorm cancels: its gradient is round-off on both
sides). Adam moves a parameter by about ``lr`` a step whatever its
gradient's size (``|m_hat| / sqrt(v_hat)`` stays under 1.004 over the first
3 steps), so after 3 steps those biases, whose round-off gradients may take
opposite signs on the two sides, differ by up to ``2 * 3 * 1.004 lr``, and
the running means that follow them by less; every other parameter's change
agrees to 1e-4 of its size.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from efficient_gnns_tpu_torch.data import molhiv as mol
from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.models.mol import MolGNN
from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer
from gnnbench.reference import mol as ref

HIDDEN, LAYERS, LR = 16, 2, 1e-3
CFG = dict(num_layers=LAYERS, hidden=HIDDEN, dropout=0.5, lr=LR, batch_size=2, max_atoms=24)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(seed=11):
    return mol.synthetic_molhiv_dataset(n_train=6, n_valid=2, n_test=3, seed=seed)


def _tuples(mols):
    return [(m.senders, m.receivers, m.num_nodes, m.atom_feats, m.bond_feats, m.label)
            for m in mols]


def _model(seed=3, dropout=0.5):
    return MolGNN("gine", HIDDEN, 1, LAYERS, dropout=dropout, virtual_node=True,
                  virtual_node_norm=True, seed=seed, device="cpu")


def _cancelled_biases(model):
    """The biases right before a BatchNorm (the conv MLP's two, the virtual
    node MLP's): their gradient is round-off."""
    return {f"0.{k}" for k, _ in model.named_parameters()
            if k.endswith("bias") and (".dense." in k or "vn_lins" in k)}


def test_the_virtual_node_mlp_carries_two_masked_batchnorms():
    model = _model()
    assert len(model.vn_bns) == 2 * (LAYERS - 1)
    assert [m.scale.shape[0] for m in model.vn_bns] == [2 * HIDDEN, HIDDEN]
    plain = MolGNN("gine", HIDDEN, 1, LAYERS, virtual_node=True, device="cpu")
    assert len(plain.vn_bns) == 0 and not any("vn_bns" in k for k in plain.state_dict())
    # eval mode reads the running statistics, which a train forward moves,
    # and a padding molecule does not move them
    ds = _data()
    full = next(mol.MolBatcher(ds.train[:3], 4, 24, shuffle=False).epoch(0))
    model(full.batch, full.atoms, full.bonds, generator=torch.Generator().manual_seed(0))
    moved = model.vn_bns[0].running_mean.clone()
    assert moved.abs().sum() > 0
    model.eval()
    a = model(full.batch, full.atoms, full.bonds)[0]
    model.vn_bns[0].running_mean.add_(1.0)
    assert not torch.equal(a, model(full.batch, full.atoms, full.bonds)[0])


def test_logits_loss_and_every_gradient_match_the_reference():
    ds = _data()
    mols = ds.train[:3]  # a batch of 4 graph slots: one padding molecule
    model = _model()
    init = {f"0.{k}": v.clone() for k, v in model.state_dict().items()}
    mb = next(mol.MolBatcher(mols, 4, 24, shuffle=False).epoch(0))
    out, _ = model(mb.batch, mb.atoms, mb.bonds, generator=torch.Generator().manual_seed(5))
    loss = criteria.cls_bce(out[:, 0], mb.labels, mb.batch.graph_mask)
    loss.backward()

    P, S = ref._split_state(init)
    b = ref.Batch(_tuples(mols), mb.batch.graph.num_nodes, "cpu")
    want = ref.forward(P, S, b, dict(CFG, batch_size=4), torch.Generator().manual_seed(5), True)
    want_loss = F.binary_cross_entropy_with_logits(want, b.labels)
    grads = ref.R.grads_of(want_loss, P, list(P))

    got, want = out[:3, 0].detach(), want.detach()
    assert got.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(loss.detach(), want_loss.detach(), rtol=1e-5, atol=0)
    named = dict(model.named_parameters())
    assert set(grads) == {f"0.{k}" for k in named}
    largest = {k: float(g.abs().max()) for k, g in grads.items()}
    median = sorted(largest.values())[len(largest) // 2]
    cancelled = _cancelled_biases(model)
    for k, g in grads.items():
        scale = max(largest[k], median) if k in cancelled else largest[k]
        torch.testing.assert_close(named[k[2:]].grad, g, rtol=0, atol=1e-4 * scale, msg=k)
    # the running statistics of every BatchNorm moved alike
    for k, v in S.items():
        torch.testing.assert_close(model.state_dict()[k[2:]], v, rtol=1e-5, atol=1e-6, msg=k)


def _trained(seed=9):
    """3 Adam steps with dropout through ``run_epochs``: 3 epochs of one
    batch of the 6 train molecules, each with its evaluation."""
    ds = _data()
    model = _model()
    tr = MolTrainer(DistillConfig(lr=LR), ds, model, batch_size=6, max_atoms=24, seed=seed,
                    device="cpu")
    init = {k: v.clone() for k, v in tr.modules.state_dict().items()}
    hist = tr.run_epochs(0, 3)
    sets = {k: _tuples(getattr(ds, k)) for k in ("train", "valid", "test")}
    return tr, init, hist, sets


def test_adam_steps_through_run_epochs_match_the_reference():
    tr, init, hist, sets = _trained()
    assert hist.shape == (3, 6) and hist.dtype == np.float32
    out = ref.follow_mol(sets, init, dict(CFG, batch_size=6), 9, 3, "cpu")
    np.testing.assert_allclose(hist[:, 0], out["loss"], rtol=1e-5)
    cancelled = _cancelled_biases(tr.model)
    state = tr.modules.state_dict()
    for k, v in out["state"].items():
        assert not torch.equal(v, init[k]), k  # every parameter and statistic moved
        if k in cancelled or k.endswith("running_mean"):
            # a cancelled bias, and the running mean that follows it: each
            # side moves it by at most 3 * 1.004 lr, in either direction
            torch.testing.assert_close(state[k], v, rtol=0, atol=2 * 3 * 1.004 * LR, msg=k)
        elif k.endswith("running_var"):
            torch.testing.assert_close(state[k], v, rtol=1e-5, atol=0, msg=k)
        else:  # the steps agree to 1e-4 of their size (measured: under 1e-5)
            moved = float((v - init[k]).norm())
            assert float((state[k] - v).norm()) <= 1e-4 * moved, k


def test_eval_logits_on_moved_running_statistics_match_the_reference():
    tr, _, _, sets = _trained()
    state = tr.modules.state_dict()
    assert all(not torch.equal(v, torch.zeros_like(v)) for k, v in state.items()
               if k.endswith("running_mean"))
    scores, aucs = tr._eval_step()
    P, S = ref._split_state({k: v.clone() for k, v in state.items()})
    with torch.no_grad():
        want = torch.cat([
            ref.forward(P, S, ref.Batch(mols[lo:lo + 6], 256, "cpu"), CFG, None, False)
            for split in ("train", "valid", "test")
            for mols in (sets[split],) for lo in range(0, len(mols), 6)])
    assert scores.shape == want.shape == (11,)
    torch.testing.assert_close(scores, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    for split, auc in zip(("train", "valid", "test"), aucs):
        assert float(auc) == mol.roc_auc(*tr.scores(split)) or np.isnan(float(auc))


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys, gnnbench.reference.mol; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    loaded = set(eval(run.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "efficient_gnns_tpu",
                         "efficient_gnns_tpu_torch"}
