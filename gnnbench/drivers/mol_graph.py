"""OGB ``gin-virtual`` on batches of molecules (``train/mol_trainer.py``) as
the system under test.

The benchmark draws its own molecules from the seed (:func:`make_inputs`,
NumPy): atoms a molecule log-normal to ogbg-molhiv's mean and spread,
clipped to its smallest and largest molecule; bonds a spanning tree (each
atom bonded to one of the few atoms before it) plus ring closures to the
published bonds an atom, stored both ways; OGB's nine atom and three bond
feature vocabularies; a share of positive labels, the molecules whose
score (heteroatoms, rings and noise) is highest. The program is the port's
``MolGNN`` under ``MolTrainer``, as ``cli/mol.py`` builds them; the benchmark
loads its own initial state into it. An epoch is the trainer's
``run_epochs`` unit: an Adam step a train batch, then an evaluation of the
train, valid and test molecules with their ROC-AUCs.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from gnnbench import work
from gnnbench.reference.mol import ATOM_DIMS, BOND_DIMS, follow_mol

SPLITS = ("train", "valid", "test")
# atomic number index (ogb: atomic_num - 1) of C, N, O, F, P, S, Cl, Br, I
ELEMENTS = np.array([5, 6, 7, 8, 14, 15, 16, 34, 52])
ELEMENT_SHARE = np.array([0.73, 0.11, 0.12, 0.013, 0.004, 0.014, 0.006, 0.002, 0.001])
BOND_TYPE_SHARE = np.array([0.62, 0.08, 0.005, 0.295, 0.0])  # single, double, triple, aromatic


@dataclasses.dataclass
class MolInputs:
    """Each split's molecules: ``(senders, receivers, number of atoms, atom
    features int32[n, 9], bond features int32[e, 3], label)``, every bond
    both ways."""

    train: List[tuple]
    valid: List[tuple]
    test: List[tuple]


def _skewed(rng, vocab: int, size, top: float = 0.8) -> np.ndarray:
    """Indices of ``vocab`` values, ``top`` of them the first value and the
    rest falling geometrically over the others."""
    rest = (1.0 - top) * 0.5 ** np.arange(vocab - 1)
    p = np.concatenate([[top], rest])
    return rng.choice(vocab, size=size, p=p / p.sum())


def _molecule(rng, n: int, closures: int) -> tuple:
    parent = np.array([rng.integers(max(0, i - 4), i) for i in range(1, n)], np.int64)
    s, r = list(range(1, n)), list(parent)
    bonded = set(zip(s, r)) | set(zip(r, s))
    for _ in range(closures if n > 2 else 0):  # ring closures of 3 to 6 atoms
        a = int(rng.integers(0, n - 2))
        b = int(min(n - 1, a + rng.integers(2, 6)))
        if (a, b) not in bonded:
            bonded |= {(a, b), (b, a)}
            s.append(b)
            r.append(a)
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    senders, receivers = np.concatenate([s, r]), np.concatenate([r, s])
    degree = np.bincount(receivers, minlength=n)
    atoms = np.stack([
        ELEMENTS[rng.choice(len(ELEMENTS), size=n, p=ELEMENT_SHARE / ELEMENT_SHARE.sum())],
        _skewed(rng, ATOM_DIMS[1], n),
        np.minimum(degree, ATOM_DIMS[2] - 1),
        (_skewed(rng, 3, n, 0.95) + 5),  # formal charge 0, +1, +2 (offset 5 is 0)
        _skewed(rng, ATOM_DIMS[4], n, 0.5),
        _skewed(rng, ATOM_DIMS[5], n, 0.99),
        _skewed(rng, 4, n, 0.45) + 1,  # hybridization sp3 / sp2 / sp / sp3d
        rng.random(n) < 0.3,  # aromatic
        rng.random(n) < 0.4,  # in a ring
    ], axis=1).astype(np.int32)
    e = len(s)
    kind = rng.choice(len(BOND_TYPE_SHARE), size=e, p=BOND_TYPE_SHARE / BOND_TYPE_SHARE.sum())
    half = np.stack([kind, _skewed(rng, BOND_DIMS[1], e, 0.97),
                     rng.random(e) < 0.45], axis=1).astype(np.int32)
    bonds = np.concatenate([half, half])
    return senders, receivers, n, atoms, bonds


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> MolInputs:
    """The molecules of the three splits from ``default_rng(seed)``."""
    rng = np.random.default_rng(int(seed))
    m = traffic["molecules"]
    counts = [cfg[f"{k}_molecules"] for k in SPLITS]
    total = sum(counts)
    s2 = np.log(1.0 + (m["atoms_sd"] / m["atoms_mean"]) ** 2)
    atoms = rng.lognormal(np.log(m["atoms_mean"]) - s2 / 2, np.sqrt(s2), size=total)
    atoms = np.clip(np.round(atoms), m["atoms_min"], m["atoms_max"]).astype(np.int64)
    # ring closures: bonds = atoms - 1 + closures, bonds_per_atom on average
    closures = rng.poisson(np.maximum(m["bonds_per_atom"] * atoms - atoms + 1, 0.0))
    mols = [_molecule(rng, int(n), int(c)) for n, c in zip(atoms, closures)]
    score = np.array([np.mean(a[:, 0] != 5) + 0.3 * np.mean(a[:, 8]) for *_, a, _ in mols])
    score += 0.1 * rng.normal(size=total)
    positive = score > np.quantile(score, 1.0 - m["positive_share"])
    mols = [mol + (float(y),) for mol, y in zip(mols, positive)]
    bounds = np.cumsum([0] + counts)
    return MolInputs(*(mols[lo:hi] for lo, hi in zip(bounds, bounds[1:])))


class _RealRows:
    """``convs[0]`` as the benchmark's forward hook sees it: its output over
    the real atoms of the batch (the padding rows are the program's own)."""

    def __init__(self, conv: torch.nn.Module):
        self.conv = conv

    def register_forward_hook(self, hook):
        return self.conv.register_forward_hook(
            lambda module, args, out: hook(module, args, out[args[0].graph.node_mask]))


class Program:
    def __init__(self, cfg: dict, traffic: dict, inputs: MolInputs, seed: int, device):
        from efficient_gnns_tpu_torch.data.molhiv import Molecule, MolDataset
        from efficient_gnns_tpu_torch.models.mol import MolGNN
        from efficient_gnns_tpu_torch.train.config import DistillConfig
        from efficient_gnns_tpu_torch.train.mol_trainer import MolTrainer

        ds = MolDataset(*([Molecule(*m) for m in getattr(inputs, k)] for k in SPLITS),
                        num_tasks=cfg["num_tasks"], mean_log_degree=0.0)
        model = MolGNN(cfg["conv"], cfg["hidden"], cfg["num_tasks"], cfg["num_layers"],
                       dropout=cfg["dropout"], virtual_node=cfg["virtual_node"],
                       residual=cfg["residual"], virtual_node_norm=cfg["virtual_node_norm"],
                       seed=seed, device=device)
        dcfg = DistillConfig(training=traffic["training"], hidden=cfg["hidden"],
                             num_layers=cfg["num_layers"], dropout=cfg["dropout"], lr=cfg["lr"])
        self.trainer = MolTrainer(dcfg, ds, model, batch_size=cfg["batch_size"],
                                  max_atoms=cfg["max_atoms"], seed=seed, device=device)
        self.modules = self.trainer.modules
        self.shapes = {"node_rows": self.trainer.batcher.node_budget,
                       "edge_rows": self.trainer.batcher.edge_budget}
        self._first_grads = {}

    def start(self) -> None:
        """Hooks that keep each parameter's first gradient norm and then
        remove themselves: an epoch is many Adam steps, so the optimizer's
        state after it no longer holds the first gradient."""
        for name, p in self.modules.named_parameters():
            handle = []

            def keep(param, name=name, handle=handle):
                self._first_grads[name] = param.grad.detach().norm()
                handle.pop().remove()

            handle.append(p.register_post_accumulate_grad_hook(keep))

    def run_epochs(self, start: int, k: int) -> np.ndarray:
        return self.trainer.run_epochs(start, k)[:, 0]

    def first_layer(self) -> _RealRows:
        return _RealRows(self.modules[0].convs[0])

    def first_grad_norms(self) -> dict:
        return {k: float(self._first_grads[k]) if k in self._first_grads else 0.0
                for k, _ in self.modules.named_parameters()}


def init_gain(cfg: dict) -> float:
    return 1.0


def epoch_work(cfg: dict, traffic: dict, shapes: dict, inputs: MolInputs) -> dict:
    """An epoch's matrix products and K1 sums over the real rows: a train
    step a batch (forward, then each product's weight and input gradients),
    then an evaluation forward of every split. A layer is the conv MLP's two
    products over the atoms and the virtual node MLP's over the molecules
    (not after the last layer); its K1 sums are the edges into their atoms
    and, but on the last layer, the atoms into their molecules (the pool),
    and the backward's the senders' gather (edges into their senders) and
    the virtual node's (atoms into their molecules); the mean pool is one
    more. ``k1_bytes``: each K1 call's float32 entries and output rows, its
    int32 entry index and row offsets, once; ``spmm_least_s`` is each call's
    least time from those bytes (a sum reads its entries, where
    ``work.spmm_bytes`` counts the rows a gather reads)."""
    f, layers, tasks, bs = cfg["hidden"], cfg["num_layers"], cfg["num_tasks"], cfg["batch_size"]
    ep, k1_bytes, least = work.Epoch(), 0.0, 0.0

    def k1(rows, entries, batches):
        nonlocal k1_bytes, least
        ep.spmm(rows, entries, f, 4, False)
        nbytes = entries * f * 4 + entries * 4 + (rows + batches) * 4 + rows * f * 4
        k1_bytes += nbytes
        least += work.least_seconds(work.spmm_flops(entries, f), nbytes)

    for split in SPLITS:
        mols = getattr(inputs, split)
        n = sum(m[2] for m in mols)
        e = sum(len(m[0]) for m in mols)
        g, nb = len(mols), -(-len(mols) // bs)
        train = split == "train"
        for backward in (True, False) if train else (False,):
            times = 3 if backward else 1
            for i in range(layers):
                ep.mm(n, f, 2 * f, times)
                ep.mm(n, 2 * f, f, times)
                k1(n, e, nb)
                if backward:
                    k1(n, e, nb)  # the senders' gather
                    k1(g, n, nb)  # the virtual node's gather
                if i < layers - 1:
                    ep.mm(g, f, 2 * f, times)
                    ep.mm(g, 2 * f, f, times)
                    k1(g, n, nb)
            ep.mm(g, f, tasks, times)
            k1(g, n, nb)
    return dict(ep.summary(), k1_bytes=k1_bytes, spmm_least_s=least)


def reference_graph(cfg: dict, inputs: MolInputs, device):
    """The molecules of each split, and the device the reference runs on."""
    return {"sets": {k: getattr(inputs, k) for k in SPLITS}, "device": device}


def reference(g, cfg: dict, traffic: dict, inputs: MolInputs, init: dict, seed: int,
              steps: int, **fault) -> dict:
    return follow_mol(g["sets"], init, cfg, seed, steps, g["device"], **fault)
