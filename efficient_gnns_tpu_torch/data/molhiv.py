"""ogbg-molhiv (counterpart of ``efficient_gnns_tpu/data/molhiv.py``): the
synthetic generator, the raw-cache loader, the padded molecule batcher
and ROC-AUC.

``synthetic_molhiv_dataset`` draws from NumPy's ``default_rng(seed)`` in the
JAX generator's order, so both give the same molecules and labels.
``load_molhiv`` reads the raw cache that OGB's ``GraphPropPredDataset``
downloads, with ``gzip`` and NumPy (no pandas, no ``ogb`` package, no
download):

    <root>[/ogbg_molhiv]/raw/edge.csv.gz            int [E, 2] local ids
    <root>[/ogbg_molhiv]/raw/edge-feat.csv.gz       int [E, 3]
    <root>[/ogbg_molhiv]/raw/node-feat.csv.gz       int [N, 9]
    <root>[/ogbg_molhiv]/raw/num-node-list.csv.gz   int [G, 1]
    <root>[/ogbg_molhiv]/raw/num-edge-list.csv.gz   int [G, 1]
    <root>[/ogbg_molhiv]/raw/graph-label.csv.gz     int [G, 1]
    <root>[/ogbg_molhiv]/split/scaffold/{train,valid,test}.csv.gz

and takes the edge rows as they are (both directions), as the JAX loader
does. :class:`MolBatcher` packs ``batch_size`` molecules into one padded
:class:`BatchedGraphs` with the JAX batcher's budgets and order, and pads a
batch past the budgets to its own size where the JAX batcher raises.
"""

from __future__ import annotations

import os
from typing import Iterator, List, NamedTuple

import numpy as np
import torch

from efficient_gnns_tpu_torch.data.ogb import _read_csv
from efficient_gnns_tpu_torch.graphs.batching import pack_graphs, pack_node_features
from efficient_gnns_tpu_torch.graphs.container import BatchedGraphs


class Molecule(NamedTuple):
    senders: np.ndarray
    receivers: np.ndarray
    num_nodes: int
    atom_feats: np.ndarray  # int32 [n, 9]
    bond_feats: np.ndarray  # int32 [e, 3]
    label: float


class MolDataset(NamedTuple):
    train: List[Molecule]
    valid: List[Molecule]
    test: List[Molecule]
    num_tasks: int
    mean_log_degree: float  # PNA delta


def _mean_log_degree(mols: List[Molecule]) -> float:
    return float(np.mean([
        np.log(np.maximum(np.bincount(m.receivers, minlength=m.num_nodes), 1) + 1).mean()
        for m in mols]))


def synthetic_molhiv_dataset(
    n_train: int = 400,
    n_valid: int = 50,
    n_test: int = 50,
    min_atoms: int = 8,
    max_atoms: int = 24,
    seed: int = 0,
) -> MolDataset:
    """Molecule-like graphs (a chain plus random extra bonds, bidirected)
    whose label is a noisy function of the visible atoms, bonds and size,
    thresholded once over the train scores (about 30% positive)."""
    rng = np.random.default_rng(seed)

    def make(k):
        mols, scores = [], []
        for _ in range(k):
            n = int(rng.integers(min_atoms, max_atoms + 1))
            atoms = np.zeros((n, 9), np.int32)
            atoms[:, 0] = rng.integers(1, 20, size=n)  # atomic number
            atoms[:, 1:] = rng.integers(0, 2, size=(n, 8))
            s = np.arange(n - 1)
            r = s + 1
            extra = max(1, n // 4)
            es = rng.integers(0, n, size=extra)
            er = rng.integers(0, n, size=extra)
            s = np.concatenate([s, es])
            r = np.concatenate([r, er])
            keep = s != r
            s, r = s[keep], r[keep]
            su = np.concatenate([s, r])
            ru = np.concatenate([r, s])
            bonds = np.zeros((len(su), 3), np.int32)
            bonds[:, 0] = rng.integers(0, 4, size=len(su))
            heavy = (atoms[:, 0] > 10).mean()
            aromatic = (bonds[:, 0] == 3).mean() if len(su) else 0.0
            chirality = atoms[:, 1].mean()
            score = (2.0 * heavy + 1.0 * chirality + 0.8 * aromatic
                     + 0.05 * len(su) / n + 0.15 * rng.normal())
            mols.append(Molecule(su, ru, n, atoms, bonds, 0.0))
            scores.append(score)
        return mols, np.asarray(scores)

    train, s_tr = make(n_train)
    valid, s_va = make(n_valid)
    test, s_te = make(n_test)
    thresh = float(np.quantile(s_tr, 0.7))

    def labelled(mols, scores):
        return [m._replace(label=float(s > thresh)) for m, s in zip(mols, scores)]

    train = labelled(train, s_tr)
    return MolDataset(train=train, valid=labelled(valid, s_va), test=labelled(test, s_te),
                      num_tasks=1, mean_log_degree=_mean_log_degree(train[:100]))


class MolBatch(NamedTuple):
    """One packed batch: the graphs, ``atoms`` int32[N_pad, 9], ``bonds``
    int32[E_pad, 3] in the packed graph's edge order, ``labels``
    float32[batch_size] (0 past ``batch.n_graph``)."""

    batch: BatchedGraphs
    atoms: torch.Tensor
    bonds: torch.Tensor
    labels: torch.Tensor

    def to(self, device) -> "MolBatch":
        """The batch with every tensor on ``device``."""
        return MolBatch(self.batch.to(device), self.atoms.to(device), self.bonds.to(device),
                        self.labels.to(device))


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


class MolBatcher:
    """Yields packed batches (:class:`MolBatch`, on the CPU) of
    ``batch_size`` molecules, padded to the JAX budgets: ``batch_size *
    max_atoms`` nodes rounded up to 128 and three edges an atom rounded up to
    1,024. A batch that fits them is packed as the JAX batcher packs it. A
    batch past a budget (real molecules reach 222 atoms), where the JAX
    batcher raises, is padded in that dimension to its own count rounded up
    to 128 nodes or 1,024 edges instead (:meth:`pads`); every other batch
    keeps the budget's shape."""

    def __init__(self, mols: List[Molecule], batch_size: int, max_atoms: int,
                 shuffle: bool = True):
        self.mols = mols
        self.batch_size = batch_size
        self.node_budget = _round_up(batch_size * max_atoms, 128)
        # chain + extra bonds, bidirected: < 3 edges per atom on average
        self.edge_budget = _round_up(batch_size * max_atoms * 3, 1024)
        self.shuffle = shuffle

    def __len__(self):
        return -(-len(self.mols) // self.batch_size)

    def pads(self, nodes: int, edges: int) -> tuple:
        """``(node rows, edge rows)`` of a batch of ``nodes`` atoms and
        ``edges`` directed bonds: each budget, or past it the count rounded up
        to 128 nodes or 1,024 edges."""
        return (self.node_budget if nodes <= self.node_budget else _round_up(nodes, 128),
                self.edge_budget if edges <= self.edge_budget else _round_up(edges, 1024))

    def chunks(self, seed: int) -> List[np.ndarray]:
        """The molecule indices of each batch of one epoch, in
        ``default_rng(seed).permutation`` order when shuffling."""
        order = np.arange(len(self.mols))
        if self.shuffle:
            order = np.random.default_rng(seed).permutation(order)
        return [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]

    def pack(self, idx: np.ndarray) -> MolBatch:
        """The molecules ``idx`` as one padded batch on the CPU."""
        chunk = [self.mols[j] for j in idx]
        b = self.batch_size
        pad_nodes, pad_edges = self.pads(sum(m.num_nodes for m in chunk),
                                         sum(len(m.senders) for m in chunk))
        batch, _, bonds = pack_graphs(
            [(m.senders, m.receivers, m.num_nodes) for m in chunk],
            pad_nodes_to=pad_nodes,
            pad_edges_to=pad_edges,
            pad_graphs_to=b,
            edge_payloads=[m.bond_feats for m in chunk],
        )
        atoms = pack_node_features([m.atom_feats for m in chunk], pad_nodes)
        labels = np.zeros(b, np.float32)
        labels[: len(chunk)] = [m.label for m in chunk]
        return MolBatch(batch, torch.from_numpy(atoms), torch.from_numpy(bonds),
                        torch.from_numpy(labels))

    def epoch(self, seed: int) -> Iterator[MolBatch]:
        """The batches of one epoch (:meth:`chunks`, each packed)."""
        return (self.pack(idx) for idx in self.chunks(seed))


def roc_auc_device(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`roc_auc` on the device, without a host copy: a float64 scalar
    tensor, NaN without both classes. Each score's rank is the mean of its
    tie group's (``searchsorted`` on the sorted scores from both sides), and
    the statistic is :func:`roc_auc`'s, operation for operation in float64,
    so both give the same bits."""
    scores = scores.reshape(-1)
    labels = labels.reshape(-1).to(torch.float64)
    ordered = torch.sort(scores).values
    below = torch.searchsorted(ordered, scores, right=False).to(torch.float64)
    upto = torch.searchsorted(ordered, scores, right=True).to(torch.float64)
    ranks = 0.5 * ((below + 1) + upto)
    pos = labels == 1
    n_pos, n_neg = pos.sum().to(torch.float64), (labels == 0).sum().to(torch.float64)
    r_pos = torch.where(pos, ranks, 0.0).sum()
    return (r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based ROC-AUC with tied scores given their mean rank (the OGB
    molhiv metric); NaN without both classes. The JAX function's ranks, by
    whole tie groups instead of a loop."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    n_pos, n_neg = int((labels == 1).sum()), int((labels == 0).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    starts = np.concatenate([[0], np.flatnonzero(s[1:] != s[:-1]) + 1])
    ends = np.append(starts[1:], len(s))
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.repeat(0.5 * ((starts + 1) + ends), ends - starts)
    r_pos = ranks[labels == 1].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


_RAW_FILES = ("edge.csv.gz", "edge-feat.csv.gz", "node-feat.csv.gz", "num-node-list.csv.gz",
              "num-edge-list.csv.gz", "graph-label.csv.gz")
_SPLITS = ("train", "valid", "test")


def molhiv_raw_files(root: str) -> dict:
    """Path of each file of the raw cache under ``root`` (or
    ``root/ogbg_molhiv``), by name (``edge.csv.gz``, ..., ``train``)."""
    base = root
    if os.path.isdir(os.path.join(root, "ogbg_molhiv")):
        base = os.path.join(root, "ogbg_molhiv")
    files = {f: os.path.join(base, "raw", f) for f in _RAW_FILES}
    files.update({s: os.path.join(base, "split", "scaffold", f"{s}.csv.gz") for s in _SPLITS})
    return files


def load_molhiv(data_root: str) -> MolDataset:
    """ogbg-molhiv from the raw cache under ``data_root``; raises
    ``FileNotFoundError`` naming a missing file (nothing is downloaded)."""
    files = molhiv_raw_files(data_root)
    missing = [p for p in files.values() if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"ogbg-molhiv raw cache incomplete under {data_root!r} (missing e.g. "
            f"{missing[0]}): the files OGB's GraphPropPredDataset writes (raw/*.csv.gz and "
            "split/scaffold/*.csv.gz); or use --dataset synthetic")

    edges = _read_csv(files["edge.csv.gz"], np.int64)
    edge_feat = _read_csv(files["edge-feat.csv.gz"], np.int32)
    node_feat = _read_csv(files["node-feat.csv.gz"], np.int32)
    n_nodes = _read_csv(files["num-node-list.csv.gz"], np.int64).reshape(-1)
    n_edges = _read_csv(files["num-edge-list.csv.gz"], np.int64).reshape(-1)
    labels = _read_csv(files["graph-label.csv.gz"], np.float32).reshape(-1)

    node_off = np.zeros(len(n_nodes) + 1, np.int64)
    np.cumsum(n_nodes, out=node_off[1:])
    edge_off = np.zeros(len(n_edges) + 1, np.int64)
    np.cumsum(n_edges, out=edge_off[1:])
    mols = []
    for i in range(len(n_nodes)):
        el, eh = edge_off[i], edge_off[i + 1]
        nl, nh = node_off[i], node_off[i + 1]
        mols.append(Molecule(
            senders=edges[el:eh, 0].copy(), receivers=edges[el:eh, 1].copy(),
            num_nodes=int(n_nodes[i]), atom_feats=node_feat[nl:nh].copy(),
            bond_feats=edge_feat[el:eh].copy(), label=float(labels[i])))

    split = {s: _read_csv(files[s], np.int64).reshape(-1) for s in _SPLITS}
    train = [mols[j] for j in split["train"]]
    return MolDataset(
        train=train, valid=[mols[j] for j in split["valid"]],
        test=[mols[j] for j in split["test"]], num_tasks=1,
        mean_log_degree=_mean_log_degree([m for m in train[:1000] if m.num_nodes]))
