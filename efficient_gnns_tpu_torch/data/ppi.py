"""PPI dataset (counterpart of ``efficient_gnns_tpu/data/ppi.py``): the
synthetic generator, micro-F1 and the loader of the torch-geometric raw files.

The real PPI benchmark is 24 protein-interaction graphs (20 train / 2 valid /
2 test, 50 features, 121 binary labels). The synthetic generator draws the
JAX package's NumPy stream, draw for draw, so a seed gives the same graphs,
features and labels in both packages.

Every graph of a dataset is padded to one (node, edge) budget, and a trainer
takes one padded graph per optimizer step (the reference's batch-1
DataLoader, ``ppi_pyg/gnn.py:305-310``). PyG's ``GATConv`` adds self loops
inside the conv; here ``build_graph`` adds them once per graph.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple

import numpy as np

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph, pad_length

_SPLITS = ("train", "valid", "test")
_PARTS = ("graph.json", "feats.npy", "labels.npy", "graph_id.npy")


class PPIGraph(NamedTuple):
    graph: Graph  # on the CPU
    x: np.ndarray  # float32 [pad_nodes, F]
    y: np.ndarray  # float32 [pad_nodes, L] multi-label
    num_nodes: int


class PPIDataset(NamedTuple):
    train: List[PPIGraph]
    valid: List[PPIGraph]
    test: List[PPIGraph]
    feat_dim: int
    num_labels: int


def _ppi_graph(s, r, n_nodes, x, y, pad_nodes, pad_edges) -> PPIGraph:
    """One padded graph of the undirected edges ``(s, r)``: both directions,
    one self loop a node, padding rows of ``x`` and ``y`` zero."""
    graph = build_graph(np.concatenate([s, r]), np.concatenate([r, s]), n_nodes,
                        self_loops=True, pad_nodes_to=pad_nodes, pad_edges_to=pad_edges,
                        n_node_valid=n_nodes)
    xp = np.zeros((pad_nodes, x.shape[1]), np.float32)
    xp[:n_nodes] = x
    yp = np.zeros((pad_nodes, y.shape[1]), np.float32)
    yp[:n_nodes] = y
    return PPIGraph(graph=graph, x=xp, y=yp, num_nodes=n_nodes)


def _make_graph(rng, n_nodes, avg_deg, feat_dim, pad_nodes, pad_edges, label_map,
                thresholds) -> PPIGraph:
    """One synthetic graph. Labels are one fixed function (the shared
    ``label_map`` and ``thresholds``) of the node features mixed with their
    neighbours' mean, so train graphs teach the mapping and the others
    measure it."""
    x = rng.normal(size=(n_nodes, feat_dim)).astype(np.float32)
    e = n_nodes * avg_deg
    s = rng.integers(0, n_nodes, size=e)
    r = rng.integers(0, n_nodes, size=e)
    su = np.concatenate([s, r])
    ru = np.concatenate([r, s])
    deg = np.bincount(ru, minlength=n_nodes).astype(np.float32)
    nbr = np.zeros_like(x)
    np.add.at(nbr, ru, x[su])
    h = x + 0.5 * nbr / np.maximum(deg, 1.0)[:, None]
    y = (h @ label_map > thresholds).astype(np.float32)
    return _ppi_graph(s, r, n_nodes, x, y, pad_nodes, pad_edges)


def synthetic_ppi_dataset(
    n_train: int = 8,
    n_valid: int = 2,
    n_test: int = 2,
    min_nodes: int = 100,
    max_nodes: int = 300,
    avg_deg: int = 8,
    feat_dim: int = 50,
    num_labels: int = 121,
    seed: int = 0,
) -> PPIDataset:
    """PPI-shaped graphs of ``min_nodes`` to ``max_nodes`` nodes with about
    ``2 * avg_deg`` edges a node, padded to ``pad_length(max_nodes, 128)``
    nodes and ``pad_length(max_nodes * avg_deg * 2 + pad_nodes, 1024)`` edges."""
    rng = np.random.default_rng(seed)
    pad_nodes = pad_length(max_nodes, 128)
    pad_edges = pad_length(max_nodes * avg_deg * 2 + pad_nodes, 1024)
    # one random linear map and per-label thresholds at about 30% positives
    label_map = rng.normal(size=(feat_dim, num_labels)).astype(np.float32)
    label_map /= np.sqrt(feat_dim)
    thresholds = (0.53 * np.linalg.norm(label_map, axis=0)).astype(np.float32)

    def make(k):
        return [
            _make_graph(rng, int(rng.integers(min_nodes, max_nodes + 1)), avg_deg,
                        feat_dim, pad_nodes, pad_edges, label_map, thresholds)
            for _ in range(k)
        ]

    return PPIDataset(train=make(n_train), valid=make(n_valid), test=make(n_test),
                      feat_dim=feat_dim, num_labels=num_labels)


def f1_from_counts(tp: int, fp: int, fn: int) -> float:
    """F1 of true positive, false positive and false negative counts; 0
    without any positive."""
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def micro_f1(logits: np.ndarray, labels: np.ndarray) -> float:
    """Micro-averaged F1 of ``logits > 0`` (sklearn ``f1_score(average=
    'micro')``, reference ``ppi_pyg/gnn.py:277-288``)."""
    pred = (np.asarray(logits) > 0).astype(np.int64).reshape(-1)
    true = np.asarray(labels).astype(np.int64).reshape(-1)
    return f1_from_counts(int(np.sum((pred == 1) & (true == 1))),
                          int(np.sum((pred == 1) & (true == 0))),
                          int(np.sum((pred == 0) & (true == 1))))


def load_ppi(data_root: str) -> PPIDataset:
    """Real PPI from the raw files ``torch_geometric.datasets.PPI`` downloads
    (the GraphSAGE layout), read with ``json`` and NumPy; nothing is
    downloaded:

        <data_root>/{train,valid,test}_graph.json     networkx node-link
        <data_root>/{split}_feats.npy                 [N, 50]
        <data_root>/{split}_labels.npy                [N, 121]
        <data_root>/{split}_graph_id.npy              [N]

    Raw self loops are dropped (``PPI`` applies ``remove_self_loops``) and
    ``build_graph`` adds one a node. Every graph of every split is padded to
    one budget. Raises ``FileNotFoundError`` when a file is missing.
    """
    needed = [os.path.join(data_root, f"{split}_{part}")
              for split in _SPLITS for part in _PARTS]
    missing = [p for p in needed if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"PPI raw cache incomplete under {data_root!r} (missing e.g. "
            f"{os.path.basename(missing[0])}). Put the torch-geometric PPI raw files "
            "({train,valid,test}_{graph.json,feats.npy,labels.npy,graph_id.npy}) "
            "there or use --dataset synthetic.")

    parsed = {}
    max_nodes = max_edges = 0
    for split in _SPLITS:
        with open(os.path.join(data_root, f"{split}_graph.json")) as f:
            gjson = json.load(f)
        feats = np.load(os.path.join(data_root, f"{split}_feats.npy"))
        labels = np.load(os.path.join(data_root, f"{split}_labels.npy"))
        gid = np.load(os.path.join(data_root, f"{split}_graph_id.npy"))
        links = np.array([[l["source"], l["target"]] for l in gjson["links"]], np.int64)
        if links.size:
            links = links[links[:, 0] != links[:, 1]]
        parsed[split] = (feats, labels, gid, links)
        for g in np.unique(gid):
            sel = np.nonzero(gid == g)[0]
            lo, hi = sel.min(), sel.max()
            m = (links[:, 0] >= lo) & (links[:, 0] <= hi)
            max_nodes = max(max_nodes, len(sel))
            max_edges = max(max_edges, 2 * int(m.sum()) + len(sel))  # both ways + loops

    pad_nodes = pad_length(max_nodes, 128)
    pad_edges = pad_length(max_edges, 1024)
    splits = {}
    for split, (feats, labels, gid, links) in parsed.items():
        graphs = []
        for g in np.unique(gid):
            sel = np.nonzero(gid == g)[0]
            lo, hi = sel.min(), sel.max()
            m = (links[:, 0] >= lo) & (links[:, 0] <= hi)
            graphs.append(_ppi_graph(links[m, 0] - lo, links[m, 1] - lo, len(sel),
                                     feats[lo:hi + 1], labels[lo:hi + 1], pad_nodes,
                                     pad_edges))
        splits[split] = graphs
    return PPIDataset(train=splits["train"], valid=splits["valid"], test=splits["test"],
                      feat_dim=parsed["train"][0].shape[1],
                      num_labels=parsed["train"][1].shape[1])
