"""ogbn-arxiv loader (counterpart of ``efficient_gnns_tpu/data/ogb.py``).

Reads the raw cache that OGB's ``NodePropPredDataset`` downloads, with
``gzip`` and NumPy (no pandas, no ``ogb`` package, no download):

    <root>[/ogbn_arxiv]/raw/edge.csv.gz          int64 [E, 2] (sender, receiver)
    <root>[/ogbn_arxiv]/raw/node-feat.csv.gz     float [N, 128]
    <root>[/ogbn_arxiv]/raw/node-label.csv.gz    int   [N, 1]
    <root>[/ogbn_arxiv]/split/time/{train,valid,test}.csv.gz   int [n, 1]

The graph is built as the JAX loader builds it: bidirected, self loops, the
hub partition and GCN normalisation as asked, 40 classes.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from efficient_gnns_tpu_torch.data.synthetic import NodeDataset
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph

_SPLITS = ("train", "valid", "test")


def _read_csv(path: str, dtype) -> np.ndarray:
    """A headerless comma-separated table as ``[rows, cols]`` of ``dtype``;
    floats are parsed in float64 first, as pandas parses them."""
    parse = np.float64 if np.issubdtype(dtype, np.floating) else np.int64
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=parse, ndmin=2).astype(dtype)


def _load_arxiv_raw(root: str):
    """``(senders, receivers, num_nodes, x, y, split_idx)`` from the raw
    cache under ``root`` (or ``root/ogbn_arxiv``), or None if a file is
    missing."""
    base = root
    if os.path.isdir(os.path.join(root, "ogbn_arxiv")):
        base = os.path.join(root, "ogbn_arxiv")
    raw = os.path.join(base, "raw")
    split_dir = os.path.join(base, "split", "time")
    needed = [os.path.join(raw, f)
              for f in ("edge.csv.gz", "node-feat.csv.gz", "node-label.csv.gz")]
    needed += [os.path.join(split_dir, f"{s}.csv.gz") for s in _SPLITS]
    if any(not os.path.exists(p) for p in needed):
        return None
    edges = _read_csv(os.path.join(raw, "edge.csv.gz"), np.int64)
    x = _read_csv(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    y = _read_csv(os.path.join(raw, "node-label.csv.gz"), np.int32).reshape(-1)
    split_idx = {k: _read_csv(os.path.join(split_dir, f"{k}.csv.gz"), np.int64).reshape(-1)
                 for k in _SPLITS}
    return edges[:, 0], edges[:, 1], x.shape[0], x, y, split_idx


def load_ogbn_arxiv(root: str = "dataset", hub_dense="auto",
                    gcn_norm: bool = True) -> NodeDataset:
    """ogbn-arxiv from the raw cache under ``root``; raises ``RuntimeError``
    when a file of it is missing (nothing is downloaded). Attention graphs
    (the GAT teacher) pass ``gcn_norm=False``."""
    raw = _load_arxiv_raw(root)
    if raw is None:
        raise RuntimeError(
            f"no ogbn-arxiv raw cache under {root!r} (the files OGB's "
            "NodePropPredDataset writes: raw/*.csv.gz and split/time/*.csv.gz); "
            "use --dataset synthetic"
        )
    s, r, num_nodes, x, y, split_idx = raw

    graph = build_graph(s, r, num_nodes, bidirected=True, self_loops=True,
                        hub_dense=hub_dense, gcn_norm=gcn_norm)
    return NodeDataset(
        graph=graph,
        x=x,
        y=y,
        split_idx={k: np.sort(np.asarray(v)).astype(np.int32) for k, v in split_idx.items()},
        num_classes=40,
        senders=np.asarray(s),
        receivers=np.asarray(r),
        num_nodes=num_nodes,
    )
