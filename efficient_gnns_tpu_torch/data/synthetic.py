"""Synthetic ogbn-arxiv-shaped node dataset (counterpart of
``efficient_gnns_tpu/data/synthetic.py``).

Draws the same NumPy random stream as the JAX package, so a seed yields the
identical graph, features, labels and splits in both packages.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph


class NodeDataset(NamedTuple):
    graph: Graph  # bidirected + self loops (+ GCN norm weights, hub partition), on the CPU
    x: np.ndarray  # float32 [N, F]
    y: np.ndarray  # int32 [N]
    split_idx: Dict[str, np.ndarray]  # train/valid/test node ids
    num_classes: int
    # raw COO (pre-normalization) for building alternative graph views
    senders: np.ndarray
    receivers: np.ndarray
    num_nodes: int


def _powerlaw_edges(rng, num_nodes: int, num_edges: int, gamma: float = 1.4):
    """Heavy-tailed citation-like edge list (senders zipf-distributed)."""
    s = rng.zipf(gamma, size=num_edges * 2) % num_nodes
    r = rng.integers(0, num_nodes, size=num_edges * 2)
    keep = s != r
    s, r = s[keep][:num_edges], r[keep][:num_edges]
    return s.astype(np.int64), r.astype(np.int64)


def synthetic_node_dataset(
    num_nodes: int = 169_343,
    num_edges: int = 1_166_243,
    feat_dim: int = 128,
    num_classes: int = 40,
    seed: int = 0,
    train_frac: float = 0.54,
    valid_frac: float = 0.18,
    label_smoothing_hops: int = 2,
    signal: float = 0.8,
    label_noise: float = 0.0,
    feat_sparse: float = 0.0,
    n_super: int = 0,
    sub_scale: float = 0.4,
    pad_nodes_to: Optional[int] = None,
    hub_dense="auto",
    gcn_norm: bool = True,
) -> NodeDataset:
    """ogbn-arxiv-shaped synthetic dataset (defaults = real arxiv sizes).

    ``signal`` scales the class-prototype component of the features,
    ``label_noise`` relabels that fraction of nodes, ``feat_sparse`` blanks
    the prototype of that fraction of nodes, and ``n_super > 0`` arranges
    the classes into confusable superclasses (see the JAX counterpart).
    ``hub_dense`` and ``gcn_norm`` go to :func:`build_graph`: an attention
    graph (``gcn_norm=False``) of 200k edges or more then carries the hub
    partition that the ``--no-attn-dst`` teacher's hub path needs.
    """
    rng = np.random.default_rng(seed)
    s, r = _powerlaw_edges(rng, num_nodes, num_edges)

    if n_super > 0:
        if num_classes % n_super:
            raise ValueError(f"num_classes={num_classes} not divisible by n_super={n_super}")
        n_sub = num_classes // n_super
        supers = rng.normal(size=(n_super, feat_dim)).astype(np.float32)
        subs = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
        protos = supers.repeat(n_sub, axis=0) + sub_scale * subs
    else:
        protos = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int64)
    for _ in range(label_smoothing_hops):
        y_new = y.copy()
        y_new[r] = y[s]  # receiver adopts a random in-neighbor's class
        y = y_new
    x = protos[y] * signal + rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
    if feat_sparse > 0:
        blank = rng.random(num_nodes) < feat_sparse
        x = np.where(blank[:, None],
                     rng.normal(size=(num_nodes, feat_dim)).astype(np.float32),
                     x)
    if label_noise > 0:
        flip = rng.random(num_nodes) < label_noise
        if n_super > 0:
            n_sub = num_classes // n_super
            wrong = (y // n_sub) * n_sub + rng.integers(0, n_sub, size=num_nodes)
        else:
            wrong = rng.integers(0, num_classes, size=num_nodes)
        y = np.where(flip, wrong, y)

    perm = rng.permutation(num_nodes)
    n_tr = int(train_frac * num_nodes)
    n_va = int(valid_frac * num_nodes)
    split_idx = {
        "train": np.sort(perm[:n_tr]).astype(np.int32),
        "valid": np.sort(perm[n_tr : n_tr + n_va]).astype(np.int32),
        "test": np.sort(perm[n_tr + n_va :]).astype(np.int32),
    }

    graph = build_graph(
        s, r, num_nodes,
        bidirected=True, self_loops=True,
        pad_nodes_to=pad_nodes_to,
        hub_dense=hub_dense,
        gcn_norm=gcn_norm,
    )
    if pad_nodes_to is not None and pad_nodes_to > num_nodes:
        x = np.concatenate(
            [x, np.zeros((pad_nodes_to - num_nodes, feat_dim), np.float32)]
        )
        y = np.concatenate([y, np.zeros(pad_nodes_to - num_nodes, np.int64)])

    return NodeDataset(
        graph=graph,
        x=x.astype(np.float32),
        y=y.astype(np.int32),
        split_idx=split_idx,
        num_classes=num_classes,
        senders=s,
        receivers=r,
        num_nodes=num_nodes,
    )
