"""ogbn-mag dataset (counterpart of ``efficient_gnns_tpu/data/mag.py``): the
synthetic generator and the loader of OGB's raw cache.

Both give the grouped typed graph the R-GCN trainer consumes
(``graphs/hetero.py``), as the reference builds it (``mag_pyg/gnn.py:307-357``):
4 node types, 7 relations after augmentation, features only on papers,
labels and splits on papers. The synthetic generator draws the JAX package's
NumPy stream, draw for draw, so a seed gives the same arrays in both
packages.

The raw cache is what OGB's ``NodePropPredDataset`` writes for ogbn-mag,
read with ``gzip`` and NumPy (no pandas, no ``ogb`` package, no download):

    <root>[/ogbn_mag]/raw/relations/<src>___<rel>___<dst>/edge.csv.gz  int [E, 2]
    <root>[/ogbn_mag]/raw/num-node-dict.csv.gz        a header of node types, one row of counts
    <root>[/ogbn_mag]/raw/node-feat/paper/node-feat.csv.gz    float [n_paper, 128]
    <root>[/ogbn_mag]/raw/node-label/paper/node-label.csv.gz  int [n_paper, 1]
    <root>[/ogbn_mag]/split/time/paper/{train,valid,test}.csv.gz  int [n, 1]
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, NamedTuple

import numpy as np

from efficient_gnns_tpu_torch.data.ogb import _read_csv
from efficient_gnns_tpu_torch.graphs.hetero import GroupedHetero, mag_preprocess

_SPLITS = ("train", "valid", "test")
# the relations of ogbn-mag, before mag_preprocess adds the reverse ones
MAG_RELATIONS = (
    ("author", "affiliated_with", "institution"),
    ("author", "writes", "paper"),
    ("paper", "cites", "paper"),
    ("paper", "has_topic", "field_of_study"),
)


class MagDataset(NamedTuple):
    grouped: GroupedHetero
    x_paper: np.ndarray  # float32 [n_paper, feat]
    y_paper: np.ndarray  # int32 [n_paper]
    split_idx: Dict[str, np.ndarray]  # paper-local ids
    num_classes: int
    num_nodes_dict: Dict[str, int]
    num_edge_types: int


def synthetic_mag_dataset(
    n_paper: int = 4000,
    n_author: int = 2000,
    n_inst: int = 100,
    n_field: int = 200,
    feat_dim: int = 128,
    num_classes: int = 16,
    avg_cites: int = 5,
    seed: int = 0,
    signal: float = 0.8,
    label_noise: float = 0.0,
    homophily: float = 0.5,
) -> MagDataset:
    """A MAG-shaped dataset from ``seed``. ``signal`` scales the
    class-prototype feature component, ``homophily`` the fraction of
    same-class citations, and ``label_noise`` relabels that fraction of
    papers after the (true-label-driven) edges are drawn."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n_paper).astype(np.int32)
    protos = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    x = protos[y] * signal + rng.normal(size=(n_paper, feat_dim)).astype(np.float32)

    def edges(n_src, n_dst, count, homophily_labels=None):
        s = rng.integers(0, n_src, size=count)
        r = rng.integers(0, n_dst, size=count)
        if homophily_labels is not None and homophily > 0:
            # citations favour same-class papers, class by class
            same_idx = np.where(rng.random(count) < homophily)[0]
            cls_of_edge = homophily_labels[s[same_idx]]
            for c in range(num_classes):
                m = same_idx[cls_of_edge == c]
                pool = np.where(homophily_labels == c)[0]
                if len(pool) and len(m):
                    r[m] = pool[rng.integers(0, len(pool), size=len(m))]
        return np.stack([s, r])

    edge_index_dict = {
        ("paper", "cites", "paper"): edges(n_paper, n_paper, avg_cites * n_paper, y),
        ("author", "writes", "paper"): edges(n_author, n_paper, 3 * n_author),
        ("author", "affiliated_with", "institution"): edges(n_author, n_inst, n_author),
        ("paper", "has_topic", "field_of_study"): edges(n_paper, n_field, 2 * n_paper),
    }
    num_nodes_dict = {
        "paper": n_paper,
        "author": n_author,
        "institution": n_inst,
        "field_of_study": n_field,
    }
    grouped = mag_preprocess(edge_index_dict, num_nodes_dict)

    if label_noise > 0:
        flip = rng.random(n_paper) < label_noise
        y = np.where(
            flip, rng.integers(0, num_classes, size=n_paper), y
        ).astype(np.int32)

    perm = rng.permutation(n_paper)
    n_tr, n_va = int(0.6 * n_paper), int(0.2 * n_paper)
    split_idx = {
        "train": np.sort(perm[:n_tr]).astype(np.int64),
        "valid": np.sort(perm[n_tr : n_tr + n_va]).astype(np.int64),
        "test": np.sort(perm[n_tr + n_va :]).astype(np.int64),
    }
    return MagDataset(
        grouped=grouped,
        x_paper=x,
        y_paper=y,
        split_idx=split_idx,
        num_classes=num_classes,
        num_nodes_dict=num_nodes_dict,
        num_edge_types=7,
    )


def mag_raw_files(root: str) -> Dict[str, str]:
    """The raw cache's files under ``root`` (or ``root/ogbn_mag``), by role."""
    base = root
    if os.path.isdir(os.path.join(root, "ogbn_mag")):
        base = os.path.join(root, "ogbn_mag")
    raw = os.path.join(base, "raw")
    files = {"___".join(rel): os.path.join(raw, "relations", "___".join(rel), "edge.csv.gz")
             for rel in MAG_RELATIONS}
    files["num_nodes"] = os.path.join(raw, "num-node-dict.csv.gz")
    files["feat"] = os.path.join(raw, "node-feat", "paper", "node-feat.csv.gz")
    files["label"] = os.path.join(raw, "node-label", "paper", "node-label.csv.gz")
    for split in _SPLITS:
        files[split] = os.path.join(base, "split", "time", "paper", f"{split}.csv.gz")
    return files


def load_ogbn_mag(root: str = "dataset") -> MagDataset:
    """ogbn-mag from the raw cache under ``root`` (349 classes, the
    reference's 7 relations); raises ``RuntimeError`` naming the missing
    files when one is absent (nothing is downloaded)."""
    files = mag_raw_files(root)
    missing = [p for p in files.values() if not os.path.exists(p)]
    if missing:
        raise RuntimeError(
            f"no complete ogbn-mag raw cache under {root!r}: missing {missing} (the "
            "files OGB's NodePropPredDataset writes); use --dataset synthetic")
    with gzip.open(files["num_nodes"], "rt") as f:
        names = f.readline().strip().split(",")
        counts = [int(float(v)) for v in f.readline().strip().split(",")]
    num_nodes_dict = dict(zip(names, counts))
    edge_index_dict = {rel: _read_csv(files["___".join(rel)], np.int64).T
                       for rel in MAG_RELATIONS}
    return MagDataset(
        grouped=mag_preprocess(edge_index_dict, num_nodes_dict),
        x_paper=_read_csv(files["feat"], np.float32),
        y_paper=_read_csv(files["label"], np.int32).reshape(-1),
        split_idx={k: _read_csv(files[k], np.int64).reshape(-1) for k in _SPLITS},
        num_classes=349,
        num_nodes_dict=num_nodes_dict,
        num_edge_types=7,
    )
