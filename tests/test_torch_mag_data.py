"""Port vs JAX: the ogbn-mag data (``graphs/hetero.py``, ``data/mag.py``)
and the raw-cache loader.

The grouping, the relation augmentation and the synthetic generator are
NumPy in both packages: the same inputs (and the same seed) give equal
arrays. The JAX loader needs the ``ogb`` package; the port reads OGB's raw
cache with gzip + NumPy, so its loader is held against a cache written here
from a synthetic dataset's own relations.
"""

import gzip
import os

import numpy as np
import pytest

from efficient_gnns_tpu.data import mag as jax_mag
from efficient_gnns_tpu.graphs import hetero as jax_hetero
from efficient_gnns_tpu_torch.data import load_ogbn_mag, synthetic_mag_dataset
from efficient_gnns_tpu_torch.data.mag import MAG_RELATIONS, mag_raw_files
from efficient_gnns_tpu_torch.graphs import group_hetero_graph, mag_preprocess

SMALL = dict(n_paper=300, n_author=150, n_inst=10, n_field=30, feat_dim=16, num_classes=4)


def _assert_grouped_equal(got, want):
    for field in ("edge_index", "edge_type", "node_type", "local_node_idx"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.key2int == want.key2int
    assert got.local2global.keys() == want.local2global.keys()
    for k in want.local2global:
        np.testing.assert_array_equal(got.local2global[k], want.local2global[k])


def _relations(rng, n):
    return {
        ("author", "affiliated_with", "institution"): rng.integers(0, [[n["author"]], [n["institution"]]], size=(2, 40)),
        ("author", "writes", "paper"): rng.integers(0, [[n["author"]], [n["paper"]]], size=(2, 90)),
        ("paper", "cites", "paper"): rng.integers(0, n["paper"], size=(2, 120)),
        ("paper", "has_topic", "field_of_study"): rng.integers(0, [[n["paper"]], [n["field_of_study"]]], size=(2, 70)),
    }


def test_group_hetero_graph_and_mag_preprocess_equal_jax(rng):
    ei = {("a", "r1", "b"): np.array([[0, 1], [0, 1]]), ("b", "r2", "a"): np.array([[0], [2]])}
    _assert_grouped_equal(group_hetero_graph(ei, {"a": 3, "b": 2}),
                          jax_hetero.group_hetero_graph(ei, {"a": 3, "b": 2}))
    n = {"paper": 50, "author": 30, "institution": 4, "field_of_study": 9}
    rel = _relations(rng, n)
    got, want = mag_preprocess(rel, n), jax_hetero.mag_preprocess(rel, n)
    _assert_grouped_equal(got, want)
    assert got.edge_type.max() == 6
    cites = got.edge_index[:, got.edge_type == got.key2int[("paper", "cites", "paper")]]
    pairs = set(map(tuple, cites.T.tolist()))
    assert all((b, a) in pairs for a, b in pairs)  # undirected


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=7, avg_cites=3, homophily=0.0),
    dict(seed=1, signal=0.3, label_noise=0.2, homophily=0.7, num_classes=6),
])
def test_synthetic_mag_dataset_equals_jax(kw):
    got = synthetic_mag_dataset(**{**SMALL, **kw})
    want = jax_mag.synthetic_mag_dataset(**{**SMALL, **kw})
    _assert_grouped_equal(got.grouped, want.grouped)
    for field in ("x_paper", "y_paper"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for k in ("train", "valid", "test"):
        np.testing.assert_array_equal(got.split_idx[k], want.split_idx[k])
    assert (got.num_classes, got.num_edge_types, got.num_nodes_dict) == (
        want.num_classes, want.num_edge_types, want.num_nodes_dict)


def _write(path, rows, fmt):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        np.savetxt(f, rows, fmt=fmt, delimiter=",")


def write_mag_cache(root, rel, num_nodes, x, y, split_idx):
    """An ogbn-mag raw cache as OGB writes it: relations ``[E, 2]``, the
    node-count header and row, paper features, labels and time splits."""
    files = mag_raw_files(root)
    for r in MAG_RELATIONS:
        _write(files["___".join(r)], np.asarray(rel[r]).T, "%d")
    os.makedirs(os.path.dirname(files["num_nodes"]), exist_ok=True)
    names = sorted(num_nodes)
    with gzip.open(files["num_nodes"], "wt") as f:
        f.write(",".join(names) + "\n" + ",".join(str(num_nodes[k]) for k in names) + "\n")
    _write(files["feat"], x, "%.9g")
    _write(files["label"], y[:, None], "%d")
    for k, v in split_idx.items():
        _write(files[k], v[:, None], "%d")


def test_raw_cache_reads_back_and_a_missing_file_raises(tmp_path, rng):
    n = {"paper": 60, "author": 40, "institution": 5, "field_of_study": 7}
    rel = _relations(rng, n)
    x = rng.normal(size=(n["paper"], 8)).astype(np.float32)
    y = rng.integers(0, 349, size=n["paper"]).astype(np.int32)
    perm = rng.permutation(n["paper"])
    split_idx = {"train": perm[:30], "valid": perm[30:45], "test": perm[45:]}
    root = tmp_path / "ogbn_mag_root"
    write_mag_cache(str(root / "ogbn_mag"), rel, n, x, y, split_idx)
    ds = load_ogbn_mag(str(root))  # finds the ogbn_mag directory itself
    _assert_grouped_equal(ds.grouped, jax_hetero.mag_preprocess(rel, n))
    np.testing.assert_array_equal(ds.x_paper, x)
    np.testing.assert_array_equal(ds.y_paper, y)
    assert ds.x_paper.dtype == np.float32 and ds.y_paper.dtype == np.int32
    for k in split_idx:
        np.testing.assert_array_equal(ds.split_idx[k], split_idx[k])
    assert (ds.num_classes, ds.num_edge_types, ds.num_nodes_dict) == (349, 7, n)

    os.remove(mag_raw_files(str(root))["paper___cites___paper"])
    with pytest.raises(RuntimeError, match="paper___cites___paper"):
        load_ogbn_mag(str(root))
    with pytest.raises(RuntimeError, match="num-node-dict"):
        load_ogbn_mag(str(tmp_path / "nothing"))
