"""Port vs JAX: the PPI data (``data/ppi.py``): the synthetic generator, the
loader of the torch-geometric raw files and micro-F1.

The generator draws the same NumPy stream in both packages, so a seed gives
every array of every graph bit for bit; the loader reads one small cache,
written here, into the same arrays.
"""

import json
import os

import numpy as np
import pytest

from efficient_gnns_tpu.data import ppi as jax_ppi
from efficient_gnns_tpu_torch.data import load_ppi, micro_f1, synthetic_ppi_dataset

_GRAPH_ARRAYS = ("senders", "receivers", "t_senders", "t_receivers", "csc_perm",
                 "row_offsets", "t_row_offsets", "node_mask")


def _assert_same_dataset(got, want):
    assert (got.feat_dim, got.num_labels) == (want.feat_dim, want.num_labels)
    for split in ("train", "valid", "test"):
        gs, ws = getattr(got, split), getattr(want, split)
        assert len(gs) == len(ws) > 0
        for g, w in zip(gs, ws):
            assert g.num_nodes == w.num_nodes
            assert g.x.dtype == w.x.dtype == g.y.dtype == np.float32
            np.testing.assert_array_equal(g.x, w.x)
            np.testing.assert_array_equal(g.y, w.y)
            assert (g.graph.num_nodes, g.graph.n_edge, g.graph.num_edges_padded) == (
                w.graph.num_nodes, int(w.graph.n_edge), w.graph.num_edges_padded)
            for name in _GRAPH_ARRAYS:
                np.testing.assert_array_equal(getattr(g.graph, name).numpy(),
                                              np.asarray(getattr(w.graph, name)),
                                              err_msg=f"{split} {name}")


@pytest.mark.parametrize("kw", [
    dict(n_train=3, n_valid=1, n_test=1, min_nodes=40, max_nodes=80, avg_deg=5,
         feat_dim=16, num_labels=12, seed=0),
    dict(seed=42),  # the CLI's --dataset synthetic
])
def test_synthetic_ppi_dataset_matches_jax(kw):
    got, want = synthetic_ppi_dataset(**kw), jax_ppi.synthetic_ppi_dataset(**kw)
    _assert_same_dataset(got, want)
    g = got.train[0]
    assert g.graph.row_split.num_long == 0  # no row above 128 edges
    assert not g.x[g.num_nodes:].any() and not g.graph.node_mask[g.num_nodes:].any()
    assert 0.1 < g.y[: g.num_nodes].mean() < 0.6  # correlated labels, about 30%


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_micro_f1_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(200, 13)).astype(np.float32)
    labels = (rng.random((200, 13)) < 0.3).astype(np.float32)
    assert micro_f1(logits, labels) == jax_ppi.micro_f1(logits, labels)
    assert micro_f1(np.full((3, 2), -1.0), np.zeros((3, 2))) == 0.0  # no positive at all


def _write_cache(root, rng):
    """A raw cache of the torch-geometric layout: per split, node-link JSON
    with a ``links`` list (one direction, a few self loops and duplicates),
    features, labels and the graph id of each node (contiguous ids)."""
    os.makedirs(root, exist_ok=True)
    for split, sizes in (("train", (30, 45, 20)), ("valid", (25,)), ("test", (35, 18))):
        links, gid, start = [], [], 0
        for g, n in enumerate(sizes):
            s = rng.integers(0, n, size=3 * n) + start
            r = rng.integers(0, n, size=3 * n) + start
            s[:2] = r[:2]  # raw self loops, which the loader drops
            links += [{"source": int(a), "target": int(b)} for a, b in zip(s, r)]
            gid += [g + 1] * n
            start += n
        with open(os.path.join(root, f"{split}_graph.json"), "w") as f:
            json.dump({"directed": False, "multigraph": False, "graph": {},
                       "nodes": [{"id": i} for i in range(start)], "links": links}, f)
        np.save(os.path.join(root, f"{split}_feats.npy"),
                rng.normal(size=(start, 7)).astype(np.float32))
        np.save(os.path.join(root, f"{split}_labels.npy"),
                (rng.random((start, 5)) < 0.4).astype(np.float32))
        np.save(os.path.join(root, f"{split}_graph_id.npy"), np.asarray(gid, np.int64))


def test_load_ppi_matches_jax(tmp_path, rng):
    root = str(tmp_path / "ppi")
    _write_cache(root, rng)
    got, want = load_ppi(root), jax_ppi.load_ppi(root)
    _assert_same_dataset(got, want)
    assert [g.num_nodes for g in got.train] == [30, 45, 20]
    # one budget for every split: the largest graph's nodes and edges
    assert got.train[0].graph.num_nodes == got.test[0].graph.num_nodes == 128
    g = got.valid[0].graph
    assert int(g.receivers[: g.n_edge].eq(g.senders[: g.n_edge]).sum()) == 25  # one loop a node


def test_load_ppi_raises_on_a_missing_file(tmp_path, rng):
    root = str(tmp_path / "ppi")
    with pytest.raises(FileNotFoundError, match="PPI raw cache incomplete"):
        load_ppi(root)
    _write_cache(root, rng)
    os.remove(os.path.join(root, "valid_labels.npy"))
    with pytest.raises(FileNotFoundError, match="valid_labels.npy"):
        load_ppi(root)
