"""Port vs JAX: the ogbn-arxiv loader on a small raw cache written here.

The port reads the cache with gzip and NumPy, the JAX loader with pandas;
the datasets must be equal: features, labels and splits exactly, the
graph's index arrays and weights exactly. No download: a missing cache
raises ``RuntimeError``. Every CLI of the port trains on the cache.
"""

import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data.ogb import load_ogbn_arxiv as jax_load_ogbn_arxiv
from efficient_gnns_tpu_torch.cli import arxiv as arxiv_cli
from efficient_gnns_tpu_torch.cli import gat_teacher as teacher_cli
from efficient_gnns_tpu_torch.cli import sign as sign_cli
from efficient_gnns_tpu_torch.data import load_ogbn_arxiv
from efficient_gnns_tpu_torch.graphs import build_graph

INDEX_FIELDS = ("senders", "receivers", "t_senders", "t_receivers", "csc_perm",
                "row_offsets", "t_row_offsets")


def _write_arxiv_cache(root, rng, n=50, e=200, f=8, c=5, subdir="ogbn_arxiv"):
    raw = os.path.join(root, subdir, "raw")
    split = os.path.join(root, subdir, "split", "time")
    os.makedirs(raw, exist_ok=True)
    os.makedirs(split, exist_ok=True)
    edges = rng.integers(0, n, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, size=n)

    def put(path, arr, fmt):
        with gzip.open(path, "wt") as fh:
            for row in np.atleast_2d(arr):
                fh.write(",".join(fmt % v for v in np.atleast_1d(row)) + "\n")

    put(os.path.join(raw, "edge.csv.gz"), edges, "%d")
    put(os.path.join(raw, "node-feat.csv.gz"), x, "%.6f")
    put(os.path.join(raw, "node-label.csv.gz"), y[:, None], "%d")
    perm = rng.permutation(n)
    for name, sel in (("train", perm[:30]), ("valid", perm[30:40]),
                      ("test", perm[40:])):
        put(os.path.join(split, f"{name}.csv.gz"), np.asarray(sel)[:, None], "%d")
    return edges, x, y


def _assert_same_dataset(tds, jds):
    assert tds.num_nodes == jds.num_nodes and tds.num_classes == jds.num_classes == 40
    assert tds.x.dtype == np.float32 and tds.y.dtype == np.int32
    np.testing.assert_array_equal(tds.x, np.asarray(jds.x))
    np.testing.assert_array_equal(tds.y, np.asarray(jds.y))
    np.testing.assert_array_equal(tds.senders, np.asarray(jds.senders))
    np.testing.assert_array_equal(tds.receivers, np.asarray(jds.receivers))
    assert set(tds.split_idx) == set(jds.split_idx) == {"train", "valid", "test"}
    for k, v in tds.split_idx.items():
        assert v.dtype == np.int32 and (np.diff(v) > 0).all()
        np.testing.assert_array_equal(v, np.asarray(jds.split_idx[k]))
    tg, jg = tds.graph, jds.graph
    assert tg.n_edge == int(jg.n_edge)
    for name in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    if jg.edge_weight is None:
        assert tg.edge_weight is None
    else:
        np.testing.assert_array_equal(tg.edge_weight.numpy(), np.asarray(jg.edge_weight))


@pytest.mark.parametrize("gcn_norm", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_loader_matches_jax(tmp_path, gcn_norm, seed):
    edges, x, y = _write_arxiv_cache(tmp_path, np.random.default_rng(seed))
    tds = load_ogbn_arxiv(root=str(tmp_path), hub_dense=0, gcn_norm=gcn_norm)
    jds = jax_load_ogbn_arxiv(root=str(tmp_path), hub_dense=0, gcn_norm=gcn_norm)
    _assert_same_dataset(tds, jds)
    np.testing.assert_allclose(tds.x, x, atol=1e-6)  # "%.6f" in the cache
    np.testing.assert_array_equal(tds.y, y)
    np.testing.assert_array_equal(np.stack([tds.senders, tds.receivers], 1), edges)
    # bidirected and self-looped over the raw edges, as build_graph makes it
    want = build_graph(edges[:, 0], edges[:, 1], 50, bidirected=True, self_loops=True,
                       gcn_norm=gcn_norm)
    for name in INDEX_FIELDS:
        assert torch.equal(getattr(tds.graph, name), getattr(want, name)), name


def test_loader_reads_a_cache_without_the_subdirectory(tmp_path):
    _write_arxiv_cache(tmp_path, np.random.default_rng(3), subdir="")
    tds = load_ogbn_arxiv(root=str(tmp_path), hub_dense=0)
    jds = jax_load_ogbn_arxiv(root=str(tmp_path), hub_dense=0)
    _assert_same_dataset(tds, jds)


def test_loader_needs_no_pandas(tmp_path, monkeypatch):
    _write_arxiv_cache(tmp_path, np.random.default_rng(4))
    want = load_ogbn_arxiv(root=str(tmp_path), hub_dense=0)
    monkeypatch.setitem(sys.modules, "pandas", None)  # any import of it raises
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    got = load_ogbn_arxiv(root=str(tmp_path), hub_dense=0)
    np.testing.assert_array_equal(got.x, want.x)
    assert torch.equal(got.graph.senders, want.graph.senders)


@pytest.mark.parametrize("missing", ["edge.csv.gz", "test.csv.gz", None])
def test_missing_cache_raises(tmp_path, missing):
    if missing is not None:
        _write_arxiv_cache(tmp_path, np.random.default_rng(5))
        for d, _, files in os.walk(tmp_path):
            if missing in files:
                os.remove(os.path.join(d, missing))
    with pytest.raises(RuntimeError, match="no ogbn-arxiv raw cache"):
        load_ogbn_arxiv(root=str(tmp_path))


def test_student_cli_trains_on_the_cache(tmp_path):
    _write_arxiv_cache(tmp_path, np.random.default_rng(6))
    out = tmp_path / "out"
    summary = arxiv_cli.main([
        "--dataset", "ogbn-arxiv", "--data_root", str(tmp_path), "--device", "cpu",
        "--epochs", "1", "--runs", "1", "--hidden_channels", "16", "--out_dir", str(out)])
    assert summary["runs"][0]["seconds"] > 0
    with open(out / "debug" / "gcn-supervised" / "seed0" / "metrics.jsonl") as f:
        assert np.isfinite(json.loads(f.readline())["loss/train"])


def test_teacher_cli_trains_on_the_cache(tmp_path):
    _write_arxiv_cache(tmp_path, np.random.default_rng(7))
    summary = teacher_cli.main([
        "--dataset", "ogbn-arxiv", "--data-root", str(tmp_path), "--device", "cpu",
        "--n-epochs", "1", "--n-runs", "1", "--n-hidden", "8", "--n-heads", "2",
        "--out-dir", str(tmp_path / "out")])
    assert len(summary["runs"][0]["losses"]) == 1
    assert np.isfinite(summary["runs"][0]["losses"]).all()


def test_sign_cli_trains_on_the_cache(tmp_path):
    _write_arxiv_cache(tmp_path, np.random.default_rng(8))
    summary = sign_cli.main([
        "--dataset", "ogbn-arxiv", "--data_root", str(tmp_path), "--device", "cpu",
        "--num_epochs", "1", "--num_runs", "1", "--num_hidden", "16", "--R", "2",
        "--batch_size", "16", "--out_dir", str(tmp_path / "out")])
    assert np.isfinite(summary["runs"][0]["losses"]).all()


def test_student_cli_refuses_an_unknown_dataset():
    with pytest.raises(ValueError, match="ogbn-arxiv"):
        arxiv_cli.main(["--dataset", "ogbn-products", "--device", "cpu"])
    with pytest.raises(ValueError, match="ogbn-arxiv"):
        teacher_cli.main(["--dataset", "ogbn-products", "--device", "cpu"])
