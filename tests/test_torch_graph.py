"""Port vs JAX: graph build and synthetic data.

The port's ``build_graph`` must give the same index arrays as the JAX
package's (bit for bit: both sort by (receiver, sender) with a stable sort)
and the same GCN weights (allclose: both compute them in float64 and round
to float32). The synthetic dataset must draw the same NumPy stream.
"""

import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data import synthetic_node_dataset as jax_synthetic
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.graphs import gcn_norm_weights as jax_gcn_norm_weights
from efficient_gnns_tpu.graphs.preprocess import induced_subgraph as jax_induced_subgraph
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.graphs import build_graph, gcn_norm_weights, induced_subgraph

INDEX_FIELDS = ("senders", "receivers", "t_senders", "t_receivers",
                "csc_perm", "row_offsets", "t_row_offsets")


def _edges(rng, n, e):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n // 2, size=e)  # the upper half of the rows stay empty
    r[: e // 4] = 3  # one high-degree receiver
    return s, r


def assert_same_graph(jg, tg):
    for name in INDEX_FIELDS:
        got = getattr(tg, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.num_nodes == jg.num_nodes
    assert tg.n_edge == int(jg.n_edge)
    np.testing.assert_array_equal(tg.node_mask.numpy(), np.asarray(jg.node_mask))
    if jg.edge_weight is None:
        assert tg.edge_weight is None and tg.t_edge_weight is None
    else:
        w = np.asarray(jg.edge_weight)
        np.testing.assert_allclose(tg.edge_weight.numpy(), w, rtol=1e-7, atol=0)
        np.testing.assert_allclose(tg.t_edge_weight.numpy(),
                                   w[np.asarray(jg.csc_perm)], rtol=1e-7, atol=0)
    if jg.node_scale is None:
        assert tg.node_scale is None
    else:
        assert tg.node_scale.dtype == torch.float32
        np.testing.assert_allclose(tg.node_scale.numpy(), np.asarray(jg.node_scale),
                                   rtol=1e-7, atol=0)


CASES = {
    "unweighted": dict(),
    "gcn_norm": dict(bidirected=True, self_loops=True, gcn_norm=True),
    "edge_weight": dict(edge_weight="random"),
    "padded_nodes": dict(self_loops=True, gcn_norm=True, pad_nodes_to=150,
                         n_node_valid=120),
    "factored": dict(bidirected=True, self_loops=True, gcn_norm="factored"),
    "factored_padded": dict(self_loops=True, gcn_norm="factored", pad_nodes_to=150,
                            n_node_valid=120),
}


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_graph_matches_jax(rng, case, block):
    n, e = 120, 700
    s, r = _edges(rng, n, e)
    kwargs = dict(CASES[case])
    if kwargs.get("edge_weight") == "random":
        kwargs["edge_weight"] = rng.normal(size=e).astype(np.float32)
    jg = jax_build_graph(s, r, n, edge_pad_multiple=64, block=block, **kwargs)
    tg = build_graph(s, r, n, edge_pad_multiple=64, **kwargs)
    assert_same_graph(jg, tg)
    # padding edges point one past the last node and lie past row_offsets[N]
    assert int(tg.row_offsets[-1]) == tg.n_edge < tg.num_edges_padded
    assert bool((tg.receivers[tg.n_edge:] == tg.num_nodes).all())


@pytest.mark.parametrize("gcn_norm", [True, "factored"])
def test_transpose_matches_jax(rng, gcn_norm):
    s, r = _edges(rng, 80, 400)
    jg = jax_build_graph(s, r, 80, edge_pad_multiple=64, gcn_norm=gcn_norm).transpose()
    tg = build_graph(s, r, 80, edge_pad_multiple=64, gcn_norm=gcn_norm).transpose()
    assert_same_graph(jg, tg)


@pytest.mark.parametrize("self_loops", [False, True])
def test_gcn_norm_weights_match_jax(rng, self_loops):
    s, r = _edges(rng, 120, 700)
    kw = dict(edge_pad_multiple=64, self_loops=self_loops)
    jg = jax_gcn_norm_weights(jax_build_graph(s, r, 120, **kw))
    bare = build_graph(s, r, 120, **kw)
    tg = gcn_norm_weights(bare)
    assert bare.edge_weight is None  # a copy: the input graph is left as it was
    assert_same_graph(jg, tg)
    assert not tg.edge_weight[tg.n_edge:].any()
    if self_loops:  # with self loops it is build_graph's fused norm
        fused = build_graph(s, r, 120, gcn_norm=True, **kw)
        np.testing.assert_allclose(tg.edge_weight.numpy(), fused.edge_weight.numpy(),
                                   rtol=1e-6)


@pytest.mark.parametrize("order", ["sorted", "shuffled", "empty"])
def test_induced_subgraph_matches_jax(rng, order):
    s, r = _edges(rng, 120, 700)
    nodes = np.sort(rng.choice(120, size=50, replace=False))
    if order == "shuffled":  # the order of node_ids defines the new labels
        nodes = rng.permutation(nodes)
    elif order == "empty":  # no edge survives: nodes that never meet
        nodes = np.array([118, 119])
    jg = jax_induced_subgraph(s, r, nodes, edge_pad_multiple=64)
    tg = induced_subgraph(s, r, nodes, edge_pad_multiple=64)
    assert_same_graph(jg, tg)
    assert tg.num_nodes == len(nodes)
    if order != "empty":
        assert 0 < tg.n_edge < 700


def test_to_device_keeps_fields(rng):
    s, r = _edges(rng, 40, 100)
    tg = build_graph(s, r, 40, edge_pad_multiple=64, gcn_norm=True)
    moved = tg.to("cpu")
    for name in INDEX_FIELDS + ("edge_weight", "t_edge_weight", "node_mask"):
        assert torch.equal(getattr(moved, name), getattr(tg, name)), name
    assert (moved.num_nodes, moved.n_edge) == (tg.num_nodes, tg.n_edge)
    factored = build_graph(s, r, 40, edge_pad_multiple=64, gcn_norm="factored")
    assert torch.equal(factored.to("cpu").node_scale, factored.node_scale)


def test_int32_guard():
    with pytest.raises(ValueError, match="int32"):
        build_graph(np.zeros(1), np.zeros(1), 4, pad_edges_to=2**31)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(label_noise=0.1, feat_sparse=0.2, n_super=5, signal=0.5, train_frac=0.3),
])
def test_synthetic_dataset_matches_jax(kwargs):
    jd = jax_synthetic(num_nodes=2000, num_edges=12000, seed=3, **kwargs)
    td = synthetic_node_dataset(num_nodes=2000, num_edges=12000, seed=3, **kwargs)
    np.testing.assert_array_equal(td.x, jd.x)
    np.testing.assert_array_equal(td.y, jd.y)
    for k in ("train", "valid", "test"):
        np.testing.assert_array_equal(td.split_idx[k], jd.split_idx[k])
    np.testing.assert_array_equal(td.senders, jd.senders)
    np.testing.assert_array_equal(td.receivers, jd.receivers)
    assert td.num_classes == jd.num_classes and td.num_nodes == jd.num_nodes
    assert_same_graph(jd.graph, td.graph)
