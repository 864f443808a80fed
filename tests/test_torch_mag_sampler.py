"""Port vs JAX: the typed graph (``Graph.edge_type``, ``build_graph`` with
types and ``max_dst``), the GraphSAINT sampler with its typed square layout
(``sampling/saint.py``), the port's loader of the native walker
(``native/host.py``) and the row split taken without a host copy.

Both samplers draw from ``np.random.default_rng(seed)`` in the same order,
with the native walker (``tests/conftest.py`` builds it) or, both forced to
it, the NumPy walk: three consecutive samples are equal array for array.
The roots stay below 4,096, so the native walker runs one thread.
"""

import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data.mag import synthetic_mag_dataset as jax_mag_dataset
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.native import host as jax_host
from efficient_gnns_tpu.sampling.saint import GraphSaintRandomWalkSampler as JaxSampler
from efficient_gnns_tpu_torch.data import synthetic_mag_dataset
from efficient_gnns_tpu_torch.graphs import build_graph, build_row_split, row_split
from efficient_gnns_tpu_torch.native import host
from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum
from efficient_gnns_tpu_torch.sampling import GraphSaintRandomWalkSampler

MAG = dict(n_paper=400, n_author=200, n_inst=12, n_field=40, feat_dim=8, num_classes=4,
           seed=2)
GRAPH_FIELDS = ("senders", "receivers", "t_senders", "t_receivers", "csc_perm", "row_offsets",
                "t_row_offsets", "edge_weight", "edge_type")


def _assert_graph_equal(got, want):
    assert got.num_nodes == want.num_nodes
    assert got.n_edge == int(want.n_edge)
    for f in GRAPH_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    np.testing.assert_array_equal(got.node_mask.numpy(), np.asarray(want.node_mask))


def test_typed_build_graph_equals_jax(rng):
    n, e, nr = 40, 300, 5
    s, r = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
    et = rng.integers(0, nr, size=e)
    kw = dict(edge_type=et, num_edge_types=nr, pad_nodes_to=48, pad_edges_to=512, n_node_valid=n)
    g, jg = build_graph(s, r, n, **kw), jax_build_graph(s, r, n, **kw)
    _assert_graph_equal(g, jg)
    assert int(g.edge_type[g.n_edge:].min()) == nr  # padding carries R
    _assert_graph_equal(g.transpose(), jg.transpose())
    # the tall typed layout: R * nb rows, receivers below nb
    cell = et * n + r
    w = 1.0 / np.maximum(np.bincount(cell, minlength=nr * n)[cell], 1)
    tkw = dict(edge_weight=w, pad_edges_to=512, n_node_valid=n - 3)
    t = build_graph(s + et * n, r, nr * n, max_dst=n, **tkw)
    _assert_graph_equal(t, jax_build_graph(s + et * n, r, nr * n, **tkw))
    assert t.max_dst == n and t.transpose().max_dst is None
    want = build_row_split(t.row_offsets[:n + 1])
    assert t.dst_row_split.num_rows == n and t.dst_row_split.num_edges == t.n_edge
    assert torch.equal(t.dst_row_split.chunks, want.chunks)
    with pytest.raises(ValueError, match="max_dst"):
        build_graph(s, r, n, max_dst=int(r.max()))


def _samplers(typed, seed=0, batch_size=150, walk_length=3):
    jds, tds = jax_mag_dataset(**MAG), synthetic_mag_dataset(**MAG)
    out = []
    for cls, ds in ((JaxSampler, jds), (GraphSaintRandomWalkSampler, tds)):
        g = ds.grouped
        out.append(cls(g.edge_index[0], g.edge_index[1], g.node_type.shape[0],
                       batch_size=batch_size, walk_length=walk_length,
                       edge_type=g.edge_type, num_edge_types=7, seed=seed,
                       typed_square=typed))
    return out


@pytest.mark.parametrize("walker", ["native", "numpy"])
@pytest.mark.parametrize("typed", [True, False])
def test_three_samples_equal_jax(monkeypatch, walker, typed):
    if walker == "numpy":
        monkeypatch.setattr(jax_host, "available", lambda: False)
        monkeypatch.setattr(host, "available", lambda: False)
    else:
        assert host.available() and jax_host.available(), "the native walker is not built"
    jax_sampler, sampler = _samplers(typed, batch_size=150 if typed else 90)
    assert sampler.node_budget == jax_sampler.node_budget
    assert sampler.edge_budget == jax_sampler.edge_budget
    shapes = set()
    for _ in range(3):
        want, got = jax_sampler.sample(), sampler.sample()
        np.testing.assert_array_equal(got.node_ids, want.node_ids)
        assert (got.num_nodes, got.dropped_edges) == (want.num_nodes, want.dropped_edges)
        _assert_graph_equal(got.graph, want.graph)
        assert (got.typed_graph is None) == (not typed)
        if typed:
            _assert_graph_equal(got.typed_graph, want.typed_graph)
            assert got.typed_graph.max_dst == sampler.node_budget
        shapes.add(tuple(tuple(getattr(g, f).shape) for g in (got.graph, got.typed_graph)
                         if g is not None for f in GRAPH_FIELDS if getattr(g, f) is not None))
    assert len(shapes) == 1  # static shapes across samples


def test_over_budget_samples_drop_edges_as_jax():
    # an edge budget far below the induced edges: rng.choice draws the kept ones
    jds, tds = jax_mag_dataset(**MAG), synthetic_mag_dataset(**MAG)
    subs = []
    for cls, ds in ((JaxSampler, jds), (GraphSaintRandomWalkSampler, tds)):
        g = ds.grouped
        sampler = cls(g.edge_index[0], g.edge_index[1], g.node_type.shape[0], batch_size=120,
                      walk_length=2, edge_budget=1024, edge_type=g.edge_type,
                      num_edge_types=7, seed=4, typed_square=True)
        subs.append([sampler.sample() for _ in range(2)])
    for want, got in zip(*subs):
        assert got.dropped_edges == want.dropped_edges > 0
        np.testing.assert_array_equal(got.node_ids, want.node_ids)
        _assert_graph_equal(got.typed_graph, want.typed_graph)


def test_native_walker_loader():
    assert host.walker() == ("native" if host.available() else "numpy")
    offsets = np.array([0, 2, 3, 3], np.int32)  # node 2 is a dead end
    nbrs = np.array([1, 2, 2], np.int32)
    walks = host.random_walks(offsets, nbrs, np.array([0, 1, 2], np.int32), 4, seed=5)
    assert walks.shape == (3, 5) and walks.dtype == np.int32
    np.testing.assert_array_equal(walks[:, 0], [0, 1, 2])
    np.testing.assert_array_equal(walks[2], [2] * 5)
    np.testing.assert_array_equal(walks, jax_host.random_walks(
        offsets, nbrs, np.array([0, 1, 2], np.int32), 4, seed=5))


def _typed_square(rng, nb=90, num_types=7, e=900):
    s, r = rng.integers(0, nb, size=e), rng.integers(0, nb, size=e)
    r[: e // 3] = 0  # receiver 0: a long row, so the split has chunks
    et = rng.integers(0, num_types, size=e)
    cell = et * nb + r
    w = 1.0 / np.maximum(np.bincount(cell, minlength=num_types * nb)[cell], 1)
    return build_graph(s + et * nb, r, num_types * nb, edge_weight=w, edge_pad_multiple=256,
                       max_dst=nb)


def test_built_splits_are_taken_without_a_host_copy(monkeypatch, rng):
    # a pair that build_graph made, moved with Graph.to, is not rebuilt by
    # check_split; a split met with other offsets still is, and is refused
    _, sampler = _samplers(True)
    graphs = [_typed_square(rng).to("cpu"), sampler.sample().typed_graph.to("cpu")]
    assert graphs[0].dst_row_split.num_long == 1

    def no_rebuild(*a, **k):
        raise AssertionError("check_split rebuilt a split that build_graph made")

    monkeypatch.setattr(row_split, "build_row_split", no_rebuild)
    for g in graphs:
        nb = g.max_dst
        x, gy = torch.randn(g.num_nodes, 4), torch.randn(nb, 4)
        torch.testing.assert_close(
            csr_segment_sum(x, g.senders, g.row_offsets[:nb + 1], g.edge_weight,
                            g.dst_row_split),
            csr_segment_sum(x, g.senders, g.row_offsets, g.edge_weight, g.row_split)[:nb])
        csr_segment_sum(gy, g.t_senders, g.t_row_offsets, g.t_edge_weight, g.t_row_split)
    monkeypatch.undo()
    g = graphs[0]
    nb = g.max_dst
    x = torch.randn(g.num_nodes, 4)
    other = g.t_row_offsets[:nb + 1].contiguous()  # same shape, other offsets
    with pytest.raises(ValueError, match="row split was not built from"):
        csr_segment_sum(x, g.senders, other, g.edge_weight, g.dst_row_split)
    edited = g.row_offsets.clone()
    split = build_row_split(edited[:nb + 1])
    csr_segment_sum(x, g.senders, edited[:nb + 1], g.edge_weight, split)
    edited[1:] = edited[-1]  # every edge moves to row 0: the pair is checked anew
    with pytest.raises(ValueError, match="row split was not built from"):
        csr_segment_sum(x, g.senders, edited[:nb + 1], g.edge_weight, split)
