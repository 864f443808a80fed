"""The port's row split (``graphs/row_split.py``): the chunk schedule that K1
and K2 walk to cut power-law hub rows into independent units.

On the CPU the kernels do not run, so these tests hold the *schedule*: it
covers every real edge exactly once and no padding edge, its chunks never
cross a row, its partial slots are in (row, chunk) order, and executing it in
plain PyTorch (:func:`segment_sum_by_split`: chunk partials, then each long
row's partials summed in slot order) gives what ``csr_segment_sum_plain`` and
``csr_segment_sum_heads_plain`` give, on the graphs of
``tests/test_torch_spmm.py`` with a small chunk size forced through the
build function's argument. Tolerance in float32: atol 1e-5 plus rtol 1e-5 of each
output's sum of absolute terms, because the two sum a long row's edges in a
different order (chunk by chunk against ``index_add_`` in edge order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch.graphs import (
    ROW_SPLIT_THRESHOLD,
    build_graph,
    build_row_split,
    gcn_norm_weights,
    induced_subgraph,
    segment_sum_by_split,
)
from efficient_gnns_tpu_torch.ops import spmm
from efficient_gnns_tpu_torch.ops.cuda import (
    csr_segment_sum,
    csr_segment_sum_heads,
    csr_segment_sum_heads_plain,
    csr_segment_sum_plain,
)
from efficient_gnns_tpu_torch.ops.segment import gather

CASES = ["random", "empty_rows", "high_degree", "multi_edges"]
N = 150


def _edges(rng, case, n=N, e=600):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    if case == "empty_rows":
        r = rng.integers(0, n // 3, size=e)
    elif case == "high_degree":  # one receiver owns 2/3 of the edges
        r[e // 3:] = 0
    elif case == "multi_edges":
        s[: e // 2] = s[e // 2:]
        r[: e // 2] = r[e // 2:]
    return s, r


def _graph(rng, case, **kwargs):
    s, r = _edges(rng, case)
    g = build_graph(s, r, N, edge_pad_multiple=64, **kwargs)
    assert g.n_edge < g.num_edges_padded  # padding edges present
    return g


def _same_split(a, b):
    return (a.threshold == b.threshold and a.num_rows == b.num_rows
            and a.num_edges == b.num_edges and torch.equal(a.long_rows, b.long_rows)
            and torch.equal(a.chunks, b.chunks) and torch.equal(a.long_first, b.long_first))


@pytest.mark.parametrize("threshold", [1, 4, 7, 128])
@pytest.mark.parametrize("direction", ["forward", "transpose"])
@pytest.mark.parametrize("case", CASES)
def test_schedule_covers_every_real_edge_once(rng, case, direction, threshold):
    g = _graph(rng, case)
    ro = (g.row_offsets if direction == "forward" else g.t_row_offsets).numpy()
    split = build_row_split(ro, threshold)
    deg = np.diff(ro)
    long_rows = split.long_rows.numpy()
    np.testing.assert_array_equal(long_rows, np.flatnonzero(deg > threshold))
    row, begin, end = split.chunks.numpy().T
    # a chunk lies inside its row and holds 1..threshold edges
    assert np.all(begin >= ro[row]) and np.all(end <= ro[row + 1])
    assert np.all(end - begin >= 1) and np.all(end - begin <= threshold)
    # slots are in (row, chunk) order: rows ascending, chunks back to back
    first = split.long_first.numpy()
    assert first[0] == 0 and first[-1] == split.num_chunks
    for i, r in enumerate(long_rows):
        sl = slice(first[i], first[i + 1])
        assert np.all(row[sl] == r)
        assert begin[sl][0] == ro[r] and end[sl][-1] == ro[r + 1]
        np.testing.assert_array_equal(begin[sl][1:], end[sl][:-1])
    # short rows and chunks together cover each real edge once, no padding edge
    cover = np.zeros(g.num_edges_padded, dtype=np.int64)
    for r in np.flatnonzero(deg <= threshold):
        cover[ro[r]:ro[r + 1]] += 1
    for b, e in zip(begin, end):
        cover[b:e] += 1
    np.testing.assert_array_equal(cover[:g.n_edge], 1)
    np.testing.assert_array_equal(cover[g.n_edge:], 0)
    assert split.num_edges == g.n_edge and split.num_rows == N


def assert_sum_close(got, want, abs_sum):
    np.testing.assert_array_less(np.abs(got - want), 1e-5 + 1e-5 * abs_sum)


@pytest.mark.parametrize("threshold", [1, 5, 32])
@pytest.mark.parametrize("weights", ["gcn", "none"])
@pytest.mark.parametrize("case", CASES)
def test_executed_schedule_matches_k1_plain(rng, case, weights, threshold):
    kwargs = dict(bidirected=True, self_loops=True, gcn_norm=True) if weights == "gcn" else {}
    g = _graph(rng, case, **kwargs)
    x = torch.from_numpy(rng.normal(size=(N, 40)).astype(np.float32))
    for src, ro, w in ((g.senders, g.row_offsets, g.edge_weight),
                       (g.t_senders, g.t_row_offsets, g.t_edge_weight)):
        split = build_row_split(ro, threshold)
        assert split.num_long > 0 or threshold == 32
        msgs = gather(x, src[:g.n_edge])
        if w is not None:
            msgs = msgs * w[:g.n_edge, None]
        got = segment_sum_by_split(msgs, ro, split)
        want = csr_segment_sum_plain(x, src, ro, w)
        abs_sum = csr_segment_sum_plain(x.abs(), src, ro, None if w is None else w.abs())
        assert_sum_close(got.numpy(), want.numpy(), abs_sum.numpy())


@pytest.mark.parametrize("heads,d", [(1, 40), (3, 5)])
@pytest.mark.parametrize("case", CASES)
def test_executed_schedule_matches_k2_plain(rng, case, heads, d):
    g = _graph(rng, case)
    e = g.n_edge
    x = torch.from_numpy(rng.normal(size=(N, heads * d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(g.num_edges_padded, heads)).astype(np.float32))
    w[e:] = float("nan")  # padding weights are never read
    for src, ro in ((g.senders, g.row_offsets), (g.t_senders, g.t_row_offsets)):
        split = build_row_split(ro, 3)
        msgs = (gather(x, src[:e]).view(e, heads, d) * w[:e, :, None]).view(e, heads * d)
        got = segment_sum_by_split(msgs, ro, split)
        want = csr_segment_sum_heads_plain(x, w, src, ro)
        abs_sum = csr_segment_sum_heads_plain(x.abs(), w.abs(), src, ro)
        assert_sum_close(got.numpy(), want.numpy(), abs_sum.numpy())


@pytest.mark.parametrize("case", CASES)
def test_build_graph_attaches_both_splits(rng, case):
    g = _graph(rng, case, gcn_norm=True)
    assert g.row_split.threshold == g.t_row_split.threshold == ROW_SPLIT_THRESHOLD
    assert _same_split(g.row_split, build_row_split(g.row_offsets))
    assert _same_split(g.t_row_split, build_row_split(g.t_row_offsets.numpy()))
    # the high-degree receiver is a long row of the forward order only
    if case == "high_degree":
        assert g.row_split.long_rows.tolist() == [0]
        assert g.t_row_split.num_long == 0


@pytest.mark.parametrize("how", ["to", "transpose", "replace", "gcn_norm_weights",
                                 "induced_subgraph"])
def test_graph_carries_or_rebuilds_the_split(rng, how):
    s, r = _edges(rng, "high_degree")
    g = build_graph(s, r, N, edge_pad_multiple=64)
    if how == "to":
        out = g.to("cpu")
        assert out.row_split.device == out.senders.device
    elif how == "transpose":
        out = g.transpose()
        assert out.row_split is g.t_row_split and out.t_row_split is g.row_split
        out = out.transpose()
    elif how == "replace":
        out = dataclasses.replace(g, node_scale=None)
        assert out.row_split is g.row_split
    elif how == "gcn_norm_weights":
        out = gcn_norm_weights(g)
    else:  # the subgraph has other rows: its split is built anew from them
        keep = np.arange(0, N, 2)
        out = induced_subgraph(s, r, keep, edge_pad_multiple=64)
        assert out.row_split.num_rows == len(keep)
        assert out.row_split.long_rows.tolist() == [0]
        g = out
    assert _same_split(out.row_split, build_row_split(g.row_offsets))
    assert _same_split(out.t_row_split, build_row_split(g.t_row_offsets))


def test_wrappers_take_the_split_and_refuse_a_wrong_one(rng):
    g = _graph(rng, "high_degree", gcn_norm=True)
    x = torch.randn(N, 16)
    w = torch.randn(g.num_edges_padded, 2)
    # on the CPU the wrappers run the plain versions, with or without a split
    for split in (g.row_split, None):
        torch.testing.assert_close(
            csr_segment_sum(x, g.senders, g.row_offsets, g.edge_weight, split),
            csr_segment_sum_plain(x, g.senders, g.row_offsets, g.edge_weight))
        torch.testing.assert_close(
            csr_segment_sum_heads(x, w, g.senders, g.row_offsets, split),
            csr_segment_sum_heads_plain(x, w, g.senders, g.row_offsets))
    # spmm on a graph without splits (built by hand) still runs
    bare = dataclasses.replace(g, row_split=None, t_row_split=None)
    torch.testing.assert_close(spmm(bare, x), spmm(g, x))
    with pytest.raises(ValueError, match="threshold"):
        build_row_split(g.row_offsets, 0)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_wrappers_refuse_a_split_of_another_graph(rng, kernel):
    g = _graph(rng, "high_degree")
    x = torch.randn(N, 16)
    w = torch.randn(g.num_edges_padded, 2)
    other = build_row_split(g.row_offsets[:-1])  # one row fewer
    with pytest.raises(ValueError, match="row split"):
        if kernel == "K1":
            csr_segment_sum(x, g.senders, g.row_offsets, None, other)
        else:
            csr_segment_sum_heads(x, w, g.senders, g.row_offsets, other)
