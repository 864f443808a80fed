"""The port's row split (``graphs/row_split.py``): the chunk schedule that K1,
K2, K5 and K6 walk to cut power-law hub rows into independent units (K3 and
K4 walk it too; their executed schedule is tested beside their plain
versions, in ``test_torch_spmm_runtime.py`` and ``test_torch_attention.py``).

On the CPU the kernels do not run, so these tests hold the *schedule*: it
covers every real edge exactly once and no padding edge, its chunks never
cross a row, its partial slots are in (row, chunk) order, and executing it in
plain PyTorch (:func:`segment_reduce_by_split`: chunk partials, then each long
row's partials summed in slot order) gives what ``csr_segment_sum_plain`` and
``csr_segment_sum_heads_plain`` give, on the graphs of
``tests/test_torch_spmm.py`` with a small chunk size forced through the
build function's argument. Tolerance in float32: atol 1e-5 plus rtol 1e-5 of each
output's sum of absolute terms, because the two sum a long row's edges in a
different order (chunk by chunk against ``index_add_`` in edge order).

The thin payloads of K5 and K6 (``[E_pad, H]``, H <= 8) go through the same
schedule as a sum and as a max (:func:`segment_reduce_by_split`) and are held
against ``csr_segment_reduce_thin_plain``: the max exactly, the sum to atol
1e-6 plus rtol 1e-6 of each output's sum of absolute terms (a row of 643
terms of order 1 summed in another order differs by a few 1e-6).
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
    segment_reduce_by_split,
)
from efficient_gnns_tpu_torch.ops import spmm
from efficient_gnns_tpu_torch.ops.cuda import (
    csr_sddmm,
    csr_sddmm_heads,
    csr_segment_sum,
    csr_segment_max_thin,
    csr_segment_reduce_thin_plain,
    csr_segment_sum_heads,
    csr_segment_sum_heads_plain,
    csr_segment_sum_plain,
    csr_segment_sum_thin,
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
        got = segment_reduce_by_split(msgs, ro, split)
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
        got = segment_reduce_by_split(msgs, ro, split)
        want = csr_segment_sum_heads_plain(x, w, src, ro)
        abs_sum = csr_segment_sum_heads_plain(x.abs(), w.abs(), src, ro)
        assert_sum_close(got.numpy(), want.numpy(), abs_sum.numpy())


def _degree_lists(t):
    """Rows at the edges of the split for chunk size ``t``."""
    return {
        "one_row": [5 * t + 3],
        "edges_of_T": [0, t, 0, t + 1, 0, 0, 2 * t, 2 * t + 1, 0, 3, 0],
        "last_row_long": [2, 0, 7, 3 * t + 5],
    }


def _assert_thin_matches_plain(v, ro, split, op):
    got = segment_reduce_by_split(v, ro, split, op)
    want = csr_segment_reduce_thin_plain(v, ro, op)
    assert got.shape == want.shape and got.dtype == torch.float32
    if op == "max":  # exact, float32 lowest on empty rows
        assert torch.equal(got, want)
    else:
        abs_sum = csr_segment_reduce_thin_plain(v.abs(), ro, "sum")
        np.testing.assert_array_less((got - want).abs().numpy(),
                                     1e-6 + 1e-6 * abs_sum.numpy())
    deg = ro[1:] - ro[:-1]
    empty = 0.0 if op == "sum" else torch.finfo(torch.float32).min
    assert (got[deg == 0] == empty).all()


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("heads", [1, 3, 8])
@pytest.mark.parametrize("threshold", [1, 3, 16, 128])
@pytest.mark.parametrize("shape", ["one_row", "edges_of_T", "last_row_long"])
def test_executed_thin_schedule_matches_plain_at_split_edges(rng, shape, threshold, heads, op):
    deg = np.array(_degree_lists(threshold)[shape])
    e, pad = int(deg.sum()), 13
    ro = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    split = build_row_split(ro, threshold)
    assert split.num_long == int((deg > threshold).sum()) >= 1
    v = torch.from_numpy(rng.normal(size=(e + pad, heads)).astype(np.float32))
    v[e:] = float("nan")  # padding edges are never read
    _assert_thin_matches_plain(v, ro, split, op)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("threshold", [2, 32])
@pytest.mark.parametrize("case", CASES)
def test_executed_thin_schedule_matches_plain_on_graphs(rng, case, threshold, op):
    g = _graph(rng, case)
    v = torch.from_numpy(rng.normal(size=(g.num_edges_padded, 3)).astype(np.float32))
    v[g.n_edge:] = float("nan")
    for ro in (g.row_offsets, g.t_row_offsets):
        _assert_thin_matches_plain(v, ro, build_row_split(ro, threshold), op)
    if op == "max":  # a row whose every logit is masked keeps float32 lowest exactly
        lowest = torch.finfo(torch.float32).min
        masked = torch.full_like(v, lowest)
        split = build_row_split(g.row_offsets, threshold)
        out = segment_reduce_by_split(masked, g.row_offsets, split, "max")
        assert (out == lowest).all()
    with pytest.raises(ValueError, match="op must be"):
        segment_reduce_by_split(v, g.row_offsets, build_row_split(g.row_offsets), "mean")


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


def _call(kernel, x, w, ro, src, split):
    if kernel == "K1":
        return csr_segment_sum(x, src, ro, None, split)
    if kernel == "K2":
        return csr_segment_sum_heads(x, w, src, ro, split)
    if kernel == "K3":
        return csr_sddmm(x, x, src, ro, split)
    if kernel == "K4":
        return csr_sddmm_heads(x, x, src, ro, 2, split)
    return (csr_segment_sum_thin if kernel == "K5" else csr_segment_max_thin)(w, ro, split)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6"])
def test_wrappers_refuse_a_split_of_another_graph(rng, kernel):
    g = _graph(rng, "high_degree")
    x = torch.randn(N, 16)
    w = torch.randn(g.num_edges_padded, 2)
    other = build_row_split(g.row_offsets[:-1])  # one row fewer
    with pytest.raises(ValueError, match="row split"):
        _call(kernel, x, w, g.row_offsets, g.senders, other)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6"])
def test_wrappers_refuse_the_other_edge_orders_split(rng, kernel):
    # both orders have the same rows and edges: only the schedule's content
    # tells them apart (receiver 0 is a long row of the forward order alone)
    g = _graph(rng, "high_degree")
    x = torch.randn(N, 16)
    w = torch.randn(g.num_edges_padded, 2)
    assert g.row_split.num_long == 1 and g.t_row_split.num_long == 0
    _call(kernel, x, w, g.row_offsets, g.senders, g.row_split)
    _call(kernel, x, w, g.t_row_offsets, g.t_senders, g.t_row_split)
    with pytest.raises(ValueError, match="row split was not built from"):
        _call(kernel, x, w, g.t_row_offsets, g.t_senders, g.row_split)
    with pytest.raises(ValueError, match="row split was not built from"):
        _call(kernel, x, w, g.row_offsets, g.senders, g.t_row_split)
    # a checked pair stays accepted, and an edit of the offsets in place is seen
    _call(kernel, x, w, g.row_offsets, g.senders, g.row_split)
    ro = g.row_offsets.clone()
    split = build_row_split(ro)
    _call(kernel, x, w, ro, g.senders, split)
    ro[1:] = ro[-1]  # every edge moves to row 0
    with pytest.raises(ValueError, match="row split was not built from"):
        _call(kernel, x, w, ro, g.senders, split)
