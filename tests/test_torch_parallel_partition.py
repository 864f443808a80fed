"""The port's partition builders (``efficient_gnns_tpu_torch/parallel/partition.py``)
against the JAX ones: the same arrays, bit for bit, for D in {2, 4, 8}, on a
weighted graph, a ``gcn_norm="factored"`` graph and a graph with an empty
shard; and each rank's CSR views hold exactly its block's edges. No
processes: the views are built on the host."""

import numpy as np
import pytest

from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.parallel import partition as jpart

from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
from efficient_gnns_tpu_torch.parallel import partition as tpart


def _edges(case, rng):
    n, e = 256, 1200
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    if case == "weighted":
        return (s, r, n), dict(edge_weight=rng.normal(size=e).astype(np.float32),
                               edge_pad_multiple=64)
    if case == "factored":
        return (s, r, n), dict(bidirected=True, self_loops=True, gcn_norm="factored",
                               edge_pad_multiple=64)
    # receivers in the first quarter only: every shard above it is empty,
    # and senders everywhere (rows that only send)
    r = rng.integers(0, n // 4, size=e)
    return (s, r, n), dict(edge_weight=rng.normal(size=e).astype(np.float32),
                           edge_pad_multiple=64)


CASES = ("weighted", "factored", "empty_shard")


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for case in CASES:
        args, kw = _edges(case, np.random.default_rng(CASES.index(case)))
        out[case] = (jax_build_graph(*args, **kw), build_graph(*args, **kw))
    return out


def _same(j, t):
    for name in j._fields:
        a, b = getattr(j, name), getattr(t, name)
        if isinstance(a, int):
            assert a == b, name
        else:
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                                  b.view(np.uint32) if b.dtype == np.float32 else b), name


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_partition_graph_bitwise_equal_to_jax(graphs, case, d):
    jg, tg = graphs[case]
    _same(jpart.partition_graph(jg, d), tpart.partition_graph(tg, d))


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_partition_graph_halo_and_stats_bitwise_equal_to_jax(graphs, case, d):
    jg, tg = graphs[case]
    jh, th = jpart.partition_graph_halo(jg, d), tpart.partition_graph_halo(tg, d)
    _same(jh, th)
    assert jpart.halo_stats(jh) == tpart.halo_stats(th)


def _real_edges(tg):
    """(receiver, sender, effective weight) of the real edges, sorted."""
    w = tpart._effective_edge_weight(tg)
    valid = tg.receivers.numpy() < tg.num_nodes
    return _sorted(tg.receivers.numpy()[valid], tg.senders.numpy()[valid], w[valid])


def _sorted(r, s, w):
    r, s, w = (np.asarray(a) for a in (r, s, w))
    order = np.lexsort((w.view(np.uint32), s, r))
    return r[order], s[order], w[order]


def _csr_entries(csr, rows_out_base=0):
    """(row, src, w) of every entry of a view."""
    ro = csr.row_offsets.numpy().astype(np.int64)
    rows = np.repeat(np.arange(ro.size - 1), np.diff(ro)) + rows_out_base
    w = np.ones(rows.size, np.float32) if csr.w is None else csr.w.numpy()
    return rows, csr.src.numpy().astype(np.int64), w


def _transposed(fwd, bwd):
    """``bwd`` holds ``fwd``'s entries with row and column swapped."""
    r, s, w = _csr_entries(fwd)
    br, bs, bw = _csr_entries(bwd)
    a, b = _sorted(r, s, w), _sorted(bs, br, bw)
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("case", CASES)
def test_rank_views_rebuild_every_edge_once(graphs, case, d):
    _, tg = graphs[case]
    want = _real_edges(tg)

    allg = tpart.partition_graph(tg, d)
    got = [[], [], []]
    for k in range(d):
        v = tpart.partition_block(allg, k)
        assert _transposed(v.fwd, v.bwd)
        r, s, w = _csr_entries(v.fwd, k * allg.rows_per_dev)
        for acc, a in zip(got, (r, s, w)):
            acc.append(a)
    assert all(np.array_equal(x, y) for x, y in zip(_sorted(*map(np.concatenate, got)), want))

    halo = tpart.partition_graph_halo(tg, d)
    rows, hw = halo.rows_per_dev, halo.halo_width
    got = [[], [], []]
    for k in range(d):
        v = tpart.partition_block(halo, k)
        assert _transposed(v.local_fwd, v.local_bwd) and _transposed(v.halo_fwd, v.halo_bwd)
        r, s, w = _csr_entries(v.local_fwd)
        hr, slot, hw_ = _csr_entries(v.halo_fwd)
        owner = slot // hw
        # a halo slot reads the row its owner ships to this rank in that slot
        hs = halo.send_idx[owner, k, slot % hw] + owner * rows
        assert np.all(owner != k)
        for acc, a in zip(got, (np.concatenate([r, hr]) + k * rows,
                                np.concatenate([s + k * rows, hs]),
                                np.concatenate([w, hw_]))):
            acc.append(a)
        # the scatter CSR sums each returned slot (dest o, position j) onto
        # the row this rank shipped there, and covers every slot a peer reads
        sr, spos, _ = _csr_entries(v.scatter)
        assert np.array_equal(sr, halo.send_idx[k].reshape(-1)[spos])
        read = {(o, int(p) % hw) for o in range(d) if o != k
                for p in np.unique(halo.s_halo[o][halo.r_halo[o] < rows]) if p // hw == k}
        assert read == {(int(p) // hw, int(p) % hw) for p in spos}
    assert all(np.array_equal(x, y) for x, y in zip(_sorted(*map(np.concatenate, got)), want))


def test_partition_needs_rows_divisible_by_devices(graphs):
    _, tg = graphs["weighted"]
    for build in (tpart.partition_graph, tpart.partition_graph_halo):
        with pytest.raises(ValueError, match="multiple of the mesh size"):
            build(tg, 3)
