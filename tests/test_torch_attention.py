"""Port vs JAX: the kernels of the GAT attention path (K2, K4-K7), ``spmm_heads``
and ``gat_attention``.

The JAX side runs its Pallas functions in interpret mode over an edge-blocked
graph; the port runs each kernel's plain version, which is what its wrapper
takes for CPU tensors. Both compute the same function over the same edges,
mapped between the blocked slot order and the CSR order with the blocking's
``csr_perm`` / ``edge_id`` (slot -> CSR edge) and ``inv_perm`` (CSR edge ->
slot). The graph has multi-edges, rows without in-edges, nodes without
out-edges, one receiver and one sender of high degree, and padding edges.

Tolerances (float32): the max (K6) and the row broadcast (K7) are exact; the
sums (K2, K4, K5) agree to rtol 1e-5 / atol 1e-5, because the summation order
differs (a one-hot matmul over edge blocks against ``index_add_`` in edge
order). ``gat_attention`` is held to rtol 2e-5 / atol 2e-6 forward and
rtol 1e-4 / atol 2e-5 on its gradients, ten times tighter than the JAX
package's own fused-vs-XLA bounds (2e-4 / 2e-5 and 2e-3 / 2e-4): over these
inputs and two more seeds, with every mask combination, the largest absolute
differences were 7.2e-7 (forward), 6.7e-6 (dfeat), 1.2e-6 (del) and 5.5e-7
(der). The gradients keep the wider bound because the softmax backward
``a * (da - sum a * da)`` cancels.

K5, K6 and ``gat_attention`` also run with a row split handed in, built at 16
edges a chunk so that the graph's hub rows are long rows of it: on the CPU the
wrappers check the split against the offsets and then take the plain version,
so the results are the same and a split of the other edge order raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu import ops as jax_ops
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.graphs.blocking import attach_blocking
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.ops.attention import gat_attention as jax_gat_attention
from efficient_gnns_tpu.ops.pallas import (
    blocked_sddmm_dw_heads,
    blocked_segment_max_thin,
    blocked_segment_sum_heads,
    blocked_segment_sum_thin,
    tile_rows_thin,
)
from efficient_gnns_tpu_torch.graphs import build_graph, build_row_split, sddmm_by_split
from efficient_gnns_tpu_torch.ops import dispatch, edge_softmax, sddmm_add, spmm_heads
from efficient_gnns_tpu_torch.ops.attention import gat_attention, sample_edge_masks
from efficient_gnns_tpu_torch.ops.cuda import (
    csr_sddmm_heads,
    csr_sddmm_heads_plain,
    csr_segment_max_thin,
    csr_segment_reduce_thin_plain,
    csr_segment_sum_heads,
    csr_segment_sum_heads_plain,
    csr_segment_sum_thin,
    csr_tile_rows_thin,
    csr_tile_rows_thin_plain,
)

N, H, D = 70, 3, 5
F32_LOWEST = np.finfo(np.float32).min


@pytest.fixture(autouse=True)
def _pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False, message_dtype=jnp.float32)
    dispatch.set_message_dtype(torch.float32)


def _edges(rng, e=310):
    s = rng.integers(5, N, size=e)  # nodes 0-4 send nothing
    r = rng.integers(0, N - 10, size=e)  # nodes 60-69 receive nothing
    r[: e // 4] = 3  # a receiver of high degree
    s[e // 4: e // 2] = 11  # a sender of high degree
    s[e // 2: e // 2 + 20] = s[e // 2 + 20: e // 2 + 40]  # multi-edges
    r[e // 2: e // 2 + 20] = r[e // 2 + 20: e // 2 + 40]
    return s, r


@pytest.fixture
def graphs(rng):
    s, r = _edges(rng)
    jg = attach_blocking(jax_build_graph(s, r, N, edge_pad_multiple=64), tm=32, eb=16)
    tg = build_graph(s, r, N, edge_pad_multiple=64)
    assert tg.n_edge < tg.num_edges_padded  # padding edges present
    np.testing.assert_array_equal(tg.senders.numpy(), np.asarray(jg.senders))
    return jg, tg


def _slot_to_csr(blk):
    return np.asarray(blk.csr_perm if blk.csr_perm is not None else blk.edge_id)


def _to_blocked(csr_vals, blk):
    """Per-edge CSR values into the blocking's slot order."""
    idx = np.minimum(_slot_to_csr(blk), csr_vals.shape[0] - 1)
    return jnp.asarray(csr_vals[idx])


def _to_csr(blocked_vals, blk, tg):
    """Per-slot values back to CSR order (padding edges 0)."""
    out = np.zeros((tg.num_edges_padded,) + blocked_vals.shape[1:], np.float32)
    e = tg.n_edge
    out[:e] = np.asarray(blocked_vals)[np.asarray(blk.inv_perm)[:e]]
    return out


def _pad_heads(x):
    """[rows, H*D] -> [rows, H*128], each head slice 128-aligned (the TPU
    kernels' layout)."""
    x3 = x.reshape(x.shape[0], H, D)
    return jnp.asarray(np.pad(x3, ((0, 0), (0, 0), (0, 128 - D))).reshape(x.shape[0], -1))


def _unpad_heads(x):
    return np.asarray(x).reshape(x.shape[0], H, 128)[:, :, :D].reshape(x.shape[0], -1)


def _directions(jg, tg):
    """(JAX blocking, port senders, receivers, row offsets, CSR->this-order
    edge permutation) of the forward and the transpose direction."""
    perm = tg.csc_perm.numpy()
    return [
        (jg.blocking, tg.senders, tg.receivers, tg.row_offsets, np.arange(len(perm))),
        (jg.t_blocking, tg.t_senders, tg.t_receivers, tg.t_row_offsets, perm),
    ]


def _with_splits(tg, threshold):
    """``tg`` with both row splits built at ``threshold`` edges a chunk, or
    without splits for None."""
    if threshold is None:
        return dataclasses.replace(tg, row_split=None, t_row_split=None)
    return dataclasses.replace(
        tg, row_split=build_row_split(tg.row_offsets, threshold),
        t_row_split=build_row_split(tg.t_row_offsets, threshold))


@pytest.mark.parametrize("split_at", [None, 16])
@pytest.mark.parametrize("direction", [0, 1])
def test_thin_segment_sum_and_max_match_pallas(rng, graphs, direction, split_at):
    jg, tg = graphs
    blk, _, _, ro, perm = _directions(jg, tg)[direction]
    sg = _with_splits(tg, split_at)
    split, other = [(sg.row_split, sg.t_row_split), (sg.t_row_split, sg.row_split)][direction]
    v_csr = rng.normal(size=(tg.num_edges_padded, H)).astype(np.float32)
    v_blk = _to_blocked(v_csr, blk)
    v = torch.from_numpy(v_csr[perm])
    want_sum = np.asarray(blocked_segment_sum_thin(v_blk, blk, N, interpret=True))
    want_max = np.asarray(blocked_segment_max_thin(v_blk, blk, N, interpret=True))
    got_sum = csr_segment_sum_thin(v, ro, split).numpy()
    got_max = csr_segment_max_thin(v, ro, split).numpy()
    np.testing.assert_allclose(got_sum, want_sum, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_max, want_max)
    deg = np.diff(ro.numpy())
    assert (deg == 0).any() and deg.max() >= 70
    assert (got_max[deg == 0] == F32_LOWEST).all() and (got_sum[deg == 0] == 0).all()
    if split is not None:  # the hub row is a long row; the other order's split raises
        assert split.num_long >= 1
        for fn in (csr_segment_sum_thin, csr_segment_max_thin):
            with pytest.raises(ValueError, match="row split was not built from"):
                fn(v, ro, other)


def test_tile_rows_thin_matches_pallas(rng, graphs):
    jg, tg = graphs
    blk = jg.blocking
    vals = rng.normal(size=(N, H)).astype(np.float32)
    padded = np.zeros((blk.num_tiles * blk.tm, H), np.float32)
    padded[:N] = vals
    want = _to_csr(tile_rows_thin(jnp.asarray(padded), blk, interpret=True), blk, tg)
    got = csr_tile_rows_thin(torch.from_numpy(vals), tg.receivers, tg.row_offsets)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[tg.n_edge:] == 0).all()


@pytest.mark.parametrize("direction", [0, 1])
def test_segment_sum_heads_matches_pallas(rng, graphs, direction):
    jg, tg = graphs
    blk, src, _, ro, perm = _directions(jg, tg)[direction]
    x = rng.normal(size=(N, H * D)).astype(np.float32)
    w_csr = rng.normal(size=(tg.num_edges_padded, H)).astype(np.float32)
    x_blk = _pad_heads(x)[np.asarray(blk.src)]
    w3 = jnp.moveaxis(_to_blocked(w_csr, blk).reshape(blk.num_blocks, blk.eb, H), 2, 1)
    want = _unpad_heads(blocked_segment_sum_heads(x_blk, w3, blk, N, H, interpret=True))
    got = csr_segment_sum_heads(torch.from_numpy(x), torch.from_numpy(w_csr[perm]), src, ro)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", [0, 1])
def test_sddmm_heads_matches_pallas(rng, graphs, direction):
    jg, tg = graphs
    blk, src, _, ro, perm = _directions(jg, tg)[direction]
    split = (tg.row_split, tg.t_row_split)[direction]
    g = rng.normal(size=(N, H * D)).astype(np.float32)
    x = rng.normal(size=(N, H * D)).astype(np.float32)
    gt = jnp.zeros((blk.num_tiles * blk.tm, H * 128)).at[:N].set(_pad_heads(g))
    x_blk = _pad_heads(x)[np.asarray(blk.src)]
    # both blockings' slots map to forward CSR edge ids: compare there
    want = _to_csr(blocked_sddmm_dw_heads(gt, x_blk, blk, H, interpret=True), blk, tg)
    got = csr_sddmm_heads(torch.from_numpy(g), torch.from_numpy(x), src, ro, H, split)
    got_csr = np.zeros_like(want)
    got_csr[perm[: tg.n_edge]] = got.numpy()[: tg.n_edge]
    np.testing.assert_allclose(got_csr, want, rtol=1e-5, atol=1e-5)
    assert (got[tg.n_edge:] == 0).all()


def _linear_loss_grads(jfn, tfn, args, cot):
    """Forward values and gradients of ``sum(f(*args) * cot)`` on both sides."""
    jargs = [jnp.asarray(a) for a in args]
    jout = jfn(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot), argnums=tuple(range(len(args))))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    (tout * torch.from_numpy(cot)).sum().backward()
    return ((np.asarray(jout), [np.asarray(g) for g in jgrads]),
            (tout.detach().numpy(), [t.grad.numpy() for t in targs]))


def test_spmm_heads_matches_jax(rng, graphs):
    jg, tg = graphs
    x = rng.normal(size=(N, H, D)).astype(np.float32)
    w = rng.normal(size=(tg.num_edges_padded, H)).astype(np.float32)
    w[tg.n_edge:] = 0.0
    cot = rng.normal(size=(N, H, D)).astype(np.float32)
    (jo, jgr), (to, tgr) = _linear_loss_grads(
        lambda x_, w_: jax_ops.spmm_heads(jg, x_, w_),
        lambda x_, w_: spmm_heads(tg, x_, w_), (x, w), cot)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    for got, want, name in zip(tgr, jgr, ("dx", "dw")):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def _attention_inputs(rng, tg, keep, attn):
    feat = rng.normal(size=(N, H, D)).astype(np.float32)
    el = rng.normal(size=(N, H)).astype(np.float32)
    er = rng.normal(size=(N, H)).astype(np.float32)
    cot = rng.normal(size=(N, H, D)).astype(np.float32)
    keep_csr = rng.random(tg.num_edges_padded) < 0.7 if keep else None
    attn_csr = rng.random((tg.num_edges_padded, H)) < 0.8 if attn else None
    if keep:  # every edge of one row dropped: its softmax is all-masked
        keep_csr[tg.row_offsets[5]: tg.row_offsets[6]] = False
    return feat, el, er, cot, keep_csr, attn_csr


@pytest.mark.parametrize("split_at", [None, 16])
@pytest.mark.parametrize("use_er", [True, False])
@pytest.mark.parametrize("masks", ["none", "keep", "attn", "both"])
def test_gat_attention_matches_jax(rng, graphs, use_er, masks, split_at):
    jg, tg = graphs
    tg = _with_splits(tg, split_at)
    blk = jg.blocking
    feat, el, er, cot, keep_csr, attn_csr = _attention_inputs(
        rng, tg, masks in ("keep", "both"), masks in ("attn", "both"))
    jkeep = jattn = None
    if keep_csr is not None:
        real_slot = np.asarray(blk.dst_local).reshape(-1) < blk.tm
        jkeep = _to_blocked(keep_csr, blk) & jnp.asarray(real_slot)
    if attn_csr is not None:
        jattn = _to_blocked(attn_csr, blk)
    tkeep = None if keep_csr is None else torch.from_numpy(keep_csr)
    tattn = None if attn_csr is None else torch.from_numpy(attn_csr)
    kw = dict(negative_slope=0.2, attn_keep_prob=0.8)
    args = (feat, el, er) if use_er else (feat, el)
    (jo, jgr), (to, tgr) = _linear_loss_grads(
        lambda f, l, *r: jax_gat_attention(jg, f, l, r[0] if r else None,
                                           keep_mask=jkeep, attn_keep=jattn, **kw),
        lambda f, l, *r: gat_attention(tg, f, l, r[0] if r else None,
                                       keep_mask=tkeep, attn_keep=tattn, **kw),
        args, cot)
    assert np.isfinite(to).all()
    np.testing.assert_allclose(to, jo, rtol=2e-5, atol=2e-6)
    for got, want, name in zip(tgr, jgr, ("dfeat", "del", "der")):
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5, err_msg=name)


def test_gat_attention_matches_unfused_composition(rng, graphs):
    # the plain path of the JAX layer: sddmm_add -> leaky relu -> edge_softmax
    # (with edge-drop) -> spmm_heads, in the port's plain ops
    _, tg = graphs
    feat, el, er, _, keep_csr, _ = _attention_inputs(rng, tg, True, False)
    keep = torch.from_numpy(keep_csr)
    f, l, r = (torch.from_numpy(a) for a in (feat, el, er))
    a = edge_softmax(tg, torch.nn.functional.leaky_relu(sddmm_add(tg, l, r), 0.2), keep)
    want = spmm_heads(tg, f, a)
    got = gat_attention(tg, f, l, r, keep_mask=keep)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_gat_attention_refuses_swapped_splits(rng, graphs):
    _, tg = graphs
    sg = _with_splits(tg, 16)
    swapped = dataclasses.replace(sg, row_split=sg.t_row_split, t_row_split=sg.row_split)
    feat, el, er, _, _, _ = _attention_inputs(rng, tg, False, False)
    f, l, r = (torch.from_numpy(a) for a in (feat, el, er))
    with pytest.raises(ValueError, match="row split was not built from"):
        gat_attention(swapped, f, l, r)
    # the backward walks the transpose order with t_row_split
    half = dataclasses.replace(sg, t_row_split=sg.row_split)
    out = gat_attention(half, f.requires_grad_(), l, r)
    with pytest.raises(ValueError, match="row split was not built from"):
        out.sum().backward()


def test_sample_edge_masks_rates():
    s, r = _edges(np.random.default_rng(1), e=4000)
    tg = build_graph(s, r, N)
    gen = torch.Generator().manual_seed(0)
    keep, attn = sample_edge_masks(tg, gen, edge_drop=0.3, attn_drop=0.1, num_heads=H)
    assert keep.shape == (tg.num_edges_padded,) and attn.shape == (tg.num_edges_padded, H)
    assert abs(keep.float().mean().item() - 0.7) < 0.03
    assert abs(attn.float().mean().item() - 0.9) < 0.02
    assert sample_edge_masks(tg, gen) == (None, None)
    again = sample_edge_masks(tg, torch.Generator().manual_seed(0), 0.3, 0.1, H)
    assert torch.equal(again[0], keep) and torch.equal(again[1], attn)


def test_wrappers_check_inputs_and_skip_padding(rng, graphs):
    _, tg = graphs
    x = torch.randn(N, H * D)
    w = torch.randn(tg.num_edges_padded, H)
    v = torch.randn(tg.num_edges_padded, H)
    with pytest.raises(ValueError, match="int32"):
        csr_segment_sum_heads(x, w, tg.senders.long(), tg.row_offsets)
    with pytest.raises(ValueError, match="float32"):
        csr_segment_sum_heads(x.double(), w, tg.senders, tg.row_offsets)
    with pytest.raises(ValueError, match="disagree"):
        csr_segment_sum_heads(torch.randn(N, H * D - 1), w, tg.senders, tg.row_offsets)
    with pytest.raises(ValueError, match="contiguous"):
        csr_sddmm_heads(x, torch.randn(H * D, N).t(), tg.senders, tg.row_offsets, H)
    with pytest.raises(ValueError, match="H <= 8"):
        csr_segment_sum_thin(torch.randn(tg.num_edges_padded, 9), tg.row_offsets)
    with pytest.raises(ValueError, match="one row per CSR row"):
        csr_tile_rows_thin(torch.randn(N + 1, H), tg.receivers, tg.row_offsets)
    # bfloat16 messages are taken (tests/test_torch_heads_bf16.py); the head
    # weights stay float32, and g and x share one dtype
    with pytest.raises(ValueError, match="w must be 2-D float32"):
        csr_segment_sum_heads(x.bfloat16(), w.bfloat16(), tg.senders, tg.row_offsets)
    with pytest.raises(ValueError, match="share one dtype"):
        csr_sddmm_heads(x.bfloat16(), x, tg.senders, tg.row_offsets, H)
    counters = (csr_segment_sum_heads, csr_sddmm_heads, csr_segment_sum_thin,
                csr_segment_max_thin, csr_tile_rows_thin)
    before = [c.launches for c in counters]
    # out-of-range indices past the real edges must never be read
    src, dst = tg.senders.clone(), tg.receivers.clone()
    src[tg.n_edge:] = 10**6
    dst[tg.n_edge:] = 10**6
    torch.testing.assert_close(csr_segment_sum_heads(x, w, src, tg.row_offsets),
                               csr_segment_sum_heads_plain(x, w, tg.senders, tg.row_offsets))
    torch.testing.assert_close(csr_sddmm_heads(x, x, src, tg.row_offsets, H),
                               csr_sddmm_heads_plain(x, x, tg.senders, tg.row_offsets, H))
    torch.testing.assert_close(csr_tile_rows_thin(v[:N], dst, tg.row_offsets),
                               csr_tile_rows_thin_plain(v[:N], tg.receivers, tg.row_offsets))
    v_nan = v.clone()
    v_nan[tg.n_edge:] = float("nan")
    for op, fn in (("sum", csr_segment_sum_thin), ("max", csr_segment_max_thin)):
        torch.testing.assert_close(fn(v_nan, tg.row_offsets),
                                   csr_segment_reduce_thin_plain(v, tg.row_offsets, op))
    assert [c.launches for c in counters] == before  # the CPU runs no kernel


def _degree_lists(t):
    """The made-up graphs of ``chip_smoke.py``'s split-edges phase, for chunk
    size ``t``: one row holding every edge; rows of exactly t, t + 1, 2t and
    2t + 1 edges among empty rows; the last row long."""
    return {
        "one_row": [5 * t + 3],
        "edges_of_T": [0, t, 0, t + 1, 0, 0, 2 * t, 2 * t + 1, 0, 3, 0],
        "last_row_long": [2, 0, 7, 3 * t + 5],
    }


@pytest.mark.parametrize("heads,d", [(1, 40), (3, 25), (4, 33)])
@pytest.mark.parametrize("threshold", [1, 3, 16, 128])
@pytest.mark.parametrize("shape", ["one_row", "edges_of_T", "last_row_long"])
def test_sddmm_heads_schedule_matches_plain_at_split_edges(rng, shape, threshold, heads, d):
    # K4's walk executed in plain PyTorch: each short row and each chunk
    # reads its own row of g; an edge no unit covered would read NaN
    deg = np.array(_degree_lists(threshold)[shape])
    e, pad, n_src = int(deg.sum()), 13, 97
    ro = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    split = build_row_split(ro, threshold)
    assert split.num_long == int((deg > threshold).sum()) >= 1
    src = torch.from_numpy(rng.integers(0, n_src, size=e + pad).astype(np.int32))
    src[e:] = 10**6  # padding edges are never read
    g = torch.from_numpy(rng.normal(size=(len(deg), heads * d)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n_src, heads * d)).astype(np.float32))
    got = sddmm_by_split(g, x, src, ro, split, heads)
    want = csr_sddmm_heads_plain(g, x, src, ro, heads)
    # the same products summed per edge: only the order within a dot differs
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    assert not got[e:].any()
    torch.testing.assert_close(csr_sddmm_heads(g, x, src, ro, heads, split), want)


@pytest.mark.parametrize("split_at", [2, 16])
@pytest.mark.parametrize("direction", [0, 1])
def test_sddmm_heads_schedule_matches_plain_on_graph(rng, graphs, direction, split_at):
    _, tg = graphs
    _, src, _, ro, _ = _directions(*graphs)[direction]
    split = build_row_split(ro, split_at)
    assert split.num_long >= 1
    g = torch.from_numpy(rng.normal(size=(N, H * D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N, H * D)).astype(np.float32))
    want = csr_sddmm_heads_plain(g, x, src, ro, H)
    torch.testing.assert_close(sddmm_by_split(g, x, src, ro, split, H), want,
                               rtol=1e-6, atol=1e-5)
    assert not want[tg.n_edge:].any()


def test_sddmm_heads_refuses_swapped_or_stale_splits(rng, graphs):
    _, tg = graphs
    g, x = torch.randn(N, H * D), torch.randn(N, H * D)
    sg = _with_splits(tg, 16)  # hub rows of both orders become long rows
    csr_sddmm_heads(g, x, sg.senders, sg.row_offsets, H, sg.row_split)
    with pytest.raises(ValueError, match="row split was not built from"):
        csr_sddmm_heads(g, x, sg.senders, sg.row_offsets, H, sg.t_row_split)
    with pytest.raises(ValueError, match="row split"):  # another graph's: one row fewer
        csr_sddmm_heads(g, x, sg.senders, sg.row_offsets, H,
                        build_row_split(sg.row_offsets[:-1]))
    ro = tg.row_offsets.clone()
    split = build_row_split(ro)
    csr_sddmm_heads(g, x, tg.senders, ro, H, split)
    ro[1:] = ro[-1]  # every edge moves to row 0: the checked split is stale
    with pytest.raises(ValueError, match="row split was not built from"):
        csr_sddmm_heads(g, x, tg.senders, ro, H, split)
