"""Port vs JAX: ``spmm`` with per-call trainable edge weights (K1 forward and
dX, K3 for the weight gradient), ``spmm_mean``, the factored norm and the
segment mean / min.

The JAX side runs its Pallas kernels (``blocked_segment_sum``,
``blocked_sddmm_dw``) in interpret mode over an edge-blocked graph, and the
XLA path beside it; the port runs the kernels' plain versions, which is what
the wrappers take for CPU tensors. Tolerances (float32): K3's plain version
against the Pallas kernel atol / rtol 1e-4 (the bound of
``tests/test_pallas.py::test_blocked_sddmm_dw_kernel``: a one-hot matmul
against a gather, multiply and sum); ``spmm`` value, ``dx`` and ``dw`` rtol
1e-4 / atol 1e-5 (summation order over a row's edges). The per-call weights
are drawn at a scale of 0.1 so that the hub row's sum stays of order 1: the
loss is ``sum(sin(out))`` (that of ``tests/test_pallas.py``), and at |out| of
50 the float32 rounding of ``out`` alone moves ``cos(out)`` by 1e-4 on every
side, the JAX XLA path included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu import ops as jax_ops
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.ops import segment as jax_segment
from efficient_gnns_tpu.ops.pallas import blocked_sddmm_dw
from efficient_gnns_tpu_torch import ops
from efficient_gnns_tpu_torch.graphs import build_graph, build_row_split, sddmm_by_split
from efficient_gnns_tpu_torch.ops import dispatch, spmm, spmm_mean
from efficient_gnns_tpu_torch.ops.cuda import csr_sddmm, csr_sddmm_plain

N = 150
CASES = ["random", "empty_rows", "high_degree", "multi_edges"]


@pytest.fixture(autouse=True)
def _pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False, message_dtype=jnp.float32)
    dispatch.set_message_dtype(torch.float32)


def _edges(rng, case, n=N, e=600):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    if case == "empty_rows":
        r = rng.integers(0, n // 3, size=e)
    elif case == "high_degree":  # one receiver owns two thirds of the edges
        r[e // 3:] = 0
    elif case == "multi_edges":
        s[: e // 2] = s[e // 2:]
        r[: e // 2] = r[e // 2:]
    return s, r


def _graphs(rng, case, **kwargs):
    s, r = _edges(rng, case)
    kwargs.setdefault("edge_pad_multiple", 64)  # padded edges in every case
    jg = jax_build_graph(s, r, N, block=True, **kwargs)
    assert jg.blocking is not None and jg.blocking.inv_perm is not None and jg.hub is None
    tg = build_graph(s, r, N, **kwargs)
    assert tg.n_edge < tg.num_edges_padded
    return jg, tg


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("f", [12, 40, 128])
@pytest.mark.parametrize("case", ["high_degree", "multi_edges"])
def test_sddmm_plain_matches_pallas_k3(rng, case, f):
    jg, tg = _graphs(rng, case)
    blk = jg.blocking
    g = rng.normal(size=(N, f)).astype(np.float32)
    x = rng.normal(size=(N, f)).astype(np.float32)
    # the TPU kernel wants F padded to 128 and whole row tiles; the port does not
    gp = np.zeros((blk.num_tiles * blk.tm, 128), np.float32)
    gp[:N, :f] = g
    xp = np.zeros((N, 128), np.float32)
    xp[:, :f] = x
    dw_blk = np.asarray(blocked_sddmm_dw(
        jnp.asarray(gp), jnp.asarray(xp)[np.asarray(blk.src)], blk, interpret=True))
    want = np.zeros(tg.num_edges_padded, np.float32)
    want[: tg.n_edge] = dw_blk[np.asarray(blk.inv_perm)[: tg.n_edge]]
    got = csr_sddmm(torch.from_numpy(g), torch.from_numpy(x), tg.senders, tg.row_offsets,
                    tg.row_split)
    assert got.dtype == torch.float32 and got.shape == (tg.num_edges_padded,)
    _close(got, want, rtol=1e-4, atol=1e-4)
    assert (got[tg.n_edge:] == 0).all()


def _losses(jg, tg, x, w, **kw):
    """Value and both gradients of sum(sin(spmm(g, x, edge_weight=w))) on the
    JAX side and in the port."""
    def jloss(x_, w_):
        return jnp.sum(jnp.sin(jax_ops.spmm(jg, x_, edge_weight=w_, **kw)))

    jv, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    tv = torch.sin(spmm(tg, xt, edge_weight=wt, **kw)).sum()
    tv.backward()
    return (float(jv), jdx, jdw), (tv.item(), xt.grad, wt.grad)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES)
def test_spmm_runtime_weights_match_jax(rng, case, backend):
    jg, tg = _graphs(rng, case)
    x = rng.normal(size=(N, 20)).astype(np.float32)
    w = 0.1 * rng.normal(size=tg.num_edges_padded).astype(np.float32)
    if backend == "xla":
        jax_dispatch.set_backend("xla")
    (jv, jdx, jdw), (tv, tdx, tdw) = _losses(jg, tg, x, w)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _close(tdx, jdx)
    _close(tdw, jdw)
    assert tdw.dtype == torch.float32 and (tdw[tg.n_edge:] == 0).all()


@pytest.mark.parametrize("static", [False, True])
def test_spmm_runtime_weights_transpose_and_override(rng, static):
    # transpose=True reads w in the transposed graph's CSR order, and per-call
    # weights override the graph's own static ones. Held against the JAX XLA
    # path: on its Pallas path the transposed graph's blocking maps slots to
    # the untransposed CSR order (blocking.csr_perm), so there the JAX op
    # reads w in that other order and disagrees with its own XLA path.
    jax_dispatch.set_backend("xla")
    kw = {"edge_weight": rng.normal(size=600).astype(np.float32)} if static else {}
    s, r = _edges(rng, "empty_rows")
    jg = jax_build_graph(s, r, N, block=True, edge_pad_multiple=64, **kw)
    tg = build_graph(s, r, N, edge_pad_multiple=64, **kw)
    x = rng.normal(size=(N, 8)).astype(np.float32)
    w = 0.1 * rng.normal(size=tg.num_edges_padded).astype(np.float32)
    (jv, jdx, jdw), (tv, tdx, tdw) = _losses(jg, tg, x, w, transpose=True)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _close(tdx, jdx)
    _close(tdw, jdw)


def test_spmm_weight_grad_false_gives_zero_dw(rng):
    jg, tg = _graphs(rng, "random")
    x = rng.normal(size=(N, 6)).astype(np.float32)
    w = rng.normal(size=tg.num_edges_padded).astype(np.float32)
    (_, jdx, jdw), (_, tdx, tdw) = _losses(jg, tg, x, w, weight_grad=False)
    assert not np.asarray(jdw).any()
    assert tdw.shape == (tg.num_edges_padded,) and not tdw.any()
    _close(tdx, jdx)


def test_spmm_runtime_weights_bf16_messages(rng):
    # messages (x, and g and x in K3) are read in bfloat16 on both sides and
    # accumulated in float32; the Pallas K1 also rounds w_e * msg_e to
    # bfloat16, the port does not: one bfloat16 rounding (2**-8) per term
    jg, tg = _graphs(rng, "random")
    x = rng.normal(size=(N, 16)).astype(np.float32)
    w = rng.uniform(0.05, 0.15, size=tg.num_edges_padded).astype(np.float32)
    jax_dispatch.set_backend("pallas", interpret=True, message_dtype=jnp.bfloat16)
    dispatch.set_message_dtype(torch.bfloat16)
    (jv, jdx, jdw), (tv, tdx, tdw) = _losses(jg, tg, x, w)
    _close(tdx, jdx, rtol=2e-2, atol=5e-2)
    _close(tdw, jdw, rtol=2e-2, atol=5e-2)
    # against float32 messages the port's dw differs by the rounding of g and x
    dispatch.set_message_dtype(torch.float32)
    _, (_, _, exact) = _losses(jg, tg, x, w)
    scale = float(exact.abs().max())
    _close(tdw, exact, rtol=2**-6, atol=2**-6 * scale)


@pytest.mark.parametrize("op", ["spmm", "spmm_mean"])
def test_factored_graph_guards(rng, op):
    s, r = _edges(rng, "random")
    tg = build_graph(s, r, N, bidirected=True, self_loops=True, gcn_norm="factored")
    x = torch.zeros(N, 4)
    if op == "spmm":
        with pytest.raises(ValueError, match="factored"):
            spmm(tg, x, edge_weight=torch.ones(tg.num_edges_padded))
    else:
        with pytest.raises(ValueError, match="factored"):
            spmm_mean(tg, x)


@pytest.mark.parametrize("transpose", [False, True])
def test_factored_norm_matches_fused_and_jax(rng, transpose):
    s, r = _edges(rng, "high_degree")
    kw = dict(bidirected=True, self_loops=True, edge_pad_multiple=64)
    jg = jax_build_graph(s, r, N, gcn_norm="factored", **kw)
    tg = build_graph(s, r, N, gcn_norm="factored", **kw)
    fused = build_graph(s, r, N, gcn_norm=True, **kw)
    assert tg.edge_weight is None
    np.testing.assert_allclose(tg.node_scale.numpy(), np.asarray(jg.node_scale), rtol=1e-7)
    x = rng.normal(size=(N, 10)).astype(np.float32)
    c = torch.from_numpy(rng.normal(size=(N, 10)).astype(np.float32))

    def run(graph):
        xt = torch.tensor(x, requires_grad=True)
        out = spmm(graph, xt, transpose=transpose)
        (out * c).sum().backward()
        return out.detach(), xt.grad

    out, dx = run(tg)
    out_fused, dx_fused = run(fused)
    _close(out, out_fused)
    _close(dx, dx_fused)
    _close(out, jax_ops.spmm(jg, jnp.asarray(x), transpose=transpose))


@pytest.mark.parametrize("weights", ["none", "gcn", "runtime"])
def test_spmm_mean_matches_jax(rng, weights):
    kw = dict(bidirected=True, self_loops=True, gcn_norm=True) if weights == "gcn" else {}
    jg, tg = _graphs(rng, "empty_rows", **kw)
    x = rng.normal(size=(N, 10)).astype(np.float32)
    c = rng.normal(size=(N, 10)).astype(np.float32)
    w = (rng.normal(size=tg.num_edges_padded).astype(np.float32)
         if weights == "runtime" else None)
    jw = None if w is None else jnp.asarray(w)
    jout = jax_ops.spmm_mean(jg, jnp.asarray(x), jw)
    jdx = jax.grad(lambda x_: jnp.sum(jax_ops.spmm_mean(jg, x_, jw) * c))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tout = spmm_mean(tg, xt, None if w is None else torch.from_numpy(w))
    (tout * torch.from_numpy(c)).sum().backward()
    _close(tout.detach(), jout)
    _close(xt.grad, jdx)


@pytest.mark.parametrize("name", ["segment_mean", "segment_min"])
def test_segment_reductions_match_jax(rng, name):
    ids = np.sort(rng.integers(0, 12, size=80))  # segments 12-14 stay empty
    ids[-5:] = 15  # out of range: dropped
    data = rng.normal(size=(80, 3)).astype(np.float32)
    want = getattr(jax_segment, name)(jnp.asarray(data), jnp.asarray(ids), 15)
    got = getattr(ops, name)(torch.from_numpy(data), torch.from_numpy(ids), 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert np.isinf(got.numpy()[12:]).all() if name == "segment_min" else not got[12:].any()


def test_sddmm_wrapper_checks_inputs(rng):
    _, tg = _graphs(rng, "random")
    g, x = torch.randn(N, 16), torch.randn(N, 16)
    args = (tg.senders, tg.row_offsets)
    with pytest.raises(ValueError, match="int32"):
        csr_sddmm(g, x, tg.senders.long(), tg.row_offsets)
    with pytest.raises(ValueError, match="contiguous"):
        csr_sddmm(torch.randn(16, N).t(), x, *args)
    with pytest.raises(ValueError, match="float32"):
        csr_sddmm(g.double(), x.double(), *args)
    with pytest.raises(ValueError, match="disagree"):
        csr_sddmm(g.bfloat16(), x, *args)
    with pytest.raises(ValueError, match="disagree"):
        csr_sddmm(g[:-1], x, *args)
    with pytest.raises(ValueError, match="edge_weight must be"):
        spmm(tg, x, edge_weight=torch.ones(tg.num_edges_padded - 1))
    # the CPU path is the plain version; it never reads a padding edge
    launches = csr_sddmm.launches
    got = csr_sddmm(g, x, *args)
    assert csr_sddmm.launches == launches
    torch.testing.assert_close(got, csr_sddmm_plain(g, x, *args))
    src = tg.senders.clone()
    src[tg.n_edge:] = 10**6
    torch.testing.assert_close(csr_sddmm(g, x, src, tg.row_offsets, tg.row_split), got)


def _degree_lists(t):
    """The made-up graphs of ``chip_smoke.py``'s split-edges phase, for chunk
    size ``t``: one row holding every edge; rows of exactly t, t + 1, 2t and
    2t + 1 edges among empty rows; the last row long."""
    return {
        "one_row": [5 * t + 3],
        "edges_of_T": [0, t, 0, t + 1, 0, 0, 2 * t, 2 * t + 1, 0, 3, 0],
        "last_row_long": [2, 0, 7, 3 * t + 5],
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("threshold", [1, 3, 16, 128])
@pytest.mark.parametrize("shape", ["one_row", "edges_of_T", "last_row_long"])
def test_sddmm_schedule_matches_plain_at_split_edges(rng, shape, threshold, dtype):
    # K3's walk executed in plain PyTorch: each short row and each chunk
    # reads its own row of g; an edge no unit covered would read NaN
    deg = np.array(_degree_lists(threshold)[shape])
    e, pad, n_src, f = int(deg.sum()), 13, 97, 40
    ro = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    split = build_row_split(ro, threshold)
    assert split.num_long == int((deg > threshold).sum()) >= 1
    src = torch.from_numpy(rng.integers(0, n_src, size=e + pad).astype(np.int32))
    src[e:] = 10**6  # padding edges are never read
    g = torch.from_numpy(rng.normal(size=(len(deg), f)).astype(np.float32)).to(dtype)
    x = torch.from_numpy(rng.normal(size=(n_src, f)).astype(np.float32)).to(dtype)
    got = sddmm_by_split(g, x, src, ro, split)[:, 0]
    want = csr_sddmm_plain(g, x, src, ro)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    assert not got[e:].any()
    torch.testing.assert_close(csr_sddmm(g, x, src, ro, split), want)


@pytest.mark.parametrize("threshold", [2, 32])
@pytest.mark.parametrize("case", CASES)
def test_sddmm_schedule_matches_plain_on_graphs(rng, case, threshold):
    _, tg = _graphs(rng, case)
    g = torch.from_numpy(rng.normal(size=(N, 24)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N, 24)).astype(np.float32))
    for src, ro in ((tg.senders, tg.row_offsets), (tg.t_senders, tg.t_row_offsets)):
        want = csr_sddmm_plain(g, x, src, ro)
        got = sddmm_by_split(g, x, src, ro, build_row_split(ro, threshold))[:, 0]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_sddmm_refuses_swapped_or_stale_splits(rng):
    # receiver 0 is a long row of the forward order alone
    _, tg = _graphs(rng, "high_degree")
    assert tg.row_split.num_long == 1 and tg.t_row_split.num_long == 0
    g, x = torch.randn(N, 8), torch.randn(N, 8)
    csr_sddmm(g, x, tg.senders, tg.row_offsets, tg.row_split)
    with pytest.raises(ValueError, match="row split was not built from"):
        csr_sddmm(g, x, tg.senders, tg.row_offsets, tg.t_row_split)
    with pytest.raises(ValueError, match="row split was not built from"):
        csr_sddmm(g, x, tg.t_senders, tg.t_row_offsets, tg.row_split)
    ro = tg.row_offsets.clone()
    split = build_row_split(ro)
    csr_sddmm(g, x, tg.senders, ro, split)
    ro[1:] = ro[-1]  # every edge moves to row 0: the checked split is stale
    with pytest.raises(ValueError, match="row split was not built from"):
        csr_sddmm(g, x, tg.senders, ro, split)
