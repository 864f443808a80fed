"""Port vs JAX: ``spmm_heads`` and ``gat_attention`` with bfloat16 messages
(K2 and K4 read bfloat16 ``x`` and cotangent, accumulate in float32).

The JAX side runs its Pallas functions in interpret mode with
``message_dtype=bfloat16`` over an edge-blocked graph; the port runs the
kernels' plain versions with ``dispatch.message_dtype()`` bfloat16. Both
round the same features and cotangents to bfloat16. The known difference:
the Pallas K2 also rounds each head weight and each ``w * x`` product to
bfloat16 before it accumulates, while the port keeps them float32 (as it
does for K1, ``tests/test_torch_spmm.py``). So every output is held to

    |port - jax| <= 2**-7 * S + 1e-5

where ``S`` is the output's sum of |terms| (``sum_e |w_e| |x_e|`` for K2's
outputs, ``sum_c |g_c| |x_c|`` for K4's, carried through the softmax
backward for the logit gradients). Largest gaps measured over these cases,
as a share of that bound: 0.40 on ``spmm_heads``' out (3.8e-2 where S = 55),
0.43 on ``dx`` (3.5e-2 where S = 68; the Pallas rounding of ``w``), 7e-6 on
``dw`` (9.5e-7: both form K4's products in float32); in ``gat_attention``
0.45 on ``dfeat`` (1.7e-2 where S = 26) and below 1e-6 absolute on the logit
gradients.
"""

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
from efficient_gnns_tpu_torch.graphs import build_graph, build_row_split
from efficient_gnns_tpu_torch.ops import dispatch, edge_softmax, sddmm_add, spmm_heads
from efficient_gnns_tpu_torch.ops.attention import gat_attention
from efficient_gnns_tpu_torch.ops.cuda import (
    csr_sddmm_heads,
    csr_sddmm_heads_plain,
    csr_segment_sum_heads,
    csr_segment_sum_heads_plain,
)

N = 70
TOL_REL, TOL_ABS = 2.0**-7, 1e-5
HEADS = [(3, 5), (2, 16)]  # D = 5: no multiple of 8 (and odd)


@pytest.fixture
def bf16_messages():
    jax_dispatch.set_backend("pallas", interpret=True, message_dtype=jnp.bfloat16)
    dispatch.set_message_dtype(torch.bfloat16)
    yield
    jax_dispatch.set_backend("auto", interpret=False, message_dtype=jnp.float32)
    dispatch.set_message_dtype(torch.float32)


@pytest.fixture
def graphs(rng):
    e = 310
    s = rng.integers(5, N, size=e)  # nodes 0-4 send nothing
    r = rng.integers(0, N - 10, size=e)  # nodes 60-69 receive nothing
    r[: e // 4] = 3  # a receiver of high degree
    s[e // 4: e // 2] = 11  # a sender of high degree
    jg = attach_blocking(jax_build_graph(s, r, N, edge_pad_multiple=64), tm=32, eb=16)
    tg = build_graph(s, r, N, edge_pad_multiple=64)
    assert tg.n_edge < tg.num_edges_padded  # padding edges present
    return jg, tg


def _bf16(a) -> torch.Tensor:
    """float32 tensor of ``a`` rounded to bfloat16."""
    return torch.as_tensor(a).bfloat16().float()


def _within(got, want, scale, name):
    """``|got - want| <= 2**-7 * scale + 1e-5`` everywhere."""
    gap = np.abs(np.asarray(got) - np.asarray(want))
    bound = TOL_REL * np.asarray(scale) + TOL_ABS
    assert np.isfinite(got).all(), name
    assert (gap <= bound).all(), (
        f"{name}: gap {gap.max():.3e} above 2**-7 * S + 1e-5 (worst ratio "
        f"{(gap / bound).max():.2f})")


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


@pytest.mark.parametrize("h,d", HEADS)
def test_spmm_heads_bf16_matches_jax(rng, graphs, bf16_messages, h, d):
    jg, tg = graphs
    x = rng.normal(size=(N, h, d)).astype(np.float32)
    w = rng.normal(size=(tg.num_edges_padded, h)).astype(np.float32)
    w[tg.n_edge:] = 0.0
    cot = rng.normal(size=(N, h, d)).astype(np.float32)
    (jo, (jdx, jdw)), (to, (tdx, tdw)) = _linear_loss_grads(
        lambda x_, w_: jax_ops.spmm_heads(jg, x_, w_),
        lambda x_, w_: spmm_heads(tg, x_, w_), (x, w), cot)
    assert to.dtype == tdx.dtype == tdw.dtype == np.float32
    xa, ca = _bf16(x).abs().view(N, -1), _bf16(cot).abs().view(N, -1)
    wa = torch.from_numpy(w).abs()
    perm = tg.csc_perm.long()
    s_out = csr_segment_sum_heads_plain(xa, wa, tg.senders, tg.row_offsets)
    s_dx = csr_segment_sum_heads_plain(ca, wa[perm].contiguous(), tg.t_senders,
                                       tg.t_row_offsets)
    s_dw = csr_sddmm_heads_plain(ca, xa, tg.senders, tg.row_offsets, h)
    _within(to, jo, s_out.view(N, h, d), "out")
    _within(tdx, jdx, s_dx.view(N, h, d), "dx")
    _within(tdw, jdw, s_dw, "dw")
    # against float32 messages the port moves by the rounding of x alone
    dispatch.set_message_dtype(torch.float32)
    exact = spmm_heads(tg, torch.from_numpy(x), torch.from_numpy(w)).numpy()
    _within(to, exact, s_out.view(N, h, d), "out against float32 messages")


def _attention_scales(tg, feat, el, er, cot, keep, attn, keep_prob):
    """Sums of |terms| of ``gat_attention``'s out, dfeat, del and der with
    bfloat16 features and cotangent (the probabilities in float32)."""
    n, h, d = feat.shape
    e = tg.n_edge
    logits = torch.nn.functional.leaky_relu(
        sddmm_add(tg, torch.from_numpy(el), torch.from_numpy(er)), 0.2)
    a = edge_softmax(tg, logits, None if keep is None else torch.from_numpy(keep))
    a_drop = a if attn is None else torch.where(torch.from_numpy(attn), a / keep_prob, 0.0)
    fa, ca = _bf16(feat).abs().view(n, -1), _bf16(cot).abs().view(n, -1)
    perm = tg.csc_perm.long()
    s_out = csr_segment_sum_heads_plain(fa, a_drop, tg.senders, tg.row_offsets)
    s_dfeat = csr_segment_sum_heads_plain(ca, a_drop[perm].contiguous(), tg.t_senders,
                                          tg.t_row_offsets)
    s_da = csr_sddmm_heads_plain(ca, fa, tg.senders, tg.row_offsets, h)
    if attn is not None:
        s_da = torch.where(torch.from_numpy(attn), s_da / keep_prob, 0.0)
    recv, send = tg.receivers[:e].long(), tg.senders[:e].long()
    inner = torch.zeros(n, h).index_add_(0, recv, (a * s_da)[:e])
    s_de = a[:e] * (s_da[:e] + inner[recv])
    s_der = torch.zeros(n, h).index_add_(0, recv, s_de)
    s_del = torch.zeros(n, h).index_add_(0, send, s_de)
    return s_out.view(n, h, d), s_dfeat.view(n, h, d), s_del, s_der


@pytest.mark.parametrize("h,d,masks", [(3, 5, False), (2, 16, True)])
def test_gat_attention_bf16_matches_jax(rng, graphs, bf16_messages, h, d, masks):
    jg, tg = graphs
    blk = jg.blocking
    feat = rng.normal(size=(N, h, d)).astype(np.float32)
    el = rng.normal(size=(N, h)).astype(np.float32)
    er = rng.normal(size=(N, h)).astype(np.float32)
    cot = rng.normal(size=(N, h, d)).astype(np.float32)
    keep = attn = jkeep = jattn = None
    if masks:
        keep = rng.random(tg.num_edges_padded) < 0.7
        attn = rng.random((tg.num_edges_padded, h)) < 0.8
        slot = np.minimum(np.asarray(blk.csr_perm if blk.csr_perm is not None
                                     else blk.edge_id), tg.num_edges_padded - 1)
        real_slot = np.asarray(blk.dst_local).reshape(-1) < blk.tm
        jkeep = jnp.asarray(keep[slot] & real_slot)
        jattn = jnp.asarray(attn[slot])
    tkeep = None if keep is None else torch.from_numpy(keep)
    tattn = None if attn is None else torch.from_numpy(attn)
    kw = dict(negative_slope=0.2, attn_keep_prob=0.8)
    (jo, jgr), (to, tgr) = _linear_loss_grads(
        lambda f, l, r: jax_gat_attention(jg, f, l, r, keep_mask=jkeep, attn_keep=jattn, **kw),
        lambda f, l, r: gat_attention(tg, f, l, r, keep_mask=tkeep, attn_keep=tattn, **kw),
        (feat, el, er), cot)
    scales = _attention_scales(tg, feat, el, er, cot, keep, attn, 0.8)
    for got, want, scale, name in zip([to, *tgr], [jo, *jgr], scales,
                                      ("out", "dfeat", "del", "der")):
        assert got.dtype == np.float32, name
        _within(got, want, scale, name)


@pytest.mark.parametrize("h,d", [(3, 5), (2, 16), (1, 40), (2, 68)])
def test_plain_versions_read_bf16_as_float32_of_the_rounded_values(rng, graphs, h, d):
    _, tg = graphs
    x = torch.from_numpy(rng.normal(size=(N, h * d)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(N, h * d)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(tg.num_edges_padded, h)).astype(np.float32))
    split = build_row_split(tg.row_offsets, 16)
    for got in (csr_segment_sum_heads_plain(x, w, tg.senders, tg.row_offsets),
                csr_segment_sum_heads(x, w, tg.senders, tg.row_offsets, split)):
        want = csr_segment_sum_heads_plain(x.float(), w, tg.senders, tg.row_offsets)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    for got in (csr_sddmm_heads_plain(g, x, tg.senders, tg.row_offsets, h),
                csr_sddmm_heads(g, x, tg.senders, tg.row_offsets, h, split)):
        want = csr_sddmm_heads_plain(g.float(), x.float(), tg.senders, tg.row_offsets, h)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
        assert (got[tg.n_edge:] == 0).all()
