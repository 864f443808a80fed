"""The hub attention layer's fused passes (``ops/cuda/hub_fused.py``, the
``_HubLayer`` function of ``ops/hub_attention.py``) against the chain of
PyTorch ops they replace: the same bits forward, gradients within 1e-6 of
the largest entry (the backward sums over D run in another order on the
card; on the CPU the plain versions repeat the chain). The kernels
themselves are held to their plain versions in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import DGLGATConv
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.ops import hub_attention as hub
from efficient_gnns_tpu_torch.ops.cuda import hub_fused
from efficient_gnns_tpu_torch.ops.spmm import spmm


@pytest.fixture(autouse=True)
def _bf16_default():
    dispatch.set_hub_message_dtype(torch.bfloat16)
    yield
    dispatch.set_hub_message_dtype(torch.bfloat16)


def _graph(rng, n=60, e=400, used=None, self_loops=True):
    """A graph with a hub partition (a sender hub and a receiver hub); with
    ``used < n`` the nodes from ``used`` on have no edges (empty rows)."""
    used = n if used is None else used
    s = rng.integers(0, used, size=e)
    r = rng.integers(0, used, size=e)
    s[: e // 5] = 7
    r[e // 5: e // 3] = 11
    g = build_graph(s, r, n, bidirected=True, self_loops=self_loops, hub_dense=4,
                    edge_pad_multiple=16)
    assert hub.supports_hub_attention(g)
    return g


def _chain(graph, feat_src, el, *, edge_drop=0.0, drop_seed=None, scale=None, res=None):
    """The hub layer as separate PyTorch ops: messages concatenated in
    float32, cast by the SpMM, K1, a strided split, ``_Normalize``, the
    scale's broadcast multiply and the residual's add."""
    n, h, d = feat_src.shape
    dp, hp = hub_fused.hub_layout(h, d)
    e = torch.nn.functional.leaky_relu(el.float(), 0.2)
    m = e.detach().max(0, keepdim=True).values
    z = torch.exp(torch.clamp_min(e - m, -60.0))
    zx = feat_src.float() * z[:, :, None]
    if hp == 0:
        y = torch.cat([zx, z[:, :, None], zx.new_zeros(n, h, dp - d - 1)], -1).reshape(n, h * dp)
    else:
        y = torch.cat([zx.reshape(n, h * dp), torch.nn.functional.pad(z, (0, hp - h))], -1)
    weight = None
    if drop_seed is not None and edge_drop > 0.0:
        weight = hub.hub_keep_weights(graph, drop_seed, 1.0 - edge_drop)
    total = spmm(graph, y, edge_weight=weight, weight_grad=False,
                 message_dtype=dispatch.hub_message_dtype())
    if hp == 0:
        num, den, _ = total.view(n, h, dp).split([d, 1, dp - d - 1], -1)
        den = den[:, :, 0]
    else:
        num, den, _ = total.split([h * dp, h, hp - h], -1)
        num = num.view(n, h, dp)
    out = hub._Normalize.apply(num, den)
    if scale is not None:
        out = out * scale[:, None, None]
    if res is not None:
        out = out + res
    return out


SHAPES = [(3, 250), (1, 40), (2, 128)]  # z-fold, z-fold, trailing z block


def _inputs(rng, n, h, d):
    feat = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    el = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32) * 2)
    return feat, el


def _close(got, want, tol=1e-6):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * max(scale, 1e-30))


@pytest.mark.parametrize("drop", [None, 2**32 - 5])
@pytest.mark.parametrize("h,d", SHAPES)
def test_fused_layer_matches_the_chain(rng, h, d, drop):
    graph = _graph(rng)
    n = graph.num_nodes
    feat, el = _inputs(rng, n, h, d)
    scale = torch.sqrt(graph.in_degrees().clamp_min(1.0))
    res = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    seed = None if drop is None else torch.tensor(drop)
    outs, grads = [], []
    for fused in (False, True):
        f, e, r = (t.clone().requires_grad_() for t in (feat, el, res))
        kw = dict(edge_drop=0.3, drop_seed=seed)
        if fused:
            out = hub.hub_gat_attention(graph, f, e, dst_scale=scale, residual=r, **kw)
        else:
            out = _chain(graph, f, e, scale=scale, res=r, **kw)
        (out * cot).sum().backward()
        outs.append(out.detach())
        grads.append((f.grad, e.grad, r.grad))
    assert torch.equal(outs[1], outs[0])
    for got, want in zip(grads[1], grads[0]):
        _close(got, want)


@pytest.mark.parametrize("h,d", SHAPES)
def test_each_plain_pass_matches_its_part_of_the_chain(rng, h, d):
    n = 50
    dp, hp = hub_fused.hub_layout(h, d)
    x = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    z = torch.from_numpy(rng.uniform(1e-3, 1.0, size=(n, h)).astype(np.float32))
    y = hub_fused.hub_messages(x, z, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == (n, h * dp + hp)
    body, col = hub_fused._unfold(y, h, d)
    assert torch.equal(body, (x * z[:, :, None]).to(torch.bfloat16))
    assert torch.equal(col, z.to(torch.bfloat16))
    assert int((y != 0).sum()) <= n * h * (d + 1)  # zeros elsewhere
    total = torch.from_numpy(rng.normal(size=(n, h * dp + hp)).astype(np.float32))
    num, den = hub_fused._unfold(total, h, d)
    den.abs_().add_(0.5)
    den[0, 0] = 1e-39  # subnormal: an empty row
    scale = torch.from_numpy(rng.uniform(1, 3, size=n).astype(np.float32))
    res = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    out = hub_fused.hub_epilogue(total, h, d, scale, res)
    assert torch.equal(out, hub._Normalize.apply(num, den) * scale[:, None, None] + res)
    assert torch.equal(out[0, 0], res[0, 0])
    # backward: the cotangent of the sums against autograd of the same ops
    g = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    t = total.clone().requires_grad_()
    tn, td = hub_fused._unfold(t, h, d)
    (hub._Normalize.apply(tn, td) * scale[:, None, None] * g).sum().backward()
    ct = hub_fused.hub_cotangent(g, total, scale, torch.float32)
    _close(ct, t.grad)
    ct_body, ct_col = hub_fused._unfold(ct, h, d)
    assert not ct_body[0, 0].any() and float(ct_col[0, 0]) == 0.0  # the empty row
    assert torch.equal(hub_fused.hub_cotangent(g, total, scale, torch.bfloat16),
                       hub_fused.hub_cotangent(g, total, scale, torch.float32).bfloat16())
    dy = torch.from_numpy(rng.normal(size=(n, h * dp + hp)).astype(np.float32))
    xg, zg = x.clone().requires_grad_(), z.clone().requires_grad_()
    (hub_fused._fold(xg * zg[:, :, None], zg) * dy).sum().backward()
    dx, dz = hub_fused.hub_message_grad(dy, x, z)
    _close(dx, xg.grad)
    _close(dz, zg.grad)


def test_empty_rows_give_zero_output_and_zero_gradient(rng):
    graph = _graph(rng, n=70, used=55, self_loops=False)
    n, h, d = graph.num_nodes, 3, 250
    empty = graph.in_degrees() == 0
    assert empty.sum() >= 15
    feat, el = _inputs(rng, n, h, d)
    f, e = feat.clone().requires_grad_(), el.clone().requires_grad_()
    out = hub.hub_gat_attention(graph, f, e)
    assert not out[empty].any() and out[~empty].abs().sum(-1).min() > 0
    cot = torch.zeros(n, h, d)
    cot[empty] = 1.0  # a cotangent on the empty rows only reaches nothing
    (out * cot).sum().backward()
    assert not f.grad.any() and not e.grad.any()


def test_no_grad_call_saves_nothing(rng):
    graph = _graph(rng)
    n, h, d = graph.num_nodes, 3, 250
    feat, el = _inputs(rng, n, h, d)
    res = torch.randn(n, h, d).requires_grad_()
    scale = torch.sqrt(graph.in_degrees().clamp_min(1.0))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            out = hub.hub_gat_attention(graph, feat.requires_grad_(), el, dst_scale=scale,
                                        residual=res)
        assert out.grad_fn is None and saved == []
        out = hub.hub_gat_attention(graph, feat, el, dst_scale=scale, residual=res)
    dp, hp = hub_fused.hub_layout(h, d)
    assert "_HubLayer" in out.grad_fn.name()
    # the layer keeps x, z, K1's sums and the scale; no [N, H, D] output
    layer = [s for s in saved if s in ((n, h, d), (n, h), (n, h * dp + hp), (n,))]
    assert sorted(layer).count((n, h, d)) == 1 and (n, h * dp + hp) in layer


def test_conv_hub_branch_gradients_match_the_chain(rng):
    """The GAT layer's parameters (fc, attn_l, res_weight) and its input get
    the chain's gradients from the fused layer."""
    graph = _graph(rng)
    n, f, h, d = graph.num_nodes, 12, 3, 250
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    conv = DGLGATConv(f, d, h, residual=True, use_symmetric_norm=True, use_attn_dst=False,
                      edge_drop=0.3, generator=torch.Generator().manual_seed(0), device="cpu")
    conv.train()
    results = []
    for fused in (False, True):
        conv.zero_grad()
        xt = x.clone().requires_grad_()
        if fused:
            out = conv(graph, xt, torch.Generator().manual_seed(4))
        else:
            seed = torch.randint(0, 2**32, (), generator=torch.Generator().manual_seed(4),
                                 dtype=torch.int64)
            feat = (xt @ conv.fc_weight).view(-1, h, d)
            feat_src = feat * torch.rsqrt(graph.out_degrees().clamp_min(1.0))[:, None, None]
            el = torch.einsum("nhd,dh->nh", feat_src, conv.attn_l)
            out = _chain(graph, feat_src, el, edge_drop=0.3, drop_seed=seed,
                         scale=torch.sqrt(graph.in_degrees().clamp_min(1.0)),
                         res=(xt @ conv.res_weight).view(-1, h, d))
        (out * cot).sum().backward()
        results.append([out.detach(), xt.grad, conv.fc_weight.grad.clone(),
                        conv.attn_l.grad.clone(), conv.res_weight.grad.clone()])
    assert torch.equal(results[1][0], results[0][0])
    for got, want in zip(results[1][1:], results[0][1:]):
        _close(got, want)


def _wrapper_calls(n=6, h=2, d=40):
    dp, hp = hub_fused.hub_layout(h, d)
    x, z = torch.randn(n, h, d), torch.rand(n, h) + 0.1
    wide = torch.randn(n, h * dp + hp)
    return {
        "hub_messages": (hub_fused.hub_messages, dict(x=x, z=z, msg_dtype=torch.bfloat16)),
        "hub_epilogue": (hub_fused.hub_epilogue,
                         dict(total=wide, heads=h, d=d, scale=torch.ones(n), res=x)),
        "hub_cotangent": (hub_fused.hub_cotangent,
                          dict(g=x, total=wide, scale=torch.ones(n), msg_dtype=torch.float32)),
        "hub_message_grad": (hub_fused.hub_message_grad, dict(dy=wide, x=x, z=z)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_wrappers_refuse_device_mixes_and_strided_inputs(name):
    fn, kw = _wrapper_calls()[name]
    launches = fn.launches
    fn(**kw)  # the plain version on the CPU launches nothing
    assert fn.launches == launches
    for key, t in kw.items():
        if not isinstance(t, torch.Tensor):
            continue
        with pytest.raises(ValueError, match="one device"):
            fn(**{**kw, key: torch.empty(t.shape, device="meta")})
        if t.dim() >= 2:
            strided = t.transpose(0, -1).contiguous().transpose(0, -1)
            with pytest.raises(ValueError, match="contiguous"):
                fn(**{**kw, key: strided})
        with pytest.raises(ValueError):
            fn(**{**kw, key: t.double()})


def test_layout_places_the_scalar_column(rng):
    for (h, d), (dp, hp) in {(3, 250): (256, 0), (1, 40): (128, 0), (2, 128): (128, 128),
                             (1, 127): (128, 0), (130, 256): (256, 256)}.items():
        assert hub_fused.hub_layout(h, d) == (dp, hp)
    x = torch.ones(2, 2, 128)
    z = torch.tensor([[2.0, 3.0], [4.0, 5.0]])
    y = hub_fused.hub_messages(x, z, torch.float32)
    assert y.shape == (2, 384)
    assert torch.equal(y[:, 256:258], z) and not y[:, 258:].any()
    assert torch.equal(y[1, :128], torch.full((128,), 4.0))
