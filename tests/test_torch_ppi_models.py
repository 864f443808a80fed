"""Port vs JAX: the PPI models (``PyGGATConv``, ``PPIGAT``, TeacherNet and
StudentNet) and their parameter transplant.

The JAX layer takes one of two branches: on a graph built with ``block=False``
(the PPI data's) its XLA composition ``sddmm_add`` -> leaky ReLU ->
``edge_softmax`` -> ``spmm_heads``, on a ``block=True`` graph of the same
edges its fused Pallas ``gat_attention`` (here in interpret mode; those cases
are in ``tests/test_torch_ppi_fused.py``, so that they run beside these). The
port runs :func:`gat_attention` on both, with its kernels' plain versions on
the CPU. The graphs are PPI-like: self loops, a receiver of high degree and
padding nodes past ``n_node_valid`` with no edge at all. Tolerances are the
attention's own (``tests/test_torch_attention.py``): rtol 2e-5 / atol 2e-6
forward, rtol 1e-4 / atol 2e-5 on gradients.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models import PPIGAT as JaxPPIGAT
from efficient_gnns_tpu.models import ppi_student as jax_ppi_student
from efficient_gnns_tpu.models import ppi_teacher as jax_ppi_teacher
from efficient_gnns_tpu.models.layers import PyGGATConv as JaxPyGGATConv
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.ops.attention import supports_fused_attention
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import (
    PPIGAT,
    PyGGATConv,
    from_jax_params,
    ppi_student,
    ppi_teacher,
)
from efficient_gnns_tpu_torch.ops.attention import gat_attention, sample_edge_masks

to_np = partial(jax.tree_util.tree_map, np.asarray)
FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=1e-4, atol=2e-5)


CONV_CASES = [(1, 5, True), (2, 4, False), (6, 3, True), (6, 4, False)]


@pytest.fixture
def xla():
    jax_dispatch.set_backend("xla")
    yield
    jax_dispatch.set_backend("auto", interpret=False)


def _graphs(rng, block, n=60, n_pad=64, e=240):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    r[: e // 5] = 2  # a receiver of high degree
    su, ru = np.concatenate([s, r]), np.concatenate([r, s])
    kw = dict(self_loops=True, pad_nodes_to=n_pad, n_node_valid=n, edge_pad_multiple=64)
    jg = jax_build_graph(su, ru, n, block=block, block_tm=32, block_eb=16, **kw)
    assert supports_fused_attention(jg) == block
    tg = build_graph(su, ru, n, **kw)
    np.testing.assert_array_equal(tg.senders.numpy(), np.asarray(jg.senders))
    return jg, tg


def _inputs(rng, n, f, n_valid=60):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[n_valid:] = 0.0  # padding rows, as the PPI data has them
    return x


def check_conv(rng, block, h, d, concat):
    """``PyGGATConv`` against the flax layer on a ``block`` graph: forward,
    ``dx`` and every parameter's gradient."""
    jg, tg = _graphs(rng, block)
    n, f = tg.num_nodes, 9
    x = _inputs(rng, n, f)
    cot = rng.normal(size=(n, h * d if concat else d)).astype(np.float32)
    jconv = JaxPyGGATConv(out_feats=d, num_heads=h, concat=concat)
    params = jconv.init({"params": jax.random.PRNGKey(3)}, jg, jnp.asarray(x))["params"]
    params = params.unfreeze() if hasattr(params, "unfreeze") else dict(params)
    params["bias"] = jnp.asarray(rng.normal(size=params["bias"].shape).astype(np.float32))

    def jloss(p, x_):
        out = jconv.apply({"params": p}, jg, x_, training=True)
        return jnp.sum(out * cot), out

    grad_fn = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    (_, jout), (jgrads, jdx) = grad_fn(params, jnp.asarray(x))
    conv = PyGGATConv(f, d, h, concat=concat, generator=torch.Generator(), device="cpu")
    state = {k[len("convs.0."):]: v
             for k, v in from_jax_params({"conv_0": to_np(params)}, {}).items()}
    conv.load_state_dict(state)
    conv.train()
    xt = torch.tensor(x, requires_grad=True)
    out = conv(tg, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **GRAD, err_msg="dx")
    want = {k[len("convs.0."):]: v
            for k, v in from_jax_params({"conv_0": to_np(jgrads)}, {}).items()}
    assert set(want) == {"weight", "att_src", "att_dst", "bias"}
    for name, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD, err_msg=name)
    assert np.isfinite(out.detach().numpy()).all()


@pytest.mark.parametrize("h,d,concat", CONV_CASES)
def test_pyg_gat_conv_matches_flax_xla_branch(rng, xla, h, d, concat):
    check_conv(rng, False, h, d, concat)


def test_pyg_gat_conv_attention_dropout_draws_from_the_generator(rng):
    _, tg = _graphs(rng, block=False)
    x = torch.from_numpy(_inputs(rng, tg.num_nodes, 9))
    conv = PyGGATConv(9, 4, 3, dropout=0.4, generator=torch.Generator().manual_seed(1),
                      device="cpu")
    conv.train()
    got = conv(tg, x, torch.Generator().manual_seed(5))
    feat = (x @ conv.weight).view(-1, 3, 4)
    el = torch.einsum("nhd,dh->nh", feat, conv.att_src)
    er = torch.einsum("nhd,dh->nh", feat, conv.att_dst)
    _, attn = sample_edge_masks(tg, torch.Generator().manual_seed(5), 0.0, 0.4, 3)
    want = gat_attention(tg, feat, el, er, attn_keep=attn, attn_keep_prob=0.6)
    torch.testing.assert_close(got, want.reshape(-1, 12) + conv.bias, rtol=0, atol=0)
    conv.eval()  # no dropout in eval mode
    torch.testing.assert_close(conv(tg, x), gat_attention(tg, feat, el, er).reshape(-1, 12)
                               + conv.bias, rtol=0, atol=0)


def check_ppi_gat(rng, block, final_heads, num_layers=3):
    """``PPIGAT`` of ``num_layers`` against the flax model on a ``block``
    graph: logits, ``out_feat`` and every parameter's gradient."""
    jg, tg = _graphs(rng, block)
    n, f = tg.num_nodes, 10
    x = _inputs(rng, n, f)
    jm = JaxPPIGAT(hidden=5, out_feats=7, num_layers=num_layers, heads=2,
                   final_heads=final_heads)
    params = jm.init({"params": jax.random.PRNGKey(2)}, jg, jnp.asarray(x))["params"]
    c_logits = rng.normal(size=(n, 7)).astype(np.float32)
    c_feat = rng.normal(size=(n, 10)).astype(np.float32)

    def jloss(p):
        logits, feat = jm.apply({"params": p}, jg, jnp.asarray(x), training=True)
        return jnp.sum(logits * c_logits) + jnp.sum(feat * c_feat), (logits, feat)

    (_, (jl, jf)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = PPIGAT(f, 5, 7, num_layers, heads=2, final_heads=final_heads, device="cpu")
    model.load_state_dict(from_jax_params(to_np(params), {}))
    model.train()
    tl, tf = model(tg, torch.from_numpy(x))
    ((tl * torch.from_numpy(c_logits)).sum() + (tf * torch.from_numpy(c_feat)).sum()).backward()
    assert model.feat_dim == tf.shape[1] == 10
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **FWD)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **FWD)
    want = from_jax_params(to_np(jgrads), {})
    assert set(want) == {name for name, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD, err_msg=name)


@pytest.mark.parametrize("final_heads", [None, 3])
def test_ppi_gat_matches_flax_xla_branch(rng, xla, final_heads):
    check_ppi_gat(rng, False, final_heads)


@pytest.mark.parametrize("which", ["teacher", "student"])
def test_reference_nets_have_the_jax_parameters(rng, xla, which):
    jg, tg = _graphs(rng, block=False)
    x = _inputs(rng, tg.num_nodes, 50)
    jm = {"teacher": jax_ppi_teacher, "student": jax_ppi_student}[which](121)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jg, jnp.asarray(x))["params"]
    want = from_jax_params(to_np(params), {})
    model = {"teacher": ppi_teacher, "student": ppi_student}[which](50, 121, device="cpu")
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(np.shape(v)))
                           for v in jax.tree_util.tree_leaves(params))
    assert model.feat_dim == {"teacher": 1024, "student": 136}[which]
    # the same initial distribution: xavier-uniform kernels, zero biases
    w = got["convs.0.weight"]
    bound = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    assert float(w.abs().max()) <= bound and not got["convs.0.bias"].any()
    model.load_state_dict(want)
    model.eval()
    logits, feat = model(tg, torch.from_numpy(x))
    jl, jf = jm.apply({"params": params}, jg, jnp.asarray(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jf), rtol=1e-4, atol=1e-5)
