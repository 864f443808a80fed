"""Port vs JAX: the DGL-style GCN baseline ``DGLGCN`` (bias on the last conv
only, optional bias-free parallel linears, input dropout ``min(0.1,
dropout)``) with transplanted flax parameters.

Float32, the bounds of ``tests/test_torch_gcn.py``: forward outputs and
BatchNorm statistics agree to rtol 1e-5 / atol 1e-5 (summation order in the
SpMM, the matmuls and the BatchNorm sums), gradients to rtol 1e-5 and an
atol of 1e-5 times the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models import DGLGCN as JaxDGLGCN
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import DGLGCN, from_jax_params

to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
F, HIDDEN, CLASSES = 12, 16, 5


def _setup(rng, num_layers, use_linear, dropout=0.0):
    n, n_pad = 90, 100
    s = rng.integers(0, n, size=300)
    r = rng.integers(0, n, size=300)
    kw = dict(bidirected=True, self_loops=True, gcn_norm=True, pad_nodes_to=n_pad,
              edge_pad_multiple=64)
    jg = jax_build_graph(s, r, n, block=True, **kw)
    tg = build_graph(s, r, n, **kw)
    x = rng.normal(size=(n_pad, F)).astype(np.float32)
    jmodel = JaxDGLGCN(hidden=HIDDEN, out_feats=CLASSES, num_layers=num_layers,
                       dropout=dropout, use_linear=use_linear)
    variables = jmodel.init({"params": jax.random.PRNGKey(1)}, jg, jnp.asarray(x))
    tmodel = DGLGCN(F, HIDDEN, CLASSES, num_layers, dropout=dropout,
                    use_linear=use_linear, device="cpu")
    tmodel.load_state_dict(from_jax_params(to_np(variables["params"]),
                                           to_np(variables["batch_stats"])))
    return jmodel, variables, jg, tg, x, tmodel


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("use_linear", [False, True])
def test_dglgcn_eval_mode_matches_jax(rng, use_linear):
    jmodel, variables, jg, tg, x, tmodel = _setup(rng, 3, use_linear)
    # running statistics away from their (0, 1) init, as after training
    bs = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
        variables["batch_stats"])
    jl, jf = jmodel.apply({"params": variables["params"], "batch_stats": bs},
                          jg, jnp.asarray(x), training=False)
    tmodel.load_state_dict(from_jax_params(to_np(variables["params"]), to_np(bs)))
    tmodel.eval()
    with torch.no_grad():
        tl, tf = tmodel(tg, torch.from_numpy(x))
    assert tl.shape == (x.shape[0], CLASSES) and tf.shape == (x.shape[0], HIDDEN)
    _close(tl, jl)
    _close(tf, jf)
    names = {k for k in tmodel.state_dict() if "linear" in k or k.endswith("bias")}
    want = {"convs.2.bias", "bns.0.bias", "bns.1.bias"}
    if use_linear:
        want |= {f"linear_weights.{i}" for i in range(3)}
    assert names == want  # a bias on the last conv only


@pytest.mark.parametrize("use_linear", [False, True])
def test_dglgcn_train_mode_gradients_match_jax(rng, use_linear):
    jmodel, variables, jg, tg, x, tmodel = _setup(rng, 2, use_linear)
    c_logits = rng.normal(size=(x.shape[0], CLASSES)).astype(np.float32)
    c_feat = rng.normal(size=(x.shape[0], HIDDEN)).astype(np.float32)

    def jloss(params):
        (logits, feat), mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jg, jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jnp.sum(logits * c_logits) + jnp.sum(feat * c_feat), (logits, feat, mut)

    (_, (jl, jf, mut)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    tmodel.train()
    tl, tf = tmodel(tg, torch.from_numpy(x))
    ((tl * torch.from_numpy(c_logits)).sum() + (tf * torch.from_numpy(c_feat)).sum()).backward()
    _close(tl.detach(), jl)
    _close(tf.detach(), jf)
    state = dict(tmodel.named_buffers())
    for name, want in from_jax_params({}, to_np(mut["batch_stats"])).items():
        _close(state[name], want)
    grads = from_jax_params(to_np(jgrads), {})
    params = dict(tmodel.named_parameters())
    assert set(grads) == set(params)
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, want in grads.items():
        np.testing.assert_allclose(params[name].grad.numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=name)


def test_dglgcn_input_dropout_rate():
    # input dropout is min(0.1, dropout): at dropout 0.5 a tenth of the inputs
    model = DGLGCN(200, 8, 3, 1, dropout=0.5, device="cpu")
    seen = {}

    def capture(module, args):
        seen["x"] = args[1]

    model.convs[0].register_forward_pre_hook(capture)
    rng = np.random.default_rng(0)
    s = rng.integers(0, 50, size=100)
    tg = build_graph(s, rng.integers(0, 50, size=100), 50)
    x = torch.ones(50, 200)
    model.train()
    logits, out_feat = model(tg, x, generator=torch.Generator().manual_seed(0))
    assert out_feat is None  # one layer: nothing enters a last layer after a hidden one
    dropped = float((seen["x"] == 0).float().mean())
    assert 0.08 < dropped < 0.12
    model.eval()
    model(tg, x)
    assert torch.equal(seen["x"], x)
