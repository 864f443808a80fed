"""Port vs JAX: the GCN student with transplanted flax parameters.

Dropout 0, float32. Forward outputs, BatchNorm running statistics and
parameter gradients must agree to rtol 1e-5 / atol 1e-5, the difference
being summation order in the SpMM, the matmuls and the BatchNorm sums. For
gradients atol is 1e-5 times the model's largest gradient: the bias of a
conv that feeds a BatchNorm has a true gradient of 0 (the batch mean cancels
it), so both sides hold rounding noise of the gradients around it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models import GCN as JaxGCN
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import GCN, from_jax_params


def _setup(rng, num_layers):
    n, n_pad, f, hidden, classes = 90, 100, 12, 16, 5
    s = rng.integers(0, n, size=300)
    r = rng.integers(0, n, size=300)
    kw = dict(bidirected=True, self_loops=True, gcn_norm=True, pad_nodes_to=n_pad,
              edge_pad_multiple=64)
    jg = jax_build_graph(s, r, n, block=True, **kw)
    tg = build_graph(s, r, n, **kw)
    x = rng.normal(size=(n_pad, f)).astype(np.float32)
    jmodel = JaxGCN(hidden=hidden, out_feats=classes, num_layers=num_layers, dropout=0.0)
    variables = jmodel.init({"params": jax.random.PRNGKey(1)}, jg, jnp.asarray(x))
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    tmodel = GCN(f, hidden, classes, num_layers, dropout=0.0, device="cpu")
    tmodel.load_state_dict(from_jax_params(np_vars["params"], np_vars["batch_stats"]))
    return jmodel, variables, jg, tg, x, tmodel


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_gcn_train_mode_matches_jax(rng, num_layers):
    jmodel, variables, jg, tg, x, tmodel = _setup(rng, num_layers)
    c_logits = rng.normal(size=(x.shape[0], 5)).astype(np.float32)
    c_feat = rng.normal(size=(x.shape[0], 16)).astype(np.float32)

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

    stats = from_jax_params({}, jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
    grads = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads), {})
    state = dict(tmodel.named_buffers())
    for name, want in stats.items():
        _close(state[name], want)
    params = dict(tmodel.named_parameters())
    assert set(grads) == set(params)
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, want in grads.items():
        np.testing.assert_allclose(params[name].grad.numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=name)


def test_gcn_eval_mode_matches_jax(rng):
    jmodel, variables, jg, tg, x, tmodel = _setup(rng, 2)
    # running statistics away from their (0, 1) init, as after training
    bs = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
        variables["batch_stats"])
    jl, jf = jmodel.apply({"params": variables["params"], "batch_stats": bs},
                          jg, jnp.asarray(x), training=False)
    tmodel.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, bs)))
    tmodel.eval()
    with torch.no_grad():
        tl, tf = tmodel(tg, torch.from_numpy(x))
    _close(tl, jl)
    _close(tf, jf)


def test_dropout_uses_generator(rng):
    _, _, _, tg, x, _ = _setup(rng, 2)
    model = GCN(x.shape[1], 16, 5, 2, dropout=0.5, device="cpu")
    model.train()
    xt = torch.from_numpy(x)
    a = model(tg, xt, generator=torch.Generator().manual_seed(3))[1]
    b = model(tg, xt, generator=torch.Generator().manual_seed(3))[1]
    c = model(tg, xt, generator=torch.Generator().manual_seed(4))[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.dropout = 0.0
    live = model(tg, xt)[1] != 0
    assert 0.4 < ((a == 0) & live).sum() / live.sum() < 0.6


def test_transplant_rejects_unknown_variables():
    with pytest.raises(KeyError, match="SAGE"):
        from_jax_params({"SAGE_0": {"kernel": np.zeros((2, 2))}}, {})
