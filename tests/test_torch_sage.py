"""Port vs JAX: the SAGE student and the projection heads with transplanted
flax parameters.

Dropout 0, float32. Forward outputs, BatchNorm running statistics and
parameter gradients must agree to rtol 1e-4 (atol 1e-5; for gradients 1e-5
times the module's largest gradient, because a bias that feeds a BatchNorm
has a true gradient of 0 and both sides hold rounding noise there). The JAX
side aggregates through its Pallas K1 in interpret mode over an edge-blocked
graph; the port through K1's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models import SAGE as JaxSAGE
from efficient_gnns_tpu.models import ProjectionGCD as JaxProjectionGCD
from efficient_gnns_tpu.models import ProjectionLinear as JaxProjectionLinear
from efficient_gnns_tpu.models import ProjectionMLP as JaxProjectionMLP
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import (
    SAGE,
    ProjectionGCD,
    ProjectionLinear,
    ProjectionMLP,
    from_jax_params,
)

N, N_PAD, F, HIDDEN, CLASSES = 90, 100, 12, 16, 5


@pytest.fixture(autouse=True)
def _pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(rng, gcn_norm):
    s = rng.integers(0, N, size=300)
    r = rng.integers(0, N, size=300)
    r[:60] = 4  # a high-degree receiver
    kw = dict(bidirected=True, self_loops=True, gcn_norm=gcn_norm, pad_nodes_to=N_PAD,
              edge_pad_multiple=64)
    return jax_build_graph(s, r, N, block=True, **kw), build_graph(s, r, N, **kw)


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=1e-5)


def _compare_train_step(japply, variables, tmodule, tcall, cots):
    """One train-mode forward and backward on both sides: outputs, updated
    BatchNorm statistics and every parameter gradient."""
    def jloss(params):
        outs, mut = japply(
            {"params": params, "batch_stats": variables.get("batch_stats", {})},
            training=True, mutable=["batch_stats"])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, mut)

    (_, (jouts, mut)), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tmodule.train()
    touts = tcall()
    touts = touts if isinstance(touts, tuple) else (touts,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots)).backward()
    for t, j in zip(touts, jouts):
        _close(t.detach(), j)
    stats = from_jax_params({}, _np(mut.get("batch_stats", {})))
    buffers = dict(tmodule.named_buffers())
    assert set(stats) == set(buffers)
    for name, want in stats.items():
        _close(buffers[name], want)
    grads = from_jax_params(_np(jgrads), {})
    params = dict(tmodule.named_parameters())
    assert set(grads) == set(params)
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, want in grads.items():
        np.testing.assert_allclose(params[name].grad.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def _sage(rng, num_layers, gcn_norm):
    jg, tg = _graphs(rng, gcn_norm)
    x = rng.normal(size=(N_PAD, F)).astype(np.float32)
    jmodel = JaxSAGE(hidden=HIDDEN, out_feats=CLASSES, num_layers=num_layers, dropout=0.0)
    variables = jmodel.init({"params": jax.random.PRNGKey(1)}, jg, jnp.asarray(x))
    tmodel = SAGE(F, HIDDEN, CLASSES, num_layers, dropout=0.0, device="cpu")
    np_vars = _np(variables)
    tmodel.load_state_dict(from_jax_params(np_vars["params"], np_vars["batch_stats"]))
    return jmodel, variables, jg, tg, x, tmodel


# the CLIs' dataset graph carries GCN weights: SAGE's "mean" then sums with
# them and divides by the in-degree count, in both packages alike
@pytest.mark.parametrize("gcn_norm", [False, True])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_sage_train_mode_matches_jax(rng, num_layers, gcn_norm):
    jmodel, variables, jg, tg, x, tmodel = _sage(rng, num_layers, gcn_norm)
    cots = (rng.normal(size=(N_PAD, CLASSES)).astype(np.float32),
            rng.normal(size=(N_PAD, HIDDEN)).astype(np.float32))
    _compare_train_step(
        lambda v, **kw: jmodel.apply(v, jg, jnp.asarray(x), **kw), variables,
        tmodel, lambda: tmodel(tg, torch.from_numpy(x)), cots)


def test_sage_eval_mode_matches_jax(rng):
    jmodel, variables, jg, tg, x, tmodel = _sage(rng, 2, False)
    # running statistics away from their (0, 1) init, as after training
    bs = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
        variables["batch_stats"])
    jl, jf = jmodel.apply({"params": variables["params"], "batch_stats": bs},
                          jg, jnp.asarray(x), training=False)
    tmodel.load_state_dict(from_jax_params(_np(variables["params"]), _np(bs)))
    tmodel.eval()
    with torch.no_grad():
        tl, tf = tmodel(tg, torch.from_numpy(x))
    _close(tl, jl)
    _close(tf, jf)


HEADS = {
    "linear": (JaxProjectionLinear, ProjectionLinear, {}),
    "mlp": (JaxProjectionMLP, ProjectionMLP, {}),
    "gcd": (JaxProjectionGCD, ProjectionGCD, {}),
    "gcd-no-linear": (JaxProjectionGCD, ProjectionGCD, {"use_linear": False}),
}


def _head(rng, name):
    jcls, tcls, kw = HEADS[name]
    jg, tg = _graphs(rng, True)
    x = rng.normal(size=(N_PAD, F)).astype(np.float32)
    jhead = jcls(proj_dim=8, **kw)
    thead = tcls(F, 8, device="cpu", **kw)
    jkw, tkw = {}, {}
    if name.startswith("gcd"):
        jargs, targs = (jg, jnp.asarray(x)), (tg, torch.from_numpy(x))
    else:  # the MLP heads see gathered rows and an optional row mask
        mask = rng.random(N_PAD) < 0.8
        jargs, targs = (jnp.asarray(x),), (torch.from_numpy(x),)
        jkw, tkw = {"mask": jnp.asarray(mask)}, {"mask": torch.from_numpy(mask)}
    variables = jhead.init({"params": jax.random.PRNGKey(2)}, *jargs)
    thead.load_state_dict(from_jax_params(
        _np(variables["params"]), _np(variables.get("batch_stats", {}))))
    return jhead, variables, jargs, jkw, thead, targs, tkw


@pytest.mark.parametrize("name", sorted(HEADS))
def test_projection_head_train_mode_matches_jax(rng, name):
    jhead, variables, jargs, jkw, thead, targs, tkw = _head(rng, name)
    cots = (rng.normal(size=(N_PAD, 8)).astype(np.float32),)
    _compare_train_step(
        lambda v, **kw: jhead.apply(v, *jargs, **jkw, **kw), variables,
        thead, lambda: thead(*targs, **tkw), cots)


@pytest.mark.parametrize("name", sorted(HEADS))
def test_projection_head_eval_mode_matches_jax(rng, name):
    jhead, variables, jargs, jkw, thead, targs, tkw = _head(rng, name)
    bs = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
        variables.get("batch_stats", {}))
    want = jhead.apply({"params": variables["params"], "batch_stats": bs},
                       *jargs, **jkw, training=False)
    thead.load_state_dict(from_jax_params(_np(variables["params"]), _np(bs)))
    thead.eval()
    with torch.no_grad():
        got = thead(*targs, **tkw)
    _close(got, want)


def test_heads_draw_their_init_from_the_seed():
    a, b, c = (ProjectionMLP(F, 8, seed=s, device="cpu") for s in (1, 1, 2))
    assert torch.equal(a.weight, b.weight) and not torch.equal(a.weight, c.weight)
    bound = (6.0 / (F + 8)) ** 0.5  # xavier uniform over [in, out]
    assert a.weight.shape == (F, 8) and a.weight.abs().max() <= bound
    g = ProjectionGCD(F, 8, seed=1, device="cpu")
    assert not torch.equal(g.conv.weight, g.lin_weight)
