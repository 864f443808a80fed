"""Port vs JAX: ``RGCNConv`` on both paths, ``RGCN`` with its embedding
tables, the layer-wise full-graph inference, ``spmm(dst_rows=True)`` and the
transplant rules of the R-GCN's parameters.

Both packages get the same seeded NumPy inputs and the JAX parameters
(transplanted with ``from_jax_params``). The JAX typed path runs both ways
it runs on the CPU: through XLA, and through its Pallas kernel in interpret
mode on a graph with the edge blockings (``block_max_dst`` as the sampler
builds it). Forward and the gradients of ``x`` and of every parameter agree
to rtol 1e-4 / atol 1e-5 (``tests/test_mag.py``'s tolerances); full-graph
logits to rtol 1e-4 / atol 1e-4.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data.mag import synthetic_mag_dataset as jax_mag_dataset
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models.gnns import RGCN as JaxRGCN
from efficient_gnns_tpu.models.layers import RGCNConv as JaxRGCNConv
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.train.layerwise import RGCNLayerwiseInference as JaxLayerwise
from efficient_gnns_tpu_torch.data import synthetic_mag_dataset
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.models import RGCN, RGCNConv, from_jax_params
from efficient_gnns_tpu_torch.ops import spmm
from efficient_gnns_tpu_torch.train import RGCNLayerwiseInference, rgcn_for

to_np = partial(jax.tree_util.tree_map, np.asarray)
N, E, R, T, F_IN, F_OUT = 40, 260, 3, 2, 8, 6


@pytest.fixture
def pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False)


def _graphs(rng, block=False):
    s, r = rng.integers(0, N, size=E), rng.integers(0, N, size=E)
    r[:60] = 1  # a receiver of high degree
    et = rng.integers(0, R, size=E)
    cell = et * N + r
    w = 1.0 / np.maximum(np.bincount(cell, minlength=R * N)[cell], 1)
    kw = dict(edge_type=et, num_edge_types=R, edge_pad_multiple=64)
    tkw = dict(edge_weight=w, edge_pad_multiple=64)
    jt = jax_build_graph(s + et * N, r, R * N, **tkw,
                         **(dict(block=True, block_max_dst=N) if block else {}))
    return ((jax_build_graph(s, r, N, **kw), jt),
            (build_graph(s, r, N, **kw), build_graph(s + et * N, r, R * N, max_dst=N, **tkw)))


def _conv_state(params):
    # a bare conv's flax tree is one RGCN layer's: transplant it as conv_0
    state = from_jax_params({"conv_0": to_np(params)}, {})
    return {k[len("convs.0."):]: v for k, v in state.items()}


def _check_conv(rng, typed, block):
    (jg, jt), (g, t) = _graphs(rng, block)
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    node_type = rng.integers(0, T, size=N).astype(np.int32)
    gy = rng.normal(size=(N, F_OUT)).astype(np.float32)
    conv = JaxRGCNConv(F_OUT, num_node_types=T, num_edge_types=R)
    params = conv.init({"params": jax.random.PRNGKey(0)}, jg, jnp.asarray(x),
                       jnp.asarray(node_type))

    def loss(p, xx):
        out = conv.apply(p, jg, xx, jnp.asarray(node_type), typed_graph=jt if typed else None)
        return jnp.sum(out * gy), out

    (_, want), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    m = RGCNConv(F_IN, F_OUT, T, R, generator=torch.Generator().manual_seed(0), device="cpu")
    m.load_state_dict(_conv_state(params["params"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = m(g, xt, torch.from_numpy(node_type).long(), t if typed else None)
    (out * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-4, atol=1e-5)
    grads = _conv_state(dp["params"])
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    return out.detach()


@pytest.mark.parametrize("typed", [True, False])
def test_rgcn_conv_matches_jax(rng, typed):
    _check_conv(rng, typed, block=False)


def test_rgcn_conv_typed_matches_the_jax_pallas_path(rng, pallas_interpret):
    _check_conv(rng, True, block=True)


def test_spmm_dst_rows_is_the_first_rows_of_the_full_product(rng):
    _, (_, t) = _graphs(rng)
    x = torch.from_numpy(rng.normal(size=(R * N, 5)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(N, 5)).astype(np.float32))
    grads = []
    for dst_rows in (True, False):
        xr = x.clone().requires_grad_(True)
        out = spmm(t, xr, dst_rows=dst_rows)[:N]
        (out * gy).sum().backward()
        grads.append((out.detach(), xr.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=0)
    assert not spmm(t, x)[N:].any()
    for bad in (dict(graph=t.transpose(), x=x), dict(graph=t, x=x, transpose=True),
                dict(graph=t, x=x, edge_weight=t.edge_weight)):
        with pytest.raises(ValueError, match="dst_rows"):
            spmm(dst_rows=True, **bad)
    # RGCNConv takes only a typed graph whose receivers are bounded by its rows
    conv = RGCNConv(5, 4, T, R, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="max_dst"):
        conv(None, x[: N - 1], torch.zeros(N - 1, dtype=torch.long), t)


MAG = dict(n_paper=300, n_author=150, n_inst=10, n_field=30, feat_dim=16, num_classes=4, seed=3)


def _rgcn_pair(layers=2, hidden=12, dropout=0.0):
    jds, tds = jax_mag_dataset(**MAG), synthetic_mag_dataset(**MAG)
    g = jds.grouped
    n = g.node_type.shape[0]
    emb = tuple((g.key2int[nt], jds.num_nodes_dict[nt]) for nt in sorted(jds.num_nodes_dict)
                if nt != "paper")
    jm = JaxRGCN(hidden=hidden, out_feats=4, num_layers=layers, num_node_types=4,
                 num_edge_types=7, dropout=dropout, emb_sizes=emb, in_feats=16)
    x = np.zeros((n, 16), np.float32)
    x[g.local2global["paper"]] = jds.x_paper
    inputs = (x, g.node_type.astype(np.int32), g.local_node_idx.astype(np.int32))
    jg = jax_build_graph(g.edge_index[0], g.edge_index[1], n, edge_type=g.edge_type,
                         num_edge_types=7)
    params = jm.init({"params": jax.random.PRNGKey(1)}, jg, *map(jnp.asarray, inputs))
    tm = rgcn_for(tds, hidden, layers, dropout, seed=5, device="cpu")
    tm.load_state_dict(from_jax_params(to_np(params["params"]), {}))
    tg = build_graph(g.edge_index[0], g.edge_index[1], n, edge_type=g.edge_type,
                     num_edge_types=7)
    return (jm, params, jg), (tm, tg), inputs, g


def test_rgcn_with_embeddings_matches_jax():
    (jm, params, jg), (tm, tg), inputs, _ = _rgcn_pair()
    assert sorted(tm.embs) == ["0", "1", "2"]  # author, field_of_study, institution

    def loss(p):
        logits, feat = jm.apply(p, jg, *map(jnp.asarray, inputs))
        return jnp.sum(logits ** 2) + jnp.sum(feat), (logits, feat)

    (_, (want, want_feat)), dp = jax.value_and_grad(loss, has_aux=True)(params)
    logits, feat = tm(tg, *(torch.from_numpy(a).long() if a.dtype != np.float32
                            else torch.from_numpy(a) for a in inputs))
    ((logits ** 2).sum() + feat.sum()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(want_feat), rtol=1e-4,
                               atol=1e-5)
    grads = from_jax_params(to_np(dp["params"]), {})
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("chunk_nodes", [256, 64])
def test_layerwise_inference_matches_jax_and_the_full_forward(chunk_nodes):
    (jm, params, jg), (tm, tg), inputs, g = _rgcn_pair(layers=3)
    n = g.node_type.shape[0]
    jl = JaxLayerwise(g.edge_index[0], g.edge_index[1], g.edge_type, n, 7,
                      chunk_nodes=chunk_nodes)
    want, want_feat = jl(params, *map(jnp.asarray, inputs), num_layers=3,
                         num_node_types=4, emb_sizes=jm.emb_sizes)
    tl = RGCNLayerwiseInference(g.edge_index[0], g.edge_index[1], g.edge_type, n, 7,
                                chunk_nodes=chunk_nodes, device="cpu")
    assert tl.n_chunks == -(-n // chunk_nodes)
    tin = [torch.from_numpy(a) if a.dtype == np.float32 else torch.from_numpy(a).long()
           for a in inputs]
    got, feat = tl(tm, *tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=1e-4, atol=1e-4)
    tm.eval()
    with torch.no_grad():
        full, full_feat = tm(tg, *tin)
    torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(feat, full_feat, rtol=1e-4, atol=1e-4)


def test_transplant_rules_of_the_rgcn():
    params = {"emb_0": np.ones((5, 3)), "emb_2": np.ones((2, 3)),
              "conv_1": {"rel_lin_6": {"kernel": np.ones((3, 4))},
                         "root_lin_3": {"kernel": np.ones((3, 4)), "bias": np.zeros(4)}},
              "lin_0": {"kernel": np.ones((2, 2))}}  # the PPI skip rule stays its own
    assert sorted(from_jax_params(params, {})) == [
        "convs.1.rel_weights.6", "convs.1.root_lins.3.bias", "convs.1.root_lins.3.weight",
        "embs.0", "embs.2", "lins.0.weight"]
    tm = RGCN(16, 8, 4, 2, 4, 7, emb_sizes=((0, 5), (2, 9)), device="cpu")
    assert sorted(k for k in tm.state_dict() if not k.startswith("convs.0")) == [
        "convs.1.rel_weights." + str(r) for r in range(7)] + [
        f"convs.1.root_lins.{t}.{p}" for t in range(4) for p in ("bias", "weight")] + [
        "embs.0", "embs.2"]
