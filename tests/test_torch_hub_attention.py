"""Port vs JAX: the hub attention path of the ``--no-attn-dst`` teacher
(``graphs/hub_dense.py``, ``ops/hub_attention.py``, the hub branch of
``DGLGATConv`` and the teacher trainer on a hub graph).

The JAX side runs as ``tests/test_hub_attention.py`` runs it: Pallas in
interpret mode over a blocked graph with a hub-dense split, its hub messages
pinned to float32 unless a test says otherwise. The port runs one ``spmm``
over the full CSR with K1's plain version. The hub index arrays and the keep
masks must be the same bits; values and gradients agree to rtol 1e-4 /
atol 1e-6 with float32 messages (the JAX path sums the hub edges as dense
matmuls and the residual edges as a one-hot scatter, the port all edges in
CSR order). With the bfloat16 default both round the same float32 ``y`` to
bfloat16, and ``exp`` may differ by an ulp before that rounding: 1e-2 of
the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data import synthetic_node_dataset as jax_synthetic
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.graphs.hub_dense import auto_hub_size as jax_auto_hub_size
from efficient_gnns_tpu.models.layers import DGLGATConv as JaxConv
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.ops import hub_attention as jax_hub
from efficient_gnns_tpu.train.gat_teacher import GATTeacherTrainer as JaxTrainer
from efficient_gnns_tpu.train.gat_teacher import TeacherConfig as JaxTeacherConfig
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.graphs import auto_hub_size, build_graph
from efficient_gnns_tpu_torch.models import DGLGATConv, from_jax_params
from efficient_gnns_tpu_torch.models import layers as port_layers
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.ops import hub_attention as hub
from efficient_gnns_tpu_torch.train import GATTeacherTrainer, TeacherConfig

HUB_FIELDS = ("hub_src", "hub_dst", "src_eids", "src_rows", "src_cols",
              "dst_eids", "dst_rows", "dst_cols")


@pytest.fixture(autouse=True)
def _hub_f32():
    jax_dispatch.set_backend("pallas", interpret=True, hub_message_dtype=jnp.float32)
    dispatch.set_hub_message_dtype(torch.float32)
    yield
    jax_dispatch.set_backend("auto", interpret=False, hub_message_dtype=jnp.bfloat16)
    dispatch.set_hub_message_dtype(torch.bfloat16)


def _edges(rng, n, e):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    s[: e // 5] = 7  # a sender hub
    r[e // 5: e // 3] = 11  # a receiver hub
    return s, r


def _graphs(rng, n=60, e=400, hub_dense=4, **kw):
    s, r = _edges(rng, n, e)
    kw = {**dict(bidirected=True, self_loops=True, edge_pad_multiple=16), **kw}
    jg = jax_build_graph(s, r, n, block=True, hub_dense=hub_dense, **kw)
    return jg, build_graph(s, r, n, hub_dense=hub_dense, **kw)


def _assert_same_hub(jg, tg):
    assert (jg.hub is None) == (tg.hub is None)
    if jg.hub is None:
        return
    for name in HUB_FIELDS:
        got = getattr(tg.hub, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jg.hub, name)),
                                      err_msg=name)


@pytest.mark.parametrize("kw", [dict(hub_dense=4), dict(hub_dense=4, pad_nodes_to=70),
                                dict(hub_dense=0)])
def test_hub_partition_matches_jax(rng, kw):
    jg, tg = _graphs(rng, **kw)
    assert (tg.hub is not None) == (kw["hub_dense"] > 0)
    _assert_same_hub(jg, tg)


@pytest.mark.parametrize("gcn_norm", [False, True, "factored"])
def test_hub_partition_auto_matches_jax(gcn_norm):
    # about 225k edges after bidirection and dedup: the auto width switches on
    rng = np.random.default_rng(4)
    jg, tg = _graphs(rng, n=3000, e=160_000, hub_dense="auto", gcn_norm=gcn_norm,
                     edge_pad_multiple=1024)
    assert tg.n_edge >= 200_000 and tg.hub.hub_src.shape[0] == (
        512 if gcn_norm is False else 256)
    _assert_same_hub(jg, tg)


@pytest.mark.parametrize("args", [
    (169343, 1_882_273, 2, (512, 256)), (169343, 1_882_273, 4, (256,)),
    (2_000_000, 10**7, 2, (512, 256)), (4_000_000, 10**7, 4, (256,)),
    (169343, 199_999, 2, (512, 256)), (10**6, 10**6, 2, (512, 256)),
])
def test_auto_hub_size_matches_jax(args):
    n, e, item, widths = args
    assert auto_hub_size(n, e, itemsize=item, widths=widths) == jax_auto_hub_size(
        n, e, itemsize=item, widths=widths)


def test_transpose_and_weights_leave_the_hub_path(rng):
    _, tg = _graphs(rng)
    assert hub.supports_hub_attention(tg)
    assert not hub.supports_hub_attention(tg.transpose())
    assert hub.supports_hub_attention(tg.transpose().transpose())
    _, weighted = _graphs(rng, gcn_norm=True)
    _, factored = _graphs(rng, gcn_norm="factored")
    _, plain = _graphs(rng, hub_dense=0)
    for g in (weighted, factored, plain):
        assert not hub.supports_hub_attention(g)
    with pytest.raises(ValueError, match="hub partition"):
        hub.hub_gat_attention(plain, torch.zeros(plain.num_nodes, 1, 4),
                              torch.zeros(plain.num_nodes, 1))
    moved = tg.to("cpu")
    for name in HUB_FIELDS:
        assert torch.equal(getattr(moved.hub, name), getattr(tg.hub, name))


SEEDS = [0, 987, 2**31 + 5, 2**32 - 1, 2**32 - 0x5EED + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_hashes_match_jax_bit_for_bit(rng, seed):
    vals = np.concatenate([rng.integers(0, 2**32, size=300, dtype=np.uint64),
                           np.array([0, 1, 2**31, 2**32 - 1], np.uint64)])
    got = hub._hash_u32(torch.from_numpy(vals.astype(np.int64)))
    want = jax_hub._hash_u32(jnp.asarray(vals.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    eids = rng.integers(0, 50_000, size=500)
    for salt in (0, 0x5EED, 0x51, 0xD5):
        for keep in (0.7, 0.5, 1.0):
            want = jax_hub.edge_keep_mask(jnp.asarray(eids, jnp.int32), jnp.uint32(seed), keep,
                                          salt=salt)
            got = hub.edge_keep_mask(torch.from_numpy(eids), torch.tensor(seed), keep, salt)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    grid = np.asarray(jax_hub._grid_keep_mask(37, 23, jnp.uint32(seed), 0.6, salt=0x51))
    rows, cols = np.meshgrid(np.arange(37), np.arange(23), indexing="ij")
    got = hub._grid_keep_mask(torch.from_numpy(rows.ravel()), torch.from_numpy(cols.ravel()),
                              seed, 0.6, 0x51)
    np.testing.assert_array_equal(got.numpy().reshape(37, 23), grid)


@pytest.mark.parametrize("seed", [3, 2**32 - 2])
def test_keep_weights_match_jax_masks(rng, seed):
    jg, tg = _graphs(rng, n=80, e=600)
    keep_prob = 0.65
    got = hub.hub_keep_weights(tg, torch.tensor(seed), keep_prob).numpy()
    # the JAX masks read at each edge's place, by its partition
    jh, e = jg.hub, tg.n_edge
    want = np.zeros(tg.num_edges_padded, np.float32)
    blk = jg.blocking
    res = np.asarray(blk.csr_perm)
    res_keep = np.asarray(jax_hub.edge_keep_mask(blk.csr_perm, jnp.uint32(seed), keep_prob,
                                                 salt=0x5EED))
    want[res[res < e]] = res_keep[res < e]
    m_src = np.asarray(jax_hub._grid_keep_mask(jg.num_nodes, jh.hub_src.shape[0],
                                               jnp.uint32(seed), keep_prob, salt=0x51))
    want[np.asarray(jh.src_eids)] = m_src[np.asarray(jh.src_rows), np.asarray(jh.src_cols)]
    m_dst = np.asarray(jax_hub._grid_keep_mask(jh.hub_dst.shape[0], jg.num_nodes,
                                               jnp.uint32(seed), keep_prob, salt=0xD5))
    want[np.asarray(jh.dst_eids)] = m_dst[np.asarray(jh.dst_rows), np.asarray(jh.dst_cols)]
    np.testing.assert_array_equal(got, want)
    assert 0.4 < got[:e].mean() < 0.9 and not got[e:].any()
    # the residual edges are the ones neither hub set holds
    n_res = np.unique(res[res < e]).size
    assert n_res + jh.src_eids.shape[0] + jh.dst_eids.shape[0] == e


def _attention_both(jg, tg, feat, el, cot, edge_drop=0.0, seed=None):
    """(out, dfeat, del) of ``sum(hub_gat_attention(...) * cot)`` on both sides."""
    jseed = None if seed is None else jnp.uint32(seed)

    def jloss(f, e):
        out = jax_hub.hub_gat_attention(jg, f, e, negative_slope=0.2,
                                        edge_drop=edge_drop, drop_seed=jseed)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feat), jnp.asarray(el))
    tf = torch.tensor(feat, requires_grad=True)
    te = torch.tensor(el, requires_grad=True)
    tout = hub.hub_gat_attention(tg, tf, te, negative_slope=0.2, edge_drop=edge_drop,
                                 drop_seed=None if seed is None else torch.tensor(seed))
    (tout * torch.from_numpy(cot)).sum().backward()
    return ((np.asarray(jout), np.asarray(jgrads[0]), np.asarray(jgrads[1])),
            (tout.detach().numpy(), tf.grad.numpy(), te.grad.numpy()))


@pytest.mark.parametrize("seed", [None, 11, 2**32 - 7])
@pytest.mark.parametrize("h,d", [(3, 8), (2, 128)])
def test_hub_gat_attention_matches_jax(rng, h, d, seed):
    jg, tg = _graphs(rng)
    n = tg.num_nodes
    feat = rng.normal(size=(n, h, d)).astype(np.float32)
    el = rng.normal(size=(n, h)).astype(np.float32) * 2
    cot = rng.normal(size=(n, h, d)).astype(np.float32)
    want, got = _attention_both(jg, tg, feat, el, cot, 0.0 if seed is None else 0.4, seed)
    for name, g, w in zip(("out", "dfeat", "del"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
    if seed is not None:  # the drop removed edges: another result than without it
        no_drop = hub.hub_gat_attention(tg, torch.from_numpy(feat), torch.from_numpy(el))
        assert float((no_drop - torch.from_numpy(got[0])).abs().max()) > 1e-3


def test_hub_gat_attention_bf16_default_close_to_jax(rng):
    jax_dispatch.set_backend("pallas", interpret=True, hub_message_dtype=jnp.bfloat16)
    dispatch.set_hub_message_dtype(torch.bfloat16)
    jg, tg = _graphs(rng)
    n, h, d = tg.num_nodes, 3, 8
    feat = rng.normal(size=(n, h, d)).astype(np.float32)
    el = rng.normal(size=(n, h)).astype(np.float32)
    cot = np.ones((n, h, d), np.float32)
    (jout, _, _), (tout, dfeat, del_) = _attention_both(jg, tg, feat, el, cot, 0.3, 5)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-2 * np.abs(jout).max())
    assert np.isfinite(dfeat).all() and np.isfinite(del_).all()


def test_floor_flattens_far_receivers_and_stays_finite(rng):
    _, tg = _graphs(rng, n=40, e=200)
    n, h, d = tg.num_nodes, 2, 4
    feat = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32)).requires_grad_()
    el_np = np.full((n, h), -100.0, np.float32)
    el_np[0] = 200.0  # 300 nats of spread: every other sender lies at the floor
    el = torch.from_numpy(el_np).requires_grad_()
    out = hub.hub_gat_attention(tg, feat, el)
    (out ** 2).sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(feat.grad).all()
    assert torch.isfinite(el.grad).all()
    s, r = tg.senders[: tg.n_edge].numpy(), tg.receivers[: tg.n_edge].numpy()
    checked = 0
    for node in range(n):
        eids = np.nonzero(r == node)[0]
        if len(eids) == 0 or np.any(s[eids] == 0):
            continue
        np.testing.assert_allclose(out[node].detach().numpy(),
                                   feat[s[eids]].detach().numpy().mean(0), rtol=1e-4, atol=1e-4)
        checked += 1
    assert checked > 0


def test_normalize_backward_matches_jax_at_tiny_denominators(rng):
    n, h, d = 8, 2, 4
    den = np.array([[1.0, 1e-10], [1e-19, 1e-25], [1e-30, 1e-38], [4e-39, 1e-44],
                    [0.0, 1.0], [1e-20, 0.0], [5e-1, 1e-35], [1e-42, 1e-15]], np.float32)
    num = rng.normal(size=(n, h, d)).astype(np.float32) * den[:, :, None]
    cot = rng.normal(size=(n, h, d)).astype(np.float32)
    jgrads = jax.grad(lambda a, b: jnp.sum(jax_hub._normalize(a, b) * cot), argnums=(0, 1))(
        jnp.asarray(num), jnp.asarray(den))
    tn, td = torch.tensor(num, requires_grad=True), torch.tensor(den, requires_grad=True)
    out = hub._Normalize.apply(tn, td)
    (out * torch.from_numpy(cot)).sum().backward()
    jout = np.asarray(jax_hub._normalize(jnp.asarray(num), jnp.asarray(den)))
    # subnormal denominators count as empty rows, as XLA (which flushes them
    # to zero) treats them
    for got, want in ((out.detach(), jout), (tn.grad, jgrads[0]), (td.grad, jgrads[1])):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    empty = den < np.finfo(np.float32).tiny
    assert not tn.grad.numpy()[empty].any() and not td.grad.numpy()[empty].any()


def _conv_pair(rng, f, h, d, **kw):
    jconv = JaxConv(out_feats=d, num_heads=h, residual=True, use_symmetric_norm=True, **kw)
    conv = DGLGATConv(f, d, h, residual=True, use_symmetric_norm=True,
                      generator=torch.Generator(), device="cpu", **kw)
    return jconv, conv


@pytest.mark.parametrize("slope,act", [(0.2, None), (0.1, "elu")])
def test_dgl_gat_conv_hub_branch_matches_flax(rng, slope, act):
    jg, tg = _graphs(rng)
    n, f, h, d = tg.num_nodes, 9, 3, 5
    x = rng.normal(size=(n, f)).astype(np.float32)
    cot = rng.normal(size=(n, h, d)).astype(np.float32)
    kw = dict(use_attn_dst=False, negative_slope=slope)
    jact = None if act is None else jax.nn.elu
    jconv = JaxConv(out_feats=d, num_heads=h, residual=True, use_symmetric_norm=True,
                    activation=jact, **kw)
    conv = DGLGATConv(f, d, h, residual=True, use_symmetric_norm=True,
                      activation=None if act is None else torch.nn.functional.elu,
                      generator=torch.Generator(), device="cpu", **kw)
    params = jconv.init({"params": jax.random.PRNGKey(3)}, jg, jnp.asarray(x))["params"]

    def jloss(p, x_):
        out = jconv.apply({"params": p}, jg, x_, training=True)
        return jnp.sum(out * cot), out

    (_, jout), (jgrads, jdx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    conv.load_state_dict({"fc_weight": torch.tensor(np.asarray(params["Dense_0"]["kernel"])),
                          "res_weight": torch.tensor(np.asarray(params["Dense_1"]["kernel"])),
                          "attn_l": torch.tensor(np.asarray(params["attn_l"]))})
    conv.train()
    xt = torch.tensor(x, requires_grad=True)
    out = conv(tg, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(conv.attn_l.grad.numpy(), np.asarray(jgrads["attn_l"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,takes_hub", [
    ("hub", True), ("attn_dst", False), ("attn_drop", False), ("no_hub", False),
    ("transposed", False), ("eval", True),
])
def test_dgl_gat_conv_takes_the_hub_branch_only_when_it_should(rng, monkeypatch, case,
                                                               takes_hub):
    _, tg = _graphs(rng, hub_dense=0 if case == "no_hub" else 4)
    if case == "transposed":
        tg = tg.transpose()
    calls = []
    real = port_layers.hub_gat_attention

    def spy(*args, **kwargs):
        calls.append(kwargs["drop_seed"])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_layers, "hub_gat_attention", spy)
    conv = DGLGATConv(6, 4, 2, edge_drop=0.3, attn_drop=0.2 if case == "attn_drop" else 0.0,
                      use_attn_dst=case == "attn_dst", generator=torch.Generator(),
                      device="cpu")
    conv.train(case != "eval")
    gen = torch.Generator().manual_seed(1)
    out = conv(tg, torch.randn(tg.num_nodes, 6), gen)
    assert out.shape == (tg.num_nodes, 2, 4) and torch.isfinite(out).all()
    assert len(calls) == int(takes_hub)
    if takes_hub:  # one uint32 seed per call in training, none in evaluation
        seed = calls[0]
        assert (seed is None) == (case == "eval")
        if seed is not None:
            assert seed.dtype == torch.int64 and 0 <= int(seed) < 2**32


DATA = dict(num_nodes=300, num_edges=1200, feat_dim=10, num_classes=4, seed=2,
            signal=0.6, gcn_norm=False, hub_dense=4)


def test_hub_teacher_trainer_tracks_jax():
    jd, td = jax_synthetic(**DATA), synthetic_node_dataset(**DATA)
    assert jd.graph.hub is not None and hub.supports_hub_attention(td.graph)
    _assert_same_hub(jd.graph, td.graph)
    cfg = dict(n_hidden=6, n_layers=3, n_heads=2, dropout=0.0, input_drop=0.0,
               attn_drop=0.0, edge_drop=0.0, use_norm=True, lr=0.05, use_labels=True,
               n_label_iters=1, mask_rate=0.0, no_attn_dst=True)
    jtr = JaxTrainer(JaxTeacherConfig(**cfg), jd.graph, jd.x, jd.y, jd.split_idx, 4)
    ttr = GATTeacherTrainer(TeacherConfig(**cfg), td.graph, td.x, td.y, td.split_idx, 4,
                            device="cpu")
    to_np = jax.tree_util.tree_map
    ttr.model.load_state_dict(from_jax_params(to_np(np.asarray, jtr.state.params),
                                              to_np(np.asarray, jtr.state.batch_stats)))
    _, want = jtr.run_epochs(1, 3)
    _, got = ttr.run_epochs(1, 3)
    want = np.asarray(want)
    losses = [0, 5, 6, 7]
    np.testing.assert_allclose(got[:, losses], want[:, losses], rtol=1e-4, atol=1e-6)
    assert got[-1, 0] != got[0, 0]
