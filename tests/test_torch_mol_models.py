"""Port vs JAX: the sorted segment ops (``ops/sorted_segment.py``) and the
molhiv models (``models/mol.py``) on the CPU.

The same packed batch (the port's ``pack_graphs`` and the JAX one give
equal arrays, ``test_torch_mol_data.py``) and the same parameters
(transplanted with ``mol_from_jax_params``) go through both; the loss is
``sum(sin(out)) + sum(sin(feat))`` so every output entry carries its own
cotangent. Tolerance: values rtol 1e-5 / atol 1e-6 (atol 1e-5 after the
three BatchNorm layers of a ``MolGNN``); gradients rtol 1e-5 with an atol
of 1e-5 times the largest gradient of the model (float32 rounding, which
BatchNorm's backward scales up in the parameters in front of it: their
true gradient is near 0). BatchNorm statistics rtol 1e-5 / atol 1e-5. The
sorted segment ops' own gradients hold to rtol 1e-6.

A ``MolGNN``'s values and statistics are held against the JAX model's,
its gradients against the JAX model run in float64 (``jax.enable_x64``;
its BatchNorm still reduces in float32), on a synthetic batch and, for one
residual setting a conv, the long batch: PNA's
float32 gradient is ill-conditioned in the JAX form (``models/mol.py``,
``PNAConv``). On the long batch the JAX float32 gradient lies 1.0e-2 from
its float64 one and the port's 1.2e-5; the last test asserts a factor of
50 between them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from efficient_gnns_tpu.data import molhiv as jax_mol
from efficient_gnns_tpu.graphs.batching import pack_graphs as jax_pack_graphs
from efficient_gnns_tpu.models import mol as jax_models
from efficient_gnns_tpu.ops import gather as jax_gather
from efficient_gnns_tpu.ops import segment_sum as jax_segment_sum
from efficient_gnns_tpu_torch.data import molhiv as mol
from efficient_gnns_tpu_torch.graphs import ROW_SPLIT_THRESHOLD, pack_graphs
from efficient_gnns_tpu_torch.models import mol as models
from efficient_gnns_tpu_torch.models.transplant import mol_from_jax_params
from efficient_gnns_tpu_torch.ops.sorted_segment import csr_segment_sum_sorted, gather_rows_csr

to_np = partial(jax.tree_util.tree_map, np.asarray)
FWD = dict(rtol=1e-5, atol=1e-6)
DEEP = dict(rtol=1e-5, atol=1e-5)  # after three layers of BatchNorm
H = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small, and
    parallel test workers that each start a thread a core run many times
    slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _long_batch():
    """Five molecules, one of more than 128 atoms whose atom 0 receives
    more than 128 bonds (a long pool row and a long aggregation row), one
    atom without bonds, a padded empty graph; payloads for the bonds."""
    rng = np.random.default_rng(0)
    graphs = []
    for n in (7, ROW_SPLIT_THRESHOLD + 40, 5, 9):
        s = rng.integers(0, n, size=2 * n)
        r = rng.integers(0, n, size=2 * n)
        if n > ROW_SPLIT_THRESHOLD:
            r[: ROW_SPLIT_THRESHOLD + 20] = 0
        graphs.append((s, r, n))
    graphs.append((np.array([0, 1]), np.array([1, 0]), 3))  # atom 2 has no bond
    feats = [rng.integers(0, 130, size=(n, 9)).astype(np.int32) for _, _, n in graphs]
    bonds = [rng.integers(0, 7, size=(len(s), 3)).astype(np.int32) for s, _, _ in graphs]
    kw = dict(pad_nodes_to=256, pad_edges_to=512, pad_graphs_to=6, edge_payloads=bonds)
    jb, _, jbonds = jax_pack_graphs(graphs, **kw)
    tb, _, tbonds = pack_graphs(graphs, **kw)
    atoms = mol.pack_node_features(feats, 256)
    assert tb.graph.row_split.num_long == 1 and tb.graph_split.num_long == 1
    return jb, tb, atoms, jbonds, tbonds


def _mol_batch(seed=3):
    """A batch of the synthetic dataset from both batchers."""
    kw = dict(n_train=24, n_valid=1, n_test=1, seed=seed)
    jb, atoms, bonds, _ = next(jax_mol.MolBatcher(
        jax_mol.synthetic_molhiv_dataset(**kw).train, 12, 24).epoch(1))
    tb = next(mol.MolBatcher(mol.synthetic_molhiv_dataset(**kw).train, 12, 24).epoch(1))
    return jb, tb.batch, atoms, bonds, tb.bonds.numpy()


def _grad_close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("what", ["edges", "pool"])
def test_csr_segment_sum_sorted_matches_jax(what):
    jb, tb, _, _, _ = _long_batch()
    rng = np.random.default_rng(1)
    g = tb.graph
    if what == "edges":
        n, ids, args = g.num_nodes, g.receivers, (g.row_offsets, g.row_split)
        jids = jb.graph.receivers
    else:
        n, ids, args = tb.num_graphs, tb.node_graph_ids, (tb.graph_offsets, tb.graph_split)
        jids = jb.node_graph_ids
    data = rng.normal(size=(ids.shape[0], 5)).astype(np.float32)
    cot = rng.normal(size=(n, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jax_segment_sum(d, jids, n), jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    got = csr_segment_sum_sorted(x, ids, *args, tb.ident)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6)
    assert float(x.grad[ids.long() >= n].abs().max()) == 0.0  # padding: no gradient


@pytest.mark.parametrize("what", ["senders", "receivers", "graph_ids"])
def test_gather_rows_csr_matches_jax(what):
    jb, tb, _, _, _ = _long_batch()
    rng = np.random.default_rng(2)
    g = tb.graph
    case = {
        "senders": (g.num_nodes, g.senders, jb.graph.senders,
                    (g.t_row_offsets, g.csc_perm, g.t_row_split)),
        "receivers": (g.num_nodes, g.receivers, jb.graph.receivers,
                      (g.row_offsets, tb.ident, g.row_split)),
        "graph_ids": (tb.num_graphs, tb.node_graph_ids, jb.node_graph_ids,
                      (tb.graph_offsets, tb.ident, tb.graph_split)),
    }
    rows, idx, jidx, args = case[what]
    data = rng.normal(size=(rows, 6)).astype(np.float32)
    # padding entries (clipped in the forward) carry a zero cotangent, as
    # after the masks of the mol models
    cot = rng.normal(size=(idx.shape[0], 6)).astype(np.float32)
    cot[idx.numpy() >= rows] = 0.0
    want, vjp = jax.vjp(lambda d: jax_gather(d, jidx), jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    got = gather_rows_csr(x, idx, *args)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_segment_extremes_match_jax_with_ties_and_padding(reduce):
    # PNA's max / min: ReLU messages tie at 0, padding ids equal the row
    # count, a node without in-edges stays at -inf / +inf (masked by PNA)
    from efficient_gnns_tpu.ops.segment import segment_max as jmax, segment_min as jmin
    from efficient_gnns_tpu_torch.ops.segment import segment_max, segment_min

    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, 12, size=60)).astype(np.int32)
    ids[ids == 4] = 5  # row 4 is empty
    ids[-7:] = 12  # padding
    data = np.maximum(rng.normal(size=(60, 3)), 0.0).astype(np.float32)
    cot = rng.normal(size=(12, 3)).astype(np.float32)
    jfn, fn = (jmax, segment_max) if reduce == "max" else (jmin, segment_min)
    want, vjp = jax.vjp(lambda d: jnp.where(jnp.isfinite(jfn(d, jnp.asarray(ids), 12)),
                                            jfn(d, jnp.asarray(ids), 12), 0.0),
                        jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    got = fn(x, torch.from_numpy(ids), 12)
    out = torch.where(torch.isfinite(got), got, 0.0)
    out.backward(torch.from_numpy(cot))
    assert not torch.isfinite(got[4]).any()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-7)


def test_categorical_encoder_and_pools_match_jax():
    jb, tb, atoms, _, _ = _long_batch()
    enc = jax_models.atom_encoder(H)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(atoms))
    port = models.atom_encoder(H, generator=torch.Generator(), device="cpu")
    port.load_state_dict({f"embs.{i}": torch.tensor(np.asarray(v["embedding"]))
                          for i, v in enumerate(
                              params["params"][f"emb_{i}"] for i in range(9))})
    np.testing.assert_allclose(port(torch.from_numpy(atoms)).detach().numpy(),
                               np.asarray(enc.apply(params, jnp.asarray(atoms))), **FWD)
    x = np.random.default_rng(3).normal(size=(256, H)).astype(np.float32)
    for jpool, pool in ((jax_models.global_sum_pool, models.global_sum_pool),
                        (jax_models.global_mean_pool, models.global_mean_pool)):
        np.testing.assert_allclose(pool(tb, torch.from_numpy(x)).numpy(),
                                   np.asarray(jpool(jb, jnp.asarray(x))), **FWD)


def _conv_case(conv, jb, tb, atoms, jbonds, tbonds):
    """One JAX conv and the port's with its parameters, on the batch's atom
    and bond embeddings; returns (values, grads) of both."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(tb.graph.num_nodes, H)).astype(np.float32)
    e = rng.normal(size=(tb.graph.num_edges_padded, H)).astype(np.float32)
    jconv = {"gine": jax_models.GINEConv(H), "gcn": jax_models.GCNMolConv(H),
             "pna": jax_models.PNAConv(H, towers=4, delta=1.3)}[conv]
    v = jconv.init(jax.random.PRNGKey(1), jb.graph, jnp.asarray(x), jnp.asarray(e))

    def jloss(p, xx, ee):
        out, mut = jconv.apply({"params": p, **{k: w for k, w in v.items() if k != "params"}},
                               jb.graph, xx, ee, training=True, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out)), (out, mut)

    (_, (jout, _)), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                         has_aux=True))(
        v["params"], jnp.asarray(x), jnp.asarray(e))
    port = {"gine": models.GINEConv, "gcn": models.GCNMolConv}.get(conv)
    kw = dict(generator=torch.Generator(), device="cpu")
    port = port(H, **kw) if port else models.PNAConv(H, towers=4, delta=1.3, **kw)
    state = mol_from_jax_params({"conv_0": to_np(v["params"])},
                                {"conv_0": to_np(v.get("batch_stats", {}))})
    port.load_state_dict({k.removeprefix("convs.0."): w for k, w in state.items()})
    port.train()
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, e))
    out = port(tb, xt, et)
    torch.sin(out).sum().backward()
    pstate = mol_from_jax_params({"conv_0": to_np(jgrads[0])}, {})
    grads = {k.removeprefix("convs.0."): w for k, w in pstate.items()}
    return (out, np.asarray(jout)), (xt.grad, et.grad, port, grads, jgrads)


@pytest.mark.parametrize("conv", ["gine", "gcn", "pna"])
def test_conv_matches_jax(conv):
    jb, tb, atoms, jbonds, tbonds = _long_batch()
    (out, jout), (dx, de, port, grads, jgrads) = _conv_case(conv, jb, tb, atoms, jbonds, tbonds)
    np.testing.assert_allclose(out.detach().numpy(), jout, **FWD)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(jgrads))
    _grad_close(dx.numpy(), np.asarray(jgrads[1]), scale)
    _grad_close(de.numpy(), np.asarray(jgrads[2]), scale)
    for name, p in port.named_parameters():
        _grad_close(p.grad.numpy(), grads[name].numpy(), scale)
    if conv == "pna":  # the atom without bonds: max / min masked, no NaN
        assert torch.isfinite(dx).all() and torch.isfinite(out).all()


MODELS = [("gine", True, False), ("gine", True, True), ("gin", False, False),
          ("gin", False, True), ("gcn", False, False), ("gcn", False, True),
          ("pna", False, False), ("pna", False, True)]
CASES = ([("synthetic",) + m for m in MODELS]
         + [("long",) + m for m in MODELS if m[2] == (m[0] in ("gine", "gcn"))])


@pytest.mark.parametrize("batch,conv,vn,residual", CASES)
def test_molgnn_matches_jax(batch, conv, vn, residual):
    if batch == "long":
        jb, tb, atoms, jbonds, tbonds = _long_batch()
    else:
        jb, tb, atoms, jbonds, tbonds = _mol_batch()
    jm = jax_models.MolGNN(conv=conv, hidden=H, num_tasks=1, num_layers=3, dropout=0.0,
                           virtual_node=vn, residual=residual, pna_delta=1.2, pna_towers=4)
    v = jm.init({"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}, jb,
                jnp.asarray(atoms), jnp.asarray(jbonds))
    args = (jb, jnp.asarray(atoms), jnp.asarray(jbonds))

    def jforward(p):  # train mode, then eval mode with the updated statistics
        (out, feat), mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, *args,
                                    training=True, mutable=["batch_stats"])
        eout, _ = jm.apply({"params": p, "batch_stats": mut["batch_stats"]}, *args)
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.sin(feat)), (out, feat, mut, eout)

    jout, jfeat, mut, jeout = to_np(jax.jit(jforward)(v["params"])[1])
    with jax.enable_x64(True):  # the gradients' reference: the JAX model in float64
        jgrads = to_np(jax.jit(jax.grad(jforward, has_aux=True))(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v["params"]))[0])
    jstats = mut["batch_stats"]
    port = models.MolGNN(conv, H, 1, 3, dropout=0.0, virtual_node=vn, residual=residual,
                         pna_delta=1.2, pna_towers=4, device="cpu")
    port.load_state_dict(mol_from_jax_params(to_np(v["params"]), to_np(v["batch_stats"])))
    port.train()
    out, feat = port(tb, torch.from_numpy(atoms), torch.from_numpy(tbonds))
    (torch.sin(out).sum() + torch.sin(feat).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **DEEP)
    np.testing.assert_allclose(feat.detach().numpy(), jfeat, **DEEP)
    want = mol_from_jax_params(jgrads, jstats)
    scale = max(float(w.abs().max()) for w in want.values())
    params = dict(port.named_parameters())
    assert set(params) | {k for k, _ in port.named_buffers() if "running" in k} == set(want)
    for name, w in want.items():
        if name in params:
            _grad_close(params[name].grad.numpy(), w.numpy(), scale)
        else:  # the running statistics after one train-mode forward
            np.testing.assert_allclose(port.get_buffer(name).numpy(), w.numpy(), **DEEP)
    assert torch.isfinite(out).all()
    port.eval()
    with torch.no_grad():
        eout, _ = port(tb, torch.from_numpy(atoms), torch.from_numpy(tbonds))
    np.testing.assert_allclose(eout.numpy(), jeout, **DEEP)


def test_molgnn_dropout_draws_from_the_generator():
    _, tb, atoms, _, tbonds = _mol_batch()
    port = models.MolGNN("gine", H, 1, 2, dropout=0.5, virtual_node=True, device="cpu")
    outs = [port(tb, torch.from_numpy(atoms), torch.from_numpy(tbonds),
                 generator=torch.Generator().manual_seed(s))[0] for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="conv must be"):
        models.MolGNN("gat", H, 1, device="cpu")


def test_pna_gradient_is_closer_to_float64_than_the_jax_float32_one():
    # the JAX one-pass variance relu(mean(m^2) - mean^2) cancels in float32
    # for nearly equal messages, and sqrt(var + 1e-5) scales the rounding's
    # gradient by up to 158; the port's two-pass variance does not
    jb, tb, atoms, jbonds, tbonds = _long_batch()
    jm = jax_models.MolGNN(conv="pna", hidden=H, num_tasks=1, num_layers=3, dropout=0.0,
                           residual=True, pna_delta=1.2, pna_towers=4)
    v = jm.init({"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}, jb,
                jnp.asarray(atoms), jnp.asarray(jbonds))

    def jloss(p):
        (out, feat), _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jb,
                                  jnp.asarray(atoms), jnp.asarray(jbonds), training=True,
                                  mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.sin(feat))

    grad = jax.jit(jax.grad(jloss))
    j32 = mol_from_jax_params(to_np(grad(v["params"])), {})
    with jax.enable_x64(True):
        j64 = mol_from_jax_params(to_np(grad(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), v["params"]))), {})
    port = models.MolGNN("pna", H, 1, 3, dropout=0.0, residual=True, pna_delta=1.2,
                         pna_towers=4, device="cpu")
    port.load_state_dict(mol_from_jax_params(to_np(v["params"]), to_np(v["batch_stats"])))
    port.train()
    out, feat = port(tb, torch.from_numpy(atoms), torch.from_numpy(tbonds))
    (torch.sin(out).sum() + torch.sin(feat).sum()).backward()
    grads = dict(port.named_parameters())
    port_err = max(float((grads[k].grad.double() - w.double()).abs().max()) for k, w in j64.items())
    jax_err = max(float((j32[k].double() - w.double()).abs().max()) for k, w in j64.items())
    assert port_err * 50 < jax_err, (port_err, jax_err)
