"""Port vs JAX: ogbg-molhiv data (``graphs/batching.py``,
``data/molhiv.py``) and ``BatchedGraphs``.

Packed batches, the synthetic dataset, the batcher's per-epoch order and the
raw-cache loader are held equal (bit for bit) to the JAX package's on the
same inputs; ROC-AUC to float64 equality (the same ranks, summed in the
same order). Small sizes only.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from efficient_gnns_tpu.data import molhiv as jax_mol
from efficient_gnns_tpu.graphs.batching import pack_graphs as jax_pack_graphs
from efficient_gnns_tpu_torch.data import molhiv as mol
from efficient_gnns_tpu_torch.graphs import (
    ROW_SPLIT_THRESHOLD,
    build_row_split,
    pack_graphs,
    pack_node_features,
)
from efficient_gnns_tpu_torch.graphs.row_split import is_recorded_pair
from efficient_gnns_tpu_torch.models.mol import global_sum_pool
from efficient_gnns_tpu_torch.ops.sorted_segment import csr_segment_sum_sorted

DATA = dict(n_train=40, n_valid=9, n_test=11, seed=3)
GRAPH_FIELDS = ("senders", "receivers", "t_senders", "t_receivers", "csc_perm",
                "row_offsets", "t_row_offsets", "node_mask")


def _assert_batch_equal(jb, tb):
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tb.graph, f).numpy(),
                                      np.asarray(getattr(jb.graph, f)), err_msg=f)
    assert tb.graph.num_nodes == jb.graph.num_nodes
    np.testing.assert_array_equal(tb.node_graph_ids.numpy(), np.asarray(jb.node_graph_ids))
    assert tb.n_graph == int(jb.n_graph) and tb.num_graphs == jb.num_graphs
    np.testing.assert_array_equal(tb.graph_mask.numpy(), np.asarray(jb.graph_mask))


def _with_duplicates(rng, n):
    s = rng.integers(0, n, size=3 * n)
    r = rng.integers(0, n, size=3 * n)
    s[:4], r[:4] = 1, 2  # the same bond four times: its payloads keep their order
    return s, r, n


def test_pack_graphs_matches_jax_with_duplicate_bonds():
    rng = np.random.default_rng(0)
    graphs = [_with_duplicates(rng, n) for n in (5, 9, 1, 7)]
    payloads = [rng.integers(0, 50, size=(len(s), 3)).astype(np.int32) for s, _, _ in graphs]
    kw = dict(pad_nodes_to=32, pad_edges_to=128, pad_graphs_to=6)
    jb, joff, jpay = jax_pack_graphs(graphs, edge_payloads=payloads, **kw)
    tb, toff, tpay = pack_graphs(graphs, edge_payloads=payloads, **kw)
    _assert_batch_equal(jb, tb)
    np.testing.assert_array_equal(toff, joff)
    np.testing.assert_array_equal(tpay, jpay)
    # the four payloads of the duplicate bond stay in their order
    g0 = tb.graph
    dup = np.flatnonzero((g0.senders.numpy() == 1) & (g0.receivers.numpy() == 2))
    np.testing.assert_array_equal(tpay[dup], payloads[0][:4])
    # the port's extras: graph CSR offsets (padded graphs empty), their
    # recorded split, the identity index
    np.testing.assert_array_equal(tb.graph_offsets.numpy(), [0, 5, 14, 15, 22, 22, 22])
    assert is_recorded_pair(tb.graph_split, tb.graph_offsets)
    assert tb.graph.row_split is not None and tb.graph.t_row_split is not None
    np.testing.assert_array_equal(tb.ident.numpy(), np.arange(128))
    moved = tb.to("cpu")
    assert is_recorded_pair(moved.graph_split, moved.graph_offsets)


def test_pack_graphs_self_loops_and_no_payload_match_jax():
    rng = np.random.default_rng(1)
    graphs = [_with_duplicates(rng, n) for n in (4, 6)]
    kw = dict(pad_nodes_to=16, pad_edges_to=64, self_loops=True)
    jb, _, jpay = jax_pack_graphs(graphs, **kw)
    tb, _, tpay = pack_graphs(graphs, **kw)
    _assert_batch_equal(jb, tb)
    assert jpay is None and tpay is None
    np.testing.assert_array_equal(pack_node_features([np.ones((2, 3)), np.zeros((1, 3))], 5),
                                  [[1] * 3, [1] * 3, [0] * 3, [0] * 3, [0] * 3])


@pytest.mark.parametrize("kw, match", [
    (dict(pad_nodes_to=32, pad_edges_to=128, pad_graphs_to=1), "pad_graphs_to"),
    (dict(pad_nodes_to=8, pad_edges_to=128), "pad_nodes_to"),
    (dict(pad_nodes_to=32, pad_edges_to=128, self_loops=True, edge_payloads=True),
     "self_loops"),
])
def test_pack_graphs_raises_as_jax(kw, match):
    rng = np.random.default_rng(2)
    graphs = [_with_duplicates(rng, n) for n in (5, 6)]
    if kw.get("edge_payloads"):
        kw = dict(kw, edge_payloads=[np.zeros((len(s), 3), np.int32) for s, _, _ in graphs])
    for pack in (jax_pack_graphs, pack_graphs):
        with pytest.raises(ValueError, match=match):
            pack(graphs, **kw)


def test_a_long_graph_has_a_long_pool_row():
    # real ogbg-molhiv molecules reach 222 atoms: above the split threshold
    rng = np.random.default_rng(3)
    n_long = ROW_SPLIT_THRESHOLD + 94
    graphs = [_with_duplicates(rng, n) for n in (6, n_long, 3)]
    tb, _, _ = pack_graphs(graphs, pad_nodes_to=256, pad_edges_to=1024, pad_graphs_to=4)
    split = tb.graph_split
    assert split.num_long == 1 and int(split.long_rows[0]) == 1 and split.num_chunks == 2
    want = build_row_split(tb.graph_offsets)
    assert torch.equal(want.chunks, split.chunks)
    assert is_recorded_pair(split, tb.graph_offsets)


def test_synthetic_dataset_matches_jax():
    jds, tds = jax_mol.synthetic_molhiv_dataset(**DATA), mol.synthetic_molhiv_dataset(**DATA)
    assert tds.num_tasks == jds.num_tasks and tds.mean_log_degree == jds.mean_log_degree
    for split in ("train", "valid", "test"):
        jm, tm = getattr(jds, split), getattr(tds, split)
        assert len(jm) == len(tm)
        for a, b in zip(jm, tm):
            assert a.num_nodes == b.num_nodes and a.label == b.label
            for f in ("senders", "receivers", "atom_feats", "bond_feats"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


@pytest.mark.parametrize("shuffle, seeds", [(True, (0, 7)), (False, (0,))])
def test_batcher_matches_jax(shuffle, seeds):
    jds, tds = jax_mol.synthetic_molhiv_dataset(**DATA), mol.synthetic_molhiv_dataset(**DATA)
    jbat = jax_mol.MolBatcher(jds.train, 16, 24, shuffle=shuffle)
    tbat = mol.MolBatcher(tds.train, 16, 24, shuffle=shuffle)
    assert (tbat.node_budget, tbat.edge_budget, len(tbat)) == (
        jbat.node_budget, jbat.edge_budget, len(jbat))
    for seed in seeds:
        got, want = list(tbat.epoch(seed)), list(jbat.epoch(seed))
        assert len(got) == len(want) == 3
        for (jb, atoms, bonds, labels), tb in zip(want, got):
            _assert_batch_equal(jb, tb.batch)
            np.testing.assert_array_equal(tb.atoms.numpy(), atoms)
            np.testing.assert_array_equal(tb.bonds.numpy(), bonds)
            np.testing.assert_array_equal(tb.labels.numpy(), labels)
        assert got[-1].batch.n_graph == 8  # 40 molecules: the last batch is padded


def _pooled(mb):
    """Each real molecule's sums of its atom features and of the bond
    features into its atoms: ``[molecules, 9 + 3]``, through the batch's CSR
    (the sums a conv and a pool read)."""
    b = mb.batch
    g = b.graph
    into = csr_segment_sum_sorted(mb.bonds.float(), g.receivers, g.row_offsets, g.row_split,
                                  b.ident)
    rows = torch.cat([mb.atoms.float(), into], 1)
    return global_sum_pool(b, rows)[: b.n_graph]


def _alone(m):
    """``m`` packed by itself, padded to its own size."""
    batch, _, bonds = pack_graphs([(m.senders, m.receivers, m.num_nodes)],
                                  pad_nodes_to=m.num_nodes, pad_edges_to=len(m.senders),
                                  edge_payloads=[m.bond_feats])
    atoms = pack_node_features([m.atom_feats], m.num_nodes)
    return mol.MolBatch(batch, torch.from_numpy(atoms), torch.from_numpy(bonds),
                        torch.zeros(1))


def _assert_packs_each_molecule(mols, batch_size, max_atoms):
    tbat = mol.MolBatcher(mols, batch_size, max_atoms, shuffle=False)
    [mb] = list(tbat.epoch(0))
    nodes, edges = sum(m.num_nodes for m in mols), sum(len(m.senders) for m in mols)
    want_rows = (tbat.node_budget if nodes <= tbat.node_budget else -(-nodes // 128) * 128,
                 tbat.edge_budget if edges <= tbat.edge_budget else -(-edges // 1024) * 1024)
    assert (mb.batch.graph.num_nodes, mb.batch.graph.num_edges_padded) == want_rows
    assert mb.atoms.shape[0] == want_rows[0] and mb.bonds.shape[0] == want_rows[1]
    assert int(mb.batch.graph_offsets[-1]) == nodes and mb.batch.n_graph == len(mols)
    want = torch.cat([_pooled(_alone(m)) for m in mols])
    np.testing.assert_array_equal(_pooled(mb).numpy(), want.numpy())
    np.testing.assert_array_equal(mb.labels[: len(mols)].numpy(), [m.label for m in mols])
    return want_rows


def test_batch_budget_overflow_raises_in_both():
    # 32 molecules of real ogbg-molhiv size (25.5 atoms on average) overflow
    # the 1,024-node budget that MolTrainer's default max_atoms=32 gives a
    # batch of 32: the JAX batcher raises, the port's pads the batch to its
    # own atoms rounded up to 128 and packs every molecule as it would alone
    kw = dict(n_train=32, n_valid=1, n_test=1, min_atoms=25, max_atoms=60, seed=4)
    jds, tds = jax_mol.synthetic_molhiv_dataset(**kw), mol.synthetic_molhiv_dataset(**kw)
    assert sum(m.num_nodes for m in tds.train) > 1024
    with pytest.raises(ValueError, match="pad_nodes_to=1024"):
        next(jax_mol.MolBatcher(jds.train, 32, 32).epoch(0))
    rows = _assert_packs_each_molecule(tds.train, 32, 32)
    assert rows[0] > 1024 and rows[0] % 128 == 0


def test_batcher_packs_two_molecules_of_200_atoms():
    # the largest molhiv molecules (222 atoms): two of 200 in one batch of 8
    # pass both budgets (8 x 32 = 256 nodes, 768 -> 1,024 edges)
    big = dict(n_train=2, n_valid=1, n_test=1, min_atoms=200, max_atoms=200, seed=5)
    small = dict(n_train=6, n_valid=1, n_test=1, min_atoms=10, max_atoms=30, seed=6)
    tmols = mol.synthetic_molhiv_dataset(**big).train + mol.synthetic_molhiv_dataset(**small).train
    jmols = (jax_mol.synthetic_molhiv_dataset(**big).train
             + jax_mol.synthetic_molhiv_dataset(**small).train)
    with pytest.raises(ValueError, match="pad_nodes_to=256"):
        next(jax_mol.MolBatcher(jmols, 8, 32, shuffle=False).epoch(0))
    nodes, edges = _assert_packs_each_molecule(tmols, 8, 32)
    assert nodes == -(-sum(m.num_nodes for m in tmols) // 128) * 128 and nodes >= 512
    assert edges > 1024 and edges % 1024 == 0


def test_batcher_packs_a_fitting_batch_as_jax():
    kw = dict(n_train=16, n_valid=1, n_test=1, seed=7)
    jds, tds = jax_mol.synthetic_molhiv_dataset(**kw), mol.synthetic_molhiv_dataset(**kw)
    [(jb, atoms, bonds, labels)] = list(jax_mol.MolBatcher(jds.train, 16, 24).epoch(3))
    [tb] = list(mol.MolBatcher(tds.train, 16, 24).epoch(3))
    _assert_batch_equal(jb, tb.batch)
    np.testing.assert_array_equal(tb.atoms.numpy(), atoms)
    np.testing.assert_array_equal(tb.bonds.numpy(), bonds)
    np.testing.assert_array_equal(tb.labels.numpy(), labels)
    assert _assert_packs_each_molecule(tds.train, 16, 24) == (384, 2048)  # the budgets


def test_roc_auc_matches_jax():
    rng = np.random.default_rng(5)
    s = rng.normal(size=300)
    y = (rng.random(300) < 0.3).astype(np.float32)
    assert mol.roc_auc(s, y) == jax_mol.roc_auc(s, y)
    ties = np.round(s, 1)  # many tied scores across both classes
    assert mol.roc_auc(ties, y) == jax_mol.roc_auc(ties, y)
    for scores, labels in (([0.5] * 4, [0, 1, 0, 1]), ([0.1, 0.2, 0.8, 0.9], [0, 0, 1, 1]),
                           ([0.9, 0.1, 0.8, 0.2], [0, 0, 1, 1])):
        assert mol.roc_auc(scores, labels) == jax_mol.roc_auc(scores, labels)
    assert np.isnan(mol.roc_auc([0.1, 0.2], [1, 1])) and np.isnan(jax_mol.roc_auc([0.1], [1]))


def _write(path, arr, fmt="%d"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        np.savetxt(f, np.asarray(arr).reshape(len(arr), -1), fmt=fmt, delimiter=",")


def write_molhiv_cache(root, ds):
    """``ds`` as OGB's ogbg-molhiv raw cache under ``root/ogbg_molhiv``:
    the molecules of train, valid and test in that order, the splits their
    positions."""
    files = mol.molhiv_raw_files(os.path.join(root, "ogbg_molhiv"))
    mols = ds.train + ds.valid + ds.test
    _write(files["edge.csv.gz"], np.concatenate(
        [np.stack([m.senders, m.receivers], 1) for m in mols]))
    _write(files["edge-feat.csv.gz"], np.concatenate([m.bond_feats for m in mols]))
    _write(files["node-feat.csv.gz"], np.concatenate([m.atom_feats for m in mols]))
    _write(files["num-node-list.csv.gz"], [m.num_nodes for m in mols])
    _write(files["num-edge-list.csv.gz"], [len(m.senders) for m in mols])
    _write(files["graph-label.csv.gz"], [int(m.label) for m in mols])
    start = 0
    for split in ("train", "valid", "test"):
        k = len(getattr(ds, split))
        _write(files[split], np.arange(start, start + k))
        start += k


def test_load_molhiv_matches_jax_and_names_a_missing_file(tmp_path):
    ds = mol.synthetic_molhiv_dataset(**DATA)
    write_molhiv_cache(str(tmp_path), ds)
    got, want = mol.load_molhiv(str(tmp_path)), jax_mol.load_molhiv(str(tmp_path))
    assert got.mean_log_degree == want.mean_log_degree and got.num_tasks == want.num_tasks
    for split in ("train", "valid", "test"):
        for a, b, c in zip(getattr(want, split), getattr(got, split), getattr(ds, split)):
            assert b.num_nodes == a.num_nodes == c.num_nodes and b.label == a.label == c.label
            for f in ("senders", "receivers", "atom_feats", "bond_feats"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
                np.testing.assert_array_equal(getattr(b, f), getattr(c, f))
                assert getattr(b, f).dtype == getattr(a, f).dtype
    os.remove(mol.molhiv_raw_files(str(tmp_path))["valid"])
    with pytest.raises(FileNotFoundError, match="valid.csv.gz"):
        mol.load_molhiv(str(tmp_path))
