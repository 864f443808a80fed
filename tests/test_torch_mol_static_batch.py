"""The mol trainer's static batches (``train/mol_trainer.py::StaticBatch``),
on the CPU: the buffer the CUDA graphs of a train step read, refilled from
each packed host batch of the same signature.

A static batch must hold exactly the tensors of the batch it was loaded
from (the graphs read them in place of the batch's own), and two batches
may share graphs only where their signatures agree. The graphs themselves
run only on a card (``tests/test_torch_gpu.py``); on the CPU the trainer
steps eagerly, as before.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch.data import molhiv as mol
from efficient_gnns_tpu_torch.graphs.row_split import is_recorded_pair
from efficient_gnns_tpu_torch.models import MolGNN
from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer
from efficient_gnns_tpu_torch.train.mol_trainer import (StaticBatch, _leaves,
                                                        _no_collection, batch_signature)

DATA = dict(n_train=40, n_valid=8, n_test=8, seed=5)


def _chain(n: int, rng) -> mol.Molecule:
    """A chain molecule of ``n`` atoms, each bond both ways."""
    s = np.arange(1, n)
    senders, receivers = np.concatenate([s, s - 1]), np.concatenate([s - 1, s])
    return mol.Molecule(senders, receivers, n, rng.integers(0, 5, (n, 9)).astype(np.int32),
                        rng.integers(0, 2, (2 * n - 2, 3)).astype(np.int32), 1.0)


def _batches(mols, batch_size=8, max_atoms=24):
    batcher = mol.MolBatcher(mols, batch_size, max_atoms, shuffle=False)
    return [batcher.pack(idx) for idx in batcher.chunks(0)]


def _assert_same(a: mol.MolBatch, b: mol.MolBatch):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
    assert (a.batch.num_graphs, a.batch.graph.num_nodes) == (b.batch.num_graphs,
                                                             b.batch.graph.num_nodes)


def test_a_static_batch_holds_the_batch_in_one_aligned_buffer():
    host = _batches(mol.synthetic_molhiv_dataset(**DATA).train)[0]
    static = StaticBatch(host, "cpu")
    _assert_same(static.batch, host)
    base = static.buffer.data_ptr()
    for t, (lo, n) in zip(_leaves(static.batch), static.spans):
        assert lo % StaticBatch.ALIGN == 0 and n == t.numel() * t.element_size()
        if n:
            assert t.data_ptr() == base + lo
    assert batch_signature(static.batch) == batch_signature(host)


def test_loading_a_batch_of_the_same_signature_replaces_every_tensor():
    first, second = _batches(mol.synthetic_molhiv_dataset(**DATA).train)[:2]
    assert batch_signature(first) == batch_signature(second)
    static = StaticBatch(first, "cpu")
    ptrs = [t.data_ptr() for t in _leaves(static.batch)]
    static.load(second)
    _assert_same(static.batch, second)
    assert [t.data_ptr() for t in _leaves(static.batch)] == ptrs  # in place


@pytest.mark.parametrize("atoms,own", [(100, False), (128, True), (150, True)])
def test_a_long_or_overflowing_molecule_gives_a_signature_of_its_own(atoms, own):
    rng = np.random.default_rng(0)
    train = mol.synthetic_molhiv_dataset(**DATA).train
    plain = batch_signature(_batches(train)[0])
    assert sum(m.num_nodes for m in train[:7]) == 129  # with 128 atoms more, past 256 rows
    odd = _batches(train[:7] + [_chain(atoms, rng)])[0]
    assert (batch_signature(odd) != plain) == own
    assert (odd.batch.graph.num_nodes > 256) == own
    # past 128 atoms the pool's row is split into chunks
    assert (odd.batch.graph_split.num_chunks > 0) == (atoms > 128)


def test_the_model_reads_a_static_batch_as_the_batch():
    host = _batches(mol.synthetic_molhiv_dataset(**DATA).train)[1]
    static = StaticBatch(_batches(mol.synthetic_molhiv_dataset(**DATA).train)[0], "cpu")
    static.load(host)
    static.record_pairs()
    g = static.batch.batch.graph
    assert is_recorded_pair(g.row_split, g.row_offsets)
    assert is_recorded_pair(g.t_row_split, g.t_row_offsets)
    assert is_recorded_pair(static.batch.batch.graph_split, static.batch.batch.graph_offsets)
    model = MolGNN("gine", 16, 1, 2, virtual_node=True, virtual_node_norm=True, seed=0,
                   device="cpu").eval()
    with torch.no_grad():
        want = model(host.batch, host.atoms, host.bonds)[0]
        got = model(static.batch.batch, static.batch.atoms, static.batch.bonds)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["supervised", "kd", "fitnet"])
def test_the_trainer_steps_eagerly_on_the_cpu(mode):
    ds = mol.synthetic_molhiv_dataset(**DATA)
    teacher = MolGNN("gine", 16, 1, 2, seed=1, device="cpu")
    tr = MolTrainer(DistillConfig(training=mode), ds, MolGNN("gine", 16, 1, 2, device="cpu"),
                    teacher=teacher, batch_size=8, max_atoms=12, device="cpu")
    assert tr.graphed is False
    host = tr.batcher.pack(tr.batcher.chunks(0)[0])
    tr._eager_steps = 10
    moved = tr._upload(host)  # a copy of its own, no static batch
    assert not tr._step_graphs and not tr._graph_of and moved is not host
    _assert_same(moved, host)


def test_a_capture_collects_cyclic_garbage_first_and_none_inside():
    class Cycle:
        pass

    a = Cycle()
    a.self = a
    gone = weakref.ref(a)
    del a
    assert gc.isenabled()
    with _no_collection():
        assert gone() is None and not gc.isenabled()
    assert gc.isenabled()
