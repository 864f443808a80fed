"""OGB's atom and bond encoders (``ops/cuda/categorical.py``,
``models/mol.py::CategoricalEncoder``) on the CPU: the plain version against
the chain the encoder ran before, against a float64 sum and against the JAX
``CategoricalEncoder`` (values and gradients), clipped ids, batches past the
budget, and the wrapper's refusals. The kernels themselves are
``tests/test_torch_gpu.py``'s.

Tolerance: values and gradients rtol 1e-6 / atol 1e-6 against JAX and
float64 (a sum of at most 9 table rows forward; backward float32 sums of
the rows of a category, against a float64 sum within 1e-5 of its sum of
|terms|); the chain exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from efficient_gnns_tpu.models import mol as jax_models
from efficient_gnns_tpu_torch.models import mol
from efficient_gnns_tpu_torch.ops.cuda import categorical as C
from efficient_gnns_tpu_torch.ops.cuda import launch

ATOM, BOND = mol.ATOM_FEATURE_DIMS, mol.BOND_FEATURE_DIMS
# (rows, vocabularies): the molhiv batch's atoms and bonds, and past the budget
SHAPES = [(1280, ATOM), (4096, BOND), (1152, ATOM), (5120, BOND), (37, (7,))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(rows, vocab, f=16, seed=0):
    """ids from two below to two above each vocabulary, tables and a
    cotangent, as numpy arrays."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(-2, v + 2, rows) for v in vocab], 1).astype(np.int32)
    tables = [rng.normal(size=(v, f)).astype(np.float32) for v in vocab]
    return ids, tables, rng.normal(size=(rows, f)).astype(np.float32)


def _chain(feats, tables):
    """The encoder's forward before the kernels (``CategoricalEncoder.forward``)."""
    max_index = torch.tensor([w.shape[0] - 1 for w in tables], dtype=torch.int32)
    idx = torch.minimum(feats.clamp_min(0), max_index)
    out = F.embedding(idx[..., 0], tables[0])
    for i in range(1, len(tables)):
        out = out + F.embedding(idx[..., i], tables[i])
    return out


def _torch_run(fn, ids, tables, dy):
    leaves = [torch.from_numpy(w).requires_grad_(True) for w in tables]
    out = fn(torch.from_numpy(ids), leaves)
    out.backward(torch.from_numpy(dy))
    return out.detach().numpy(), [w.grad.numpy() for w in leaves]


@pytest.mark.parametrize("rows,vocab", SHAPES)
def test_plain_version_is_the_old_chain_and_a_float64_sum(rows, vocab):
    ids, tables, dy = _inputs(rows, vocab)
    got = _torch_run(C.categorical_encode_plain, ids, tables, dy)
    again = _torch_run(C.categorical_encode, ids, tables, dy)
    assert np.array_equal(again[0], got[0])
    assert all(np.array_equal(a, b) for a, b in zip(again[1], got[1]))
    old = _torch_run(_chain, ids, tables, dy)
    assert np.array_equal(got[0], old[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[1], old[1]))
    k = [np.clip(ids[:, t], 0, v - 1) for t, v in enumerate(vocab)]
    want = sum(w.astype(np.float64)[kt] for w, kt in zip(tables, k))
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)
    for g, kt, v in zip(got[1], k, vocab):
        ref, terms = np.zeros((v, dy.shape[1])), np.zeros((v, dy.shape[1]))
        np.add.at(ref, kt, dy.astype(np.float64))
        np.add.at(terms, kt, np.abs(dy.astype(np.float64)))
        assert (np.abs(g - ref) <= 1e-5 * terms).all()


@pytest.mark.parametrize("dims", [ATOM, BOND])
def test_plain_version_matches_the_jax_encoder(dims):
    ids, _, dy = _inputs(1152 if dims is ATOM else 5120, dims, f=12, seed=1)
    enc = jax_models.CategoricalEncoder(dims, 12)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    tables = [np.array(params["params"][f"emb_{i}"]["embedding"]) for i in range(len(dims))]
    want, vjp = jax.vjp(lambda p: enc.apply(p, jnp.asarray(ids)), params)
    (grads,) = vjp(jnp.asarray(dy))
    got = _torch_run(C.categorical_encode_plain, ids, tables, dy)
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=1e-6, atol=1e-6)
    for i, g in enumerate(got[1]):
        np.testing.assert_allclose(g, np.asarray(grads["params"][f"emb_{i}"]["embedding"]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims", [ATOM, BOND])
def test_ids_outside_a_vocabulary_are_clipped(dims):
    """An id below 0 takes row 0, one past the end the last row: the
    encoder's output and gradients equal those of the clipped ids."""
    ids, _, dy = _inputs(300, dims, seed=2)
    enc = mol.CategoricalEncoder(dims, 16, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    assert (ids < 0).any() and (ids >= np.array(dims)).any()
    clipped = np.clip(ids, 0, np.array(dims) - 1).astype(np.int32)
    runs = []
    for x in (ids, clipped):
        enc.zero_grad()
        out = enc(torch.from_numpy(x))
        out.backward(torch.from_numpy(dy))
        runs.append((out.detach(), [w.grad.clone() for w in enc.embs]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_encoder_on_the_cpu_runs_the_chain_and_launches_nothing():
    ids, _, _ = _inputs(64, ATOM)
    enc = mol.atom_encoder(16, generator=torch.Generator().manual_seed(0), device="cpu")
    before = [k.launches for k in C.KERNELS]
    got = enc(torch.from_numpy(ids))
    assert [k.launches for k in C.KERNELS] == before
    assert torch.equal(got, _chain(torch.from_numpy(ids), list(enc.embs)))
    assert all(launch.COUNTED[k.__name__] is k for k in C.KERNELS)
    assert "categorical" in C._LIB.source and C._LIB.cdll is None  # nothing built


def test_kernels_take_the_encoders_table_counts_and_vocabularies():
    """The kernels are built for the bond and atom encoders' table counts
    alone, and their vocabularies fit the kernels' bins."""
    assert C.TABLE_COUNTS == (len(BOND), len(ATOM))
    assert max(sum(ATOM), sum(BOND)) <= C.MAX_BINS


def _refusal_cases():
    ids = torch.zeros(6, 3, dtype=torch.int32)
    tables = [torch.randn(v, 8) for v in BOND]
    return {
        "int64 ids": (dict(feats=ids.long(), tables=tables), r"feats must be 2-D int32"),
        "1-D ids": (dict(feats=ids[:, 0].contiguous(), tables=tables), r"feats must be 2-D"),
        "strided ids": (dict(feats=ids.t().contiguous().t(), tables=tables), "contiguous"),
        "float64 table": (dict(feats=ids, tables=[tables[0].double(), *tables[1:]]),
                          r"tables\[0\] must be 2-D float32"),
        "table on meta": (dict(feats=ids, tables=[*tables[:2], tables[2].to("meta")]),
                          r"tables\[2\].* on meta"),
        "ids on meta": (dict(feats=ids.to("meta"), tables=[w.to("meta") for w in tables]),
                        "runs on cpu or cuda, not meta"),
        "a column short": (dict(feats=ids[:, :2].contiguous(), tables=tables), "disagree"),
        "another width": (dict(feats=ids, tables=[*tables[:2], torch.randn(2, 9)]), "disagree"),
        "an empty table": (dict(feats=ids, tables=[*tables[:2], torch.randn(0, 8)]), "disagree"),
        "no table": (dict(feats=ids[:, :0].contiguous(), tables=[]), "takes 3 or 9 tables"),
        "4 tables": (dict(feats=torch.zeros(6, 4, dtype=torch.int32),
                          tables=[torch.randn(2, 8)] * 4), "takes 3 or 9 tables"),
        "too many rows together": (dict(feats=ids, tables=[torch.randn(200, 8), torch.randn(50, 8),
                                                           torch.randn(7, 8)]),
                                   "exceed 256"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_wrapper_refuses_what_no_kernel_takes(case):
    """The checks the wrapper runs before a launch on a CUDA device (on the
    CPU the chain runs whatever it takes), called as the wrapper calls them."""
    kw, message = _refusal_cases()[case]
    with pytest.raises(ValueError, match=message):
        C._check(**kw)
    if case == "ids on meta":  # the wrapper itself refuses a device other than cpu or cuda
        with pytest.raises(ValueError, match=message):
            C.categorical_encode(**kw)
