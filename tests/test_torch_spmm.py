"""Port vs JAX: ``spmm`` forward and gradient.

The JAX side runs its Pallas K1 (``blocked_segment_sum``) in interpret mode
over an edge-blocked graph; the port runs K1's plain version, which is what
its wrapper takes for CPU tensors. Tolerance in float32: atol 1e-5 plus
rtol 1e-5 of each row's sum of absolute terms (sum_e |w_e x_e|), because the
two sum each row's edges in a different order (the one-hot matmul over edge
blocks vs ``index_add_`` in edge order), and the rounding error of a sum
scales with its terms, not its result: a hub row of hundreds of unit terms
that cancel to a small value differs in the fifth digit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu import ops as jax_ops
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu_torch.graphs import build_graph
from efficient_gnns_tpu_torch.ops import dispatch, spmm
from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum, csr_segment_sum_plain


@pytest.fixture(autouse=True)
def _pallas_interpret():
    jax_dispatch.set_backend("pallas", interpret=True)
    yield
    jax_dispatch.set_backend("auto", interpret=False, message_dtype=jnp.float32)
    dispatch.set_message_dtype(torch.float32)


def _edges(rng, case, n=150, e=600):
    s = rng.integers(0, n, size=e)
    r = rng.integers(0, n, size=e)
    if case == "empty_rows":
        r = rng.integers(0, n // 3, size=e)
    elif case == "high_degree":  # as tests/test_pallas.py: one receiver owns 2/3
        r[e // 3:] = 0
    elif case == "multi_edges":
        s[: e // 2] = s[e // 2:]
        r[: e // 2] = r[e // 2:]
    return s, r


def _graphs(rng, case, weights):
    n = 150
    s, r = _edges(rng, case, n)
    kwargs = dict(edge_pad_multiple=64)  # padded edges in every case
    if weights == "gcn":
        kwargs.update(bidirected=True, self_loops=True, gcn_norm=True)
    elif weights == "static":
        kwargs["edge_weight"] = rng.normal(size=len(s)).astype(np.float32)
    jg = jax_build_graph(s, r, n, block=True, **kwargs)
    assert jg.blocking is not None
    tg = build_graph(s, r, n, **kwargs)
    assert tg.n_edge < tg.num_edges_padded
    return jg, tg, n


def _abs_adjacency(tg):
    """Dense |A| of the port's graph (A[r, s] += |w|), for the tolerance."""
    e = tg.n_edge
    w = np.ones(e) if tg.edge_weight is None else np.abs(tg.edge_weight.numpy()[:e])
    a = np.zeros((tg.num_nodes, tg.num_nodes))
    np.add.at(a, (tg.receivers.numpy()[:e], tg.senders.numpy()[:e]), w)
    return a


def assert_sum_close(got, want, abs_sum):
    np.testing.assert_array_less(np.abs(got - want), 1e-5 + 1e-5 * abs_sum)


def _check_both(jg, tg, x, c, transpose):
    (jo, jd), (to, td) = _run_both(jg, tg, x, c, transpose)
    a = _abs_adjacency(tg)
    fwd, bwd = (a.T, a) if transpose else (a, a.T)
    assert_sum_close(to, jo, fwd @ np.abs(x))
    assert_sum_close(td, jd, bwd @ np.abs(c))


def _run_both(jg, tg, x, c, transpose):
    # a loss linear in the output, so the gradient (A^T c, the backward K1)
    # carries no rounding of the forward
    def jloss(x_):
        return jnp.sum(jax_ops.spmm(jg, x_, transpose=transpose) * c)

    jout = jax_ops.spmm(jg, jnp.asarray(x), transpose=transpose)
    jgrad = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tout = spmm(tg, xt, transpose=transpose)
    (tout * torch.from_numpy(c)).sum().backward()
    return (np.asarray(jout), np.asarray(jgrad)), (tout.detach().numpy(), xt.grad.numpy())


@pytest.mark.parametrize("f", [40, 256])
@pytest.mark.parametrize("weights", ["gcn", "static", "none"])
@pytest.mark.parametrize("case", ["random", "empty_rows", "high_degree", "multi_edges"])
def test_spmm_matches_pallas_k1(rng, case, weights, f):
    jg, tg, n = _graphs(rng, case, weights)
    x = rng.normal(size=(n, f)).astype(np.float32)
    c = rng.normal(size=(n, f)).astype(np.float32)
    _check_both(jg, tg, x, c, transpose=False)


@pytest.mark.parametrize("weights", ["static", "none"])
def test_spmm_transpose_matches_jax(rng, weights):
    jg, tg, n = _graphs(rng, "empty_rows", weights)
    x = rng.normal(size=(n, 40)).astype(np.float32)
    c = rng.normal(size=(n, 40)).astype(np.float32)
    _check_both(jg, tg, x, c, transpose=True)


def test_spmm_bf16_messages_match_jax(rng):
    # Both read bfloat16 messages and accumulate in float32, but the Pallas
    # kernel also rounds w_e * msg_e to bfloat16 while the port keeps that
    # product in float32: tolerance of one bfloat16 rounding (2**-8) per term.
    jg, tg, n = _graphs(rng, "random", "gcn")
    x = rng.normal(size=(n, 40)).astype(np.float32)
    jax_dispatch.set_backend("pallas", interpret=True, message_dtype=jnp.bfloat16)
    dispatch.set_message_dtype(torch.bfloat16)
    jo = np.asarray(jax_ops.spmm(jg, jnp.asarray(x)))
    to = spmm(tg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-2, atol=1e-2)
    # against float32 messages the port's error is the rounding of x alone
    dispatch.set_message_dtype(torch.float32)
    exact = spmm(tg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(to, exact, rtol=2**-8, atol=2**-8)


def test_spmm_refuses_runtime_weights_and_bad_shapes(rng):
    _, tg, n = _graphs(rng, "random", "gcn")
    x = torch.zeros(n, 8)
    # per-call weights are taken in CSR order over all E_pad edges
    # (tests/test_torch_spmm_runtime.py); any other length is refused
    assert spmm(tg, x, edge_weight=torch.ones(tg.num_edges_padded)).shape == (n, 8)
    with pytest.raises(ValueError, match="edge_weight"):
        spmm(tg, x, edge_weight=torch.ones(tg.n_edge))
    with pytest.raises(ValueError):
        spmm(tg, torch.zeros(n + 1, 8))


def test_segment_sum_wrapper_checks_inputs(rng):
    _, tg, n = _graphs(rng, "random", "static")
    x = torch.randn(n, 16)
    with pytest.raises(ValueError, match="int32"):
        csr_segment_sum(x, tg.senders.long(), tg.row_offsets)
    with pytest.raises(ValueError, match="contiguous"):
        csr_segment_sum(torch.randn(16, n).t(), tg.senders, tg.row_offsets)
    with pytest.raises(ValueError, match="float32"):
        csr_segment_sum(x.double(), tg.senders, tg.row_offsets)
    with pytest.raises(ValueError, match="w must be"):
        csr_segment_sum(x, tg.senders, tg.row_offsets, tg.edge_weight[:-1])
    # the CPU path is the plain version, and it ignores the padding edges
    launches = csr_segment_sum.launches
    got = csr_segment_sum(x, tg.senders, tg.row_offsets, tg.edge_weight)
    assert csr_segment_sum.launches == launches
    torch.testing.assert_close(
        got, csr_segment_sum_plain(x, tg.senders, tg.row_offsets, tg.edge_weight))
    poisoned = tg.senders.clone()
    poisoned[tg.n_edge:] = 10**6  # out of range: must never be read
    torch.testing.assert_close(
        csr_segment_sum(x, poisoned, tg.row_offsets, tg.edge_weight), got)
