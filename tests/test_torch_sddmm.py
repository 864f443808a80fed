"""Port vs JAX: ``sddmm_dot`` (``out_e = <a[receiver_e], b[sender_e]>``, 0 on
padding edges), whose forward is K3 and whose backward is two K1 sums.

The port runs the kernels' plain versions on the CPU. Float32 values and
gradients agree to rtol 1e-5 / atol 1e-6 (the sums run in another order).
With bfloat16 inputs both packages form the products and sums in float32
and round the result to bfloat16 once, so outputs differ at most where the
float32 sums straddle a rounding boundary: one bfloat16 step, rtol 2**-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu import ops as jax_ops
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu_torch.graphs import build_graph, build_row_split
from efficient_gnns_tpu_torch.ops import sddmm_dot
from efficient_gnns_tpu_torch.ops.cuda import csr_sddmm_plain

N = 60


def _graphs(rng, e=260, **kw):
    s = rng.integers(4, N, size=e)  # nodes 0-3 send nothing
    r = rng.integers(0, N - 6, size=e)  # nodes 54-59 receive nothing
    r[: e // 3] = 2  # a receiver of high degree
    jg = jax_build_graph(s, r, N, edge_pad_multiple=64, **kw)
    tg = build_graph(s, r, N, edge_pad_multiple=64, **kw)
    assert tg.n_edge < tg.num_edges_padded  # padding edges present
    return jg, tg


def _both(jg, tg, a, b, cot, dtype):
    """``sddmm_dot`` values and gradients of ``sum(out * cot)`` in both
    packages, in ``dtype`` ("float32" or "bfloat16"), as float32 arrays."""
    jdt = getattr(jnp, dtype)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)

    def jloss(a_, b_):
        return jnp.sum(jax_ops.sddmm_dot(jg, a_, b_).astype(jnp.float32) * cot)

    jout = jax_ops.sddmm_dot(jg, ja, jb)
    jda, jdb = jax.grad(jloss, argnums=(0, 1))(ja, jb)
    tdt = getattr(torch, dtype)
    ta = torch.tensor(a).to(tdt).requires_grad_(True)
    tb = torch.tensor(b).to(tdt).requires_grad_(True)
    tout = sddmm_dot(tg, ta, tb)
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    assert tout.dtype == ta.grad.dtype == tb.grad.dtype == tdt
    f32 = lambda v: np.asarray(jnp.asarray(v, jnp.float32))  # noqa: E731
    return ([f32(jout), f32(jda), f32(jdb)],
            [t.detach().float().numpy() for t in (tout, ta.grad, tb.grad)])


@pytest.mark.parametrize("f", [1, 16, 40])
@pytest.mark.parametrize("split_at", [None, 16])
def test_sddmm_dot_matches_jax(rng, f, split_at):
    jg, tg = _graphs(rng)
    if split_at is not None:  # the graph's hub row as a long row of the split
        tg = dataclasses.replace(tg, row_split=build_row_split(tg.row_offsets, split_at),
                                 t_row_split=build_row_split(tg.t_row_offsets, split_at))
    a = rng.normal(size=(N, f)).astype(np.float32)
    b = rng.normal(size=(N, f)).astype(np.float32)
    cot = rng.normal(size=tg.num_edges_padded).astype(np.float32)
    want, got = _both(jg, tg, a, b, cot, "float32")
    for g, w, name in zip(got, want, ("out", "da", "db")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
    # padding edges give 0, and their cotangent reaches no input
    assert (got[0][tg.n_edge:] == 0).all()
    cot[tg.n_edge:] = 1e6
    again = _both(jg, tg, a, b, cot, "float32")[1]
    for g, w in zip(again[1:], got[1:]):
        np.testing.assert_array_equal(g, w)


def test_sddmm_dot_bf16_matches_jax(rng):
    jg, tg = _graphs(rng)
    a = rng.normal(size=(N, 24)).astype(np.float32)
    b = rng.normal(size=(N, 24)).astype(np.float32)
    cot = rng.normal(size=tg.num_edges_padded).astype(np.float32)
    want, got = _both(jg, tg, a, b, cot, "bfloat16")
    for g, w, name in zip(got, want, ("out", "da", "db")):
        np.testing.assert_allclose(g, w, rtol=2**-7, atol=1e-5, err_msg=name)
    assert (got[0][tg.n_edge:] == 0).all()


def test_sddmm_dot_forward_is_k3(rng):
    _, tg = _graphs(rng)
    a = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32))
    want = csr_sddmm_plain(a, b, tg.senders, tg.row_offsets)
    torch.testing.assert_close(sddmm_dot(tg, a, b), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="num_nodes"):
        sddmm_dot(tg, a[:-1], b[:-1])
    with pytest.raises(ValueError, match="one dtype"):
        sddmm_dot(tg, a, b.bfloat16())
