"""The port's multi-device layer on CPU worlds of gloo ranks against the JAX
``parallel/`` package on the virtual 8-device CPU mesh (``conftest.py``).

Two worlds are spawned (``parallel.launch.run_world``): one of 8 ranks runs
every SpMM, ring and BatchNorm check (``tests/torch_parallel_ranks.py``) and
hands its arrays back; one of 4 trains the MAG R-GCN with its embedding
tables row-sharded. JAX runs in this process.

Tolerances: the SpMMs' values and gradients within 1e-5 + 1e-5 * sum|terms|
per entry (the sums run in another order); the ring terms' values rtol 1e-5 and their
gradients rtol 1e-5 in norm (a gradient D times too large must fail it, and
does); BatchNorm rtol 1e-6;
the sharded MAG steps rtol 1e-5 of the unsharded ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from efficient_gnns_tpu import ops as jops
from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
from efficient_gnns_tpu.models.layers import MaskedBatchNorm as JaxBN
from efficient_gnns_tpu.parallel import make_mesh as jax_mesh
from efficient_gnns_tpu.parallel import partition as jpart
from efficient_gnns_tpu.parallel.ring import ring_gsp_term, ring_nce_term

from efficient_gnns_tpu_torch.models.layers import MaskedBatchNorm
from efficient_gnns_tpu_torch.parallel import run_world

D = 8
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    n, e = 256, 1200
    return dict(
        n=n, s=rng.integers(0, n, size=e), r=rng.integers(0, n, size=e),
        w=rng.normal(size=e).astype(np.float32),
        x=rng.normal(size=(n, 16)).astype(np.float32),
        f=rng.normal(size=(64, 12)).astype(np.float32),
        t=rng.normal(size=(64, 20)).astype(np.float32),
        t_nce=rng.normal(size=(64, 12)).astype(np.float32),
        xb=rng.normal(size=(64, 8)).astype(np.float32) * 2 + 1,
        mb=rng.random(64) < 0.7,
        cb=rng.normal(size=(64, 8)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs):
    """The 8 ranks' results, each key's arrays concatenated in rank order
    (BatchNorm's parameter gradients summed, its running statistics per
    rank)."""
    res = run_world(ranks.world8, D, backend="gloo", device="cpu", args=(inputs,))
    return res


def _cat(world, key):
    return tuple(np.concatenate([r[key][i] for r in world]) for i in range(2))


@pytest.fixture(scope="module")
def jax_spmm(inputs):
    """JAX values and gradients of sum(sin(A @ x)), per path and mesh."""
    g = jax_build_graph(inputs["s"], inputs["r"], inputs["n"], edge_weight=inputs["w"],
                        edge_pad_multiple=64)
    x = jnp.asarray(inputs["x"])
    mesh = jax_mesh(D)
    halo = jpart.partition_graph_halo(g, D)
    allg = jpart.partition_graph(g, D)
    fns = {
        "sharded": lambda v: jpart.spmm_sharded(mesh, allg, v),
        "halo": lambda v: jpart.spmm_halo(mesh, halo, v),
    }
    for shape in ((2, 4), (4, 2)):
        m2 = jax_mesh(D, axes=("host", "chip"), shape=shape)
        fns[f"halo_2level_{shape[0]}x{shape[1]}"] = (
            lambda v, m2=m2: jpart.spmm_halo_2level(m2, halo, v))
    out = {}
    for name, fn in fns.items():
        def y_dx(v, fn=fn):
            y, vjp = jax.vjp(fn, v)
            return y, vjp(jnp.cos(y))[0]  # d sum(sin(y)) / dv

        out[name] = tuple(np.asarray(a) for a in jax.jit(y_dx)(x))
    # sum of |terms| of each output and gradient entry
    a = np.zeros((inputs["n"], inputs["n"]))
    np.add.at(a, (inputs["r"], inputs["s"]), np.abs(inputs["w"]))
    y_ref = np.asarray(jops.spmm(g, x))
    out["scale"] = (a @ np.abs(inputs["x"]), a.T @ np.abs(np.cos(y_ref)))
    return out


def _within(got, want, scale):
    return np.all(np.abs(got - want) <= TOL + TOL * scale)


SPMM = ("sharded", "halo", "halo_2level_2x4", "halo_2level_4x2")


@pytest.mark.parametrize("path", SPMM)
def test_spmm_values_and_gradients_match_jax(world, jax_spmm, path):
    y, dx = _cat(world, path)
    jy, jdx = jax_spmm[path]
    sy, sdx = jax_spmm["scale"]
    assert y.shape == jy.shape and dx.shape == jdx.shape
    assert _within(y, jy, sy), np.abs(y - jy).max()
    assert _within(dx, jdx, sdx), np.abs(dx - jdx).max()


@pytest.fixture(scope="module")
def single(inputs):
    return ranks.single_device(inputs)


@pytest.mark.parametrize("path", SPMM)
def test_spmm_matches_the_single_device_spmm(world, single, jax_spmm, path):
    ref = single["spmm"]
    y, dx = _cat(world, path)
    sy, sdx = jax_spmm["scale"]
    assert _within(y, ref[0], sy) and _within(dx, ref[1], sdx)


@pytest.mark.parametrize("shape", ["2x4", "4x2"])
def test_two_level_halo_gives_the_flat_halo_bits(world, shape):
    for r in world:
        for a, b in zip(r["halo"], r[f"halo_2level_{shape}"]):
            assert np.array_equal(a, b)


def test_replicate_broadcasts_rank_zeros_values(world):
    weight0 = world[0]["replicated"][0]
    assert np.all(weight0 == 0.0)  # rank 0 filled its weight with its rank
    for r in world:
        assert np.array_equal(r["replicated"][0], weight0)
        assert np.array_equal(r["replicated"][1], np.zeros(4, np.float32))


@pytest.fixture(scope="module")
def jax_ring(inputs):
    f, t, tn = (jnp.asarray(inputs[k]) for k in ("f", "t", "t_nce"))
    mesh = jax_mesh(D)
    fns = {f"gsp_{k}": (lambda v, k=k: ring_gsp_term(mesh, v, t, k)) for k in ranks.KERNELS}
    fns["nce"] = lambda v: ring_nce_term(mesh, v, tn, nce_T=ranks.NCE_T)
    out = {}
    for name, fn in fns.items():
        v, g = jax.jit(jax.value_and_grad(fn))(f)
        out[name] = (float(v), np.asarray(g))
    return out


def _ring_close(value, grad, want_value, want_grad):
    """The value within rtol 1e-5, the gradient within rtol 1e-5 in norm.
    Entry by entry a gradient is a sum of many terms that cancel: JAX's own
    ring and single-device l2 gradients differ by 6e-4 of an entry."""
    return (np.isclose(value, want_value, rtol=TOL, atol=0.0)
            and np.linalg.norm(grad - want_grad) <= TOL * np.linalg.norm(want_grad))


@pytest.mark.parametrize("term", [f"gsp_{k}" for k in ranks.KERNELS] + ["nce"])
def test_ring_terms_match_jax_and_the_single_device_terms(world, single, jax_ring, term):
    values = {r[term][0] for r in world}
    assert len(values) == 1  # the replicated scalar, the same on every rank
    value, grad = world[0][term][0], np.concatenate([r[term][1] for r in world])
    assert _ring_close(value, grad, *jax_ring[term])
    assert _ring_close(value, grad, *single[term])


def test_ring_gradient_with_a_summed_backward_is_rejected(world, jax_ring):
    """The check above catches the wrong all-reduce: with the BatchNorm
    backward (a sum of the ranks' cotangents) in the ring's final sum, the
    value is right and every gradient is D times too large."""
    value = world[0]["nce_sum_backward"][0]
    grad = np.concatenate([r["nce_sum_backward"][1] for r in world])
    want_value, want_grad = jax_ring["nce"]
    assert np.isclose(value, want_value, rtol=TOL)
    assert not _ring_close(value, grad, want_value, want_grad)
    assert np.linalg.norm(grad - D * want_grad) <= TOL * np.linalg.norm(D * want_grad)


@pytest.fixture(scope="module")
def jax_bn(inputs):
    """The JAX layer with ``axis_name`` under ``shard_map`` (output, input
    gradient, running statistics) and on all rows at once (the parameter
    gradients: the sums of the shards')."""
    x, m, c = (jnp.asarray(inputs[k]) for k in ("xb", "mb", "cb"))
    init = JaxBN().init(jax.random.PRNGKey(0), x, m)
    mesh = jax_mesh(D)

    def sharded(xx):
        def local(xl, ml):
            y, upd = JaxBN(axis_name="data").apply(init, xl, ml, mutable=["batch_stats"])
            return y, upd["batch_stats"]["mean"][None], upd["batch_stats"]["var"][None]

        return shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P("data"), P("data"), P("data")),
                         check_vma=False)(xx, m)

    y, mean, var = jax.jit(sharded)(x)
    dx = jax.jit(jax.grad(lambda xx: jnp.sum(jnp.sin(sharded(xx)[0]) * c)))(x)

    def full(params):
        y, _ = JaxBN().apply({**init, "params": params}, x, m, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y) * c)

    dp = jax.jit(jax.grad(full))(init["params"])
    return dict(y=np.asarray(y), dx=np.asarray(dx), running_mean=np.asarray(mean),
                running_var=np.asarray(var), dscale=np.asarray(dp["scale"]),
                dbias=np.asarray(dp["bias"]))


def _port_bn_full(inputs):
    import torch

    x = torch.from_numpy(inputs["xb"]).requires_grad_()
    bn = MaskedBatchNorm(x.shape[1], device="cpu")
    y = bn(x, torch.from_numpy(inputs["mb"]))
    (torch.sin(y) * torch.from_numpy(inputs["cb"])).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(), dscale=bn.scale.grad.numpy(),
                dbias=bn.bias.grad.numpy(), running_mean=bn.running_mean.numpy(),
                running_var=bn.running_var.numpy())


def _bn_world(world, key="bn"):
    return dict(y=np.concatenate([r[key]["y"] for r in world]),
                dx=np.concatenate([r[key]["dx"] for r in world]),
                dscale=sum(r[key]["dscale"] for r in world),
                dbias=sum(r[key]["dbias"] for r in world))


@pytest.mark.parametrize("against", ["jax_axis_name", "port_all_rows"])
def test_batchnorm_over_row_shards(world, inputs, jax_bn, against):
    want = jax_bn if against == "jax_axis_name" else _port_bn_full(inputs)
    got = _bn_world(world)
    for k in ("y", "dx", "dscale", "dbias"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for r in world:  # every rank updates its running statistics identically
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r["bn"][k], np.reshape(want[k], (-1, 8))[0],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            assert np.array_equal(r["bn"][k], world[0]["bn"][k])


def test_batchnorm_without_a_group_keeps_its_bits(world, inputs):
    """``group=None`` is the single-device layer: each rank's output is the
    layer's on its own rows alone, bit for bit, and the one-process layer is
    the sum / sum-of-squares formula it always was."""
    import torch

    for k, r in enumerate(world):
        rows = slice(8 * k, 8 * (k + 1))
        sub = {key: inputs[key][rows] for key in ("xb", "mb", "cb")}
        want = _port_bn_full(sub)
        for key in want:
            assert np.array_equal(r["bn_local"][key], want[key]), key
    x, m = torch.from_numpy(inputs["xb"]), torch.from_numpy(inputs["mb"]).float()[:, None]
    count = m.sum().clamp_min(1.0)
    mean = (x * m).sum(0) / count
    var = ((x * x * m).sum(0) / count - mean * mean).clamp_min(0.0)
    y = (x - mean) * torch.rsqrt(var + 1e-5) * torch.ones(8) + torch.zeros(8)
    assert np.array_equal(_port_bn_full(inputs)["y"], y.numpy())


MAG_STEPS = 3


@pytest.fixture(scope="module")
def mag():
    sharded = run_world(ranks.world4_mag, 4, backend="gloo", device="cpu", args=(MAG_STEPS,))
    return sharded, ranks.mag_trainer("cpu", MAG_STEPS)


@pytest.mark.parametrize("shard_after", [0, 1])
def test_mag_sharded_embeddings_match_the_unsharded_steps(mag, shard_after):
    world, full = mag
    sharded = [r[shard_after] for r in world]
    for r in sharded:
        np.testing.assert_allclose(r["losses"], full["losses"], rtol=1e-5)
    for name, (_, table) in full["tables"].items():
        blocks = sorted((r["tables"][name] for r in sharded), key=lambda b: b[0])
        los = [lo for lo, _ in blocks]
        assert los == sorted(los) and los[0] == 0
        gathered = np.concatenate([b for _, b in blocks])
        assert gathered.shape == table.shape
        np.testing.assert_allclose(gathered, table, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shard_after", [0, 1])
def test_mag_replicated_parameters_stay_equal_across_ranks(mag, shard_after):
    world, full = mag
    sharded = [r[shard_after] for r in world]
    for name, want in full["others"].items():
        for r in sharded:
            assert np.array_equal(r["others"][name], sharded[0]["others"][name]), name
        np.testing.assert_allclose(sharded[0]["others"][name], want, rtol=1e-5, atol=1e-7)
