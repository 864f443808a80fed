"""The port's data-parallel GCN-KD step (``parallel.sharded_trainer``) and
SIGN dp x tp step (``parallel.tensor``) on CPU worlds of gloo ranks, against
the JAX dryrun's sections (``__graft_entry__.py``'s ``dryrun_multichip``,
written out here) on the virtual CPU mesh of ``conftest.py``, sharded and
unsharded, and against the port's own single-process steps.

Two worlds are spawned (``tests/torch_parallel_ranks.py::dp_world``): 4
ranks, the GCN rows and the SIGN batch over ``data`` of a ``(2, 2)``
``("data", "model")`` mesh; and 2 ranks, the GCN rows over a 1-D ``(2,)``
mesh and SIGN on ``(1, 2)``, pure tensor parallelism. The weights come from
the JAX modules through ``models/transplant.py``. Dropout differs between
the packages' random streams, so the steps held against JAX run with
dropout 0; with dropout on, the port's sharded steps are held to its own
single-process steps from the same seed.

Tolerances: losses rtol 1e-5 against JAX and 1e-6 against the port's
single-process steps; gradients rtol 1e-5 in norm, tensor by tensor (a
gradient M or D times too large must fail it, and does), and the first
conv's bias, whose exact gradient is 0 before BatchNorm, below 1e-6 of the
whole gradient's norm; BatchNorm running statistics rtol 1e-6.
After an Adam step a parameter moves by ``lr * g / (|g| + eps)``, about
``lr * sign(g)``: an entry whose gradient is near 0 may move the other way
under another summation order. So the parameters after the step are
compared only where ``|g| > max(1e-6, 1e-4 max |g|)`` (rtol 1e-5).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from efficient_gnns_tpu.data import synthetic_node_dataset as jax_dataset
from efficient_gnns_tpu.distill import criteria as jcrit
from efficient_gnns_tpu.models import GCN as JaxGCN
from efficient_gnns_tpu.models import SIGN as JaxSIGN
from efficient_gnns_tpu.parallel import make_mesh as jax_mesh
from efficient_gnns_tpu.parallel import replicate as jax_replicate
from efficient_gnns_tpu.parallel import shard_rows as jax_shard_rows
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train import NodeDistillTrainer as JaxTrainer

from efficient_gnns_tpu_torch import ops
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.data import synthetic_node_dataset
from efficient_gnns_tpu_torch.models import GCN
from efficient_gnns_tpu_torch.models.layers import dropout
from efficient_gnns_tpu_torch.models.transplant import from_jax_params
from efficient_gnns_tpu_torch.parallel import run_world, shard_cols
from efficient_gnns_tpu_torch.parallel.dryrun import sign_inputs, teacher_logits
from efficient_gnns_tpu_torch.train.config import DistillConfig
from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer

TOL = 1e-5
MODES = ("supervised", "kd")
WORLDS = {4: (("data", "model"), (2, 2)), 2: (("data",), (2,))}
SIGN_MESHES = {4: (("data", "model"), (2, 2)), 2: (("data", "model"), (1, 2))}


def _to_np(state):
    return {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_gcn():
    """The JAX GCN-KD step (dropout 0) per mode, with ``x`` / ``y`` under
    ``shard_rows`` on a ``(2, 2)`` mesh and unsharded: loss, gradients (of
    the step's loss, written out), parameters and running statistics after
    the step, in the port's names; and the initial weights."""
    ds = jax_dataset(**ranks.DP_DATA)
    tl = jnp.asarray(teacher_logits(np.asarray(ds.y), 8))
    mesh = jax_mesh(4, axes=("data", "model"), shape=(2, 2))
    out = {}
    for mode in MODES:
        cfg = JaxConfig(training=mode, epochs=1, hidden=16, num_layers=2, dropout=0.0)
        for sharded in (True, False):
            tr = JaxTrainer(JaxGCN(hidden=16, out_feats=8, num_layers=2, dropout=0.0), cfg,
                            ds.graph, ds.x, ds.y, ds.split_idx, teacher_logits=tl)
            out["init"] = from_jax_params(tr.state.params["model"],
                                          tr.state.batch_stats["model"])
            with mesh:
                state = tr.state
                if sharded:
                    state = jax_replicate(mesh, tr.state)
                    tr.x, tr.y = jax_shard_rows(mesh, tr.x), jax_shard_rows(mesh, tr.y)
                step = jax.jit(tr._make_train_step())
                new, metrics = step(state, jax.random.PRNGKey(0), tr._batch())
                bs, idx = state.batch_stats["model"], tr.split_idx["train"]

                def loss_fn(params, tr=tr, bs=bs, idx=idx):
                    (logits, _), _ = tr.model.apply(
                        {"params": params, "batch_stats": bs}, tr.graph, tr.x, training=True,
                        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
                    if mode == "supervised":
                        return jcrit.cls_ce(logits[idx], tr.y[idx])
                    return jcrit.kd_criterion(logits[idx], tr.y[idx], tl[idx], cfg.alpha,
                                              cfg.kd_T, reduction=cfg.kd_reduction)[0]

                grads = jax.jit(jax.grad(loss_fn))(state.params["model"])
            out[mode, sharded] = dict(
                loss=float(metrics["loss"]), grads=_to_np(from_jax_params(grads, {})),
                state=_to_np(from_jax_params(new.params["model"], new.batch_stats["model"])))
    out["init"] = _to_np(out["init"])
    return out


@pytest.fixture(scope="module")
def jax_sign():
    """The JAX SIGN dp x tp step (dropout 0) with the ``shard_param`` rule
    on a ``(2, 2)`` mesh and unsharded: loss, gradients, parameters after the
    step; and the initial weights."""
    feats_np, labels_np = sign_inputs("tiny")
    hid = ranks.SIGN_HIDDEN
    feats, labels = [jnp.asarray(f) for f in feats_np], jnp.asarray(labels_np.astype(np.int32))
    model = JaxSIGN(hidden=hid, out_feats=8, num_hops=ranks.SIGN_HOPS, ff_layers=2,
                    dropout=0.0)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)}, feats)
    tx = optax.adam(1e-3)
    mesh = jax_mesh(4, axes=("data", "model"), shape=(2, 2))

    def shard_param(path, p):
        if p.ndim == 2 and p.shape[1] == hid:
            return jax.device_put(p, NamedSharding(mesh, P(None, "model")))
        return jax.device_put(p, NamedSharding(mesh, P()))

    def loss_fn(p, feats, labels):
        logits, _ = model.apply({"params": p}, feats, training=True,
                                rngs={"dropout": jax.random.PRNGKey(2)})
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))

    @jax.jit
    def sign_step(params, opt_state, feats, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, feats, labels)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), loss, grads

    out = {"init": _to_np(from_jax_params(variables["params"], {}))}
    for sharded in (True, False):
        params = variables["params"]
        with mesh:
            f, y = feats, labels
            if sharded:
                params = jax.tree_util.tree_map_with_path(shard_param, params)
                f, y = [jax_shard_rows(mesh, a) for a in feats], jax_shard_rows(mesh, labels)
            new, loss, grads = sign_step(params, tx.init(params), f, y)
        out[sharded] = dict(loss=float(loss), grads=_to_np(from_jax_params(grads, {})),
                            params=_to_np(from_jax_params(new, {})))
    return out


@pytest.fixture(scope="module")
def worlds(jax_gcn, jax_sign):
    feats, labels = sign_inputs("tiny")
    out = {}
    for d, gcn_mesh in WORLDS.items():
        inputs = dict(gcn_mesh=gcn_mesh, sign_mesh=SIGN_MESHES[d], gcn_state=jax_gcn["init"],
                      sign_state=jax_sign["init"], sign_feats=feats, sign_labels=labels,
                      wrong=d == 4)
        out[d] = run_world(ranks.dp_world, d, backend="gloo", device="cpu", args=(inputs,))
    return out


def _grads_close(got, want, factor=1.0):
    """Each gradient within rtol 1e-5 of ``factor`` times JAX's in norm; one
    whose exact value is 0 (a bias just before BatchNorm, which the
    normalisation removes: rounding noise below 1e-6 of the whole gradient's
    norm in both packages) below that too."""
    want = {k: factor * v for k, v in want.items()}
    floor = 1e-6 * np.sqrt(sum(np.sum(v * v) for v in want.values()))
    return all(np.linalg.norm(got[k]) < floor if np.linalg.norm(w) < floor
               else np.linalg.norm(got[k] - w) <= TOL * np.linalg.norm(w)
               for k, w in want.items())


def _params_close_where_clear(got, want, grads):
    for k, g in grads.items():
        clear = np.abs(g) > max(1e-6, 1e-4 * np.abs(g).max())
        np.testing.assert_allclose(got[k][clear], want[k][clear], rtol=TOL, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("sharded", [True, False], ids=["jax_sharded", "jax_unsharded"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", list(WORLDS))
def test_gcn_kd_step_matches_jax(worlds, jax_gcn, d, mode, sharded):
    want = jax_gcn[mode, sharded]
    for r in worlds[d]:
        got = r[f"gcn_{mode}"]
        assert np.isclose(got["loss"], want["loss"], rtol=TOL, atol=0.0)
        assert _grads_close(got["grads"], want["grads"])
        _params_close_where_clear(got["state"], want["state"], want["grads"])
        for k in ("bns.0.running_mean", "bns.0.running_var"):
            np.testing.assert_allclose(got["state"][k], want["state"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("sharded", [True, False], ids=["jax_sharded", "jax_unsharded"])
@pytest.mark.parametrize("d", list(WORLDS))
def test_sign_dp_tp_step_matches_jax(worlds, jax_sign, d, sharded):
    want = jax_sign[sharded]
    for r in worlds[d]:
        got = r["sign"]
        assert np.isclose(got["losses"][0], want["loss"], rtol=TOL, atol=0.0)
        assert _grads_close(got["grads"], want["grads"])
        _params_close_where_clear(got["params"], want["params"], want["grads"])
    # the JAX rule splits the hidden-width kernels and nothing else
    assert worlds[d][0]["sign"]["split"] == sorted(
        [f"inceptions.{i}.weights.{j}" for i in range(ranks.SIGN_HOPS) for j in range(2)]
        + ["project.weights.0"])


@pytest.mark.parametrize("d", list(WORLDS))
def test_sharded_steps_with_dropout_match_the_single_process_steps(worlds, d):
    """The same seed gives the same masks and the same losses: GCN-KD (two
    epochs, dropout 0.5, then a ``run_epochs`` chunk of two with its global
    accuracies) against ``NodeDistillTrainer``, SIGN (two steps, dropout
    0.1) against ``SIGN.forward``."""
    ds = synthetic_node_dataset(**ranks.DP_DATA)
    cfg = DistillConfig(training="kd", hidden=16, num_layers=2, dropout=0.5)
    tr = NodeDistillTrainer(GCN(32, 16, 8, 2, 0.5, seed=0, device="cpu"), cfg, ds.graph, ds.x,
                            ds.y, ds.split_idx, teacher_logits=teacher_logits(ds.y, 8),
                            device="cpu")
    gcn = [tr.train_epoch(e)["loss"] for e in range(2)]
    chunk = tr.run_epochs(2, 2)  # losses, then the global accuracies
    feats, labels = sign_inputs("tiny")
    sign = ranks.sign_unsharded_losses(dict(sign_feats=feats, sign_labels=labels), 0.1, 2)
    for r in worlds[d]:
        np.testing.assert_allclose(r["gcn_dropout"], gcn, rtol=1e-6)
        np.testing.assert_allclose(r["gcn_run_epochs"], chunk, rtol=1e-6)
        np.testing.assert_allclose(r["sign_dropout"], sign, rtol=1e-6)


@pytest.mark.parametrize("d", list(WORLDS))
def test_row_block_dropout_masks_are_the_single_device_masks(worlds, d):
    gen = torch.Generator().manual_seed(7)
    n = ranks.DP_DATA["num_nodes"]
    whole = [dropout(torch.ones(n, 5), 0.5, gen).numpy() for _ in range(2)]
    for r in worlds[d]:
        lo, masks = r["masks"]
        for got, want in zip(masks, whole):
            assert np.array_equal(got, want[lo:lo + got.shape[0]])


@pytest.mark.parametrize("d", list(WORLDS))
def test_replicated_parameters_hold_the_same_bits_on_every_rank(worlds, d):
    world = worlds[d]
    for mode in MODES:
        for r in world:
            for k, v in r[f"gcn_{mode}"]["state"].items():
                assert np.array_equal(v, world[0][f"gcn_{mode}"]["state"][k]), k
    split = world[0]["sign"]["split"]
    for r in world:
        for k, v in r["sign"]["own"].items():
            # a split kernel's block is replicated over data: compare it with
            # the first rank of the same model index
            ref = next(q for q in world if k not in split
                       or q["sign"]["model_index"] == r["sign"]["model_index"])
            assert np.array_equal(v, ref["sign"]["own"][k]), k


def test_a_wrong_backward_or_group_is_rejected(worlds, jax_gcn, jax_sign):
    """The gradient checks above catch each wrong choice (world of 4, (2, 2)):
    the loss's sum with a summed backward makes every GCN gradient 2 (the
    ``data`` size) and every SIGN gradient 4 (the world) times too large; a
    column gather whose backward sums nothing, or the replicated gradients
    summed over ``data`` only (each held only its ``model`` rank's share),
    give wrong gradients too."""
    world = worlds[4]
    want_gcn, want_sign = jax_gcn["kd", True]["grads"], jax_sign[True]["grads"]
    for r in world:
        assert np.isclose(r["gcn_loss_sum_backward"]["loss"], jax_gcn["kd", True]["loss"],
                          rtol=TOL)
        assert not _grads_close(r["gcn_loss_sum_backward"]["grads"], want_gcn)
        assert _grads_close(r["gcn_loss_sum_backward"]["grads"], want_gcn, factor=2.0)
        assert not _grads_close(r["sign_loss_sum_backward"]["grads"], want_sign)
        assert _grads_close(r["sign_loss_sum_backward"]["grads"], want_sign, factor=4.0)
        assert not _grads_close(r["sign_gather_slice_backward"]["grads"], want_sign)
        over_data = r["sign_replicated_over_data"]
        split = set(over_data["split"])
        assert _grads_close({k: over_data["grads"][k] for k in split},
                            {k: want_sign[k] for k in split})
        assert not _grads_close(over_data["grads"], want_sign)


def test_unported_modes_and_runtime_weights_raise():
    # every mode runs on row shards (tests/test_torch_parallel_modes.py);
    # runtime edge weights on a sharded graph still raise
    sharded = mock.Mock(num_nodes=4)
    with pytest.raises(ValueError, match="static weights only"):
        ops.spmm(sharded, torch.ones(4, 2), edge_weight=torch.ones(3))
    assert ops.spmm(sharded, torch.ones(4, 2)) is sharded.spmm.return_value


@pytest.mark.parametrize("d", list(WORLDS))
def test_all_reduce_grads_keeps_a_gradient_that_no_rank_has_none(worlds, d):
    """A parameter with a gradient on one rank gets that rank's gradient on
    every rank; one without a gradient on any rank keeps ``None``, so the
    optimizer skips it (no weight decay) as on one device."""
    for r in worlds[d]:
        some, none = r["grads_none"]
        np.testing.assert_array_equal(some, [2.0, -3.0])
        assert none is None


def test_a_sharded_graph_refuses_bf16_messages():
    sharded = mock.Mock(num_nodes=4)
    dispatch.set_message_dtype(torch.bfloat16)
    try:
        with pytest.raises(ValueError, match="float32 messages only"):
            ops.spmm(sharded, torch.ones(4, 2))
    finally:
        dispatch.set_message_dtype(torch.float32)
    sharded.spmm.assert_not_called()


@pytest.mark.parametrize("index", [0, 1])
def test_shard_cols_takes_the_ranks_column_block(index):
    mesh = mock.Mock(device=torch.device("cpu"), size=lambda axis: 2, index=lambda axis: index)
    w = torch.arange(24.0).reshape(3, 8)
    assert torch.equal(shard_cols(mesh, w), w[:, 4 * index:4 * index + 4])
    with pytest.raises(ValueError, match="must divide the 'model' axis"):
        shard_cols(mesh, torch.ones(3, 5))


def test_sharded_graph_moves_its_views():
    """``ShardedGraph.to`` moves the rank's CSR views and mask and keeps the
    recorded row splits; ``num_nodes`` is the rank's row count."""
    from efficient_gnns_tpu_torch.parallel.partition import (
        ShardedGraph,
        partition_block,
        partition_graph_halo,
    )

    ds = synthetic_node_dataset(**ranks.DP_DATA)
    part = partition_graph_halo(ds.graph, 2)
    g = ShardedGraph(partition_block(part, 1), None, "data", torch.ones(512, dtype=torch.bool))
    moved = g.to("cpu")
    assert moved is not g and moved.num_nodes == 512 and moved.axis == "data"
    assert torch.equal(moved.local.local_fwd.src, g.local.local_fwd.src)
    assert torch.equal(moved.node_mask, g.node_mask)
