"""Every distillation mode of the port's row-sharded trainer
(``parallel.sharded_trainer``), alone and with ``kd_and_aux``, on CPU worlds
of gloo ranks: against the JAX ``NodeDistillTrainer`` with ``x``, ``y`` and
the teacher's arrays under ``shard_rows`` on the virtual CPU mesh of
``conftest.py``, and unsharded; and against the port's own single-process
trainer.

Two worlds are spawned (``tests/torch_parallel_ranks.py::modes_world``): 4
ranks, the rows over ``data`` of a ``(2, 2)`` ``("data", "model")`` mesh,
and 2 ranks on a 1-D ``(2,)`` mesh; each runs every case of
``MODE_CASES``, and the world of 4 also ``parallel.modes.modes_rank`` (what
``chip_smoke.py`` runs on the card). Both worlds run while this process
compiles the JAX steps. The steps held against JAX start from the JAX weights (the
model's and both heads', through ``models/transplant.py``) with dropout 0
and ``max_samples`` above the 552 train rows, so neither side draws rows
(the packages' random streams differ). The steps held against the port's
single process run with dropout 0.5, a draw of 256 rows and a train split
that is not sorted, once with every train row and once with those of the
graph's first half only (a rank without train rows).

Tolerances: losses rtol 1e-5 against JAX and 1e-6 against the port's
single process; gradients rtol 1e-5 in norm, tensor by tensor (JAX's are
read from Adam's first moment after one step, ``0.1 g``); parameters after
the step where ``|g| > max(1e-6, 1e-4 max |g|)`` (rtol 1e-5) and running
statistics rtol 1e-6, as in ``tests/test_torch_parallel_dp.py``. A
parameter whose exact gradient is 0 (the biases just before a BatchNorm:
rounding noise, which ``beta`` scales, in both packages) is compared by its
gradient only: Adam moves it by about ``lr`` times the noise's sign.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from efficient_gnns_tpu.data import synthetic_node_dataset as jax_dataset
from efficient_gnns_tpu.graphs.preprocess import induced_subgraph as jax_induced_subgraph
from efficient_gnns_tpu.models import GCN as JaxGCN
from efficient_gnns_tpu.parallel import make_mesh as jax_mesh
from efficient_gnns_tpu.parallel import replicate as jax_replicate
from efficient_gnns_tpu.parallel import shard_rows as jax_shard_rows
from efficient_gnns_tpu.train import DistillConfig as JaxConfig
from efficient_gnns_tpu.train import NodeDistillTrainer as JaxTrainer

from efficient_gnns_tpu_torch.models import GCN
from efficient_gnns_tpu_torch.models.transplant import from_jax_params
from efficient_gnns_tpu_torch.parallel import modes, run_world
from efficient_gnns_tpu_torch.parallel.dryrun import build_inputs
from efficient_gnns_tpu_torch.train.node_trainer import NodeDistillTrainer

TOL = 1e-5
WORLDS = {4: (("data", "model"), (2, 2)), 2: (("data",), (2,))}
CASE_IDS = [m + ("-kd" if kd else "") for m, kd in ranks.MODE_CASES]
ADAM_B1 = 0.9


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(params, batch_stats):
    """``<module>.<name>`` arrays of the trainer's model and heads."""
    return {f"{part}.{k}": v.numpy() for part in params
            for k, v in from_jax_params(params[part], batch_stats.get(part, {})).items()}


def _jax_trainers():
    """Per case, the JAX trainer (dropout 0, every train row) and its
    initial weights of the model and the heads, in the port's names."""
    jd = jax_dataset(**ranks.DP_DATA)
    data = ranks.modes_inputs(False)
    tf, tl = jnp.asarray(data["teacher_feat"]), jnp.asarray(data["teacher_logits"])
    lsp = jax_induced_subgraph(jd.senders, jd.receivers, jd.split_idx["train"])
    trainers, inits = {}, {}
    for mode, kd in ranks.MODE_CASES:
        cfg = JaxConfig(**vars(ranks.modes_config(mode, kd, 0.0, 4096)))
        tr = trainers[mode, kd] = JaxTrainer(
            JaxGCN(hidden=16, out_feats=8, num_layers=2, dropout=0.0), cfg, jd.graph, jd.x,
            jd.y, jd.split_idx, teacher_feat=tf, teacher_logits=tl, lsp_graph=lsp)
        inits[mode, kd] = {
            part: {k: v.numpy() for k, v in from_jax_params(
                _np_tree(tr.state.params[part]),
                _np_tree(tr.state.batch_stats.get(part, {}))).items()}
            for part in tr.state.params}
    return trainers, inits


def _jax_steps(trainers):
    """Per case, the JAX step with the arrays under ``shard_rows`` on a
    ``(2, 2)`` mesh, and unsharded for the modes alone (``kd_and_aux``
    changes the loss's sum only, and each JAX step costs a compilation): the
    three losses, the gradients, the state after the step."""
    mesh = jax_mesh(4, axes=("data", "model"), shape=(2, 2))
    out = {}
    for (mode, kd), tr in trainers.items():
        init = tr.state
        whole = (tr.x, tr.y, tr.teacher_feat, tr.teacher_logits)
        for sharded in (True, False)[:2 - kd]:
            with mesh:
                arrays = whole
                state = init
                if sharded:
                    state = jax_replicate(mesh, init)
                    arrays = [jax_shard_rows(mesh, a) for a in arrays]
                tr.x, tr.y, tr.teacher_feat, tr.teacher_logits = arrays
                new, metrics = jax.jit(tr._make_train_step())(state, jax.random.PRNGKey(0),
                                                              tr._batch())
            mu = _np_tree(new.opt_state[0].mu)
            out[mode, kd, sharded] = dict(
                losses=[float(metrics[k]) for k in ("loss", "loss_cls", "loss_aux")],
                grads={k: v / (1 - ADAM_B1) for k, v in _named(mu, {}).items()},
                state=_named(_np_tree(new.params), _np_tree(new.batch_stats)))
    return out


def _single_process():
    """The port's single-process trainer per case: two steps from the seed
    with dropout 0.5, a draw of 256 rows and the unsorted split; and the
    same with the train rows of the graph's first half only."""
    out = {}
    for key, below in (("draw", None), ("empty_rank", ranks.EMPTY_RANK_BELOW)):
        data = ranks.modes_inputs(True, below)
        train, ds = data["split"]["train"], data["ds"]
        assert not np.array_equal(train, np.sort(train))
        assert (train < ranks.EMPTY_RANK_BELOW).all() == (below is not None)
        for mode, kd in ranks.MODE_CASES:
            tr = NodeDistillTrainer(
                GCN(ds.x.shape[1], 16, 8, 2, 0.5, seed=0, device="cpu"),
                ranks.modes_config(mode, kd, 0.5, ranks.DRAW_SAMPLES), ds.graph, ds.x, ds.y,
                data["split"], teacher_feat=data["teacher_feat"],
                teacher_logits=data["teacher_logits"], lsp_graph=data["lsp_graph"], seed=0,
                device="cpu")
            out[key, mode, kd] = [list(tr.train_epoch(e).values()) for e in range(2)]
    return out


@pytest.fixture(scope="module")
def runs():
    """Everything the tests read: the two worlds, started first (each in a
    thread that waits on it), then in this process the JAX steps and the
    port's single process while the worlds run, and last
    ``parallel.modes.check_modes`` of the world of 4's ``modes_rank``
    results (at ``build_inputs``' tiny shape)."""
    # the ranks run torch on one thread each (parallel/launch.py); this
    # process does too meanwhile: a thread pool here would contend with them
    # for the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainers, inits = _jax_trainers()
        modes_inputs = build_inputs(4, "tiny")
        shared = modes.rank_inputs(modes_inputs)
        with ThreadPoolExecutor(len(WORLDS)) as pool:
            started = {d: pool.submit(run_world, ranks.modes_world, d, backend="gloo",
                                      device="cpu",
                                      args=(dict(mesh=mesh, jax_init=inits, wrong=d == 4,
                                                 modes=shared if d == 4 else None),))
                       for d, mesh in WORLDS.items()}
            out = dict(jax=_jax_steps(trainers), single=_single_process())
            out["worlds"] = {d: world.result() for d, world in started.items()}
        out["modes"] = modes.check_modes(modes_inputs, shared,
                                         [r["modes"] for r in out["worlds"][4]], "cpu")
    finally:
        torch.set_num_threads(threads)
    return out


def _grads_close(got, want):
    """Each gradient within rtol 1e-5 of JAX's in norm; one whose exact
    value is 0 (a bias just before BatchNorm) below 1e-6 of the whole
    gradient's norm."""
    floor = 1e-6 * np.sqrt(sum(np.sum(v * v) for v in want.values()))
    return set(got) == set(want) and all(
        np.linalg.norm(got[k]) < floor if np.linalg.norm(w) < floor
        else np.linalg.norm(got[k] - w) <= TOL * np.linalg.norm(w)
        for k, w in want.items())


def _state_close(got, want, grads):
    floor = 1e-6 * np.sqrt(sum(np.sum(v * v) for v in grads.values()))
    for k, w in want.items():
        if k in grads:  # a parameter: where its gradient is clear of 0
            g = grads[k]
            if np.linalg.norm(g) < floor:  # exactly 0: Adam moves it by the noise's sign
                continue
            clear = np.abs(g) > max(1e-6, 1e-4 * np.abs(g).max())
            np.testing.assert_allclose(got[k][clear], w[clear], rtol=TOL, atol=1e-7, err_msg=k)
        else:  # a running statistic
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7, err_msg=k)


JAX_CASES = [case + (True,) for case in ranks.MODE_CASES] + [
    (mode, False, False) for mode in ranks.AUX_MODES]


@pytest.mark.parametrize("mode,kd,sharded", JAX_CASES,
                         ids=[m + ("-kd" if kd else "") + ("-jax_sharded" if sh else
                                                           "-jax_unsharded")
                              for m, kd, sh in JAX_CASES])
@pytest.mark.parametrize("d", list(WORLDS))
def test_mode_step_matches_jax(runs, d, mode, kd, sharded):
    want = runs["jax"][mode, kd, sharded]
    for r in runs["worlds"][d]:
        got = r["jax", mode, kd]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL, atol=0.0)
        assert _grads_close(got["grads"], want["grads"])
        _state_close(got["state"], want["state"], want["grads"])


@pytest.mark.parametrize("mode,kd", ranks.MODE_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("d", list(WORLDS))
def test_mode_steps_with_a_draw_match_the_single_process(runs, d, mode, kd):
    for r in runs["worlds"][d]:
        np.testing.assert_allclose(r["draw", mode, kd], runs["single"]["draw", mode, kd],
                                   rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("d", list(WORLDS))
def test_a_rank_without_train_rows_matches_the_single_process(runs, d):
    """The train rows of the graph's first half only: the second rank of
    ``data`` adds 0 to every share, still joins every exchange of the
    forward and the backward, and every mode's losses are the single
    process's."""
    for r in runs["worlds"][d]:
        for mode, kd in ranks.MODE_CASES:
            np.testing.assert_allclose(r["empty_rank", mode, kd],
                                       runs["single"]["empty_rank", mode, kd], rtol=1e-6,
                                       atol=0.0, err_msg=f"{mode} {kd}")


@pytest.mark.parametrize("d", list(WORLDS))
def test_replicated_parameters_hold_the_same_bits_on_every_rank(runs, d):
    world = runs["worlds"][d]
    for case in ranks.MODE_CASES:
        for r in world:
            for k, v in r[("jax",) + case]["state"].items():
                assert np.array_equal(v, world[0][("jax",) + case]["state"][k]), (case, k)


def test_wrong_collectives_are_rejected(runs):
    """Each wrong choice fails the checks above (world of 4, ``data`` of
    size 2): the replicated ``nce`` term summed over the axis again is 2
    times too large (its gradients are not: that sum's backward is the
    identity); the chosen rows' assembly
    with a summed backward (as ``all_gather_rows``' reduce-scatter would
    sum) leaves the loss and doubles the gradients through the heads; ``at``
    normalised by each rank's own norm, and ``gcd`` heads whose BatchNorm
    has no group, give other losses."""
    for r in runs["worlds"][4]:
        want = runs["jax"]["nce", False, True]
        again = r["wrong", "summed_again"]
        np.testing.assert_allclose(again["losses"][2], 2 * want["losses"][2], rtol=TOL)
        assert not np.allclose(again["losses"], want["losses"], rtol=TOL, atol=0.0)
        gather = r["wrong", "gather_sum_backward"]
        np.testing.assert_allclose(gather["losses"], want["losses"], rtol=TOL)
        assert not _grads_close(gather["grads"], want["grads"])
        heads = {k: v for k, v in want["grads"].items() if k.startswith(("sproj.", "tproj."))}
        assert _grads_close({k: gather["grads"][k] for k in heads},
                            {k: 2 * v for k, v in heads.items()})
        for key, mode in (("at_local_norm", "at"), ("gcd_local_bn", "gcd")):
            want = runs["jax"][mode, False, True]["losses"]
            assert not np.allclose(r["wrong", key]["losses"], want, rtol=TOL, atol=0.0), key


def test_modes_rank_holds_every_mode_to_the_single_device(runs):
    """``parallel.modes.modes_rank`` and ``check_modes`` (what
    ``chip_smoke.py`` runs on the card through ``run_modes``) on the CPU
    world of 4 at the tiny shape: no failure, and the bytes a rank sends a
    step differ between modes by what each exchanges. ``nce`` assembles the
    chosen rows of both heads (2 x ``max_samples`` x ``proj_dim`` floats)
    where ``fitnet`` sums one share; ``lpw`` assembles every train row of
    the ``hidden``-wide features where ``at`` sums its two squared norms
    (and their cotangents) and its share."""
    out = runs["modes"]
    assert out["failures"] == []
    assert sorted(out["single"]) == sorted(modes.case_name(*c) for c in modes.CASES)
    cfg, f32 = modes.mode_config("tiny", "nce", False), 4
    for r in out["ranks"]:
        sent = {name: case["bytes_step"] for name, case in r.items()}
        assert all(len(case["ms"]) == 2 for case in r.values())
        assert sent["nce"] - sent["fitnet"] == 2 * cfg.max_samples * cfg.proj_dim * f32 - f32
        assert sent["lpw"] - sent["at"] == out["n_train"] * cfg.hidden * f32 - (2 + 2 + 1) * f32
