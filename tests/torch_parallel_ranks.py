"""Rank functions of ``tests/test_torch_parallel.py`` (not collected: no
``test_`` prefix). A spawned rank imports this module by name, so it imports
torch and the port only, never JAX."""

from unittest import mock

import torch
import torch.distributed as dist

from efficient_gnns_tpu_torch.distill import criteria
from efficient_gnns_tpu_torch.graphs.preprocess import build_graph
from efficient_gnns_tpu_torch.models.layers import MaskedBatchNorm
from efficient_gnns_tpu_torch.parallel import ring
from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_stat
from efficient_gnns_tpu_torch.parallel.mesh import make_mesh, replicate, shard_rows
from efficient_gnns_tpu_torch.parallel.partition import (
    local_partition,
    partition_graph,
    partition_graph_halo,
    spmm_halo,
    spmm_halo_2level,
    spmm_sharded,
)

KERNELS = ("cosine", "poly", "l2", "rbf")
NCE_T = 0.075


def graph(inputs):
    return build_graph(inputs["s"], inputs["r"], inputs["n"], edge_weight=inputs["w"],
                       edge_pad_multiple=64)


def _sin_grad(fn, x):
    x = x.clone().requires_grad_()
    out = fn(x)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _grad(fn, x):
    x = x.clone().requires_grad_()
    v = fn(x)
    v.backward()
    return float(v.detach()), x.grad.numpy()


def world8(device, inputs):
    """Every check of the 8-rank world: the three SpMMs (the two-level one on
    (2, 4) and (4, 2) meshes), the ring terms, BatchNorm over row shards."""
    d = dist.get_world_size()
    g = graph(inputs)
    mesh = make_mesh(d, device=device)
    out = {}
    x = torch.from_numpy(inputs["x"])
    xs = shard_rows(mesh, x)
    allg = local_partition(mesh, partition_graph(g, d))
    halo_part = partition_graph_halo(g, d)
    halo = local_partition(mesh, halo_part)
    out["sharded"] = _sin_grad(lambda v: spmm_sharded(mesh, allg, v), xs)
    out["halo"] = _sin_grad(lambda v: spmm_halo(mesh, halo, v), xs)
    for shape in ((2, 4), (4, 2)):
        mesh2 = make_mesh(d, axes=("host", "chip"), shape=shape, device=device)
        local2 = local_partition(mesh2, halo_part, ("host", "chip"))
        out[f"halo_2level_{shape[0]}x{shape[1]}"] = _sin_grad(
            lambda v: spmm_halo_2level(mesh2, local2, v), shard_rows(mesh2, x, ("host", "chip")))

    f, t = torch.from_numpy(inputs["f"]), torch.from_numpy(inputs["t"])
    t_nce = torch.from_numpy(inputs["t_nce"])
    fs, ts, tns = (shard_rows(mesh, a) for a in (f, t, t_nce))
    for k in KERNELS:
        out[f"gsp_{k}"] = _grad(lambda v: ring.ring_gsp_term(mesh, v, ts, k), fs)
    out["nce"] = _grad(lambda v: ring.ring_nce_term(mesh, v, tns, NCE_T), fs)
    # the ring's final sum with the BatchNorm backward (an all-reduce of the
    # cotangent): every rank's gradient comes out D times too large
    with mock.patch.object(ring, "all_reduce_replicated", all_reduce_stat):
        out["nce_sum_backward"] = _grad(lambda v: ring.ring_nce_term(mesh, v, tns, NCE_T), fs)

    # replicate: every rank ends with rank 0's values, a module's and a list's
    lin, vec = torch.nn.Linear(3, 2), torch.full((4,), float(mesh.rank))
    torch.nn.init.constant_(lin.weight, float(mesh.rank))
    replicate(mesh, lin)
    replicate(mesh, [vec])
    out["replicated"] = (lin.weight.detach().numpy(), vec.numpy())

    xb, mb, cb = (shard_rows(mesh, torch.from_numpy(inputs[k])) for k in ("xb", "mb", "cb"))
    for name, group in (("bn", mesh.group("data")), ("bn_local", None)):
        bn = MaskedBatchNorm(xb.shape[1], device=device, group=group)
        xg = xb.clone().requires_grad_()
        y = bn(xg, mb)
        (torch.sin(y) * cb).sum().backward()
        out[name] = dict(y=y.detach().numpy(), dx=xg.grad.numpy(),
                         dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(),
                         running_mean=bn.running_mean.numpy(),
                         running_var=bn.running_var.numpy())
    return out


def single_device(inputs):
    """The same checks on one process: ``ops.spmm`` and the single-device
    ``gsp_term`` / ``nce_term``."""
    from efficient_gnns_tpu_torch import ops

    out = {"spmm": _sin_grad(lambda v: ops.spmm(graph(inputs), v), torch.from_numpy(inputs["x"]))}
    f, t = torch.from_numpy(inputs["f"]), torch.from_numpy(inputs["t"])
    t_nce = torch.from_numpy(inputs["t_nce"])
    n = f.shape[0]
    for k in KERNELS:
        out[f"gsp_{k}"] = _grad(lambda v: criteria.gsp_term(v, t, k, max_samples=n), f)
    out["nce"] = _grad(lambda v: criteria.nce_term(v, t_nce, NCE_T, max_samples=n), f)
    return out


def mag_trainer(device, steps, shard_after=None):
    """``MagTrainer`` (supervised) on a small synthetic MAG, ``steps``
    one-step epochs, with the embedding tables row-sharded over the world
    after ``shard_after`` steps (0: before the first; None: never). Returns
    the per-step losses, each table's rows (this rank's block, with the
    index of its first row) and the other parameters."""
    from efficient_gnns_tpu_torch.data.mag import synthetic_mag_dataset
    from efficient_gnns_tpu_torch.train.config import DistillConfig
    from efficient_gnns_tpu_torch.train.mag_trainer import MagTrainer

    ds = synthetic_mag_dataset(n_paper=320, n_author=160, n_inst=10, n_field=32, feat_dim=16,
                               num_classes=4)
    tr = MagTrainer(DistillConfig(training="supervised", hidden=8, num_layers=2, lr=0.01), ds,
                    batch_size=32, num_steps=1, seed=0, prefetch=0, device=device)
    losses = []
    for e in range(steps):
        if e == shard_after:  # the Adam moments of later shards are sliced too
            tr.shard_embeddings(make_mesh(dist.get_world_size(), device=device))
        losses.append(tr.train_epoch(e)["loss"])
    model = tr.model
    tables = {name: (model.emb_lo.get(name, 0), p.detach().numpy().copy())
              for name, p in model.embs.items()}
    others = {name: p.detach().numpy().copy() for name, p in model.named_parameters()
              if not name.startswith("embs.")}
    return dict(losses=losses, tables=tables, others=others)


def world4_mag(device, steps):
    """Sharded before the first step, and after the first."""
    return {after: mag_trainer(device, steps, shard_after=after) for after in (0, 1)}


# --------------------------------------------------------------------------
# the dp GCN-KD and SIGN dp x tp sections (tests/test_torch_parallel_dp.py)
# --------------------------------------------------------------------------

DP_DATA = dict(num_nodes=1024, num_edges=4096, feat_dim=32, num_classes=8, seed=0)
SIGN_HOPS, SIGN_HIDDEN = 3, 64


def _np(tensors):
    return {n: t.detach().cpu().numpy().copy() for n, t in tensors}


def _gcn(mesh, ds, part, mode, dropout, state=None):
    from efficient_gnns_tpu_torch.parallel.dryrun import teacher_logits
    from efficient_gnns_tpu_torch.parallel.sharded_trainer import ShardedNodeDistillTrainer
    from efficient_gnns_tpu_torch.train.config import DistillConfig

    cfg = DistillConfig(training=mode, hidden=16, num_layers=2, dropout=dropout)
    tr = ShardedNodeDistillTrainer(mesh, cfg, part, ds.x, ds.y, ds.split_idx, 8,
                                   node_mask=ds.graph.node_mask.numpy().copy(),
                                   teacher_logits=teacher_logits(ds.y, 8), seed=0)
    if state is not None:
        tr.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return tr


def _gcn_step(tr):
    loss = tr.train_epoch(0)["loss"]
    return dict(loss=loss, grads=_np((n, p.grad) for n, p in tr.model.named_parameters()),
                state=_np(tr.model.state_dict().items()))


def sign_model(dropout, state=None, device="cpu"):
    from efficient_gnns_tpu_torch.models import SIGN

    model = SIGN(DP_DATA["feat_dim"], SIGN_HIDDEN, DP_DATA["num_classes"], SIGN_HOPS,
                 ff_layers=2, dropout=dropout, seed=0, device=device)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _sign_steps(mesh, inputs, dropout, steps=1, state=None):
    """``steps`` dp x tp steps of a SIGN (each with the dropout seed 2);
    returns the losses, the whole gradients and parameters after the last
    (gathered over ``model``) and this rank's own tensors."""
    from efficient_gnns_tpu_torch.parallel import tensor

    model = tensor.shard_sign(sign_model(dropout, state), mesh)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    feats = [shard_rows(mesh, torch.from_numpy(f)) for f in inputs["sign_feats"]]
    labels = shard_rows(mesh, torch.from_numpy(inputs["sign_labels"]))
    gen, losses = torch.Generator(), []
    for _ in range(steps):
        gen.manual_seed(2)
        losses.append(float(tensor.sign_dp_tp_step(model, opt, feats, labels, mesh, gen)))
    group = mesh.group("model")
    with torch.no_grad():
        grads = {n: tensor.all_gather_cols(p.grad, group) if n in model.tp_split else p.grad
                 for n, p in model.named_parameters()}
    return dict(losses=losses, grads=_np(grads.items()),
                params=_np(tensor.gather_sign(model, mesh).items()),
                own=_np(model.named_parameters()), split=sorted(model.tp_split),
                model_index=mesh.index("model"))


class _GatherColsSliceBackward(torch.autograd.Function):
    """The column gather with the wrong backward: each rank keeps its
    columns of its own cotangent, summing nothing."""

    @staticmethod
    def forward(ctx, x, group):
        from efficient_gnns_tpu_torch.parallel.collectives import all_gather_cols

        ctx.lo, ctx.cols = dist.get_rank(group) * x.shape[-1], x.shape[-1]
        return all_gather_cols(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.cols].contiguous(), None


def dp_world(device, inputs):
    """The GCN-KD steps on ``inputs["gcn_mesh"]`` and the SIGN steps on
    ``inputs["sign_mesh"]`` (``(axes, shape)``): from the JAX weights with
    dropout 0, and from the seed with dropout on; row blocks of dropout
    masks; with ``inputs["wrong"]`` each wrong choice of a collective's
    backward or group."""
    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.models.layers import RowBlockGenerator, dropout
    from efficient_gnns_tpu_torch.parallel import sharded_trainer, tensor
    from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_grads

    d = dist.get_world_size()
    gmesh = make_mesh(d, *inputs["gcn_mesh"], device=device)
    smesh = make_mesh(d, *inputs["sign_mesh"], device=device)
    ds = synthetic_node_dataset(**DP_DATA)
    part = partition_graph_halo(ds.graph, gmesh.size("data"))
    out = {"rank": dist.get_rank()}
    for mode in ("supervised", "kd"):
        out[f"gcn_{mode}"] = _gcn_step(_gcn(gmesh, ds, part, mode, 0.0, inputs["gcn_state"]))
    tr = _gcn(gmesh, ds, part, "kd", 0.5)
    out["gcn_dropout"] = [tr.train_epoch(e)["loss"] for e in range(2)]
    out["gcn_run_epochs"] = tr.run_epochs(2, 2)
    rows = tr.x.shape[0]
    gen = torch.Generator().manual_seed(7)
    blocks = RowBlockGenerator(gen, rows * gmesh.size("data"), tr.lo)
    out["masks"] = (tr.lo, [dropout(torch.ones(rows, 5), 0.5, blocks).numpy() for _ in range(2)])
    out["sign"] = _sign_steps(smesh, inputs, 0.0, state=inputs["sign_state"])
    out["sign_dropout"] = _sign_steps(smesh, inputs, 0.1, steps=2)["losses"]
    # a gradient on rank 0 only, and one on no rank
    some, none = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
    if dist.get_rank() == 0:
        some.grad = torch.tensor([2.0, -3.0])
    all_reduce_grads([some, none], dist.group.WORLD)
    out["grads_none"] = (some.grad.numpy(), none.grad)
    if inputs.get("wrong"):
        with mock.patch.object(sharded_trainer, "all_reduce_replicated", all_reduce_stat):
            out["gcn_loss_sum_backward"] = _gcn_step(
                _gcn(gmesh, ds, part, "kd", 0.0, inputs["gcn_state"]))
        data = smesh.group("data")
        wrong = {
            "sign_loss_sum_backward": ("all_reduce_replicated", all_reduce_stat),
            "sign_gather_slice_backward": ("all_gather_cols", _GatherColsSliceBackward.apply),
            # the replicated gradients summed over data only, not over model
            "sign_replicated_over_data": ("all_reduce_grads",
                                          lambda params, group: all_reduce_grads(params, data)),
        }
        for key, (name, fn) in wrong.items():
            with mock.patch.object(tensor, name, fn):
                out[key] = _sign_steps(smesh, inputs, 0.0, state=inputs["sign_state"])
    return out


def sign_unsharded_losses(inputs, dropout, steps):
    """The port's SIGN on one process: ``SIGN.forward``, the NLL mean, Adam,
    each step with the dropout seed 2."""
    import torch.nn.functional as F

    model = sign_model(dropout)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    feats = [torch.from_numpy(f) for f in inputs["sign_feats"]]
    labels = torch.from_numpy(inputs["sign_labels"])
    gen, losses = torch.Generator(), []
    for _ in range(steps):
        gen.manual_seed(2)
        model.train()
        loss = F.nll_loss(F.log_softmax(model(feats, gen)[0], -1), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


# --------------------------------------------------------------------------
# every distillation mode on row shards (tests/test_torch_parallel_modes.py)
# --------------------------------------------------------------------------

AUX_MODES = ("fitnet", "at", "gpw", "lpw", "nce", "gcd", "nce-labels", "nce-edges",
             "nce-labels-edges")
MODE_CASES = [(mode, kd) for mode in AUX_MODES for kd in (False, True)]
TEACHER_DIM = 24
DRAW_SAMPLES = 256  # below the 552 train rows: a real draw
EMPTY_RANK_BELOW = DP_DATA["num_nodes"] // 2


def modes_config(mode, kd_and_aux, dropout, max_samples):
    from efficient_gnns_tpu_torch.train.config import DistillConfig

    return DistillConfig(training=mode, kd_and_aux=kd_and_aux, hidden=16, num_layers=2,
                         dropout=dropout, proj_dim=16, max_samples=max_samples)


def modes_inputs(unsorted, train_below=None):
    """The dp data set, the teacher's features (from seed 3) and logits, the
    split (its train indices permuted with seed 4 when ``unsorted``, and
    only those below ``train_below`` kept when given) and the train
    subgraph in that train order."""
    import numpy as np

    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.graphs import induced_subgraph
    from efficient_gnns_tpu_torch.parallel.dryrun import teacher_logits

    ds = synthetic_node_dataset(**DP_DATA)
    split = dict(ds.split_idx)
    if unsorted:
        split["train"] = np.random.default_rng(4).permutation(split["train"])
    if train_below is not None:
        split["train"] = split["train"][split["train"] < train_below]
    tf = np.random.default_rng(3).normal(size=(DP_DATA["num_nodes"], TEACHER_DIM))
    return dict(ds=ds, split=split, teacher_feat=tf.astype(np.float32),
                teacher_logits=teacher_logits(ds.y, DP_DATA["num_classes"]),
                lsp_graph=induced_subgraph(ds.senders, ds.receivers, split["train"]))


def _modes_trainer(mesh, part, data, cfg, state=None, cls=None):
    from efficient_gnns_tpu_torch.parallel.sharded_trainer import ShardedNodeDistillTrainer

    ds = data["ds"]
    tr = (cls or ShardedNodeDistillTrainer)(
        mesh, cfg, part, ds.x, ds.y, data["split"], DP_DATA["num_classes"],
        node_mask=ds.graph.node_mask.numpy().copy(), teacher_feat=data["teacher_feat"],
        teacher_logits=data["teacher_logits"], lsp_graph=data["lsp_graph"], seed=0)
    if state is not None:
        for name, module in tr._named_modules().items():
            module.load_state_dict({k: torch.from_numpy(v) for k, v in state[name].items()})
    return tr


def _modes_step(tr):
    """One step: its (loss, loss_cls, loss_aux), every module's gradients
    and state after it, by ``<module>.<name>``."""
    losses = tr.train_epoch(0)
    named = tr._named_modules().items()
    return dict(losses=[losses[k] for k in ("loss", "loss_cls", "loss_aux")],
                grads=_np((f"{m}.{n}", p.grad) for m, mod in named
                          for n, p in mod.named_parameters()),
                state=_np((f"{m}.{n}", v) for m, mod in named
                          for n, v in mod.state_dict().items()))


def _assemble_rows_summed_backward(rows, slots, m, group):
    """The chosen rows' assembly with the wrong backward: a sum of the
    ranks' cotangents, which are all the whole one."""
    keep = slots >= 0
    buf = rows.new_zeros((m,) + tuple(rows.shape[1:]))
    return all_reduce_stat(buf.index_add(0, slots[keep], rows[keep]), group)


def modes_world(device, inputs):
    """Every case of ``MODE_CASES`` on ``inputs["mesh"]`` (``(axes,
    shape)``): one step from the JAX weights (``inputs["jax_init"]``) with
    dropout 0 and every train row (no draw); two steps from the seed with
    dropout 0.5, a draw of ``DRAW_SAMPLES`` rows and an unsorted train
    split, and the same with the train rows of the first half of the graph
    only; with ``inputs["wrong"]`` each wrong collective, one step from the
    JAX weights; with ``inputs["modes"]`` (``parallel.modes.rank_inputs``)
    ``parallel.modes.modes_rank`` on them."""
    from efficient_gnns_tpu_torch.parallel import sharded_trainer
    from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_replicated

    mesh = make_mesh(dist.get_world_size(), *inputs["mesh"], device=device)
    sorted_data, unsorted_data = modes_inputs(False), modes_inputs(True)
    # the train rows of the first half only: the second rank of data has none
    half_data = modes_inputs(True, EMPTY_RANK_BELOW)
    part = partition_graph_halo(sorted_data["ds"].graph, mesh.size("data"))
    out = {}
    for mode, kd in MODE_CASES:
        init = inputs["jax_init"][mode, kd]
        tr = _modes_trainer(mesh, part, sorted_data, modes_config(mode, kd, 0.0, 4096), init)
        out["jax", mode, kd] = _modes_step(tr)
        for key, data in (("draw", unsorted_data), ("empty_rank", half_data)):
            tr = _modes_trainer(mesh, part, data, modes_config(mode, kd, 0.5, DRAW_SAMPLES))
            out[key, mode, kd] = [list(tr.train_epoch(e).values()) for e in range(2)]
    if inputs.get("modes") is not None:
        from efficient_gnns_tpu_torch.parallel.modes import modes_rank

        out["modes"] = modes_rank(device, inputs["modes"])
    if not inputs.get("wrong"):
        return out

    class SummedAgain(sharded_trainer.ShardedNodeDistillTrainer):
        def _aux_term(self, feat, labels, tr):
            return all_reduce_replicated(super()._aux_term(feat, labels, tr), self.group)

    def step(mode, cls=None):
        cfg = modes_config(mode, False, 0.0, 4096)
        return _modes_trainer(mesh, part, sorted_data, cfg, inputs["jax_init"][mode, False],
                              cls)

    out["wrong", "summed_again"] = _modes_step(step("nce", SummedAgain))
    with mock.patch.object(sharded_trainer, "assemble_rows", _assemble_rows_summed_backward):
        out["wrong", "gather_sum_backward"] = _modes_step(step("nce"))
    with mock.patch.object(sharded_trainer, "all_reduce_stat", lambda x, group: x):
        out["wrong", "at_local_norm"] = _modes_step(step("at"))
    tr = step("gcd")
    tr.sproj.bn.group = tr.tproj.bn.group = None
    out["wrong", "gcd_local_bn"] = _modes_step(tr)
    return out
