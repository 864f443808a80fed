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
