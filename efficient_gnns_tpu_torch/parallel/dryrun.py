"""Drive every path of the multi-device layer once on a world of ranks
(counterpart of the ``parallel/`` sections of ``dryrun_multichip`` in the
JAX repository's ``__graft_entry__.py``).

    python -m efficient_gnns_tpu_torch.parallel.dryrun 4 --backend gloo --device cuda
    python -m efficient_gnns_tpu_torch.parallel.dryrun 4 --backend gloo --device cpu

Each rank runs, in order:

1. the halo-partition GCN step: ``spmm_halo(x @ w)``, log-softmax NLL as a
   mean over every real node, one SGD step of the replicated ``w`` with its
   gradient summed over the ranks; then the step's halo exchange alone
   (timed: its share of the step);
2. ``spmm_sharded`` and ``spmm_halo`` forward and backward of
   ``sum(sin(A @ x))``;
3. the ring InfoNCE term and its gradient;
4. the two-level ``(2, D/2)`` halo step, whose loss must equal the flat
   one's bits (skipped, saying so, for an odd world);
5. the MAG R-GCN step with the embedding tables row-sharded
   (``MagTrainer.shard_embeddings``).

``shape="tiny"`` is the JAX dryrun's size; ``shape="arxiv"`` the synthetic
ogbn-arxiv graph (169,343 nodes, padded to a multiple of the world) with
F_in = 128 and 40 classes for the step, F = 256 for the SpMMs, the ``nce``
mode's 8,192 x 256 for the ring, and a MAG at the teacher's widths (3 x 512,
349 classes) on a twentieth of ogbn-mag's node counts, 2 steps. The halo
step's loss is checked against the single-device ``ops.spmm`` loss on the
caller's device (rtol 1e-5). Left for later: the JAX dryrun's data-parallel
GCN-KD and SIGN dp x tp sections (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from efficient_gnns_tpu_torch.parallel.launch import run_world

SHAPES = {
    "tiny": dict(num_nodes=1024, num_edges=4096, feat_dim=32, num_classes=8, seed=0,
                 spmm_feat=16, nce_rows=1024, nce_dim=16,
                 mag=dict(n_paper=320, n_author=160, n_inst=8, n_field=32, feat_dim=16,
                          num_classes=4),
                 mag_hidden=8, mag_layers=2, mag_batch=32, mag_steps=1, reps=1),
    "arxiv": dict(num_nodes=169343, num_edges=1166243, feat_dim=128, num_classes=40, seed=42,
                  spmm_feat=256, nce_rows=8192, nce_dim=256,
                  mag=dict(n_paper=36819, n_author=56732, n_inst=437, n_field=2998,
                           feat_dim=128, num_classes=349),
                  mag_hidden=512, mag_layers=3, mag_batch=1000, mag_steps=2, reps=3),
}


def build_inputs(n_devices: int, shape: str = "tiny") -> Dict:
    """Everything the ranks share, built once on the host: the graph padded
    to a multiple of the world, its two partitions (flat ``n_devices``), the
    features, labels and node mask, the step's initial ``w``."""
    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.parallel.partition import partition_graph, partition_graph_halo

    cfg = SHAPES[shape]
    n = cfg["num_nodes"]
    ds = synthetic_node_dataset(num_nodes=n, num_edges=cfg["num_edges"],
                                feat_dim=cfg["feat_dim"], num_classes=cfg["num_classes"],
                                seed=cfg["seed"], pad_nodes_to=-(-n // n_devices) * n_devices,
                                hub_dense=0)
    w = np.random.default_rng(1).normal(size=(cfg["feat_dim"], cfg["num_classes"]))
    return dict(shape=shape, graph=ds.graph, x=ds.x, y=ds.y.astype(np.int64),
                # a copy: pickling the graph for the ranks moves its tensors'
                # storage to shared memory, which would leave a view dangling
                node_mask=ds.graph.node_mask.numpy().copy(), n_real=n,
                w=(w * 0.1).astype(np.float32),
                halo=partition_graph_halo(ds.graph, n_devices),
                allg=partition_graph(ds.graph, n_devices))


def _nll_sum(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, -1)
    return -(logp.gather(1, y[:, None])[:, 0] * mask).sum()


def single_device_loss(inputs: Dict, device) -> float:
    """The halo step's loss on one device: ``ops.spmm`` over the whole
    graph."""
    from efficient_gnns_tpu_torch.ops import spmm

    g = inputs["graph"].to(device)
    x = torch.from_numpy(inputs["x"]).to(device)
    z = x @ torch.from_numpy(inputs["w"]).to(device)
    mask = torch.from_numpy(inputs["node_mask"]).to(device).float()
    y = torch.from_numpy(inputs["y"]).to(device)
    return float(_nll_sum(spmm(g, z), y, mask)) / inputs["n_real"]


class _Clock:
    """Per-section host ms of each of ``reps`` runs (the ranks start each
    together; synchronised on a card) and K1's launches in one run; the
    first run's result."""

    def __init__(self, device, reps):
        from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum

        self.device, self.reps, self.k1 = device, reps, csr_segment_sum
        self.ms, self.launches = {}, {}

    def __call__(self, name, fn, reps=None):
        reps = self.reps if reps is None else reps
        self.ms[name], before, results = [], self.k1.launches, []
        for _ in range(reps):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dist.barrier()  # every rank starts the section together
            t0 = time.perf_counter()
            results.append(fn())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.ms[name].append((time.perf_counter() - t0) * 1e3)
        self.launches[name] = (self.k1.launches - before) // reps
        return results[0]


def _halo_step(spmm_fn, x, y, mask, w0, n_real, group):
    """One SGD step of the halo GCN whose aggregation is ``spmm_fn`` over
    the ranks of ``group``; returns (loss, the next w)."""
    from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_replicated

    w = w0.clone().requires_grad_()
    h = spmm_fn(x @ w)
    loss = all_reduce_replicated(_nll_sum(h, y, mask), group) / n_real
    loss.backward()
    grad = w.grad.clone()
    dist.all_reduce(grad, group=group)  # w is replicated: sum the ranks' shares
    return float(loss.detach()), (w0 - 0.1 * grad).cpu().numpy()


def _sin_fwd_bwd(mesh, fn, local, x):
    x = x.clone().requires_grad_()
    out = fn(mesh, local, x)
    torch.sin(out).sum().backward()
    return out.detach(), x.grad


def dryrun_rank(device: torch.device, inputs: Dict) -> Dict:
    """One rank of :func:`dryrun_multichip`; returns its losses, its
    per-section host ms and K1 launches, and its exchange's bytes."""
    from efficient_gnns_tpu_torch.data.mag import synthetic_mag_dataset
    from efficient_gnns_tpu_torch.parallel.collectives import all_to_all
    from efficient_gnns_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from efficient_gnns_tpu_torch.parallel.partition import (
        local_partition,
        spmm_halo,
        spmm_halo_2level,
        spmm_sharded,
    )
    from efficient_gnns_tpu_torch.parallel.ring import ring_nce_term
    from efficient_gnns_tpu_torch.train.config import DistillConfig
    from efficient_gnns_tpu_torch.train.mag_trainer import MagTrainer

    cfg = SHAPES[inputs["shape"]]
    d = dist.get_world_size()
    out = {"rank": dist.get_rank()}
    clock = _Clock(device, cfg["reps"])
    mesh = make_mesh(d, device=device)
    halo = local_partition(mesh, inputs["halo"])
    allg = local_partition(mesh, inputs["allg"])

    def rows(a):
        return shard_rows(mesh, torch.from_numpy(a))

    x, y, mask = rows(inputs["x"]), rows(inputs["y"]), rows(inputs["node_mask"]).float()
    w0 = torch.from_numpy(inputs["w"]).to(device)
    n_real = inputs["n_real"]

    out["halo_loss"], out["w_next"] = clock("halo_step", lambda: _halo_step(
        lambda z: spmm_halo(mesh, halo, z), x, y, mask, w0, n_real, mesh.group("data")))
    out["exchange_bytes"] = halo.exchange_rows * cfg["num_classes"] * 4
    # the step's exchange alone: its share of the step
    blocks = torch.zeros(d * halo.halo_width, cfg["num_classes"], device=device)
    clock("halo_exchange", lambda: all_to_all(blocks, mesh.group("data")))

    xf = torch.from_numpy(np.random.default_rng(4).normal(
        size=(halo.rows_per_dev * d, cfg["spmm_feat"])).astype(np.float32))
    xs = shard_rows(mesh, xf)
    for name, fn, local in (("spmm_sharded", spmm_sharded, allg), ("spmm_halo", spmm_halo, halo)):
        o, g = clock(name, lambda: _sin_fwd_bwd(mesh, fn, local, xs))
        out[name] = (float(o.abs().sum()), float(g.abs().sum()))  # checked finite

    rng = np.random.default_rng(2)
    nce_rows = cfg["nce_rows"] - cfg["nce_rows"] % d  # equal shards on every rank
    ft, tt = (rng.normal(size=(nce_rows, cfg["nce_dim"])).astype(np.float32)
              for _ in range(2))
    fs = shard_rows(mesh, torch.from_numpy(ft)).requires_grad_()

    def nce():
        v = ring_nce_term(mesh, fs, shard_rows(mesh, torch.from_numpy(tt)), nce_T=0.075)
        v.backward()
        return float(v.detach())

    out["nce"] = clock("ring_nce", nce)

    if d % 2:
        out["halo2_loss"] = None
        print(f"dryrun: an odd world of {d}: the two-level (2, {d}/2) section is skipped",
              flush=True)
    else:
        mesh2 = make_mesh(d, axes=("host", "chip"), shape=(2, d // 2), device=device)
        halo2 = local_partition(mesh2, inputs["halo"], ("host", "chip"))
        out["halo2_loss"], w2 = clock("halo2_step", lambda: _halo_step(
            lambda z: spmm_halo_2level(mesh2, halo2, z), x, y, mask, w0, n_real,
            dist.group.WORLD))
        out["halo2_same_bits"] = (out["halo2_loss"] == out["halo_loss"]
                                  and np.array_equal(w2, out["w_next"]))

    mds = synthetic_mag_dataset(**cfg["mag"])
    mtr = MagTrainer(DistillConfig(training="supervised", hidden=cfg["mag_hidden"],
                                   num_layers=cfg["mag_layers"], dropout=0.0, lr=0.01),
                     mds, batch_size=cfg["mag_batch"], num_steps=cfg["mag_steps"], seed=0,
                     prefetch=0, device=device)
    mtr.shard_embeddings(mesh)
    out["mag_loss"] = clock("mag_epoch", lambda: mtr.train_epoch(0)["loss"], reps=1)
    out["ms"], out["k1_launches"] = clock.ms, clock.launches
    return out


def dryrun_multichip(n_devices: int, *, backend: str = "nccl", device: str = "cuda",
                     shape: str = "tiny") -> Dict:
    """:func:`build_inputs`, then :func:`run_dryrun` on a world of
    ``n_devices`` ranks."""
    return run_dryrun(build_inputs(n_devices, shape), n_devices, backend=backend,
                      device=device)


def run_dryrun(inputs: Dict, n_devices: int, *, backend: str = "nccl",
               device: str = "cuda") -> Dict:
    """Run :func:`dryrun_rank` on a world of ``n_devices`` ranks; check that
    every loss is finite, that the halo step's loss equals the single-device
    one (rtol 1e-5) and that the ranks agree; print one summary line and
    return rank 0's result (with every rank's under ``"ranks"`` and the halo
    partition's ``halo_stats``)."""
    from efficient_gnns_tpu_torch.native import host
    from efficient_gnns_tpu_torch.parallel.partition import halo_stats

    host.available()  # build the native walker here, not in every rank at once
    shared = {k: v for k, v in inputs.items() if k != "graph"}  # the ranks' share
    ranks = run_world(dryrun_rank, n_devices, backend=backend, device=device,
                      args=(shared,))
    r0 = dict(ranks[0], ranks=ranks, halo_stats=halo_stats(inputs["halo"]))
    single = single_device_loss(inputs, device)
    losses = [r0["halo_loss"], r0["nce"], r0["mag_loss"], *r0["spmm_sharded"],
              *r0["spmm_halo"]]
    if not all(np.isfinite(v) for v in losses):
        raise RuntimeError(f"dryrun: a loss or an SpMM's sum is not finite: {losses}")
    if not np.isclose(r0["halo_loss"], single, rtol=1e-5, atol=0.0):
        raise RuntimeError(f"dryrun: halo step loss {r0['halo_loss']} != single-device {single}")
    for key in ("halo_loss", "nce", "mag_loss", "halo2_loss"):
        if any(r[key] != r0[key] for r in ranks):
            raise RuntimeError(f"dryrun: the ranks disagree on {key}")
    if n_devices % 2 == 0 and not all(r["halo2_same_bits"] for r in ranks):
        raise RuntimeError("dryrun: the two-level step is not the flat step's bits")
    r0["single_device_loss"] = single
    two = ("skipped (odd world)" if r0["halo2_loss"] is None
           else f"{r0['halo2_loss']:.6f} (the flat step's bits)")
    print(f"dryrun_multichip OK on {n_devices} ranks ({backend}, {device}, "
          f"{inputs['shape']}): {r0['halo_stats']}, "
          f"halo-partition GCN step loss {r0['halo_loss']:.6f} (single device {single:.6f}), "
          f"2-level (host x chip) halo step loss {two}, ring NCE {r0['nce']:.4f}, "
          f"MAG sharded-emb step loss {r0['mag_loss']:.4f}", flush=True)
    return r0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=4)
    parser.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--shape", default="tiny", choices=tuple(SHAPES))
    a = parser.parse_args(argv)
    r = dryrun_multichip(a.n_devices, backend=a.backend, device=a.device, shape=a.shape)
    for rank in r["ranks"]:
        print(f"rank {rank['rank']}: ms {rank['ms']} K1 launches {rank['k1_launches']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
